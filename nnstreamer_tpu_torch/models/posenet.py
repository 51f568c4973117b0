"""PoseNet pose estimation — benchmark config 4.

The PyTorch counterpart of ``nnstreamer_tpu/models/posenet.py``
(reference PoseNet fixture consumed by the ``pose_estimation`` decoder,
tensordec-pose.c): keypoint heatmaps and short-range offsets.

MobileNetV2 backbone, then two 1x1 heads with bias (flax ``Conv_0`` the
heatmaps through a sigmoid in f32, ``Conv_1`` the offsets).  The outputs
are HWC, ``(h, w, 17)`` and ``(h, w, 34)`` (9x9 at 257x257), as the JAX
model's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..device import DeviceLike, parse_dtype, resolve_device
from ..tensor.info import TensorInfo, TensorsInfo
from ..tensor.types import TensorType
from .mobilenet_v2 import (_ConvBN, conv_bias_targets,
                           convbn_targets, frames_nchw, init_weights,
                           inverted_residuals, ir_targets)
from .registry import Model, loss_misfit, register_model

NUM_KEYPOINTS = 17  # COCO


class PoseNet(nn.Module):
    """PoseNet (MobileNetV2, heatmap and offset heads) over uint8 HWC
    frames."""

    def __init__(self, num_keypoints: int = NUM_KEYPOINTS,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.stem = _ConvBN(3, 32, 3, 2)
        blocks, cin = inverted_residuals(32)
        self.blocks = nn.Sequential(*blocks)
        self.heat = nn.Conv2d(cin, num_keypoints, 1)
        self.offsets = nn.Conv2d(cin, 2 * num_keypoints, 1)

    def forward(self, frame: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frame: uint8 ``(H, W, 3)`` → ``(heat (h, w, K), offsets (h, w,
        2K))`` in f32; a batch ``(B, H, W, 3)`` → the same with a leading
        ``B``."""
        x = self.blocks(self.stem(frames_nchw(frame, self.dtype)))
        heat = torch.sigmoid(self.heat(x).float()).permute(0, 2, 3, 1)
        offs = self.offsets(x).float().permute(0, 2, 3, 1)
        if frame.dim() == 3:
            return heat[0], offs[0]
        return heat, offs

    def flax_targets(self):
        yield from convbn_targets("stem.", ("_ConvBN_0",))
        yield from ir_targets(self.blocks, "blocks.")
        yield from conv_bias_targets("heat.", "Conv_0")
        yield from conv_bias_targets("offsets.", "Conv_1")


def output_hw(size: int) -> Tuple[int, int]:
    """The heatmap grid of a ``size`` x ``size`` input: five stride-2
    SAME stages, each ``ceil(n / 2)``."""
    n = size
    for _ in range(5):
        n = -(-n // 2)
    return n, n


def build_posenet(custom_props: Dict[str, str],
                  device: DeviceLike = None) -> Model:
    device = resolve_device(device)
    seed = int(custom_props.get("seed", 0))
    size = int(custom_props.get("input_size", 257))
    dtype = parse_dtype(custom_props.get("dtype"), device)
    module = PoseNet(dtype=dtype)
    init_weights(module, torch.Generator().manual_seed(seed))
    module = module.to(device=device, dtype=dtype,
                       memory_format=torch.channels_last).eval()
    h, w = output_hw(size)
    in_info = TensorsInfo([TensorInfo(TensorType.UINT8, (3, size, size))])
    out_info = TensorsInfo([
        TensorInfo(TensorType.FLOAT32, (NUM_KEYPOINTS, w, h)),
        TensorInfo(TensorType.FLOAT32, (2 * NUM_KEYPOINTS, w, h)),
    ])
    return Model(name="posenet", module=module, device=device,
                 in_info=in_info, out_info=out_info, batched=module)


register_model("posenet", untrainable=loss_misfit(
    "its first output is the (H, W, 17) heatmap"))(build_posenet)
