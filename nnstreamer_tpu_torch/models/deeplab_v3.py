"""DeepLabV3 semantic segmentation — benchmark config 3.

The PyTorch counterpart of ``nnstreamer_tpu/models/deeplab_v3.py``
(reference fixture ``deeplabv3_257_mv_gpu.tflite`` consumed by the
``image_segment`` decoder, tensordec-imagesegment.c tflite-deeplab mode):
per-pixel class scores, the decoder takes the argmax.

MobileNetV2 backbone at output stride 16 (the first 13 inverted
residuals), an ASPP-lite head (a 1x1 branch beside a global-pooling
branch, concatenated, then a 1x1 projection and the class conv), and a
bilinear upsample in f32 back to the input size inside the forward
(``F.interpolate(align_corners=False, antialias=False)``, which is
``jax.image.resize(..., "bilinear")`` when upsampling).  The output is
HWC, ``(size, size, classes)``, as the JAX model's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, parse_dtype, resolve_device
from ..tensor.info import TensorInfo, TensorsInfo
from ..tensor.types import TensorType
from .mobilenet_v2 import (_INVERTED_RESIDUAL_CFG, _ConvBN, conv_bias_targets,
                           convbn_targets, frames_nchw, init_weights,
                           inverted_residuals, ir_targets)
from .registry import Model, loss_misfit, register_model

NUM_SEG_CLASSES = 21  # PASCAL VOC, same as the tflite fixture


class DeepLabV3(nn.Module):
    """DeepLabV3 (MobileNetV2, ASPP-lite) over uint8 HWC frames."""

    def __init__(self, num_classes: int = NUM_SEG_CLASSES,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.stem = _ConvBN(3, 32, 3, 2)
        # backbone at output stride 16: stop before the last stride-2 stage
        blocks, cin = inverted_residuals(32, _INVERTED_RESIDUAL_CFG[:5])
        self.blocks = nn.Sequential(*blocks)
        self.aspp = _ConvBN(cin, 256, 1)
        self.pool = _ConvBN(cin, 256, 1)
        self.project = _ConvBN(512, 256, 1)
        self.classifier = nn.Conv2d(256, num_classes, 1)

    def forward(self, frame: torch.Tensor) -> Tuple[torch.Tensor]:
        """frame: uint8 ``(H, W, 3)`` → ``(scores_f32 (H, H, classes),)``;
        a batch ``(B, H, W, 3)`` → ``((B, H, H, classes),)``."""
        size = frame.shape[-3]
        x = self.blocks(self.stem(frames_nchw(frame, self.dtype)))
        a = self.aspp(x)
        g = self.pool(x.mean(dim=(2, 3), keepdim=True))
        y = self.project(torch.cat([a, g.expand_as(a)], dim=1))
        y = F.interpolate(self.classifier(y).float(), size=(size, size),
                          mode="bilinear", align_corners=False,
                          antialias=False)
        y = y.permute(0, 2, 3, 1)
        return (y[0],) if frame.dim() == 3 else (y,)

    def flax_targets(self):
        yield from convbn_targets("stem.", ("_ConvBN_0",))
        yield from ir_targets(self.blocks, "blocks.")
        yield from convbn_targets("aspp.", ("_ConvBN_1",))
        yield from convbn_targets("pool.", ("_ConvBN_2",))
        yield from convbn_targets("project.", ("_ConvBN_3",))
        yield from conv_bias_targets("classifier.", "Conv_0")


def build_deeplab_v3(custom_props: Dict[str, str],
                     device: DeviceLike = None) -> Model:
    device = resolve_device(device)
    seed = int(custom_props.get("seed", 0))
    size = int(custom_props.get("input_size", 257))
    dtype = parse_dtype(custom_props.get("dtype"), device)
    module = DeepLabV3(dtype=dtype)
    init_weights(module, torch.Generator().manual_seed(seed))
    module = module.to(device=device, dtype=dtype,
                       memory_format=torch.channels_last).eval()
    in_info = TensorsInfo([TensorInfo(TensorType.UINT8, (3, size, size))])
    out_info = TensorsInfo(
        [TensorInfo(TensorType.FLOAT32, (NUM_SEG_CLASSES, size, size))])
    return Model(name="deeplab_v3", module=module, device=device,
                 in_info=in_info, out_info=out_info, batched=module)


register_model("deeplab_v3", untrainable=loss_misfit(
    "its one output is the (H, W, classes) score map"))(build_deeplab_v3)
