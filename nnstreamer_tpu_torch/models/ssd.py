"""SSD-MobileNetV2 object detection — benchmark config 2.

The PyTorch counterpart of ``nnstreamer_tpu/models/ssd.py``, whose output
contract matches the tflite SSD graph consumed by the ``bounding_boxes``
decoder (reference: ext/nnstreamer/tensor_decoder/tensordec-boundingbox.c,
mobilenet-ssd scheme): raw box encodings ``(anchors, 4)`` and per-class
sigmoid scores ``(anchors, 91)``; decoding (priors, NMS) happens in the
decoder or, pushed down, in the filter's graph.

- The heads flatten **HWC** maps, as the JAX model's ``reshape(-1, 4)``
  does, so the anchor order is (row, column, anchor): the NCHW maps are
  permuted to NHWC first;
- the anchor count follows from the input size (1,887 at 300x300, not the
  JAX module's nominal ``NUM_ANCHORS = 1917``): :func:`anchor_count`
  reads it off a meta-device pass;
- flax names: the stem ``_ConvBN_0``, ``_InvertedResidual_0..16``, the
  extra maps ``_ConvBN_1..4`` and the heads ``Conv_0..7`` (box, score per
  feature map, in call order, with bias).
"""

from __future__ import annotations

import itertools
from typing import Dict, Tuple

import torch
from torch import nn

from ..device import DeviceLike, parse_dtype, resolve_device
from ..tensor.info import TensorInfo, TensorsInfo
from ..tensor.types import TensorType
from .mobilenet_v2 import (_INVERTED_RESIDUAL_CFG, _ConvBN,
                           conv_bias_targets, convbn_targets, frames_nchw,
                           init_weights, inverted_residuals, ir_targets,
                           load_flax, params_from_flax)
from .registry import Model, loss_misfit, register_model

__all__ = ["SSDMobileNetV2", "anchor_count", "build_ssd_mobilenet_v2",
           "load_flax", "params_from_flax"]

NUM_CLASSES = 91
#: anchors per cell of each feature map (stride 16, 32, 64, 128)
ANCHORS_PER_CELL = (3, 6, 6, 6)


class SSDMobileNetV2(nn.Module):
    """MobileNetV2 feature extractor + SSD heads over uint8 HWC frames."""

    def __init__(self, num_classes: int = NUM_CLASSES,
                 dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.stem = _ConvBN(3, 32, 3, 2)
        blocks, cin = inverted_residuals(32)
        self.blocks = nn.Sequential(*blocks)
        # the stride-16 and stride-32 maps: the last blocks of the 96-
        # and 320-channel stages
        ends = itertools.accumulate(n for _, _, n, _ in
                                    _INVERTED_RESIDUAL_CFG)
        self.taps = {end - 1 for end, (_, ch, _, _) in
                     zip(ends, _INVERTED_RESIDUAL_CFG) if ch in (96, 320)}
        # extra SSD feature maps (stride 64/128) for multi-scale anchors
        self.extra = nn.ModuleList([
            _ConvBN(cin, 256, 1), _ConvBN(256, 512, 3, 2),
            _ConvBN(512, 128, 1), _ConvBN(128, 256, 3, 2)])
        feats = (96, cin, 512, 256)
        self.box_heads = nn.ModuleList(
            nn.Conv2d(c, a * 4, 3, padding=1)
            for c, a in zip(feats, ANCHORS_PER_CELL))
        self.score_heads = nn.ModuleList(
            nn.Conv2d(c, a * num_classes, 3, padding=1)
            for c, a in zip(feats, ANCHORS_PER_CELL))

    def heads(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: NCHW in [-1, 1] → raw f32 ``(B, anchors, 4)`` box encodings
        and ``(B, anchors, classes)`` score logits."""
        feats = []
        x = self.stem(x)
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in self.taps:
                feats.append(x)
        y = self.extra[1](self.extra[0](x))
        z = self.extra[3](self.extra[2](y))
        feats += [y, z]
        boxes, scores = [], []
        for f, bh, sh in zip(feats, self.box_heads, self.score_heads):
            # NHWC before flattening: anchors in (row, column, anchor)
            # order, as the JAX model's reshape of its HWC maps
            boxes.append(bh(f).permute(0, 2, 3, 1).reshape(f.shape[0], -1, 4))
            scores.append(sh(f).permute(0, 2, 3, 1)
                          .reshape(f.shape[0], -1, self.num_classes))
        return torch.cat(boxes, 1).float(), torch.cat(scores, 1).float()

    def forward(self, frame: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """frame: uint8 ``(H, W, 3)`` → ``(boxes (anchors, 4), scores
        (anchors, classes))`` in f32, scores through a sigmoid; a batch
        ``(B, H, W, 3)`` → the same with a leading ``B``."""
        boxes, scores = self.heads(frames_nchw(frame, self.dtype))
        scores = torch.sigmoid(scores)
        if frame.dim() == 3:
            return boxes[0], scores[0]
        return boxes, scores

    def flax_targets(self):
        yield from convbn_targets("stem.", ("_ConvBN_0",))
        yield from ir_targets(self.blocks, "blocks.")
        for i in range(4):
            yield from convbn_targets(f"extra.{i}.", (f"_ConvBN_{i + 1}",))
        for i in range(4):
            yield from conv_bias_targets(f"box_heads.{i}.", f"Conv_{2 * i}")
            yield from conv_bias_targets(f"score_heads.{i}.",
                                         f"Conv_{2 * i + 1}")


def anchor_count(size: int, num_classes: int = NUM_CLASSES) -> int:
    """Anchors of a ``size`` x ``size`` input, from a pass over the
    module's shapes on the meta device (no weights, no compute)."""
    with torch.device("meta"):
        probe = SSDMobileNetV2(num_classes).eval()
        boxes, _ = probe.heads(torch.empty(1, 3, size, size))
    return int(boxes.shape[1])


def build_ssd_mobilenet_v2(custom_props: Dict[str, str],
                           device: DeviceLike = None) -> Model:
    device = resolve_device(device)
    seed = int(custom_props.get("seed", 0))
    size = int(custom_props.get("input_size", 300))
    dtype = parse_dtype(custom_props.get("dtype"), device)
    module = SSDMobileNetV2(dtype=dtype)
    init_weights(module, torch.Generator().manual_seed(seed))
    module = module.to(device=device, dtype=dtype,
                       memory_format=torch.channels_last).eval()
    n_anchors = anchor_count(size)
    in_info = TensorsInfo([TensorInfo(TensorType.UINT8, (3, size, size))])
    out_info = TensorsInfo([
        TensorInfo(TensorType.FLOAT32, (4, n_anchors)),
        TensorInfo(TensorType.FLOAT32, (NUM_CLASSES, n_anchors)),
    ])
    return Model(name="ssd_mobilenet_v2", module=module, device=device,
                 in_info=in_info, out_info=out_info, batched=module)


register_model("ssd_mobilenet_v2", untrainable=loss_misfit(
    "its first output is the (anchors, 4) box tensor"))(
        build_ssd_mobilenet_v2)
