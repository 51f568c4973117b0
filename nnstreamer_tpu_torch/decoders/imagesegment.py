"""image_segment decoder: per-pixel class scores → colorized RGBA video.

Parity with ext/nnstreamer/tensor_decoder/tensordec-imagesegment.c
(tflite-deeplab mode: argmax over the class axis, per-class color map).
Option1 selects the scheme (``tflite-deeplab`` | ``snpe-deeplab`` | ``argmax``
for pre-argmaxed int maps).

The counterpart of ``nnstreamer_tpu/decoders/imagesegment.py``: the
class-axis argmax (the pushdown, and the reduction of a device buffer
that arrives without one) is ``torch.argmax``, which returns the first
maximal index as ``jnp.argmax`` does.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import BatchView, TensorBuffer, to_host
from ..tensor.info import TensorsConfig
from . import Decoder, register_decoder, squeeze_leading

# 21-class VOC-ish color map, RGBA
_COLORS = np.array(
    [[0, 0, 0, 0]] + [
        [(i * 67) % 256, (i * 113) % 256, (i * 197) % 256, 160]
        for i in range(1, 64)],
    dtype=np.uint8)

def class_map(scores: torch.Tensor) -> torch.Tensor:
    """Class-axis (last) argmax as int32, on the scores' device."""
    return torch.argmax(scores, dim=-1).to(torch.int32)


def _is_integer(t) -> bool:
    if isinstance(t, torch.Tensor):
        return not (t.dtype.is_floating_point or t.dtype.is_complex
                    or t.dtype == torch.bool)
    return np.issubdtype(np.dtype(t.dtype), np.integer)


@register_decoder
class ImageSegmentDecoder(Decoder):
    MODE = "image_segment"

    def __init__(self) -> None:
        self.scheme = "tflite-deeplab"

    def set_option(self, index: int, value: str) -> None:
        if index == 1 and value:
            self.scheme = value

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        dims = tuple(config.info[0].dims)
        # dims are innermost-first; drop OUTERMOST unit dims (trailing
        # here) — the batch-dim analogue of decode()'s stripping
        while len(dims) > 2 and dims[-1] == 1:
            dims = dims[:-1]
        is_classmap = np.dtype(config.info[0].np_dtype).kind in "iu"
        if self.scheme == "argmax" or is_classmap or len(dims) == 2:
            # pre-argmaxed map — native scheme or device-reduced pushdown
            w, h = (dims + (1, 1))[:2]
        else:
            _, w, h = (dims + (1, 1, 1))[:3]
        return Caps([Structure("video/x-raw", {
            "format": "RGBA", "width": w, "height": h,
            "framerate": config.rate or Fraction(0, 1)})])

    def device_reduce_spec(self, config: TensorsConfig):
        """Pushdown: class-axis argmax on device — DeepLab-257 fetches a
        260 KB int map instead of the 5.5 MB float score volume."""
        if self.scheme == "argmax" or config.info.num_tensors != 1:
            return None
        shape = config.info[0].np_shape
        if len(shape) != 3:                     # already reduced
            return None
        from ..tensor.info import TensorInfo, TensorsInfo
        from ..tensor.types import TensorType, np_shape_to_dim

        def fn(outs):
            return [class_map(outs[0])]

        reduced = TensorsInfo([TensorInfo(TensorType.INT32,
                                          np_shape_to_dim(shape[:2]))])
        return fn, reduced

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        raw = buf.tensors[0]
        if isinstance(raw, BatchView):
            raw = raw.device_slice()
        # strip leading batch/unit dims (real tflite graphs emit
        # (1, H, W, C); reference dims are 1-padded the same way).  An
        # integer tensor is an already-argmaxed class map — native
        # pre-argmaxed schemes and the device-reduced pushdown form both
        # produce one — so it strips down to (H, W).
        is_classmap = _is_integer(raw)
        raw = squeeze_leading(raw, 2 if is_classmap else 3)
        if raw is not buf.tensors[0]:
            buf = buf.with_tensors([raw] + list(buf.tensors[1:]))
        if self.scheme == "argmax" or is_classmap or len(raw.shape) == 2:
            # native pre-argmaxed scheme, or the device-reduced pushdown
            # form (filter already argmaxed on device)
            classes = buf.np(0).astype(np.int32)
        elif isinstance(raw, torch.Tensor):
            # device buffer without pushdown (e.g. no upstream filter
            # handled the event): argmax where it lies — avoids fetching
            # the full score volume
            classes = to_host(class_map(raw))
        else:
            classes = buf.np(0).argmax(axis=-1).astype(np.int32)  # (H, W)
        rgba = _COLORS[classes % len(_COLORS)]
        out = buf.with_tensors([rgba])
        out.extra["class_map"] = classes
        return out
