"""direct_video decoder: uint8 tensor → video/x-raw.

Parity with ext/nnstreamer/tensor_decoder/tensordec-directvideo.c
(tensor dims (c,w,h) with c∈{1,3,4} → GRAY8/RGB/RGBA video).  The
counterpart of ``nnstreamer_tpu/decoders/directvideo.py``.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig
from ..tensor.types import TensorType
from . import Decoder, register_decoder

_FORMATS = {1: "GRAY8", 3: "RGB", 4: "RGBA"}


@register_decoder
class DirectVideoDecoder(Decoder):
    MODE = "direct_video"

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        info = config.info[0]
        if info.dtype is not TensorType.UINT8:
            raise ValueError("direct_video requires uint8 tensors")
        c, w, h = (tuple(info.dims) + (1, 1, 1))[:3]
        if c not in _FORMATS:
            raise ValueError(f"direct_video: {c} channels unsupported")
        return Caps([Structure("video/x-raw", {
            "format": _FORMATS[c], "width": w, "height": h,
            "framerate": config.rate or Fraction(0, 1)})])

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        return buf.with_tensors([buf.np(0)])

    def lower_decode(self, config: TensorsConfig):
        """fuse=xla: a payload passthrough (the uint8/channel checks ran
        at caps time): the frame stays on the device to segment exit,
        where the consumer's ``np()`` is the one sync.  No host
        finisher."""
        return (lambda ts: [ts[0]]), False


@register_decoder
class OctetStreamDecoder(Decoder):
    """octet_stream decoder (reference tensordec-octetstream.c): raw bytes."""

    MODE = "octet_stream"

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps([Structure("application/octet-stream", {
            "framerate": config.rate or Fraction(0, 1)})])

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        from ..pipeline.tracing import record_copy

        if buf.num_tensors == 1:
            arr = buf.np(0)
            if arr.flags.c_contiguous:
                # single contiguous tensor: the raw bytes ARE the
                # payload — reinterpret, don't concatenate
                return buf.with_tensors(
                    [arr.reshape(-1).view(np.uint8)])
        chunks = [np.ascontiguousarray(buf.np(i)).reshape(-1).view(np.uint8)
                  for i in range(buf.num_tensors)]
        record_copy(sum(c.nbytes for c in chunks))
        return buf.with_tensors([np.concatenate(chunks)])
