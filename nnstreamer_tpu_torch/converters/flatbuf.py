"""flatbuf converter: serialized ``Tensors`` flatbuffers → tensor frames.

Parity with ext/nnstreamer/tensor_converter/tensor_converter_flatbuf.cc
(inverse of the flatbuf decoder; schema ext/nnstreamer/include/
nnstreamer.fbs), decoded with the in-tree flatbuffer runtime.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig
from ..utils.tensor_flatbuf import decode_tensors
from . import Converter, register_converter


@register_converter
class FlatbufConverter(Converter):
    NAME = "flatbuf"

    def query_caps(self) -> Caps:
        return Caps([Structure("other/flatbuf-tensor", {})])

    def get_out_config(self, in_caps: Caps) -> TensorsConfig:
        rate = in_caps.first().get("framerate")
        return TensorsConfig(rate=rate if isinstance(rate, Fraction)
                             else Fraction(0, 1))

    def convert(self, buf: TensorBuffer) -> TensorBuffer:
        blob = bytes(np.ascontiguousarray(buf.np(0)).reshape(-1)
                     .view(np.uint8))
        arrays, _rate, _names = decode_tensors(blob)
        return buf.with_tensors(arrays)
