"""protobuf converter: serialized Tensors messages → tensor frames.

Parity with ext/nnstreamer/tensor_converter/tensor_converter_protobuf.cc
(inverse of the protobuf decoder; schema nnstreamer.proto).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..decoders.serialize import decode_tensors_proto
from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig
from . import Converter, register_converter


@register_converter
class ProtobufConverter(Converter):
    NAME = "protobuf"

    def query_caps(self) -> Caps:
        return Caps([Structure("other/protobuf-tensor", {})])

    def get_out_config(self, in_caps: Caps) -> TensorsConfig:
        rate = in_caps.first().get("framerate")
        return TensorsConfig(rate=rate if isinstance(rate, Fraction)
                             else Fraction(0, 1))

    def convert(self, buf: TensorBuffer) -> TensorBuffer:
        blob = bytes(np.ascontiguousarray(buf.np(0)).reshape(-1)
                     .view(np.uint8))
        return buf.with_tensors(decode_tensors_proto(blob))
