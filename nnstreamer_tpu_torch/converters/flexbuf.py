"""flexbuf converter: serialized flexible-tensor payloads → static tensors.

Role parity with the reference's flexbuf/flatbuf converters
(ext/nnstreamer/tensor_converter/tensor_converter_flexbuf.cc): a byte stream
whose per-buffer payload is our flexible wire format (128-byte meta header +
payload per tensor, :mod:`nnstreamer_tpu_torch.tensor.meta`) converted back
to tensors.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig
from ..tensor.meta import META_HEADER_SIZE, TensorMetaInfo
from . import Converter, register_converter


@register_converter
class FlexbufConverter(Converter):
    NAME = "flexbuf"

    def query_caps(self) -> Caps:
        return Caps([Structure("other/flexbuf", {})])

    def get_out_config(self, in_caps: Caps) -> TensorsConfig:
        rate = in_caps.first().get("framerate")
        return TensorsConfig(rate=rate if isinstance(rate, Fraction)
                             else Fraction(0, 1))

    def convert(self, buf: TensorBuffer) -> TensorBuffer:
        data = np.ascontiguousarray(buf.np(0)).reshape(-1).view(np.uint8)
        raw = data.tobytes()
        tensors = []
        off = 0
        while off + META_HEADER_SIZE <= len(raw):
            meta = TensorMetaInfo.from_bytes(raw[off:off + META_HEADER_SIZE])
            size = meta.data_size
            payload = np.frombuffer(
                raw, np.uint8, count=size, offset=off + META_HEADER_SIZE)
            from ..tensor.types import dim_to_np_shape

            tensors.append(payload.view(meta.dtype.np_dtype)
                           .reshape(dim_to_np_shape(meta.dims)))
            off += META_HEADER_SIZE + size
        return buf.with_tensors(tensors)
