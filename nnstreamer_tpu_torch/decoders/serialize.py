"""Serialization decoders: flexbuf / protobuf wire formats + python scripts.

Parity with the reference's serialization decoder subplugins (SURVEY.md
§2.5): tensordec-flexbuf.cc / tensordec-protobuf.cc (tensor frames →
self-describing byte streams; schema ext/nnstreamer/include/nnstreamer.proto)
and tensordec-python3.cc (user script decode).  The flexbuf format here is
the framework's own 128-byte-meta wire layout (shared with the query
protocol and the flexbuf converter); the protobuf format is a hand-rolled
proto3 encoding of the reference's ``nnstreamer.proto`` Tensors message —
encoded with protobuf wire rules so real protobuf tooling can parse it,
without requiring the protobuf runtime.

The port of ``nnstreamer_tpu/decoders/serialize.py``: the same bytes for
the same frames.  ``buf.np(i)`` brings a tensor on the card to the host
(one sync a tensor); a bf16 tensor arrives as ``ml_dtypes.bfloat16``,
whose dtype name the protobuf encoding carries as the JAX package does.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np

from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorInfo, TensorsConfig
from ..tensor.meta import TensorMetaInfo
from . import Decoder, register_decoder


@register_decoder
class FlexbufDecoder(Decoder):
    """Frame → concatenated (meta header ++ payload) per tensor — the
    inverse of converters/flexbuf.py."""

    MODE = "flexbuf"

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps([Structure("other/flexbuf", {
            "framerate": config.rate or Fraction(0, 1)})])

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        from ..pipeline.tracing import record_copy

        parts = []
        for i in range(buf.num_tensors):
            arr = buf.np(i)
            meta = TensorMetaInfo.from_info(TensorInfo.from_np(arr))
            parts.append(meta.to_bytes())
            parts.append(np.ascontiguousarray(arr).tobytes())
        blob = b"".join(parts)
        record_copy(len(blob))   # serialization output IS a materialize
        return buf.with_tensors([np.frombuffer(blob, np.uint8)])


# -- minimal proto3 wire encoding ------------------------------------------
# Faithful to ext/nnstreamer/include/nnstreamer.proto:7-40:
# message Tensor  { string name=1; Tensor_type type=2;
#                   repeated uint32 dimension=3; bytes data=4; }
# message Tensors { uint32 num_tensor=1; frame_rate fr=2
#                   {int32 rate_n=1; int32 rate_d=2};
#                   repeated Tensor tensor=3; Tensor_format format=4; }

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


_TYPE_IDS = ["int32", "uint32", "int16", "uint16", "int8", "uint8",
             "float64", "float32", "int64", "uint64", "float16", "bfloat16"]


def encode_tensors_proto(buf: TensorBuffer,
                         rate: Optional[Fraction] = None) -> bytes:
    body = bytearray()
    body += _tag(1, 0) + _varint(buf.num_tensors)
    fr = bytearray()
    if rate is not None:
        fr += _tag(1, 0) + _varint(rate.numerator)
        fr += _tag(2, 0) + _varint(rate.denominator)
    body += _len_field(2, bytes(fr))
    for i in range(buf.num_tensors):
        arr = buf.np(i)
        t = bytearray()
        name = b""
        t += _len_field(1, name)
        t += _tag(2, 0) + _varint(_TYPE_IDS.index(arr.dtype.name)
                                  if arr.dtype.name in _TYPE_IDS else 5)
        for d in reversed(arr.shape):  # reference dim order
            t += _tag(3, 0) + _varint(int(d))
        t += _len_field(4, np.ascontiguousarray(arr).tobytes())
        body += _len_field(3, bytes(t))
    return bytes(body)


def decode_tensors_proto(blob: bytes) -> List[np.ndarray]:
    """Parse the Tensors message back into arrays."""
    tensors = []
    off = 0

    def read_varint(buf, off):
        n = shift = 0
        while True:
            b = buf[off]
            off += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n, off
            shift += 7

    while off < len(blob):
        key, off = read_varint(blob, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            _, off = read_varint(blob, off)
        elif wire == 2:
            ln, off = read_varint(blob, off)
            payload = blob[off:off + ln]
            off += ln
            if field == 3:  # Tensor submessage
                t_off = 0
                dtype = np.uint8
                dims: List[int] = []
                data = b""
                while t_off < len(payload):
                    k2, t_off = read_varint(payload, t_off)
                    f2, w2 = k2 >> 3, k2 & 7
                    if w2 == 0:
                        v, t_off = read_varint(payload, t_off)
                        if f2 == 2:
                            name = _TYPE_IDS[v]
                            import ml_dtypes

                            dtype = (np.dtype(ml_dtypes.bfloat16)
                                     if name == "bfloat16"
                                     else np.dtype(name))
                        elif f2 == 3:
                            dims.append(v)
                    elif w2 == 2:
                        l2, t_off = read_varint(payload, t_off)
                        if f2 == 4:
                            data = payload[t_off:t_off + l2]
                        elif f2 == 3:
                            # proto3 packs repeated uint32 by default (the
                            # reference's C++ protobuf emits this form)
                            p_off, p_end = t_off, t_off + l2
                            while p_off < p_end:
                                v, p_off = read_varint(payload, p_off)
                                dims.append(v)
                        t_off += l2
                shape = tuple(reversed(dims))
                tensors.append(np.frombuffer(data, dtype).reshape(shape))
    return tensors


@register_decoder
class FlatbufDecoder(Decoder):
    """``mode=flatbuf``: frame → one finished ``Tensors`` flatbuffer
    (schema nnstreamer.fbs; reference tensordec-flatbuf.cc), built with the
    in-tree flatbuffer runtime — no flatbuffers library required."""

    MODE = "flatbuf"

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps([Structure("other/flatbuf-tensor", {
            "framerate": config.rate or Fraction(0, 1)})])

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        from ..utils.tensor_flatbuf import encode_tensors

        arrays = [buf.np(i) for i in range(buf.num_tensors)]
        names = [i.name for i in config.info] if config.info else None
        blob = encode_tensors(arrays, rate=config.rate, names=names)
        return buf.with_tensors([np.frombuffer(blob, np.uint8)])


@register_decoder
class ProtobufDecoder(Decoder):
    MODE = "protobuf"

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps([Structure("other/protobuf-tensor", {
            "framerate": config.rate or Fraction(0, 1)})])

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        blob = encode_tensors_proto(buf, rate=config.rate)
        return buf.with_tensors([np.frombuffer(blob, np.uint8)])


@register_decoder
class PythonScriptDecoder(Decoder):
    """``mode=python3``: option1 = path to a script defining
    ``class CustomDecoder`` with ``get_out_caps(config)->str`` and
    ``decode(tensors, config)->np.ndarray`` (reference tensordec-python3.cc
    script contract, adapted)."""

    MODE = "python3"

    def __init__(self) -> None:
        self._obj = None

    def set_option(self, index: int, value: str) -> None:
        if index == 1 and value:
            from ..utils.nns_python_compat import load_user_script

            got, _ = load_user_script(value, "_nns_pydec",
                                      "CustomDecoder", "decoder_instance")
            self._obj = got() if isinstance(got, type) else got

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        if self._obj is None:
            raise ValueError("python3 decoder: option1 script required")
        if hasattr(self._obj, "getOutCaps"):
            # reference tensordec-python3.cc contract: caps as bytes,
            # no arguments
            raw = self._obj.getOutCaps()
            if isinstance(raw, bytes):
                raw = raw.decode()
            return Caps.from_string(str(raw))
        return Caps.from_string(str(self._obj.get_out_caps(config)))

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        tensors = [buf.np(i) for i in range(buf.num_tensors)]
        if hasattr(self._obj, "getOutCaps"):
            # reference contract: decode(raw_data, in_info, rate_n,
            # rate_d) -> serialized bytes (one u8 output tensor)
            from ..utils.nns_python_compat import from_tensors_info

            raw = [np.ascontiguousarray(t).tobytes() for t in tensors]
            rate = config.rate or Fraction(0, 1)
            out = self._obj.decode(raw, from_tensors_info(config.info),
                                   rate.numerator, rate.denominator)
            arr = np.frombuffer(bytes(out), dtype=np.uint8).copy()
            return buf.with_tensors([arr])
        out = self._obj.decode(tensors, config)
        if not isinstance(out, (list, tuple)):
            out = [out]
        return buf.with_tensors([np.asarray(o) for o in out])
