"""Minimal protobuf wire-format reader (dependency-free).

The image has no ``protobuf`` runtime, and vendoring generated stubs would
tie us to a schema compiler — the framework instead walks the wire format
directly by field number, the same approach the in-tree flatbuffer runtime
(``utils/flatbuf.py``) takes for flatbuffers.  Used by the TensorFlow
GraphDef loader (``filter/backends/tensorflow.py``); the hand-rolled
encoder side for the nnstreamer.proto tensor frames lives in
``decoders/serialize.py``.

Wire types: 0 varint, 1 fixed64, 2 length-delimited, 5 fixed32.

The port of ``nnstreamer_tpu/utils/protowire.py``, unchanged: it reads
the frames of the gRPC ``idl=protobuf`` codec in the port's tests.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterator, List, Tuple, Union

Value = Union[int, bytes]


def read_varint(buf: bytes, off: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[off]
        off += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, off
        shift += 7
        if shift > 70:
            raise ValueError("protowire: varint too long")


def iter_fields(buf: bytes) -> Iterator[Tuple[int, int, Value]]:
    """Yield (field_number, wire_type, raw_value) over a message body.

    Length-delimited fields yield bytes; varint/fixed yield ints.
    """
    off, end = 0, len(buf)
    while off < end:
        key, off = read_varint(buf, off)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, off = read_varint(buf, off)
        elif wire == 1:
            v = struct.unpack_from("<Q", buf, off)[0]
            off += 8
        elif wire == 2:
            ln, off = read_varint(buf, off)
            v = bytes(buf[off:off + ln])
            if len(v) != ln:
                raise ValueError("protowire: truncated length-delimited field")
            off += ln
        elif wire == 5:
            v = struct.unpack_from("<I", buf, off)[0]
            off += 4
        else:
            raise ValueError(f"protowire: unsupported wire type {wire}")
        yield field, wire, v


def fields_dict(buf: bytes) -> Dict[int, List[Tuple[int, Value]]]:
    """Collect all fields: number → [(wire_type, value), ...]."""
    out: Dict[int, List[Tuple[int, Value]]] = {}
    for field, wire, v in iter_fields(buf):
        out.setdefault(field, []).append((wire, v))
    return out


def first(d: Dict[int, List[Tuple[int, Value]]], field: int,
          default=None) -> Value:
    vals = d.get(field)
    return vals[0][1] if vals else default


def repeated(d: Dict[int, List[Tuple[int, Value]]], field: int) -> List[Value]:
    return [v for _, v in d.get(field, [])]


def zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def to_signed64(n: int) -> int:
    """Varint-encoded int64 fields arrive as unsigned — re-interpret."""
    return n - (1 << 64) if n >= (1 << 63) else n


def packed_or_repeated_varints(entries: List[Tuple[int, Value]]) -> List[int]:
    """A repeated varint field may arrive packed (wire 2) or one-per-entry
    (wire 0); normalize to a list of ints."""
    out: List[int] = []
    for wire, v in entries:
        if wire == 0:
            out.append(v)          # type: ignore[arg-type]
        elif wire == 2:
            off = 0
            while off < len(v):    # type: ignore[arg-type]
                n, off = read_varint(v, off)  # type: ignore[arg-type]
                out.append(n)
        else:
            raise ValueError("protowire: bad wire type for varint list")
    return out


def packed_or_repeated_fixed64(entries: List[Tuple[int, Value]],
                               fmt: str = "<d") -> List:
    out: List = []
    for wire, v in entries:
        if wire == 1:
            out.append(struct.unpack(fmt, struct.pack("<Q", v))[0])
        elif wire == 2:
            n = len(v) // 8        # type: ignore[arg-type]
            out.extend(struct.unpack(f"<{n}{fmt[-1]}", v))
        else:
            raise ValueError("protowire: bad wire type for fixed64 list")
    return out


def packed_or_repeated_fixed32(entries: List[Tuple[int, Value]],
                               fmt: str = "<f") -> List:
    out: List = []
    for wire, v in entries:
        if wire == 5:
            out.append(struct.unpack(fmt, struct.pack("<I", v))[0])
        elif wire == 2:
            n = len(v) // 4        # type: ignore[arg-type]
            out.extend(struct.unpack(f"<{n}{fmt[-1]}", v))
        else:
            raise ValueError("protowire: bad wire type for fixed32 list")
    return out
