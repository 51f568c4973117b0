"""Minimal dependency-free FlatBuffers runtime (reader + builder).

The reference links the official flatbuffers C++ runtime for its .tflite
loader and flatbuf codec (ext/nnstreamer/tensor_filter/
tensor_filter_tensorflow_lite.cc, ext/nnstreamer/tensor_decoder/
tensordec-flatbuf.cc).  That library is not in this image, so this module
implements the FlatBuffers wire format directly — enough to (a) parse
.tflite model files and (b) encode/decode the tensor-stream flatbuf schema
(reference ext/nnstreamer/include/nnstreamer.fbs).

Wire format (little-endian throughout):

- file: ``int32`` relative offset to the root table (optionally followed by
  a 4-byte file identifier).
- table: at its position holds an ``int32`` *backwards* offset to its
  vtable; the vtable is ``uint16 vtable_bytes, uint16 table_bytes`` then one
  ``uint16`` per field slot (0 = absent → default).
- scalars are stored inline in the table; strings/vectors/subtables are
  stored via a ``uint32`` forward offset.
- string: ``uint32 len`` + bytes (+NUL); vector: ``uint32 len`` + elements.

The port of ``nnstreamer_tpu/utils/flatbuf.py``, unchanged; the port
uses it for the tensor-stream schema (``utils/tensor_flatbuf.py``).
"""

from __future__ import annotations

import struct
from typing import Any, List, Optional, Sequence, Tuple


def _u8(buf: bytes, pos: int) -> int:
    return buf[pos]


def _u16(buf: bytes, pos: int) -> int:
    return struct.unpack_from("<H", buf, pos)[0]


def _i32(buf: bytes, pos: int) -> int:
    return struct.unpack_from("<i", buf, pos)[0]


def _u32(buf: bytes, pos: int) -> int:
    return struct.unpack_from("<I", buf, pos)[0]


_SCALAR_FMT = {
    "bool": ("<?", 1), "int8": ("<b", 1), "uint8": ("<B", 1),
    "int16": ("<h", 2), "uint16": ("<H", 2),
    "int32": ("<i", 4), "uint32": ("<I", 4),
    "int64": ("<q", 8), "uint64": ("<Q", 8),
    "float32": ("<f", 4), "float64": ("<d", 8),
}


class Table:
    """Read-cursor over one flatbuffer table."""

    __slots__ = ("buf", "pos", "_vt", "_vt_size")

    def __init__(self, buf: bytes, pos: int) -> None:
        self.buf = buf
        self.pos = pos
        self._vt = pos - _i32(buf, pos)
        self._vt_size = _u16(buf, self._vt)

    def _field_pos(self, field_id: int) -> int:
        """Absolute position of field's inline data, or 0 when absent."""
        vt_off = 4 + 2 * field_id
        if vt_off >= self._vt_size:
            return 0
        rel = _u16(self.buf, self._vt + vt_off)
        return self.pos + rel if rel else 0

    def has(self, field_id: int) -> bool:
        return self._field_pos(field_id) != 0

    # -- scalars -------------------------------------------------------------
    def scalar(self, field_id: int, kind: str, default: Any = 0) -> Any:
        p = self._field_pos(field_id)
        if not p:
            return default
        fmt, _ = _SCALAR_FMT[kind]
        return struct.unpack_from(fmt, self.buf, p)[0]

    # -- offset objects ------------------------------------------------------
    def _indirect(self, field_id: int) -> int:
        p = self._field_pos(field_id)
        if not p:
            return 0
        return p + _u32(self.buf, p)

    def string(self, field_id: int) -> Optional[str]:
        p = self._indirect(field_id)
        if not p:
            return None
        n = _u32(self.buf, p)
        return self.buf[p + 4:p + 4 + n].decode("utf-8", "replace")

    def table(self, field_id: int) -> Optional["Table"]:
        p = self._indirect(field_id)
        return Table(self.buf, p) if p else None

    def struct(self, field_id: int, fmt: str) -> Optional[Tuple[Any, ...]]:
        """Inline struct field unpacked with ``fmt`` (e.g. ``"<ii"``)."""
        p = self._field_pos(field_id)
        if not p:
            return None
        return struct.unpack_from(fmt, self.buf, p)

    # -- vectors -------------------------------------------------------------
    def _vector(self, field_id: int) -> Tuple[int, int]:
        """(element-0 position, length); (0, 0) when absent."""
        p = self._indirect(field_id)
        if not p:
            return 0, 0
        return p + 4, _u32(self.buf, p)

    def vector_len(self, field_id: int) -> int:
        return self._vector(field_id)[1]

    def scalar_vector(self, field_id: int, kind: str) -> List[Any]:
        p, n = self._vector(field_id)
        if not n:
            return []
        fmt, size = _SCALAR_FMT[kind]
        return [struct.unpack_from(fmt, self.buf, p + i * size)[0]
                for i in range(n)]

    def bytes_vector(self, field_id: int) -> memoryview:
        """[ubyte] vector as a zero-copy memoryview (np.frombuffer-ready);
        large weight buffers must not be copied at model load."""
        p, n = self._vector(field_id)
        return memoryview(self.buf)[p:p + n]

    def table_vector(self, field_id: int) -> List["Table"]:
        p, n = self._vector(field_id)
        out = []
        for i in range(n):
            ep = p + i * 4
            out.append(Table(self.buf, ep + _u32(self.buf, ep)))
        return out

    def string_vector(self, field_id: int) -> List[str]:
        p, n = self._vector(field_id)
        out = []
        for i in range(n):
            ep = p + i * 4
            sp = ep + _u32(self.buf, ep)
            sl = _u32(self.buf, sp)
            out.append(self.buf[sp + 4:sp + 4 + sl].decode("utf-8", "replace"))
        return out


def root(buf: bytes, expect_identifier: Optional[str] = None) -> Table:
    """Root table of a finished flatbuffer."""
    if len(buf) < 8:
        raise ValueError("flatbuffer too short")
    if expect_identifier is not None:
        ident = buf[4:8].decode("ascii", "replace")
        if ident != expect_identifier:
            raise ValueError(
                f"flatbuffer identifier {ident!r} != {expect_identifier!r}")
    return Table(buf, _u32(buf, 0))


# ---------------------------------------------------------------------------
# builder
# ---------------------------------------------------------------------------

class Builder:
    """Minimal flatbuffer builder (bottom-up, like the official runtime).

    Supports scalars, strings, scalar vectors, byte vectors, vectors of
    offsets, and nested tables — the surface the tensor flatbuf schema
    needs.  The buffer is built back-to-front; offsets returned by
    ``end_table``/``string``/vector methods count from the *end* of the
    final buffer (larger offset = earlier file position), the same
    convention as the official runtimes.
    """

    def __init__(self) -> None:
        self._buf = bytearray()   # reversed: index 0 = LAST byte of file
        self._minalign = 4
        self._vtables: List[Tuple[Tuple[int, ...], int]] = []
        self._current: Optional[List[Tuple[int, int, Any, str]]] = None

    def _offset(self) -> int:
        return len(self._buf)

    def _push(self, data: bytes) -> None:
        self._buf.extend(reversed(data))

    def _prep(self, size: int, additional: int) -> None:
        """Pad so the object about to be pushed (``additional`` bytes of
        header/payload) ends up ``size``-aligned in the final buffer."""
        self._minalign = max(self._minalign, size)
        while (len(self._buf) + additional) % size:
            self._buf.append(0)

    def _push_u32_rel(self, target_off: int) -> None:
        """Push a uint32 forward offset to an object at ``target_off``."""
        self._prep(4, 4)
        rel = self._offset() + 4 - target_off
        if rel <= 0:
            raise ValueError("flatbuffer forward offset must be positive")
        self._push(struct.pack("<I", rel))

    # -- leaf objects --------------------------------------------------------
    def string(self, s: str) -> int:
        raw = s.encode("utf-8")
        self._prep(4, 1 + len(raw) + 4)
        self._push(b"\x00")
        self._push(raw)
        self._push(struct.pack("<I", len(raw)))
        return self._offset()

    def bytes_vector(self, data: bytes) -> int:
        self._prep(4, len(data) + 4)
        self._push(bytes(data))
        self._push(struct.pack("<I", len(data)))
        return self._offset()

    def scalar_vector(self, kind: str, values: Sequence[Any]) -> int:
        fmt, size = _SCALAR_FMT[kind]
        vals = list(values)
        self._prep(max(4, size), len(vals) * size + 4)
        for v in reversed(vals):
            self._push(struct.pack(fmt, v))
        self._push(struct.pack("<I", len(vals)))
        return self._offset()

    def offset_vector(self, offsets: Sequence[int]) -> int:
        offs = list(offsets)
        self._prep(4, len(offs) * 4 + 4)
        for i, off in enumerate(reversed(offs)):
            rel = self._offset() + 4 - off
            if rel <= 0:
                raise ValueError("offset vector target not yet written")
            self._push(struct.pack("<I", rel))
        self._push(struct.pack("<I", len(offs)))
        return self._offset()

    # -- tables --------------------------------------------------------------
    def start_table(self) -> None:
        if self._current is not None:
            raise RuntimeError("nested start_table")
        self._current = []

    def add_scalar(self, field_id: int, kind: str, value: Any,
                   default: Any = 0) -> None:
        assert self._current is not None
        if value == default:
            return
        self._current.append((field_id, 0, value, kind))

    def add_offset(self, field_id: int, offset: Optional[int]) -> None:
        assert self._current is not None
        if not offset:
            return
        self._current.append((field_id, 1, offset, ""))

    def add_struct(self, field_id: int, fmt: str,
                   values: Sequence[Any], align: int = 4) -> None:
        """Inline struct field: packed with ``fmt``, ``align`` = largest
        member size (structs are stored in-place in the table)."""
        assert self._current is not None
        self._current.append(
            (field_id, 2, (struct.pack(fmt, *values), align), ""))

    def end_table(self) -> int:
        assert self._current is not None
        fields = self._current
        self._current = None
        # field data, high field-ids pushed first (= further from table
        # start in the file); layout order within a table is free-form
        slots: dict = {}   # field_id -> (end-offset of field start, size)
        for field_id, is_off, value, kind in sorted(
                fields, key=lambda f: -f[0]):
            if is_off == 1:
                self._push_u32_rel(value)
                size = 4
            elif is_off == 2:
                raw, align = value
                size = len(raw)
                self._prep(align, size)
                self._push(raw)
            else:
                fmt, size = _SCALAR_FMT[kind]
                self._prep(size, size)
                self._push(struct.pack(fmt, value))
            slots[field_id] = (self._offset(), size)
        # table header: int32 soffset to vtable, patched once vtable lands
        self._prep(4, 4)
        patch_at = len(self._buf)
        self._push(b"\x00\x00\x00\x00")
        table_pos = self._offset()
        n_slots = (max(slots) + 1) if slots else 0
        vt = [0] * n_slots
        for fid, (off, _size) in slots.items():
            vt[fid] = table_pos - off
        vt_key = tuple(vt)
        vpos = next((v for key, v in self._vtables if key == vt_key), None)
        if vpos is None:
            vt_bytes = 4 + 2 * n_slots
            tbl_bytes = (table_pos - min(off - size
                                         for off, size in slots.values())
                         if slots else 4)
            for fo in reversed(vt):
                self._push(struct.pack("<H", fo))
            self._push(struct.pack("<H", tbl_bytes))
            self._push(struct.pack("<H", vt_bytes))
            vpos = self._offset()
            self._vtables.append((vt_key, vpos))
        # soffset: vtable_pos = table_pos - soffset (absolute file coords)
        self._buf[patch_at:patch_at + 4] = bytes(
            reversed(struct.pack("<i", vpos - table_pos)))
        return table_pos

    def finish(self, root_offset: int,
               identifier: Optional[str] = None) -> bytes:
        header = 4 + (4 if identifier is not None else 0)
        self._prep(self._minalign, header)
        if identifier is not None:
            ident = identifier.encode("ascii")
            if len(ident) != 4:
                raise ValueError("identifier must be 4 bytes")
            self._push(ident)
        self._push_u32_rel(root_offset)
        return bytes(reversed(self._buf))
