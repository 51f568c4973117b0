"""Tensor-stream flatbuffer codec: the reference ``nnstreamer.fbs`` schema.

Faithful wire-format implementation of ext/nnstreamer/include/nnstreamer.fbs
(namespace nnstreamer.flatbuf, root_type Tensors):

- ``Tensor``  { name:string(0); type:Tensor_type(1, default NNS_END);
  dimension:[uint32](2); data:[ubyte](3); rank:uint(4, extension) }
- ``Tensors`` { num_tensor:int(0); fr:frame_rate struct(1);
  tensor:[Tensor](2); format:Tensor_format(3) }
- ``frame_rate`` struct { rate_n:int; rate_d:int }

Encoded buffers are parseable by flatc-generated readers of that schema
(and vice versa) — used by the flatbuf decoder/converter pair, the
counterpart of tensordec-flatbuf.cc / tensor_converter_flatbuf.cc.

The wire dimension vector cannot distinguish genuine leading unit dims
from rank padding (the reference writes all NNS_TENSOR_RANK_LIMIT slots,
1- or 0-padded).  This codec therefore appends a ``rank`` field at a NEW
vtable slot — flatbuffers schema evolution: reference readers ignore it,
reference-produced buffers simply lack it — so our own round trips stay
lossless while foreign buffers fall back to padding heuristics.

The port of ``nnstreamer_tpu/utils/tensor_flatbuf.py``, unchanged: both
packages write the same bytes for the same arrays.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np

from . import flatbuf as fb

#: Tensor_type enum order (nnstreamer.fbs:12-25)
_NNS_TYPES = ["int32", "uint32", "int16", "uint16", "int8", "uint8",
              "float64", "float32", "int64", "uint64"]
_NNS_END = 10


def encode_tensors(arrays: List[np.ndarray],
                   rate: Optional[Fraction] = None,
                   names: Optional[List[Optional[str]]] = None) -> bytes:
    """Arrays (numpy shape order) → finished ``Tensors`` flatbuffer."""
    b = fb.Builder()
    tensor_offs = []
    for i, arr in enumerate(arrays):
        arr = np.ascontiguousarray(arr)
        if arr.dtype.name not in _NNS_TYPES:
            raise ValueError(
                f"flatbuf: dtype {arr.dtype} not in nnstreamer.fbs "
                "Tensor_type")
        name = names[i] if names and i < len(names) else None
        name_off = b.string(name) if name else None
        if arr.ndim > 8:
            raise ValueError(
                f"flatbuf: rank {arr.ndim} exceeds NNS_TENSOR_RANK_LIMIT 8")
        # reference dim order (innermost-first), 1-padded to the rank limit
        # exactly like the reference writers (tensordec-flatbuf.cc:127)
        dims = list(reversed(arr.shape)) or [1]
        dim_off = b.scalar_vector("uint32",
                                  dims + [1] * (8 - len(dims)))
        data_off = b.bytes_vector(arr.tobytes())
        b.start_table()
        b.add_offset(0, name_off)
        b.add_scalar(1, "int32", _NNS_TYPES.index(arr.dtype.name),
                     default=_NNS_END)
        b.add_offset(2, dim_off)
        b.add_offset(3, data_off)
        b.add_scalar(4, "uint32", len(dims), default=0)   # rank extension
        tensor_offs.append(b.end_table())
    vec_off = b.offset_vector(tensor_offs)
    b.start_table()
    b.add_scalar(0, "int32", len(arrays))
    if rate is not None:
        b.add_struct(1, "<ii", (rate.numerator, rate.denominator))
    b.add_offset(2, vec_off)
    # format(3): static=0 is the default → omitted
    root_off = b.end_table()
    return b.finish(root_off)


def decode_tensors(blob: bytes) -> Tuple[List[np.ndarray],
                                         Optional[Fraction],
                                         List[Optional[str]]]:
    """``Tensors`` flatbuffer → (arrays, framerate, names)."""
    t = fb.root(bytes(blob))
    fr = t.struct(1, "<ii")
    rate = None
    if fr is not None and fr[1] != 0:
        rate = Fraction(fr[0], fr[1])
    arrays: List[np.ndarray] = []
    names: List[Optional[str]] = []
    for tt in t.table_vector(2):
        type_id = tt.scalar(1, "int32", _NNS_END)
        if type_id >= _NNS_END:
            raise ValueError(f"flatbuf: bad Tensor_type {type_id}")
        dtype = np.dtype(_NNS_TYPES[type_id])
        raw = tt.scalar_vector(2, "uint32")
        rank = tt.scalar(4, "uint32", 0)       # our rank extension field
        if rank:
            dims = list(raw[:rank])            # exact — lossless round trip
        else:
            # Foreign (reference-written) buffer: all NNS_TENSOR_RANK_LIMIT
            # entries serialized (tensordec-flatbuf.cc:127), unfilled slots
            # 0 when default-initialized (util_impl.c:131) but 1 when
            # parsed from a dim string (:951).  Strip zeros, then — for a
            # full-rank-limit vector — the trailing 1s (= outermost unit
            # dims), which are semantically neutral in nnstreamer.
            dims = [d for d in raw if d > 0]
            if len(raw) in (4, 8):
                while len(dims) > 1 and dims[-1] == 1:
                    dims.pop()
        shape = tuple(reversed(dims)) or (1,)
        data = tt.bytes_vector(3)
        arrays.append(np.frombuffer(data, dtype).reshape(shape))
        names.append(tt.string(0))
    n = t.scalar(0, "int32")
    if n != len(arrays):
        raise ValueError(f"flatbuf: num_tensor {n} != {len(arrays)}")
    return arrays, rate, names
