"""Tensor type system: dtypes, formats, and limits.

The JAX package's tensor type model (``nnstreamer_tpu/tensor/types.py``),
a re-design of the reference tensor type model
(reference: gst/nnstreamer/include/tensor_typedef.h:133-148 for the dtype
enum, :34-46 for rank/count limits, :222-296 for the info structs).

Differences from the reference, by design:

- dtypes map directly onto numpy/JAX dtypes; ``bfloat16`` is added as a
  first-class type because it is the native MXU dtype on TPU (the reference
  only has IEEE float16 behind an ``enable-float16`` build flag).
- there is no C union of scalar values; Python/numpy scalars are used.
"""

from __future__ import annotations

import enum
from typing import Sequence, Tuple

import numpy as np

#: Maximum rank of a single tensor (reference: tensor_typedef.h:34
#: ``NNS_TENSOR_RANK_LIMIT`` = 8).
TENSOR_RANK_LIMIT = 8

#: Maximum number of tensors carried in one frame of an ``other/tensors``
#: stream (reference: tensor_typedef.h:35 ``NNS_TENSOR_SIZE_LIMIT`` = 16).
TENSOR_SIZE_LIMIT = 16

#: Additional "extra" tensors accessible beyond the base 16 (reference:
#: tensor_typedef.h:44-46 ``NNS_TENSOR_SIZE_EXTRA_LIMIT``).
TENSOR_SIZE_EXTRA_LIMIT = 256


class TensorType(enum.Enum):
    """Element dtype of a tensor stream.

    Reference: ``tensor_type`` enum, tensor_typedef.h:133-148.  String names
    below are the canonical names used in caps/dim strings and must round-trip
    through :func:`TensorType.from_string`.
    """

    INT32 = "int32"
    UINT32 = "uint32"
    INT16 = "int16"
    UINT16 = "uint16"
    INT8 = "int8"
    UINT8 = "uint8"
    FLOAT64 = "float64"
    FLOAT32 = "float32"
    INT64 = "int64"
    UINT64 = "uint64"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"  # TPU-native addition; MXU-preferred dtype.

    @property
    def np_dtype(self) -> np.dtype:
        if self is TensorType.BFLOAT16:
            # numpy has no bfloat16 of its own; only this lookup needs the
            # ml_dtypes extension, so a host without it still runs every
            # stream whose tensors are not bf16 on the host
            import ml_dtypes

            return np.dtype(ml_dtypes.bfloat16)
        return np.dtype(self.value)

    @property
    def element_size(self) -> int:
        """Bytes per element (reference: tensor_element_size table,
        nnstreamer_plugin_api_util_impl.c:31-35)."""
        return self.np_dtype.itemsize

    @classmethod
    def from_string(cls, name: str) -> "TensorType":
        name = name.strip().lower()
        for t in cls:
            if t.value == name:
                return t
        raise ValueError(f"unknown tensor type {name!r}")

    @classmethod
    def from_np(cls, dtype) -> "TensorType":
        # ml_dtypes' bfloat16 is named "bfloat16", so the name lookup
        # covers it without importing ml_dtypes
        return cls.from_string(np.dtype(dtype).name)

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value


class TensorFormat(enum.Enum):
    """Data format of an ``other/tensors`` stream.

    Reference: ``tensor_format`` enum, tensor_typedef.h:150-157.

    - STATIC: shapes/dtypes fixed at negotiation time (XLA-friendly; the
      common case, and the only format the TPU hot path compiles).
    - FLEXIBLE: every buffer carries a per-tensor meta header describing its
      own shape/dtype (reference ``GstTensorMetaInfo``).
    - SPARSE: COO-style values+indices payload behind the same meta header.
    """

    STATIC = "static"
    FLEXIBLE = "flexible"
    SPARSE = "sparse"

    @classmethod
    def from_string(cls, name: str) -> "TensorFormat":
        name = name.strip().lower()
        for f in cls:
            if f.value == name:
                return f
        raise ValueError(f"unknown tensor format {name!r}")

    def __str__(self) -> str:  # pragma: no cover - trivial
        return self.value


#: A tensor dimension, reference convention: ``dim[0]`` is the innermost
#: (fastest-varying) axis — e.g. RGB 640x480 video is ``(3, 640, 480, 1)``.
#: numpy/JAX shape is the reverse of this tuple.
Dimension = Tuple[int, ...]


def dim_parse(dimstr: str) -> Dimension:
    """Parse a ``d1:d2:d3:d4`` dimension string.

    Reference: ``gst_tensor_parse_dimension``
    (nnstreamer_plugin_api_util_impl.c:1081-1118).  Missing trailing
    dimensions are *not* padded here; use :func:`dim_padded` when a fixed
    rank is needed.  ``0`` entries are allowed only in flexible contexts.
    """
    dimstr = dimstr.strip()
    if not dimstr:
        return ()
    parts = dimstr.split(":")
    if len(parts) > TENSOR_RANK_LIMIT:
        raise ValueError(
            f"rank {len(parts)} exceeds limit {TENSOR_RANK_LIMIT}: {dimstr!r}")
    dims = []
    for p in parts:
        p = p.strip()
        v = int(p)
        if v < 0:
            raise ValueError(f"negative dimension in {dimstr!r}")
        dims.append(v)
    return tuple(dims)


def dim_to_string(dim: Sequence[int], *, trim: bool = True) -> str:
    """Print a dimension as ``d1:d2:...``.

    Reference: ``gst_tensor_get_dimension_string``
    (nnstreamer_plugin_api_util_impl.c:1166-1184).  With ``trim`` the
    trailing 1s beyond the first dimension are dropped, matching the
    rank-trimmed printer used in caps.
    """
    dim = list(dim)
    if not dim:
        return ""
    if trim:
        while len(dim) > 1 and dim[-1] == 1:
            dim.pop()
    return ":".join(str(d) for d in dim)


def dim_padded(dim: Sequence[int], rank: int = TENSOR_RANK_LIMIT) -> Dimension:
    """Pad with 1s up to ``rank`` (reference pads unset dims with 1;
    tensor_typedef.h:60-66 discussion)."""
    dim = tuple(dim)
    if len(dim) > rank:
        raise ValueError(f"rank {len(dim)} exceeds {rank}")
    return dim + (1,) * (rank - len(dim))


def dims_equal(a: Sequence[int], b: Sequence[int]) -> bool:
    """Rank-lenient equality: ``3:224:224`` == ``3:224:224:1``.

    Reference: ``gst_tensor_dimension_is_equal``
    (nnstreamer_plugin_api_util_impl.c:1007-1027).
    """
    return dim_padded(a) == dim_padded(b)


def dim_is_static(dim: Sequence[int]) -> bool:
    """True when every entry is > 0 (fully specified shape)."""
    return len(dim) > 0 and all(d > 0 for d in dim)


def dim_element_count(dim: Sequence[int]) -> int:
    """Number of elements for a static dimension (reference:
    gst_tensor_get_element_count, nnstreamer_plugin_api_util_impl.c:1129)."""
    if not dim_is_static(dim):
        raise ValueError(f"dimension {dim} is not static")
    n = 1
    for d in dim:
        n *= d
    return n


def dim_to_np_shape(dim: Sequence[int]) -> Tuple[int, ...]:
    """Reference dim order (innermost-first) → numpy shape (outermost-first)."""
    return tuple(reversed(tuple(dim)))


def np_shape_to_dim(shape: Sequence[int]) -> Dimension:
    """numpy shape → reference dim order."""
    return tuple(reversed(tuple(shape)))
