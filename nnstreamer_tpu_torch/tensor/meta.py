"""Per-buffer tensor meta header for flexible / sparse streams.

TPU-native equivalent of ``GstTensorMetaInfo`` (reference:
gst/nnstreamer/include/tensor_typedef.h:263-296; header serialize/parse at
nnstreamer_plugin_api_util_impl.c:1237-1435).  A flexible stream's every
payload is prefixed with this binary header so each buffer can carry its own
shape/dtype; a sparse payload additionally records ``nnz`` and is laid out as
``values[nnz] ++ indices[nnz]``.

Wire format (little-endian, 128 bytes fixed):

    uint32 magic        (0x544e4e53, "SNNT")
    uint32 version      (1)
    uint32 type         (TensorType index, table below)
    uint32 format       (0 static, 1 flexible, 2 sparse)
    uint32 media_type
    uint32 rank
    uint32 dims[8]
    uint32 sparse_nnz
    uint8  reserved[...]  (pad to 128)

The reference's header is 128 bytes as well (``META_HEADER_SIZE`` via
gst_tensor_meta_info_get_header_size).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Optional, Tuple

import numpy as np

from .types import (
    Dimension,
    TENSOR_RANK_LIMIT,
    TensorFormat,
    TensorType,
    dim_element_count,
)
from .info import TensorInfo

META_MAGIC = 0x544E4E53  # "SNNT"
META_VERSION = 1
META_HEADER_SIZE = 128

# Stable wire ids for dtypes (do NOT reorder; append only).
_TYPE_IDS = [
    TensorType.INT32, TensorType.UINT32, TensorType.INT16, TensorType.UINT16,
    TensorType.INT8, TensorType.UINT8, TensorType.FLOAT64, TensorType.FLOAT32,
    TensorType.INT64, TensorType.UINT64, TensorType.FLOAT16,
    TensorType.BFLOAT16,
]
_TYPE_TO_ID = {t: i for i, t in enumerate(_TYPE_IDS)}

_FORMAT_IDS = [TensorFormat.STATIC, TensorFormat.FLEXIBLE, TensorFormat.SPARSE]
_FORMAT_TO_ID = {f: i for i, f in enumerate(_FORMAT_IDS)}

_HEADER_STRUCT = struct.Struct("<6I8II")  # magic..rank, dims[8], nnz


@dataclasses.dataclass
class TensorMetaInfo:
    """Parsed per-buffer tensor meta (reference: GstTensorMetaInfo)."""

    dtype: TensorType
    dims: Dimension
    format: TensorFormat = TensorFormat.FLEXIBLE
    media_type: int = 0
    sparse_nnz: int = 0

    def to_bytes(self) -> bytes:
        """Serialize to the fixed 128-byte header (reference:
        gst_tensor_meta_info_update_header)."""
        rank = len(self.dims)
        if rank > TENSOR_RANK_LIMIT:
            raise ValueError(f"rank {rank} exceeds {TENSOR_RANK_LIMIT}")
        dims = list(self.dims) + [0] * (TENSOR_RANK_LIMIT - rank)
        payload = _HEADER_STRUCT.pack(
            META_MAGIC, META_VERSION, _TYPE_TO_ID[self.dtype],
            _FORMAT_TO_ID[self.format], self.media_type, rank,
            *dims, self.sparse_nnz)
        return payload + b"\x00" * (META_HEADER_SIZE - len(payload))

    @classmethod
    def from_bytes(cls, data: bytes) -> "TensorMetaInfo":
        """Parse the fixed header (reference: gst_tensor_meta_info_parse_header,
        nnstreamer_plugin_api_util_impl.c:1397-1435)."""
        if len(data) < META_HEADER_SIZE:
            raise ValueError(f"short meta header: {len(data)} bytes")
        fields = _HEADER_STRUCT.unpack_from(data, 0)
        magic, version, type_id, fmt_id, media_type, rank = fields[:6]
        dims = fields[6:14]
        nnz = fields[14]
        if magic != META_MAGIC:
            raise ValueError(f"bad meta magic 0x{magic:08x}")
        if version != META_VERSION:
            raise ValueError(f"unsupported meta version {version}")
        return cls(dtype=_TYPE_IDS[type_id], dims=tuple(dims[:rank]),
                   format=_FORMAT_IDS[fmt_id], media_type=media_type,
                   sparse_nnz=nnz)

    @classmethod
    def from_info(cls, info: TensorInfo,
                  format: TensorFormat = TensorFormat.FLEXIBLE) -> "TensorMetaInfo":
        return cls(dtype=info.dtype, dims=info.dims, format=format)

    def to_info(self) -> TensorInfo:
        """Reference: gst_tensor_meta_info_convert."""
        return TensorInfo(dtype=self.dtype, dims=self.dims)

    @property
    def data_size(self) -> int:
        """Payload byte size described by this meta (reference:
        gst_tensor_meta_info_get_data_size).  For sparse format this is the
        values+indices layout size."""
        esz = self.dtype.element_size
        if self.format is TensorFormat.SPARSE:
            return self.sparse_nnz * (esz + 4 * TENSOR_RANK_LIMIT)
        return dim_element_count(self.dims) * esz


def wrap_flex(arr: np.ndarray, meta: Optional[TensorMetaInfo] = None) -> bytes:
    """Prefix a raw tensor payload with its flexible meta header."""
    if meta is None:
        meta = TensorMetaInfo.from_info(TensorInfo.from_np(arr))
    return meta.to_bytes() + np.ascontiguousarray(arr).tobytes()


def unwrap_flex(data: bytes) -> Tuple[TensorMetaInfo, np.ndarray]:
    """Split a flexible payload into (meta, ndarray view)."""
    meta = TensorMetaInfo.from_bytes(data)
    raw = np.frombuffer(data, dtype=np.uint8, offset=META_HEADER_SIZE,
                        count=meta.data_size)
    from .types import dim_to_np_shape

    arr = raw.view(meta.dtype.np_dtype).reshape(dim_to_np_shape(meta.dims))
    return meta, arr
