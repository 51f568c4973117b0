"""Tensor type system: dtypes, infos, configs, meta, buffers."""

from .types import (TENSOR_RANK_LIMIT, TENSOR_SIZE_EXTRA_LIMIT,
                    TENSOR_SIZE_LIMIT, Dimension, TensorFormat, TensorType,
                    dim_element_count, dim_is_static, dim_padded, dim_parse,
                    dim_to_np_shape, dim_to_string, dims_equal,
                    np_shape_to_dim)
from .info import TensorInfo, TensorsConfig, TensorsInfo
from .meta import (META_HEADER_SIZE, TensorMetaInfo, unwrap_flex, wrap_flex)
from .buffer import CLOCK_TIME_NONE, SECOND, TensorBuffer, frames_to_ns

__all__ = [
    "TENSOR_RANK_LIMIT", "TENSOR_SIZE_LIMIT", "TENSOR_SIZE_EXTRA_LIMIT",
    "Dimension", "TensorFormat", "TensorType", "TensorInfo", "TensorsInfo",
    "TensorsConfig", "TensorMetaInfo", "TensorBuffer", "META_HEADER_SIZE",
    "CLOCK_TIME_NONE", "SECOND", "dim_parse", "dim_to_string", "dim_padded",
    "dims_equal", "dim_is_static", "dim_element_count", "dim_to_np_shape",
    "np_shape_to_dim", "wrap_flex", "unwrap_flex", "frames_to_ns",
]
