"""Tensor info/config records and their parse/print/compare utilities.

TPU-native re-design of ``GstTensorInfo`` / ``GstTensorsInfo`` /
``GstTensorsConfig`` (reference: gst/nnstreamer/include/tensor_typedef.h:222-260
and the util impls in nnstreamer_plugin_api_util_impl.c).  These are plain
immutable-ish Python dataclasses; "validate" maps to :meth:`is_valid` and the
copy/free pairs collapse into dataclass copies.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Optional, Tuple

import numpy as np

from .types import (
    Dimension,
    TENSOR_RANK_LIMIT,
    TENSOR_SIZE_LIMIT,
    TENSOR_SIZE_EXTRA_LIMIT,
    TensorFormat,
    TensorType,
    dim_element_count,
    dim_is_static,
    dim_parse,
    dim_to_np_shape,
    dim_to_string,
    dims_equal,
)


@dataclasses.dataclass
class TensorInfo:
    """Metadata of a single tensor: name, dtype, dimension.

    Reference: ``GstTensorInfo`` tensor_typedef.h:222-231.
    """

    dtype: Optional[TensorType] = None
    dims: Dimension = ()
    name: Optional[str] = None

    # -- validation / size ---------------------------------------------------
    def is_valid(self) -> bool:
        """Reference: gst_tensor_info_validate
        (nnstreamer_plugin_api_util_impl.c:133-147)."""
        return self.dtype is not None and dim_is_static(self.dims)

    @property
    def element_count(self) -> int:
        return dim_element_count(self.dims)

    @property
    def size(self) -> int:
        """Byte size of one frame of this tensor.

        Reference: gst_tensor_info_get_size
        (nnstreamer_plugin_api_util_impl.c:156-170).
        """
        if not self.is_valid():
            raise ValueError(f"invalid tensor info: {self}")
        return self.element_count * self.dtype.element_size

    @property
    def np_shape(self) -> Tuple[int, ...]:
        return dim_to_np_shape(self.dims)

    @property
    def np_dtype(self) -> np.dtype:
        if self.dtype is None:
            raise ValueError("tensor info has no dtype")
        return self.dtype.np_dtype

    # -- compare -------------------------------------------------------------
    def is_equal(self, other: "TensorInfo") -> bool:
        """Dtype+dims equality, rank-lenient; names are not compared.

        Reference: gst_tensor_info_is_equal
        (nnstreamer_plugin_api_util_impl.c:182-205).
        """
        if self.dtype is None or other.dtype is None:
            return False
        return self.dtype is other.dtype and dims_equal(self.dims, other.dims)

    # -- parse / print -------------------------------------------------------
    @classmethod
    def from_np(cls, arr: np.ndarray, name: Optional[str] = None) -> "TensorInfo":
        from .types import np_shape_to_dim

        return cls(dtype=TensorType.from_np(arr.dtype),
                   dims=np_shape_to_dim(arr.shape), name=name)

    def to_string(self) -> str:
        return f"{self.dtype},{dim_to_string(self.dims)}"

    def __str__(self) -> str:
        return (f"TensorInfo(name={self.name!r} type={self.dtype} "
                f"dims={dim_to_string(self.dims)})")

    def copy(self) -> "TensorInfo":
        return dataclasses.replace(self)


@dataclasses.dataclass
class TensorsInfo:
    """Ordered collection of :class:`TensorInfo` (≤16 base + extra).

    Reference: ``GstTensorsInfo`` tensor_typedef.h:233-243; extra-tensor
    handling nnstreamer_plugin_api_util_impl.c:57-111.
    """

    infos: List[TensorInfo] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        limit = TENSOR_SIZE_LIMIT + TENSOR_SIZE_EXTRA_LIMIT
        if len(self.infos) > limit:
            raise ValueError(f"too many tensors: {len(self.infos)} > {limit}")

    @property
    def num_tensors(self) -> int:
        return len(self.infos)

    def __len__(self) -> int:
        return len(self.infos)

    def __getitem__(self, i: int) -> TensorInfo:
        return self.infos[i]

    def __iter__(self):
        return iter(self.infos)

    def append(self, info: TensorInfo) -> None:
        if len(self.infos) >= TENSOR_SIZE_LIMIT + TENSOR_SIZE_EXTRA_LIMIT:
            raise ValueError("tensor count limit reached")
        self.infos.append(info)

    def is_valid(self) -> bool:
        """Reference: gst_tensors_info_validate
        (nnstreamer_plugin_api_util_impl.c:590-612)."""
        return self.num_tensors > 0 and all(i.is_valid() for i in self.infos)

    def is_equal(self, other: "TensorsInfo") -> bool:
        """Reference: gst_tensors_info_is_equal
        (nnstreamer_plugin_api_util_impl.c:620-644)."""
        if self.num_tensors != other.num_tensors:
            return False
        return all(a.is_equal(b) for a, b in zip(self.infos, other.infos))

    # -- parse / print (reference: gst_tensors_info_parse_*_string and
    #    gst_tensors_info_get_*_string,
    #    nnstreamer_plugin_api_util_impl.c:652-899) ---------------------------
    @classmethod
    def from_strings(cls, dims: str, types: str,
                     names: Optional[str] = None) -> "TensorsInfo":
        """Build from ``"3:224:224,10"`` style dim and ``"uint8,float32"``
        style type strings (comma- or dot-separated per reference caps)."""
        dim_list = _split_multi(dims)
        type_list = _split_multi(types)
        if len(dim_list) != len(type_list):
            raise ValueError(
                f"dims/types count mismatch: {len(dim_list)} vs {len(type_list)}")
        name_list: List[Optional[str]] = [None] * len(dim_list)
        if names:
            parsed = [n.strip() or None for n in _split_multi(names)]
            if len(parsed) != len(dim_list):
                raise ValueError("names count mismatch")
            name_list = parsed
        infos = [
            TensorInfo(dtype=TensorType.from_string(t), dims=dim_parse(d),
                       name=n)
            for d, t, n in zip(dim_list, type_list, name_list)
        ]
        return cls(infos=infos)

    def dims_string(self, sep: str = ",") -> str:
        """``sep="."`` is the in-caps separator (reference caps use ``.``
        because ``,`` delimits caps fields)."""
        return sep.join(dim_to_string(i.dims) for i in self.infos)

    def types_string(self, sep: str = ",") -> str:
        return sep.join(str(i.dtype) for i in self.infos)

    def names_string(self, sep: str = ",") -> str:
        return sep.join(i.name or "" for i in self.infos)

    def total_size(self) -> int:
        return sum(i.size for i in self.infos)

    def copy(self) -> "TensorsInfo":
        return TensorsInfo(infos=[i.copy() for i in self.infos])

    def __str__(self) -> str:
        return f"TensorsInfo[{', '.join(str(i) for i in self.infos)}]"


DEFAULT_FRAMERATE = Fraction(0, 1)


@dataclasses.dataclass
class TensorsConfig:
    """Stream-level configuration: tensors info + framerate + format.

    Reference: ``GstTensorsConfig`` tensor_typedef.h:245-260 (rate_n/rate_d
    become a :class:`fractions.Fraction`; ``info`` keeps its role).
    """

    info: TensorsInfo = dataclasses.field(default_factory=TensorsInfo)
    rate: Optional[Fraction] = None  # None = unspecified; 0/1 = "static" src
    format: TensorFormat = TensorFormat.STATIC

    def is_valid(self) -> bool:
        """Reference: gst_tensors_config_validate
        (nnstreamer_plugin_api_util_impl.c:932-955): flexible/sparse streams
        don't require static per-tensor info; static streams do.  A known
        framerate is required for a fully-negotiated stream."""
        if self.rate is None:
            return False
        if self.format is not TensorFormat.STATIC:
            return True
        return self.info.is_valid()

    def is_equal(self, other: "TensorsConfig") -> bool:
        """Reference: gst_tensors_config_is_equal
        (nnstreamer_plugin_api_util_impl.c:963-984)."""
        if self.format is not other.format:
            return False
        if (self.rate or DEFAULT_FRAMERATE) != (other.rate or DEFAULT_FRAMERATE):
            return False
        if self.format is TensorFormat.STATIC:
            return self.info.is_equal(other.info)
        return True

    def copy(self) -> "TensorsConfig":
        return TensorsConfig(info=self.info.copy(), rate=self.rate,
                             format=self.format)

    def __str__(self) -> str:
        rate = "?" if self.rate is None else f"{self.rate.numerator}/{self.rate.denominator}"
        return f"TensorsConfig(format={self.format} rate={rate} info={self.info})"


def _split_multi(s: str) -> List[str]:
    """Split a caps list string on ``,`` (reference also accepts ``.`` as the
    separator inside caps strings because ``,`` delimits caps fields;
    nnstreamer_plugin_api_util_impl.c:672-676)."""
    s = s.strip()
    if not s:
        return []
    sep = "," if "," in s else "."
    return [p for p in s.split(sep)]
