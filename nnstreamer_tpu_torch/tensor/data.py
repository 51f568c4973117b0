"""Typed scalar/aggregate ops used by transform and if elements.

The port's copy of ``nnstreamer_tpu/tensor/data.py``: the ``tensor_data_s``
ops (reference: gst/nnstreamer/tensor_data.c:78-454).  The reference keeps a tagged-union
scalar with per-dtype C switch statements; here numpy handles dtype dispatch
and we only keep the semantic API: typecast, average, std, per-channel
variants.
"""

from __future__ import annotations


import numpy as np

from .types import TensorType


def typecast(value, dtype: TensorType):
    """Scalar typecast with C-style saturation-free semantics (reference:
    gst_tensor_data_typecast, tensor_data.c:213-300)."""
    return np.asarray(value).astype(dtype.np_dtype)


def average(arr: np.ndarray) -> np.float64:
    """Mean over all elements as float64 (reference:
    gst_tensor_data_raw_average, tensor_data.c:330-360)."""
    return np.float64(np.mean(np.asarray(arr, dtype=np.float64)))


def average_per_channel(arr: np.ndarray, *, channel_axis: int = -1) -> np.ndarray:
    """Per-channel mean (reference: gst_tensor_data_raw_average_per_channel,
    tensor_data.c:368-400; the reference's "channel" is dim[0], the innermost
    axis, which is numpy axis -1)."""
    a = np.asarray(arr, dtype=np.float64)
    axes = tuple(i for i in range(a.ndim) if i != (channel_axis % a.ndim))
    return np.mean(a, axis=axes)


def std(arr: np.ndarray) -> np.float64:
    """Population standard deviation (reference:
    gst_tensor_data_raw_std, tensor_data.c:408-440)."""
    return np.float64(np.std(np.asarray(arr, dtype=np.float64)))


def std_per_channel(arr: np.ndarray, *, channel_axis: int = -1) -> np.ndarray:
    a = np.asarray(arr, dtype=np.float64)
    axes = tuple(i for i in range(a.ndim) if i != (channel_axis % a.ndim))
    return np.std(a, axis=axes)
