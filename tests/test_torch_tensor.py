"""The port's copies of the tensor type modules agree with the JAX
package's: ``types``, ``info``, ``meta`` and ``caps_util`` give the same
answers on a table of cases."""

from fractions import Fraction

import ml_dtypes
import numpy as np
import pytest

from nnstreamer_tpu.tensor import caps_util as jax_caps_util
from nnstreamer_tpu.tensor import info as jax_info
from nnstreamer_tpu.tensor import meta as jax_meta
from nnstreamer_tpu.tensor import types as jax_types
import torch

from nnstreamer_tpu_torch.tensor import buffer as torch_buffer
from nnstreamer_tpu_torch.tensor import caps_util as torch_caps_util
from nnstreamer_tpu_torch.tensor import info as torch_info
from nnstreamer_tpu_torch.tensor import meta as torch_meta
from nnstreamer_tpu_torch.tensor import types as torch_types

TYPE_NAMES = [t.value for t in jax_types.TensorType]

NP_DTYPES = [np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32,
             np.int64, np.uint64, np.float16, np.float32, np.float64,
             ml_dtypes.bfloat16]

DIM_STRINGS = ["3:224:224:1", "1001", "3:224:224", "4:1:1:1:1",
               "1:2:3:4:5:6:7:8", "10:0"]

#: (dims, types) of TensorsInfo.from_strings
INFO_STRINGS = [("3:224:224:1", "uint8"), ("1001", "float32"),
                ("1", "int32"), ("3:32:32,10", "uint8,float32"),
                ("2:2.4:4", "bfloat16.float16")]


@pytest.mark.parametrize("name", TYPE_NAMES)
def test_tensor_type_by_name(name):
    j = jax_types.TensorType.from_string(name)
    t = torch_types.TensorType.from_string(name)
    assert t.value == j.value
    assert t.np_dtype == j.np_dtype
    assert t.element_size == j.element_size


@pytest.mark.parametrize("dtype", NP_DTYPES, ids=lambda d: np.dtype(d).name)
def test_tensor_type_by_numpy_dtype(dtype):
    assert (torch_types.TensorType.from_np(dtype).value
            == jax_types.TensorType.from_np(dtype).value)


@pytest.mark.parametrize("dims", DIM_STRINGS)
def test_dimension_helpers(dims):
    dim = jax_types.dim_parse(dims)
    assert torch_types.dim_parse(dims) == dim
    for fn in ("dim_to_string", "dim_padded", "dim_is_static",
               "dim_element_count", "dim_to_np_shape"):
        assert (_outcome(getattr(torch_types, fn), dim)
                == _outcome(getattr(jax_types, fn), dim)), fn


def _outcome(fn, *args):
    """What ``fn`` returns, or the type of what it raises."""
    try:
        return fn(*args)
    except ValueError as exc:
        return type(exc)


@pytest.mark.parametrize("dims,types", INFO_STRINGS)
def test_tensors_info_and_caps(dims, types):
    j = jax_info.TensorsInfo.from_strings(dims, types)
    t = torch_info.TensorsInfo.from_strings(dims, types)
    assert t.dims_string() == j.dims_string()
    assert t.types_string() == j.types_string()
    assert [i.np_shape for i in t] == [i.np_shape for i in j]
    assert [i.np_dtype for i in t] == [i.np_dtype for i in j]
    assert t.total_size() == j.total_size()
    rate = Fraction(30, 1)
    j_caps = jax_caps_util.caps_from_config(
        jax_info.TensorsConfig(info=j, rate=rate))
    t_caps = torch_caps_util.caps_from_config(
        torch_info.TensorsConfig(info=t, rate=rate))
    assert str(t_caps) == str(j_caps)
    back = torch_caps_util.config_from_caps(t_caps)
    assert back.info.is_equal(t) and back.rate == rate


@pytest.mark.parametrize("dtype,shape", [(np.uint8, (3, 4)),
                                         (np.float32, (1001,)),
                                         (np.int32, (1,)),
                                         (ml_dtypes.bfloat16, (2, 2, 2))])
def test_flex_meta_bytes(dtype, shape):
    arr = (np.arange(int(np.prod(shape))) % 7).astype(dtype).reshape(shape)
    j_bytes = jax_meta.wrap_flex(arr)
    assert torch_meta.wrap_flex(arr) == j_bytes
    meta, back = torch_meta.unwrap_flex(j_bytes)
    assert back.shape == shape and back.dtype == arr.dtype
    np.testing.assert_array_equal(back, arr)
    assert meta.to_bytes() == jax_meta.unwrap_flex(j_bytes)[0].to_bytes()


@pytest.mark.parametrize("payload", [
    np.arange(6, dtype=np.uint8).reshape(2, 3),
    torch.arange(6, dtype=torch.int32).reshape(2, 3),
    torch.arange(4, dtype=torch.bfloat16)], ids=["numpy", "cpu-int32",
                                                  "cpu-bf16"])
def test_buffer_host_handles(payload):
    """Host payloads are not device arrays, and ``np()`` gives their
    values as numpy (bf16 through ml_dtypes' bfloat16)."""
    buf = torch_buffer.TensorBuffer(tensors=[payload], pts=0)
    assert not torch_buffer.is_device_array(payload)
    host = buf.np(0)
    assert isinstance(host, np.ndarray) and host.shape == tuple(payload.shape)
    want = (payload.float().numpy() if isinstance(payload, torch.Tensor)
            else payload)
    np.testing.assert_array_equal(host.astype(np.float32),
                                  want.astype(np.float32))
