"""Frame normalization: the PyTorch port against the JAX package.

The JAX ``normalize_frame`` (a Pallas kernel, run here in interpret mode
as the JAX package's own tests run it on the CPU) rounds
``x * scale + shift`` once to f32.  The port's plain version must match it
bit for bit, in f32 and in bf16: that is the function the port's CUDA
kernel computes, and ``chip_smoke.py`` holds the kernel to this plain
version with a tolerance of 0 on the card (and so does
``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops import preprocess as jax_pre
from nnstreamer_tpu_torch.models.mobilenet_v2 import MobileNetV2
from nnstreamer_tpu_torch.ops import preprocess as torch_pre

DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}

#: odd sizes, sizes that are not multiples of the TPU kernel's 1024-value
#: tile, the main path's frame, and every uint8 value at once
SHAPES = [(224, 224, 3), (1,), (7, 13, 3), (1025,), (3, 1000), (256,)]

#: the model's (scale, shift) and a second pair whose products round
#: differently
PAIRS = [(1.0 / 127.5, -1.0), (0.017, -2.1)]


def _frame(shape, seed=0):
    if shape == (256,):
        return np.arange(256, dtype=np.uint8)
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _bits(x) -> np.ndarray:
    """Raw bits of a torch or JAX result, for a bit-exact comparison."""
    if isinstance(x, torch.Tensor):
        x = x.float().numpy()
    return np.asarray(np.asarray(x, dtype=np.float32)).view(np.uint32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("scale,shift", PAIRS, ids=["model", "other"])
def test_normalize_frame_matches_jax_bit_for_bit(shape, dtype, scale, shift):
    t_dtype, j_dtype = DTYPES[dtype]
    frame = _frame(shape)
    want = jax_pre.normalize_frame(jnp.asarray(frame), scale=scale,
                                   shift=shift, dtype=j_dtype)
    got = torch_pre.normalize_frame(torch.from_numpy(frame), scale, shift,
                                    t_dtype)
    assert got.dtype == t_dtype and tuple(got.shape) == shape
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_path_matches_jax_cast_first_order(dtype):
    """``use_pallas:0`` casts the frame to the model dtype before it
    scales (``nnstreamer_tpu/models/mobilenet_v2.py`` forward, run under
    ``jit`` by the backend); the port's plain path keeps that order, with
    the constants rounded to the model dtype as JAX rounds its weakly
    typed Python scalars, and XLA's contraction of the f32 multiply-add
    into one FMA."""
    t_dtype, j_dtype = DTYPES[dtype]
    frame = np.arange(256, dtype=np.uint8).reshape(16, 16, 1).repeat(3, 2)
    want = jax.jit(lambda f: f.astype(j_dtype) * (1.0 / 127.5) - 1.0)(
        jnp.asarray(frame))
    model = MobileNetV2(num_classes=10, width=0.25, dtype=t_dtype,
                        use_pallas=False)
    got = model.preprocess(torch.from_numpy(frame))
    assert got.dtype == t_dtype
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    """A non-CPU, non-CUDA tensor is refused, and the CPU path never
    counts as a kernel launch."""
    from nnstreamer_tpu_torch import _cuda

    _cuda.reset_launches()
    torch_pre.normalize_frame(torch.zeros(4, dtype=torch.uint8))
    assert _cuda.launches["normalize_frame"] == 0
    with pytest.raises(ValueError, match="unsupported device"):
        torch_pre.normalize_frame(torch.zeros(4, dtype=torch.uint8,
                                              device="meta"))

