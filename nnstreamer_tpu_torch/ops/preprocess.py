"""Frame preprocessing: uint8 media → scaled/shifted model dtype.

The PyTorch counterpart of ``nnstreamer_tpu/ops/preprocess.py``, whose
``normalize_frame`` is a Pallas TPU kernel.  Here it is a hand-written
CUDA kernel (``csrc/normalize_frame.cu``, built by :mod:`.._cuda`) for
tensors on the card, and :func:`normalize_frame_reference`, its plain
version, for tensors on the CPU.

Both compute ``y = cast(fma(f32(x), f32(scale), f32(shift)))``: the
product and sum are rounded ONCE to f32, as the JAX reference rounds them
on the CPU, so the port matches it bit for bit in f32 and in bf16.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda

_OUT_DTYPES = (torch.float32, torch.bfloat16)


def normalize_frame_reference(frame: torch.Tensor, scale: float = 1.0 / 127.5,
                              shift: float = -1.0,
                              dtype: torch.dtype = torch.bfloat16
                              ) -> torch.Tensor:
    """Plain version of the kernel.  ``x * scale`` of an 8-bit integer and
    an f32 scale is exact in float64, and so is adding an f32 shift of
    like magnitude; one rounding to f32 then gives exactly the FMA's
    single rounding."""
    scale64 = float(np.float32(scale))
    shift64 = float(np.float32(shift))
    y = frame.to(torch.float64) * scale64 + shift64
    return y.to(torch.float32).to(dtype)


def cast_then_scale(frame: torch.Tensor, dtype: torch.dtype,
                    scale: float = 1.0 / 127.5,
                    shift: float = -1.0) -> torch.Tensor:
    """The JAX models' plain preprocessing, ``frame.astype(dtype) * scale
    + shift``: cast first, then scale and shift in ``dtype``.  The Python
    constants round to ``dtype`` first, as JAX's weakly typed scalars do;
    in f32 XLA contracts the multiply-add into one FMA, so the product
    and sum round once (exact in float64 for an 8-bit x, as in
    :func:`normalize_frame_reference`)."""
    x = frame.to(dtype)
    scale = float(torch.tensor(scale, dtype=dtype))
    shift = float(torch.tensor(shift, dtype=dtype))
    if dtype == torch.float32:
        return (x.double() * scale + shift).float()
    return x * scale + shift


def _kernel():
    lib = _cuda.library("normalize_frame")
    fn = lib.nns_normalize_frame
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_float, ctypes.c_float, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, fn


def normalize_frame(frame: torch.Tensor, scale: float = 1.0 / 127.5,
                    shift: float = -1.0,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``y = cast(fma(x, scale, shift))`` for a uint8 frame of any shape.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (no sync) or raises."""
    if frame.device.type == "cpu":
        return normalize_frame_reference(frame, scale, shift, dtype)
    if not frame.is_cuda:
        raise ValueError(f"normalize_frame: unsupported device {frame.device}")
    if frame.dtype != torch.uint8:
        raise TypeError(f"normalize_frame: input must be uint8, "
                        f"got {frame.dtype}")
    if dtype not in _OUT_DTYPES:
        raise TypeError(f"normalize_frame: output dtype must be one of "
                        f"{_OUT_DTYPES}, got {dtype}")
    if not frame.is_contiguous():
        raise ValueError("normalize_frame: input must be contiguous")
    out = torch.empty(frame.shape, dtype=dtype, device=frame.device)
    lib, fn = _kernel()
    with torch.cuda.device(frame.device):
        stream = torch.cuda.current_stream(frame.device).cuda_stream
        code = fn(frame.data_ptr(), out.data_ptr(), frame.numel(),
                  scale, shift, int(dtype == torch.bfloat16), stream)
    _cuda.check(lib, code, "normalize_frame")
    _cuda.launches["normalize_frame"] += 1
    return out
