"""Flash attention: exact local attention with a streaming softmax.

The PyTorch counterpart of ``nnstreamer_tpu/ops/flash_attention.py``, whose
forward is a Pallas TPU kernel.  Here the forward is a hand-written CUDA
kernel (``csrc/flash_attention.cu``, built by :mod:`.._cuda`) for tensors on
the card, and :func:`flash_attention_reference`, its plain version, for
tensors on the CPU.  Both compute, for ``q (Tq, H, D)`` and ``k, v (Tkv, H,
D)``:

- scores ``q·kᵀ / sqrt(D)`` in f32, masked where (``causal``) the key's
  global position ``k_offset + j`` exceeds the query's ``q_offset + i``;
- ``out`` in q's dtype, and the per-row logsumexp ``lse`` (H, Tq) in f32;
- a row that sees no key gives ``out`` 0 and ``lse`` −inf (not NaN).

The backward kernels (ROADMAP B3/B4) are not ported yet, so a call that
needs a gradient raises.

Kernel or plain attention for ``flash=None`` callers: the JAX package gates
on TPU measurements (``utils/tuned.py``), which say nothing of this card.
Until an H100 record exists, :func:`flash_wins` picks the kernel at every
length for tensors on the card; ``NNS_TPU_FLASH_MIN_T`` keeps its meaning
as an operator threshold.
"""

from __future__ import annotations

import ctypes
import math
import os
import warnings
from typing import Optional

import torch

from .. import _cuda

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

#: the kernel's widest head dimension
MAX_HEAD_DIM = 256


def flash_is_default(x: torch.Tensor) -> bool:
    """Whether a ``flash=None`` caller should pick the kernel for ``x``:
    keys off the tensor's actual placement, as the JAX package keys off
    the actual device — only a tensor on the card can take it."""
    return bool(x.is_cuda)


def _env_min_t() -> Optional[int]:
    """NNS_TPU_FLASH_MIN_T operator override as an int, or None (absent
    or malformed; malformed warns)."""
    raw = os.environ.get("NNS_TPU_FLASH_MIN_T")
    if raw:
        try:
            return int(raw)
        except ValueError:
            warnings.warn(f"NNS_TPU_FLASH_MIN_T={raw!r} is not an int; "
                          f"ignoring the override")
    return None


def flash_wins(t: int, x: torch.Tensor) -> bool:
    """Kernel selection for ``flash=None`` callers doing full local
    attention over ``t`` tokens of tensors placed like ``x``.  Off the
    card: never.  On it: ``t >= NNS_TPU_FLASH_MIN_T`` when that override
    is set, else always — there is no H100 crossover record yet."""
    if not flash_is_default(x):
        return False
    env = _env_min_t()
    if env is not None:
        return t >= env
    return True


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be (T, H, D)")
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    if q.shape[1:] != k.shape[1:]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in heads or head dim")
    if q.shape[2] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {q.shape[2]} > "
                         f"{MAX_HEAD_DIM}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              q_offset: int = 0, k_offset: int = 0,
                              return_lse: bool = False):
    """Plain version of the kernel: the whole score matrix at once, with
    the kernel's row semantics — ``out = Σ exp(s − m)·v / max(l, 1e-20)``
    and ``lse = m + log l``, so a row with no visible key gives 0 and −inf
    where a plain softmax would give NaN."""
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[2]))
    if causal:
        qpos = q_offset + torch.arange(q.shape[0], device=q.device)
        kpos = k_offset + torch.arange(k.shape[0], device=q.device)
        s = s.masked_fill(kpos[None, None, :] > qpos[None, :, None],
                          float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                       # exp(−inf) = 0 where masked
    l = p.sum(dim=-1)                          # (H, Tq)
    out = torch.einsum("hqk,khd->qhd", p, v.float()) \
        / l.clamp_min(1e-20).t()[:, :, None]
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-20)),
                      torch.full_like(l, float("-inf")))
    return out, lse


def _kernel():
    lib = _cuda.library("flash_attention")
    fn = lib.nns_flash_attention_fwd
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, i, ll, ll, ll, ll, ll, ll, i,
                       ll, ll, ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    return lib, fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None, q_offset: int = 0,
                    k_offset: int = 0, return_lse: bool = False):
    """Exact attention over ``q (Tq, H, D)``, ``k, v (Tkv, H, D)``.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel on the current stream (no sync) or raises.  Inputs are read in
    place through their strides (the head dim must be contiguous): the
    q/k/v views of a fused QKV projection cost no copy.

    ``causal`` masks ``k_offset + j > q_offset + i`` (global positions, so
    blockwise callers keep global causality).  ``block_q``/``block_k`` are
    kept for signature parity with the JAX package and never change the
    result: the kernel's tiles are its own.  ``return_lse`` also returns
    the per-row logsumexp (H, Tq) f32.  Float32, float16 and bfloat16;
    head dim up to 256.  Forward only: a call that needs a gradient raises
    :class:`NotImplementedError`."""
    del block_q, block_k
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash_attention: the backward kernels are not ported yet "
            "(ROADMAP B3/B4); call it under torch.no_grad() or "
            "torch.inference_mode()")
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, q_offset,
                                         k_offset, return_lse)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.stride(2) != 1 or k.stride(2) != 1 or v.stride(2) != 1:
        raise ValueError("flash_attention: the head dim of q, k and v must "
                         "be contiguous")
    tq, h, d = q.shape
    tkv = k.shape[0]
    out = torch.empty((tq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((h, tq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    lib, fn = _kernel()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), tq, tkv, h, d, q.stride(0), q.stride(1),
                  k.stride(0), k.stride(1), v.stride(0), v.stride(1),
                  int(bool(causal)), int(q_offset), int(k_offset),
                  1.0 / math.sqrt(d), _DTYPES[q.dtype], stream)
    _cuda.check(lib, code, "flash_attention")
    _cuda.launches["flash_attention"] += 1
    return (out, lse) if return_lse else out
