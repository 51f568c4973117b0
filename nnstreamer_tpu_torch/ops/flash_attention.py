"""Flash attention: exact local attention with a streaming softmax.

The PyTorch counterpart of ``nnstreamer_tpu/ops/flash_attention.py``, whose
forward and two backward kernels are Pallas TPU kernels.  Here each is a
hand-written CUDA kernel for tensors on the card, built by :mod:`.._cuda`:

- K2, the forward (``csrc/flash_attention.cu``), plain version
  :func:`flash_attention_reference`: f16 and bf16 on the tensor cores,
  rounding p to the inputs' type before ``p·v`` (so within a tolerance of
  the plain version, not bit-equal), f32 and head dims past 128 on the
  CUDA cores;
- K3 (dq) and K4 (dk, dv), the backward (``csrc/flash_attention_bwd.cu``),
  plain version :func:`flash_attention_backward_reference`.

For ``q (Tq, H, D)`` and ``k, v (Tkv, H, D)`` — or the same with a leading
batch axis, ``(B, T, H, D)``, which the kernels take as a grid axis, as
``jax.vmap`` lifts the batch into the ``pallas_call`` grid — they compute:

- scores ``q·kᵀ / sqrt(D)`` in f32, masked where (``causal``) the key's
  global position ``k_offset + j`` exceeds the query's ``q_offset + i``;
- ``out`` in q's dtype, and the per-row logsumexp ``lse`` ``([B,] H, Tq)``
  in f32;
- a row that sees no key gives ``out`` 0 and ``lse`` −inf (not NaN).

A call that needs a gradient goes through :class:`_FlashFn`, the
``jax.custom_vjp`` of the JAX package: the forward saves ``(q, k, v, out,
lse)``; the backward recomputes each probability tile from ``lse`` with
``delta = rowsum(dO ∘ out)`` in f32, less the lse cotangent when ``lse`` was
returned and used.  A CPU tensor takes the plain versions; a CUDA tensor
launches the kernels or raises.

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

#: the forward kernel's widest head dimension
MAX_HEAD_DIM = 256
#: the backward kernels' widest head dimension (K4's 128-wide tiles fill
#: most of an SM's shared memory)
MAX_BWD_HEAD_DIM = 128
#: the kernels' largest batch (their grid's z extent)
MAX_BATCH = 65535


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
    if q.dim() not in (3, 4) or k.dim() != q.dim() or v.dim() != q.dim():
        raise ValueError("flash_attention: q, k, v must be (T, H, D) or "
                         "(B, T, H, D)")
    if k.shape != v.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} differ")
    if q.shape[-2:] != k.shape[-2:] or q.shape[:-3] != k.shape[:-3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in batch, heads or "
                         f"head dim")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {q.shape[-1]} > "
                         f"{MAX_HEAD_DIM}")
    if q.dim() == 4 and q.shape[0] > MAX_BATCH:
        raise ValueError(f"flash_attention: batch {q.shape[0]} > "
                         f"{MAX_BATCH}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int,
            k_offset: int):
    """f32 scaled scores ``([B,] H, Tq, Tkv)`` and the mask of the
    visible (query, key) pairs (None when every pair is visible)."""
    s = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if not causal:
        return s, None
    qpos = q_offset + torch.arange(q.shape[-3], device=q.device)
    kpos = k_offset + torch.arange(k.shape[-3], device=q.device)
    return s, kpos[None, :] <= qpos[:, None]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              q_offset: int = 0, k_offset: int = 0,
                              return_lse: bool = False):
    """Plain version of K2: the whole score matrix at once, with the
    kernel's row semantics — ``out = Σ exp(s − m)·v / max(l, 1e-20)`` and
    ``lse = m + log l``, so a row with no visible key gives 0 and −inf
    where a plain softmax would give NaN."""
    s, visible = _scores(q, k, causal, q_offset, k_offset)
    if visible is not None:
        s = s.masked_fill(~visible, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)                       # exp(−inf) = 0 where masked
    l = p.sum(dim=-1)                          # ([B,] H, Tq)
    out = torch.einsum("...hqk,...khd->...qhd", p, v.float()) \
        / l.clamp_min(1e-20).transpose(-1, -2)[..., None]
    out = out.to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l > 0, m[..., 0] + torch.log(l.clamp_min(1e-20)),
                      torch.full_like(l, float("-inf")))
    return out, lse


def flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                       causal: bool = False,
                                       q_offset: int = 0, k_offset: int = 0):
    """Plain version of K3 and K4 together: ``(dq, dk, dv)`` in the
    inputs' dtypes from the saved ``lse`` and ``delta ([B,] H, Tq)``.

    ``p = exp(s − lse)`` with ``_recompute_p``'s semantics — masked pairs
    and rows with ``lse = −inf`` give exactly 0 — then ``ds = p·(dO·vᵀ −
    delta)/sqrt(D)``, ``dq = ds·k``, ``dk = dsᵀ·q`` and ``dv = pᵀ·dO``, all
    in f32."""
    s, visible = _scores(q, k, causal, q_offset, k_offset)
    live = torch.isfinite(lse)[..., None]
    if visible is not None:
        live = live & visible
    p = torch.where(live, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dof = dout.float()
    dp = torch.einsum("...qhd,...khd->...hqk", dof, v.float())
    ds = p * (dp - delta[..., None]) * (1.0 / math.sqrt(q.shape[-1]))
    dq = torch.einsum("...hqk,...khd->...qhd", ds, k.float())
    dk = torch.einsum("...hqk,...qhd->...khd", ds, q.float())
    dv = torch.einsum("...hqk,...qhd->...khd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _fn(lib_name: str, symbol: str, argtypes):
    lib = _cuda.library(lib_name)
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib, fn


def _batched(x: torch.Tensor) -> torch.Tensor:
    """A (T, H, D) view as (1, T, H, D); a batched tensor as it is."""
    return x if x.dim() == 4 else x.unsqueeze(0)


def _strides(x: torch.Tensor):
    """(batch, row, head) strides of a (B, T, H, D) tensor in elements."""
    return x.stride(0), x.stride(1), x.stride(2)


def _require_card(what: str, *xs: torch.Tensor) -> None:
    if not xs[0].is_cuda:
        raise ValueError(f"{what}: unsupported device {xs[0].device}")
    if any(x.stride(-1) != 1 for x in xs):
        raise ValueError(f"{what}: the head dim of q, k and v must be "
                         f"contiguous")


#: K2's tensor-core versions (f16/bf16), which ``flash_attention_version``
#: launches and chip_smoke.py times against each other;
#: ``flash_attention`` launches 1 where blocks of 128 query rows fill every
#: SM twice over, else 2
FORWARD_VERSIONS = {1: "two warpgroups a block, 64 keys a stage",
                    2: "one warpgroup a block, 128 keys a stage"}


def _kernel_forward(q, k, v, causal, q_offset, k_offset):
    """K2: (out, lse) on the current stream (no sync)."""
    return _launch_forward(q, k, v, causal, q_offset, k_offset, 0)


def flash_attention_version(q, k, v, version: int, causal: bool = False,
                            q_offset: int = 0, k_offset: int = 0):
    """K2 in tensor-core version ``version`` (:data:`FORWARD_VERSIONS`;
    CUDA tensors): (out, lse).  The same function as
    :func:`flash_attention`, for timing the versions against each
    other."""
    _check(q, k, v)
    return _launch_forward(q, k, v, causal, q_offset, k_offset, version)


def _launch_forward(q, k, v, causal: bool, q_offset: int, k_offset: int,
                    version: int):
    _require_card("flash_attention", q, k, v)
    q4, k4, v4 = _batched(q), _batched(k), _batched(v)
    b, tq, h, d = q4.shape
    tkv = k4.shape[1]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:-3] + (h, tq), dtype=torch.float32,
                      device=q.device)
    if out.numel() == 0:
        return out, lse
    args = [_P] * 5 + [_I] * 5 + [_LL] * 9 + [_I, _LL, _LL, ctypes.c_float,
                                              _I, _P]
    lib, fn = (_fn("flash_attention", "nns_flash_attention_fwd", args)
               if not version else
               _fn("flash_attention", "nns_flash_attention_fwd_version",
                   args + [_I]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), b, tq, tkv, h, d, *_strides(q4),
                  *_strides(k4), *_strides(v4), int(bool(causal)),
                  int(q_offset), int(k_offset), 1.0 / math.sqrt(d),
                  _DTYPES[q.dtype], stream, *([version] if version else []))
    _cuda.check(lib, code, "flash_attention")
    _cuda.launches["flash_attention"] += 1
    return out, lse


#: argument types after the pointers: b, tq, tkv, h, d, the 12 strides,
#: causal, q_offset, k_offset, scale, dtype, stream
_BWD_TAIL = [_I] * 5 + [_LL] * 12 + [_I, _LL, _LL, ctypes.c_float, _I, _P]


def _bwd_launch(which: str, q, k, v, dout, lse, delta, causal, q_offset,
                k_offset):
    """One backward kernel on the current stream (no sync): ``which`` is
    ``"dq"`` (K3, returns dq) or ``"dkv"`` (K4, returns (dk, dv))."""
    _require_card("flash_attention backward", q, k, v, dout)
    q4, k4, v4, o4 = _batched(q), _batched(k), _batched(v), _batched(dout)
    b, tq, h, d = q4.shape
    tkv = k4.shape[1]
    outs = ((q,) if which == "dq" else (k, v))
    if tq == 0 or tkv == 0:         # nothing is visible: all gradients 0
        grads = tuple(torch.zeros(x.shape, dtype=x.dtype, device=x.device)
                      for x in outs)
        return grads[0] if which == "dq" else grads
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    grads = tuple(torch.empty(x.shape, dtype=x.dtype, device=x.device)
                  for x in outs)
    lib, fn = _fn("flash_attention_bwd", f"nns_flash_attention_bwd_{which}",
                  [_P] * (6 + len(grads)) + _BWD_TAIL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                  lse.data_ptr(), delta.data_ptr(),
                  *(g.data_ptr() for g in grads), b, tq, tkv, h, d,
                  *_strides(q4), *_strides(k4), *_strides(v4),
                  *_strides(o4), int(bool(causal)), int(q_offset),
                  int(k_offset), 1.0 / math.sqrt(d), _DTYPES[q.dtype],
                  stream)
    _cuda.check(lib, code, f"flash_attention backward ({which})")
    _cuda.launches[f"flash_attention_bwd_{which}"] += 1
    return grads[0] if which == "dq" else grads


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False,
                           q_offset=0, k_offset=0) -> torch.Tensor:
    """K3 alone: dq from the saved ``lse`` and ``delta`` (CUDA tensors)."""
    return _bwd_launch("dq", q, k, v, dout, lse, delta, causal, q_offset,
                       k_offset)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False,
                            q_offset=0, k_offset=0):
    """K4 alone: (dk, dv) from the saved ``lse`` and ``delta`` (CUDA
    tensors)."""
    return _bwd_launch("dkv", q, k, v, dout, lse, delta, causal, q_offset,
                       k_offset)


def _forward(q, k, v, causal, q_offset, k_offset):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, q_offset, k_offset,
                                         return_lse=True)
    return _kernel_forward(q, k, v, causal, q_offset, k_offset)


def _backward(q, k, v, dout, lse, delta, causal, q_offset, k_offset):
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                                  causal, q_offset, k_offset)
    args = (q, k, v, dout, lse, delta, causal, q_offset, k_offset)
    return (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))


class _FlashFn(torch.autograd.Function):
    """The JAX package's ``_flash``/``_flash_lse`` custom VJP in one:
    ``(out, lse)`` forward; the backward folds the lse cotangent (zero
    when ``lse`` went unused) into ``delta``, as ``_flash_lse_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset):
        out, lse = _forward(q, k, v, causal, q_offset, k_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, k_offset)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if dout is None:
            dout = torch.zeros_like(out)
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        # D_i = dO_i · O_i from the returned (rounded) out, in f32
        delta = (dout.float() * out.float()).sum(-1).transpose(-1, -2)
        if dlse is not None:
            delta = delta - dlse.float()
        dq, dk, dv = _backward(q, k, v, dout, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None, q_offset: int = 0,
                    k_offset: int = 0, return_lse: bool = False):
    """Exact attention over ``q ([B,] Tq, H, D)``, ``k, v ([B,] Tkv, H,
    D)``.

    A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernels on the current stream (no sync) or raises.  Inputs are read
    in place through their strides (the head dim must be contiguous): the
    q/k/v views of a fused QKV projection cost no copy.

    ``causal`` masks ``k_offset + j > q_offset + i`` (global positions, so
    blockwise callers keep global causality).  ``block_q``/``block_k`` are
    kept for signature parity with the JAX package and never change the
    result: the kernels' tiles are their own.  ``return_lse`` also returns
    the per-row logsumexp ``([B,] H, Tq)`` f32; both outputs are
    differentiable.  Float32, float16 and bfloat16; head dim up to 256
    forward, up to 128 when a gradient is needed."""
    del block_q, block_k
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if q.shape[-1] > MAX_BWD_HEAD_DIM:
            raise ValueError(f"flash_attention: head dim {q.shape[-1]} > "
                             f"{MAX_BWD_HEAD_DIM}, the backward kernels' "
                             f"widest")
        out, lse = _FlashFn.apply(q, k, v, bool(causal), int(q_offset),
                                  int(k_offset))
    else:
        out, lse = _forward(q, k, v, causal, q_offset, k_offset)
    return (out, lse) if return_lse else out
