"""Flash attention: exact local attention with a streaming softmax.

The PyTorch counterpart of ``nnstreamer_tpu/ops/flash_attention.py``, whose
forward and two backward kernels are Pallas TPU kernels.  Here each is a
hand-written CUDA kernel for tensors on the card, built by :mod:`.._cuda`:

- K2, the forward (``csrc/flash_attention.cu``), plain version
  :func:`flash_attention_reference`: every dtype at every head dim on the
  tensor cores.  f16 and bf16 round p to the inputs' type before ``p·v``
  (so within a tolerance of the plain version, not bit-equal); past a head
  dim of 256 a block owns a piece of 256 output columns and takes the
  scores over the whole head dim.  f32 takes each product as three TF32
  products (each operand split into a TF32 part and the rest), within the
  f32 tolerance of the plain version, in pieces of 128 columns past 128;
- K3 (dq) and K4 (dk, dv), the backward (``csrc/flash_attention_bwd.cu``),
  plain version :func:`flash_attention_backward_reference`: every dtype
  at every head dim on the tensor cores, as the forward.  f16 and bf16
  up to 256 round p and ds to the inputs' type before the products that
  take them; past 256 a block owns a piece of 128 output columns and
  takes s and dp over the whole head dim.  f32 takes all five products
  as three TF32 products each, within the f32 tolerance of the plain
  version, in pieces of 128 columns past 64.  Every head dim the JAX
  package takes is taken here too.

For ``q (Tq, H, D)`` and ``k, v (Tkv, H, D)`` — or the same with a leading
batch axis, ``(B, T, H, D)``, which the kernels take as a grid axis, as
``jax.vmap`` lifts the batch into the ``pallas_call`` grid — they compute:

- scores ``q·kᵀ / sqrt(D)`` in f32, masked where (``causal``) the key's
  global position ``k_offset + j`` exceeds the query's ``q_offset + i``;
- ``out`` in q's dtype, and the per-row logsumexp ``lse`` ``([B,] H, Tq)``
  in f32;
- a row that sees no key gives ``out`` 0 and ``lse`` −inf (not NaN).

With ``bias`` (a float32 ``(H, Tq, Tkv)`` added to every batch row's
scores, SwinV2's learned position bias) and optionally ``regions`` (int32
``(G, T)`` region labels: batch row ``b``'s pair ``(i, j)`` takes
:data:`REGION_MASK` where ``regions[b mod G]`` differs at ``i`` and ``j``,
SwinV2's mask of a cyclically shifted window), the scores are ``scale
q·kᵀ + bias (+ mask)``, and the backward also returns the bias's gradient,
``dbias = Σ_b p·(dp − delta)``.  On the card these run in kernels of their
own (``csrc/flash_attention_bias.cu``, its library built at the first
biased call; f16 and bf16 at head dims up to 128 and up to
:data:`MAX_BIASED_TOKENS` queries and keys, any other raises), so a call
without a bias builds and launches what it did.

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

#: the kernels' largest batch (their grid's z extent)
MAX_BATCH = 65535
#: the score a biased call gives a pair of tokens from different regions
#: (SwinV2's shifted-window mask)
REGION_MASK = -100.0
#: the integer types region labels may come in (the kernels read int32)
_LABEL_DTYPES = (torch.int32, torch.int64, torch.int16, torch.int8,
                 torch.uint8)
#: the biased kernels' widest query and key axes, and head dim
MAX_BIASED_TOKENS = 256
MAX_BIASED_HEAD_DIM = 128


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
    if q.dim() == 4 and q.shape[0] > MAX_BATCH:
        raise ValueError(f"flash_attention: batch {q.shape[0]} > "
                         f"{MAX_BATCH}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: q, k, v must share one of "
                        f"{list(_DTYPES)}; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def _scale(scale: Optional[float], d: int) -> float:
    """The scores' scale: ``scale``, or ``1 / sqrt(D)`` where it is None."""
    return 1.0 / math.sqrt(d) if scale is None else float(scale)


def region_mask(regions: torch.Tensor, batch: int) -> torch.Tensor:
    """The additive mask of region labels ``(G, T)`` for ``batch`` rows,
    ``(batch, T, T)`` f32: :data:`REGION_MASK` where row ``b``'s labels
    (``regions[b mod G]``) differ at the query and the key, else 0."""
    lab = regions[torch.arange(batch, device=regions.device)
                  % regions.shape[0]]
    return (lab[:, :, None] != lab[:, None, :]).float() * REGION_MASK


def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int,
            k_offset: int, scale: Optional[float] = None,
            bias: Optional[torch.Tensor] = None,
            regions: Optional[torch.Tensor] = None):
    """f32 scaled scores ``([B,] H, Tq, Tkv)`` with the bias and region
    mask added, and the mask of the visible (query, key) pairs (None when
    every pair is visible)."""
    s = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) \
        * _scale(scale, q.shape[-1])
    if bias is not None:
        s = s + bias.float()
    if regions is not None:
        mask = region_mask(regions, q.shape[0] if q.dim() == 4 else 1)
        s = s + (mask[:, None] if q.dim() == 4 else mask)
    if not causal:
        return s, None
    qpos = q_offset + torch.arange(q.shape[-3], device=q.device)
    kpos = k_offset + torch.arange(k.shape[-3], device=q.device)
    return s, kpos[None, :] <= qpos[:, None]


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool = False,
                              q_offset: int = 0, k_offset: int = 0,
                              return_lse: bool = False,
                              scale: Optional[float] = None,
                              bias: Optional[torch.Tensor] = None,
                              regions: Optional[torch.Tensor] = None):
    """Plain version of K2 and of its biased variant: the whole score
    matrix at once, with the kernel's row semantics — ``out = Σ exp(s −
    m)·v / max(l, 1e-20)`` and ``lse = m + log l``, so a row with no
    visible key gives 0 and −inf where a plain softmax would give NaN."""
    s, visible = _scores(q, k, causal, q_offset, k_offset, scale, bias,
                         regions)
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
                                       q_offset: int = 0, k_offset: int = 0,
                                       scale: Optional[float] = None,
                                       bias: Optional[torch.Tensor] = None,
                                       regions: Optional[torch.Tensor] = None):
    """Plain version of K3 and K4 together (and of their biased variants):
    ``(dq, dk, dv)`` in the inputs' dtypes from the saved ``lse`` and
    ``delta ([B,] H, Tq)``, and with ``bias`` also ``dbias (H, Tq, Tkv)``
    in f32.

    ``p = exp(s − lse)`` with ``_recompute_p``'s semantics — masked pairs
    and rows with ``lse = −inf`` give exactly 0 — then ``g = p·(dO·vᵀ −
    delta)``, ``ds = g·scale`` (``1/sqrt(D)`` by default), ``dq = ds·k``,
    ``dk = dsᵀ·q``, ``dv = pᵀ·dO`` and ``dbias = Σ_b g``, all in f32."""
    s, visible = _scores(q, k, causal, q_offset, k_offset, scale, bias,
                         regions)
    live = torch.isfinite(lse)[..., None]
    if visible is not None:
        live = live & visible
    p = torch.where(live, torch.exp(s - lse[..., None]),
                    torch.zeros_like(s))
    dof = dout.float()
    dp = torch.einsum("...qhd,...khd->...hqk", dof, v.float())
    g = p * (dp - delta[..., None])
    ds = g * _scale(scale, q.shape[-1])
    dq = torch.einsum("...hqk,...khd->...qhd", ds, k.float())
    dk = torch.einsum("...hqk,...qhd->...khd", ds, q.float())
    dv = torch.einsum("...hqk,...qhd->...khd", p, dof)
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    if bias is None:
        return grads
    return grads + (g.sum(0) if q.dim() == 4 else g,)


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


#: K2's tensor-core versions (f16/bf16, head dims up to 256), which
#: ``flash_attention_version`` launches and chip_smoke.py times against
#: each other; ``flash_attention`` launches 1 where blocks of 128 query rows
#: fill every SM twice over, else 2 (f32, and every dtype past 256, have
#: one kernel and no version)
FORWARD_VERSIONS = {1: "two warpgroups a block, 64 keys a stage",
                    2: "one warpgroup a block, 128 keys a stage (64 at a "
                       "head dim past 128)"}


def _kernel_forward(q, k, v, causal, q_offset, k_offset, scale=None):
    """K2: (out, lse) on the current stream (no sync)."""
    return _launch_forward(q, k, v, causal, q_offset, k_offset, 0, scale)


def flash_attention_version(q, k, v, version: int, causal: bool = False,
                            q_offset: int = 0, k_offset: int = 0):
    """K2 in tensor-core version ``version`` (:data:`FORWARD_VERSIONS`;
    CUDA tensors): (out, lse).  The same function as
    :func:`flash_attention`, for timing the versions against each
    other."""
    _check(q, k, v)
    return _launch_forward(q, k, v, causal, q_offset, k_offset, version)


def _launch_forward(q, k, v, causal: bool, q_offset: int, k_offset: int,
                    version: int, scale: Optional[float] = None):
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
                  int(q_offset), int(k_offset), _scale(scale, d),
                  _DTYPES[q.dtype], stream, *([version] if version else []))
    _cuda.check(lib, code, "flash_attention")
    _cuda.launches["flash_attention"] += 1
    return out, lse


#: argument types after the pointers: b, tq, tkv, h, d, the 12 strides,
#: causal, q_offset, k_offset, scale, dtype, stream
_BWD_TAIL = [_I] * 5 + [_LL] * 12 + [_I, _LL, _LL, ctypes.c_float, _I, _P]


def _bwd_launch(which: str, q, k, v, dout, lse, delta, causal, q_offset,
                k_offset, scale=None):
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
                  int(k_offset), _scale(scale, d), _DTYPES[q.dtype],
                  stream)
    _cuda.check(lib, code, f"flash_attention backward ({which})")
    _cuda.launches[f"flash_attention_bwd_{which}"] += 1
    return grads[0] if which == "dq" else grads


def flash_attention_bwd_dq(q, k, v, dout, lse, delta, causal=False,
                           q_offset=0, k_offset=0, scale=None) -> torch.Tensor:
    """K3 alone: dq from the saved ``lse`` and ``delta`` (CUDA tensors)."""
    return _bwd_launch("dq", q, k, v, dout, lse, delta, causal, q_offset,
                       k_offset, scale)


def flash_attention_bwd_dkv(q, k, v, dout, lse, delta, causal=False,
                            q_offset=0, k_offset=0, scale=None):
    """K4 alone: (dk, dv) from the saved ``lse`` and ``delta`` (CUDA
    tensors)."""
    return _bwd_launch("dkv", q, k, v, dout, lse, delta, causal, q_offset,
                       k_offset, scale)


# ---------------------------------------------------------------------------
# the biased kernels (csrc/flash_attention_bias.cu)
# ---------------------------------------------------------------------------

#: argument types after a biased entry point's own pointers: bias,
#: regions, groups, b, tq, tkv, h, d, the 12 strides, scale, dtype, stream
_BIASED_TAIL = [_P, _P, _I] + [_I] * 5 + [_LL] * 12 + [ctypes.c_float, _I,
                                                       _P]


def _check_biased(q, k, bias, regions) -> None:
    """The operands of a biased call: ``bias`` ``(H, Tq, Tkv)``,
    ``regions`` an integer ``(G, T)`` with ``Tq == Tkv == T``, both on
    q's device; and on the card what the kernels take."""
    h, tq, tkv = q.shape[-2], q.shape[-3], k.shape[-3]
    if tuple(bias.shape) != (h, tq, tkv) or bias.device != q.device:
        raise ValueError(f"flash_attention: bias must be ({h}, {tq}, {tkv}) "
                         f"on {q.device}, got {tuple(bias.shape)} on "
                         f"{bias.device}")
    if regions is not None:
        if (regions.dim() != 2 or regions.shape[1] != tq or tq != tkv
                or regions.shape[0] < 1 or regions.device != q.device
                or regions.dtype not in _LABEL_DTYPES):
            raise ValueError(f"flash_attention: regions must be integer (G, "
                             f"{tq}) labels on {q.device} with Tq == Tkv, "
                             f"got {tuple(regions.shape)} {regions.dtype} "
                             f"for Tkv {tkv}")
    if not q.is_cuda:
        return
    if q.dtype not in (torch.float16, torch.bfloat16):
        raise TypeError(f"flash_attention: the biased kernels take float16 "
                        f"and bfloat16, got {q.dtype}")
    if (q.shape[-1] > MAX_BIASED_HEAD_DIM or tq > MAX_BIASED_TOKENS
            or tkv > MAX_BIASED_TOKENS):
        raise ValueError(f"flash_attention: the biased kernels take head "
                         f"dims up to {MAX_BIASED_HEAD_DIM} and up to "
                         f"{MAX_BIASED_TOKENS} queries and keys, got "
                         f"{q.shape[-1]}, {tq} and {tkv}")


def _biased_args(q4, k4, v4, o4, bias, regions, scale, dtype, stream):
    """The tail of a biased entry point's arguments (:data:`_BIASED_TAIL`)
    for the (B, T, H, D) views."""
    b, tq, h, d = q4.shape
    return [bias.data_ptr(), None if regions is None else regions.data_ptr(),
            1 if regions is None else regions.shape[0], b, tq, k4.shape[1],
            h, d, *_strides(q4), *_strides(k4), *_strides(v4),
            *_strides(o4), _scale(scale, d), _DTYPES[dtype], stream]


def _biased_operands(bias, regions):
    """bias as contiguous f32 and regions as contiguous int32, each 16-byte
    aligned (the kernels read them in pairs)."""
    bias = bias.float().contiguous()
    if regions is not None:
        regions = regions.to(torch.int32).contiguous()
    return tuple(None if x is None else x.clone() if x.data_ptr() % 16 else x
                 for x in (bias, regions))


def _launch_biased_forward(q, k, v, bias, regions, scale):
    """The biased K2: (out, lse) on the current stream (no sync)."""
    _require_card("flash_attention", q, k, v)
    bias, regions = _biased_operands(bias, regions)
    q4, k4, v4 = _batched(q), _batched(k), _batched(v)
    b, tq, h, _ = q4.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty(q.shape[:-3] + (h, tq), dtype=torch.float32,
                      device=q.device)
    lib, fn = _fn("flash_attention_bias", "nns_flash_biased_fwd",
                  [_P] * 5 + [_I] + _BIASED_TAIL)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  lse.data_ptr(), windows_per_block(b, tq, h, q.device),
                  *_biased_args(q4, k4, v4, q4, bias, regions, scale,
                                q.dtype, stream))
    _cuda.check(lib, code, "flash_attention (biased)")
    _cuda.launches["flash_attention_bias"] += 1
    _cuda.rows["flash_attention_bias"] += b
    return out, lse


def windows_per_block(b: int, t: int, h: int, device) -> int:
    """Batch rows (windows) a block of a biased kernel takes one after
    another (its rows of the bias read once; K3 sums their part of dbias):
    as many as leave about four blocks an SM for ``t`` rows of ``h``
    heads (fewer groups, fewer reads of the bias and partials to sum)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-t // 64) * h
    groups = min(b, max(1, -(-4 * sms // tiles)))
    return -(-b // groups)


def _launch_biased_backward(q, k, v, dout, lse, delta, bias, regions,
                            scale):
    """The biased K3 (dq and the groups' partials of dbias), the partials'
    sum and K4 on the current stream (no sync): (dq, dk, dv, dbias)."""
    _require_card("flash_attention backward", q, k, v, dout)
    bias, regions = _biased_operands(bias, regions)
    q4, k4, v4, o4 = _batched(q), _batched(k), _batched(v), _batched(dout)
    b, tq, h, _ = q4.shape
    tkv = k4.shape[1]
    lse = lse.float().contiguous()
    delta = delta.float().contiguous()
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    per_block = windows_per_block(b, tq, h, q.device)
    groups = -(-b // per_block)
    partial = torch.empty((groups, h, tq, tkv), dtype=torch.float32,
                          device=q.device)
    dbias = torch.empty((h, tq, tkv), dtype=torch.float32, device=q.device)
    lib, fn_dq = _fn("flash_attention_bias", "nns_flash_biased_bwd_dq",
                     [_P] * 8 + [_I] + _BIASED_TAIL)
    _, fn_dkv = _fn("flash_attention_bias", "nns_flash_biased_bwd_dkv",
                    [_P] * 8 + [_I] + _BIASED_TAIL)
    _, fn_sum = _fn("flash_attention_bias", "nns_flash_biased_dbias_sum",
                    [_P, _P, _I, _LL, _P])
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        tail = _biased_args(q4, k4, v4, o4, bias, regions, scale, q.dtype,
                            stream)
        _cuda.check(lib, fn_dq(*ptrs, dq.data_ptr(), partial.data_ptr(),
                               per_block, *tail),
                    "flash_attention backward (biased dq)")
        _cuda.check(lib, fn_sum(partial.data_ptr(), dbias.data_ptr(), groups,
                                dbias.numel(), stream),
                    "flash_attention backward (dbias sum)")
        _cuda.check(lib, fn_dkv(*ptrs, dk.data_ptr(), dv.data_ptr(),
                                windows_per_block(b, tkv, h, q.device),
                                *tail),
                    "flash_attention backward (biased dkv)")
    for name in ("flash_attention_bias_bwd_dq",
                 "flash_attention_bias_bwd_dkv"):
        _cuda.launches[name] += 1
        _cuda.rows[name] += b
    _cuda.launches["flash_attention_bias_dbias_sum"] += 1
    return dq, dk, dv, dbias


def _forward(q, k, v, causal, q_offset, k_offset, scale=None):
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal, q_offset, k_offset,
                                         return_lse=True, scale=scale)
    return _kernel_forward(q, k, v, causal, q_offset, k_offset, scale)


def _backward(q, k, v, dout, lse, delta, causal, q_offset, k_offset,
              scale=None):
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, dout, lse, delta,
                                                  causal, q_offset, k_offset,
                                                  scale)
    args = (q, k, v, dout, lse, delta, causal, q_offset, k_offset, scale)
    return (flash_attention_bwd_dq(*args), *flash_attention_bwd_dkv(*args))


def _delta(dout, out, dlse):
    """``(dout, delta)``: dO made whole where it is None and contiguous in
    the head dim, and ``delta = rowsum(dO ∘ out)`` in f32 less the lse
    cotangent, ``([B,] H, Tq)``."""
    if dout is None:
        dout = torch.zeros_like(out)
    if dout.stride(-1) != 1:
        dout = dout.contiguous()
    # D_i = dO_i · O_i from the returned (rounded) out, in f32
    delta = (dout.float() * out.float()).sum(-1).transpose(-1, -2)
    if dlse is not None:
        delta = delta - dlse.float()
    return dout, delta


class _FlashFn(torch.autograd.Function):
    """The JAX package's ``_flash``/``_flash_lse`` custom VJP in one:
    ``(out, lse)`` forward; the backward folds the lse cotangent (zero
    when ``lse`` went unused) into ``delta``, as ``_flash_lse_bwd`` does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, k_offset, scale):
        out, lse = _forward(q, k, v, causal, q_offset, k_offset, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, q_offset, k_offset, scale)
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dout, delta = _delta(dout, out, dlse)
        dq, dk, dv = _backward(q, k, v, dout, lse, delta, *ctx.args)
        return dq, dk, dv, None, None, None, None


class _FlashBiasFn(torch.autograd.Function):
    """:class:`_FlashFn` with a bias and region labels: the backward also
    returns the bias's gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, regions, scale):
        if q.device.type == "cpu":
            out, lse = flash_attention_reference(
                q, k, v, return_lse=True, scale=scale, bias=bias,
                regions=regions)
        else:
            out, lse = _launch_biased_forward(q, k, v, bias, regions, scale)
        ctx.save_for_backward(q, k, v, out, lse, bias, regions)
        ctx.scale = scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse, bias, regions = ctx.saved_tensors
        dout, delta = _delta(dout, out, dlse)
        if q.device.type == "cpu":
            grads = flash_attention_backward_reference(
                q, k, v, dout, lse, delta, scale=ctx.scale, bias=bias,
                regions=regions)
        else:
            grads = _launch_biased_backward(q, k, v, dout, lse, delta, bias,
                                            regions, ctx.scale)
        return (*grads, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, block_q: Optional[int] = None,
                    block_k: Optional[int] = None, q_offset: int = 0,
                    k_offset: int = 0, return_lse: bool = False,
                    scale: Optional[float] = None,
                    bias: Optional[torch.Tensor] = None,
                    regions: Optional[torch.Tensor] = None):
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
    differentiable.  Float32, float16 and bfloat16, at any head dim.
    ``scale`` multiplies the scores (default ``1 / sqrt(D)``).

    ``bias`` (``(H, Tq, Tkv)``, added to every batch row's scores in f32;
    differentiable) and ``regions`` (integer ``(G, T)`` labels, the mask
    :func:`region_mask` makes of them) take the biased kernels (module
    doc); they do not combine with ``causal`` or offsets."""
    del block_q, block_k
    _check(q, k, v)
    if bias is not None:
        if causal or q_offset or k_offset:
            raise ValueError("flash_attention: a bias takes no causal mask "
                             "or offsets")
        _check_biased(q, k, bias, regions)
        out, lse = _FlashBiasFn.apply(q, k, v, bias, regions, scale)
    elif regions is not None:
        raise ValueError("flash_attention: regions need a bias")
    elif torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                      or v.requires_grad):
        out, lse = _FlashFn.apply(q, k, v, bool(causal), int(q_offset),
                                  int(k_offset), scale)
    else:
        out, lse = _forward(q, k, v, causal, q_offset, k_offset, scale)
    return (out, lse) if return_lse else out
