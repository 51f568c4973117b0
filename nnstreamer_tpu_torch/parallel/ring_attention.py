"""Ring attention over a sequence axis, and single-device attention.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/ring_attention.py``.
The JAX package runs it inside ``shard_map``: each device holds a sequence
block and K/V blocks rotate around the ``sp`` ring while a streaming
softmax accumulates exact attention.  The port trains on one card, so the
ring has one member (``axis_size=1``): the block loop runs once, over the
diagonal block, through the same code as the JAX package's —

- the plain route (``flash=False``): the streaming-softmax scan in f32,
  one (T, T) score block at a time;
- the flash route (``flash=True``): each block through
  :func:`~..ops.flash_attention.flash_attention` with its logsumexp, the
  diagonal/past/future relation deciding the block's mask, and blocks
  merged through their lse — whose cotangent reaches the backward kernels,
  as in the JAX package.

Inputs take an optional leading batch axis, ``(B, T, H, D)``, which the
kernels run as a grid axis (the JAX package vmaps the call).  A ring of
more than one member (multi-card sequence parallelism over
``torch.distributed``) is not yet ported and raises.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _ring_size(axis_size: int) -> int:
    if axis_size != 1:
        raise NotImplementedError(
            f"ring_attention over {axis_size} sequence shards: multi-card "
            "training is not yet ported (the sp axis must have size 1)")
    return 1


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = False,
                   flash: Optional[bool] = None,
                   axis_size: int = 1) -> torch.Tensor:
    """Exact multi-head attention over a ring of sequence shards.

    Args:
      q, k, v: ``([B,] T_local, n_heads, head_dim)`` — this member's block
      axis_name: the mesh axis carrying the sequence shards (kept for
        signature parity; the ring has ``axis_size`` members)
      causal: apply causal masking using global positions
      flash: run each ring step's block through the flash kernels and
        combine blocks via their logsumexp.  ``None``: the kernels for
        tensors on the card, the plain scan off it.
      axis_size: the ring's size (the ``shard_map`` context of the JAX
        package); only a ring of one is ported, so this member is member
        0 of it.

    Returns: ``([B,] T_local, n_heads, head_dim)`` in q's dtype.
    """
    del axis_name
    n = _ring_size(axis_size)
    my_idx = 0
    if flash is None:
        from ..ops.flash_attention import flash_is_default

        flash = flash_is_default(q)
    if flash:
        return _ring_flash(q, k, v, causal, n, my_idx)
    t_local, n_heads, head_dim = q.shape[-3:]
    scale = 1.0 / math.sqrt(head_dim)
    dev = q.device
    q_pos = my_idx * t_local + torch.arange(t_local, device=dev)
    batch = q.shape[:-3]
    acc = torch.zeros(batch + (n_heads, t_local, head_dim), device=dev)
    row_max = torch.full(batch + (n_heads, t_local), float("-inf"),
                         device=dev)
    row_sum = torch.zeros(batch + (n_heads, t_local), device=dev)
    k_blk, v_blk = k, v
    for step in range(n):
        # the block held at `step` originated at member (my_idx - step) % n
        src = (my_idx - step) % n
        k_pos = src * t_local + torch.arange(t_local, device=dev)
        s = torch.einsum("...qhd,...khd->...hqk", q.float(),
                         k_blk.float()) * scale
        if causal:
            s = s.masked_fill(k_pos[None, :] > q_pos[:, None],
                              float("-inf"))
        new_max = torch.maximum(row_max, s.amax(dim=-1))
        # guard fully-masked rows (all -inf)
        safe_max = torch.where(torch.isfinite(new_max), new_max,
                               torch.zeros_like(new_max))
        p = torch.exp(s - safe_max[..., None])
        p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
        corr = torch.exp(torch.where(torch.isfinite(row_max),
                                     row_max - safe_max,
                                     torch.full_like(row_max,
                                                     float("-inf"))))
        corr = torch.where(torch.isfinite(corr), corr,
                           torch.zeros_like(corr))
        acc = acc * corr[..., None] + torch.einsum(
            "...hqk,...khd->...hqd", p, v_blk.float())
        row_sum = row_sum * corr + p.sum(dim=-1)
        row_max = new_max
    out = acc / row_sum[..., None].clamp_min(1e-20)
    return out.transpose(-3, -2).to(q.dtype)          # ([B,] Tq, h, d)


def _ring_flash(q, k, v, causal: bool, n: int, my_idx: int):
    """Ring steps through the flash kernels: each K/V block runs the
    streaming-softmax forward with its logsumexp, and blocks combine
    through the lse merge — no (T_local, T_local) score matrix is ever
    kept.  Causality decomposes per block relation: a block from the
    ring's past is fully visible, the diagonal block is causal at equal
    offsets, a future block contributes nothing."""
    from ..ops.flash_attention import flash_attention

    t_local, n_heads, head_dim = q.shape[-3:]
    batch = q.shape[:-3]
    dev = q.device
    acc = torch.zeros(q.shape, device=dev)
    m = torch.full(batch + (n_heads, t_local), float("-inf"), device=dev)
    den = torch.zeros(batch + (n_heads, t_local), device=dev)
    k_blk, v_blk = k, v
    for step in range(n):
        src = (my_idx - step) % n
        if causal and src > my_idx:           # a future block: skip
            o_blk = torch.zeros_like(q)
            lse = torch.full_like(m, float("-inf"))
        else:
            o_blk, lse = flash_attention(q, k_blk, v_blk,
                                         causal=causal and src == my_idx,
                                         return_lse=True)
        new_m = torch.maximum(m, lse)
        safe = torch.where(torch.isfinite(new_m), new_m,
                           torch.zeros_like(new_m))
        w = torch.where(torch.isfinite(lse), torch.exp(lse - safe),
                        torch.zeros_like(lse))
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe),
                           torch.zeros_like(m))
        acc = (acc * corr.transpose(-1, -2)[..., None]
               + o_blk.float() * w.transpose(-1, -2)[..., None])
        den = den * corr + w
        m = new_m
    denq = den.transpose(-1, -2)[..., None].clamp_min(1e-20)
    return (acc / denq).to(q.dtype)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Softmax attention over ``q, k, v ([B,] T, H, D)`` in f32, cast back
    to q's dtype; ``causal`` masks keys after the query (same
    positions)."""
    t = q.shape[-3]
    s = torch.einsum("...qhd,...khd->...hqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[-1]))
    if causal:
        pos = torch.arange(t, device=q.device)
        s = s.masked_fill(pos[None, :] > pos[:, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("...hqk,...khd->...qhd", p, v.float())
    return out.to(q.dtype)
