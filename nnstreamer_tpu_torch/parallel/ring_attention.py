"""Ring attention over a sequence axis, and single-device attention.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/ring_attention.py``.
Each member of the mesh's ``sp`` axis holds a sequence block; K/V blocks
rotate around the ring (:func:`~.collectives.ppermute`) while a streaming
softmax accumulates exact attention over global positions —

- the plain route (``flash=False``): the streaming-softmax scan in f32,
  one (T_local, T_local) score block at a time, with the JAX package's
  guards for fully-masked rows;
- the flash route (``flash=True``): each step one call of
  :func:`~..ops.flash_attention.flash_attention` (K2 on the card) with
  ``q_offset``/``k_offset`` at the two blocks' global positions, whose
  causal mask gives a past block every key, the diagonal block the causal
  triangle and a future block none (``out`` 0, ``lse`` −inf); blocks
  merge through their lse, whose cotangent reaches the backward kernels
  (K3/K4) as in the JAX package.

The backward is autograd's: dK/dV rotate back around the ring through
``ppermute``'s inverse.  Every member runs every step, a future block too,
so the ring's collectives pair up across members forward and backward.
With no mesh (or an ``sp`` axis of 1) the ring has one member and the
loop runs once, over the diagonal block.  Inputs take an optional leading
batch axis, ``(B, T, H, D)``, which the kernels run as a grid axis (the
JAX package vmaps the call).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .collectives import ppermute
from .mesh import Mesh


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "sp", causal: bool = False,
                   flash: Optional[bool] = None,
                   mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Exact multi-head attention over a ring of sequence shards.

    Args:
      q, k, v: ``([B,] T_local, n_heads, head_dim)`` — this member's block
      axis_name: the mesh axis carrying the sequence shards
      causal: apply causal masking using global positions
      flash: run each ring step's block through the flash kernels and
        combine blocks via their logsumexp.  ``None``: the kernels for
        tensors on the card, the plain scan off it.
      mesh: the mesh whose ``axis_name`` members form the ring (the
        ``shard_map`` context of the JAX package); ``None``: a ring of
        one.

    Returns: ``([B,] T_local, n_heads, head_dim)`` in q's dtype.
    """
    n = 1 if mesh is None else mesh.axis_size(axis_name)
    my_idx = 0 if mesh is None else mesh.axis_index(axis_name)
    if flash is None:
        from ..ops.flash_attention import flash_is_default

        flash = flash_is_default(q)
    if flash:
        return _ring_flash(q, k, v, causal, n, my_idx, mesh, axis_name)
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
        if step < n - 1:
            k_blk, v_blk = _rotate(k_blk, v_blk, n, mesh, axis_name)
    out = acc / row_sum[..., None].clamp_min(1e-20)
    return out.transpose(-3, -2).to(q.dtype)          # ([B,] Tq, h, d)


def _rotate(k_blk, v_blk, n: int, mesh, axis_name: str):
    """K/V to the next member of the ring (the JAX package's ``ppermute``
    over ``(i, i + 1 mod n)``); the blocks' sequence axis leads after the
    batch, so a batched block moves as one tensor."""
    perm = [(i, (i + 1) % n) for i in range(n)]
    return (ppermute(k_blk, mesh, axis_name, perm),
            ppermute(v_blk, mesh, axis_name, perm))


def _ring_flash(q, k, v, causal: bool, n: int, my_idx: int, mesh,
                axis_name: str):
    """Ring steps through the flash kernels: each K/V block is one K2
    launch at the blocks' global offsets, with its logsumexp, and blocks
    combine through the lse merge — no (T_local, T_local) score matrix
    is ever kept.  A future block's rows see no key: K2 gives them
    ``out`` 0 and ``lse`` −inf, which the merge's guards weigh 0 (and
    whose backward gives 0)."""
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
        o_blk, lse = flash_attention(q, k_blk, v_blk, causal=causal,
                                     q_offset=my_idx * t_local,
                                     k_offset=src * t_local,
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
        if step < n - 1:
            k_blk, v_blk = _rotate(k_blk, v_blk, n, mesh, axis_name)
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
