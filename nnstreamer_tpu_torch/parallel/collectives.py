"""Collectives over a mesh's axes, with the JAX package's gradients.

The JAX package writes its sharded steps inside ``shard_map(...,
check_vma=False)`` (``parallel/train_step.py``) with ``jax.lax.psum``,
``all_to_all`` and ``ppermute`` over named axes.  Each is here a
``torch.autograd.Function`` over a :class:`~.mesh.Mesh`'s subgroup whose
backward is the transpose JAX uses there:

- :func:`psum` — all-reduce (sum); its transpose is again a psum of the
  cotangent (without the replication check JAX cannot know a cotangent
  is the same on every member, so a loss ``psum``'d over ``n`` members
  gets ``n`` times its one-member gradient: the port follows);
- :func:`all_to_all` — ``tiled=True``: ``split_axis`` cut into one block
  a member, the blocks received concatenated along ``concat_axis`` in
  member order; its transpose swaps the two axes;
- :func:`ppermute` — ``perm`` of ``(source, destination)`` members, zeros
  where no one sends; its transpose is the inverse permutation.

Over axes of size 1 each is the identity (no autograd node), so a
one-device step computes exactly what it did without them.  Every rank
must call the same collectives in the same order, forward and backward:
a collective's output that one rank leaves out of its loss would leave
the others waiting in the backward, so callers mask with ``where`` (as
the JAX code does) instead of branching per rank.

Transport: ``all_reduce`` and ``all_to_all_single`` on the subgroup.
Over ``gloo`` a CUDA tensor is staged through host memory (gloo refuses
some collectives on CUDA tensors, and stages the others itself): only
the exchange leaves the card, never the step's compute.  ``nccl`` takes
the card's tensors as they are.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from .mesh import Axes, Mesh


def _staged(x: torch.Tensor, group) -> bool:
    import torch.distributed as dist

    return x.is_cuda and dist.get_backend(group) == "gloo"


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``, a new tensor on ``x``'s device."""
    import torch.distributed as dist

    if _staged(x, group):
        host = x.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    out = x.detach().contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _exchange(x: torch.Tensor, group, out_splits: Optional[List[int]] = None,
              in_splits: Optional[List[int]] = None,
              out_rows: Optional[int] = None) -> torch.Tensor:
    """``all_to_all_single`` of ``x`` along dim 0 (equal blocks, or the
    given splits), staged through host memory over gloo."""
    import torch.distributed as dist

    src = x.detach().contiguous()
    dev = src.device
    if _staged(src, group):
        src = src.to("cpu")
    rows = src.shape[0] if out_rows is None else out_rows
    out = torch.empty((rows,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_to_all_single(out, src, output_split_sizes=out_splits,
                           input_split_sizes=in_splits, group=group)
    return out.to(dev)


def unshard(x: torch.Tensor, mesh: Mesh,
            spec: Sequence[Optional[Axes]]) -> torch.Tensor:
    """The global tensor of which ``x`` is this member's block under
    ``spec`` (the inverse of :func:`~.mesh.shard`; no autograd): each
    sharded dimension is gathered from the members along its axis, in
    member order.  Every member along those axes must call it."""
    import torch.distributed as dist

    for dim, part in enumerate(spec):
        group = mesh.group(part) if part else None
        if group is None:
            continue
        n = mesh.axis_size(part)
        src = x.detach().contiguous()
        dev = src.device
        if _staged(src, group):
            src = src.to("cpu")
        parts = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(parts, src, group=group)
        x = torch.cat(parts, dim=dim).to(dev)
    return x


def psum_(tensors: Sequence[torch.Tensor], mesh: Mesh, axes: Axes) -> None:
    """Sum each of ``tensors`` over ``axes`` in place, in one exchange
    (no autograd: a gradient sync).  Each must be contiguous."""
    group = mesh.group(axes)
    if group is None:
        return
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    flat = _all_reduce(flat, group)
    with torch.no_grad():
        offset = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[offset:offset + n].view_as(t))
            offset += n


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def psum(x: torch.Tensor, mesh: Optional[Mesh], axes: Axes) -> torch.Tensor:
    """``jax.lax.psum(x, axes)``: the sum over the members along
    ``axes``; its gradient is the psum of the cotangent."""
    group = None if mesh is None else mesh.group(axes)
    if group is None:
        return x
    return _PSum.apply(x, group)


def _a2a(x: torch.Tensor, group, n: int, split_axis: int,
         concat_axis: int) -> torch.Tensor:
    blocks = torch.stack(x.chunk(n, dim=split_axis))
    got = _exchange(blocks, group)
    return torch.cat(got.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, split_axis, concat_axis):
        ctx.args = (group, n, split_axis, concat_axis)
        return _a2a(x, group, n, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, n, split_axis, concat_axis = ctx.args
        return _a2a(g, group, n, concat_axis, split_axis), None, None, \
            None, None


def all_to_all(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
               split_axis: int, concat_axis: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis, concat_axis,
    tiled=True)``: ``split_axis`` is cut into one block a member (it must
    divide), member ``i`` gets block ``i``, and each member concatenates
    what it got along ``concat_axis`` in member order."""
    group = None if mesh is None else mesh.group(axis)
    if group is None:
        return x
    n = mesh.axis_size(axis)
    split_axis %= x.dim()
    concat_axis %= x.dim()
    if x.shape[split_axis] % n:
        raise ValueError(f"all_to_all: dimension {split_axis} of "
                         f"{tuple(x.shape)} does not split over {n}")
    return _AllToAll.apply(x, group, n, split_axis, concat_axis)


def _permute(x: torch.Tensor, group, n: int, me: int,
             perm: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    """One ``all_to_all_single`` with at most one non-empty block each
    way: this member's tensor to its destination, its source's back."""
    to = next((d for s, d in perm if s == me), None)
    frm = next((s for s, d in perm if d == me), None)
    rows = x.shape[0]
    flat = x.reshape(rows, -1)
    in_splits = [rows if j == to else 0 for j in range(n)]
    out_splits = [rows if j == frm else 0 for j in range(n)]
    got = _exchange(flat[:sum(in_splits)], group, out_splits, in_splits,
                    out_rows=sum(out_splits))
    if frm is None:
        return torch.zeros_like(x)
    return got.reshape(x.shape)


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, me, perm):
        ctx.args = (group, n, me, perm)
        return _permute(x, group, n, me, perm)

    @staticmethod
    def backward(ctx, g):
        group, n, me, perm = ctx.args
        inverse = tuple((d, s) for s, d in perm)
        return _permute(g, group, n, me, inverse), None, None, None, None


def ppermute(x: torch.Tensor, mesh: Optional[Mesh], axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute(x, axis, perm)``: member ``d`` gets member
    ``s``'s ``x`` for each ``(s, d)`` of ``perm``; a member no one sends
    to gets zeros."""
    group = None if mesh is None else mesh.group(axis)
    perm = tuple((int(s), int(d)) for s, d in perm)
    if group is None:
        # one member: it keeps its own tensor where it sends to itself
        return x if (0, 0) in perm else torch.zeros_like(x)
    for s, d in perm:
        if len([1 for s2, _ in perm if s2 == s]) > 1 or \
                len([1 for _, d2 in perm if d2 == d]) > 1:
            raise ValueError(f"ppermute: {perm} is not a permutation")
    return _PPermute.apply(x, group, mesh.axis_size(axis),
                           mesh.axis_index(axis), perm)
