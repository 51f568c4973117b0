"""Ulysses-style all-to-all sequence parallelism, the second long-context
strategy next to :mod:`.ring_attention`.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/ulysses.py``:

1. an all-to-all scatters the HEAD dimension and gathers the SEQUENCE
   dimension — each member then holds the whole sequence for heads/n
   heads;
2. exact attention runs locally: the flash kernels (K2 forward, K3/K4
   backward) on the card, plain attention off it;
3. the inverse all-to-all restores sequence shards x all heads.

It needs ``heads % n == 0`` and raises as the JAX package does otherwise;
ring attention takes any head count.
"""

from __future__ import annotations

from typing import Optional

import torch

from .collectives import all_to_all
from .mesh import Mesh
from .ring_attention import local_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str = "sp", causal: bool = False,
                      flash: Optional[bool] = None,
                      mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Exact attention over sequence shards via head↔sequence all-to-all.

    Args:
      q, k, v: ``([B,] T_local, n_heads, head_dim)``; n_heads must divide
        by the axis size.
      flash: the local core through the flash kernels — default: for
        tensors on the card (the JAX package's default on TPU: this is
        the sequence-parallel training path, so no length gate applies).
      mesh: the mesh whose ``axis_name`` members hold the shards
        (``None``: one member).

    Returns: ``([B,] T_local, n_heads, head_dim)``.
    """
    n = 1 if mesh is None else mesh.axis_size(axis_name)
    n_heads = q.shape[-2]
    if n_heads % n:
        raise ValueError(
            f"ulysses: heads {n_heads} not divisible by |{axis_name}|={n}"
            " (use ring_attention for uneven head counts)")

    def a2a(x, split_axis, concat_axis):
        return all_to_all(x, mesh, axis_name, split_axis, concat_axis)

    # scatter heads, gather sequence: (T_local, H, D) -> (T_global, H/n, D)
    qg, kg, vg = (a2a(x, -2, -3) for x in (q, k, v))
    if flash is None:
        from ..ops.flash_attention import flash_is_default

        flash = flash_is_default(q)
    if flash:
        from ..ops.flash_attention import flash_attention

        out = flash_attention(qg, kg, vg, causal=causal)
    else:
        out = local_attention(qg, kg, vg, causal=causal)
    # inverse: scatter sequence, gather heads
    return a2a(out, -3, -2)
