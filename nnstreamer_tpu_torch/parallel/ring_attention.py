"""Single-device attention, the plain path beside the flash kernel.

The PyTorch counterpart of ``local_attention`` in
``nnstreamer_tpu/parallel/ring_attention.py``: the ``flash=False`` /
``attn:naive`` path of ViT and the StreamFormer LM.  ``ring_attention``
itself waits for the training slice (ROADMAP A12).
"""

from __future__ import annotations

import math

import torch


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Softmax attention over ``q, k, v (T, H, D)`` in f32, cast back to
    q's dtype; ``causal`` masks keys after the query (same positions)."""
    t = q.shape[0]
    s = torch.einsum("qhd,khd->hqk", q.float(), k.float()) \
        * (1.0 / math.sqrt(q.shape[2]))
    if causal:
        pos = torch.arange(t, device=q.device)
        s = s.masked_fill(pos[None, None, :] > pos[None, :, None],
                          float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("hqk,khd->qhd", p, v.float())
    return out.to(q.dtype)
