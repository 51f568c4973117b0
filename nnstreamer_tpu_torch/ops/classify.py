"""Classifier post-processing reductions as torch ops.

The counterpart of ``nnstreamer_tpu/ops/classify.py``: the argmax-style
decoders reduce a score vector to one index on the device, so only a
``(1,)`` int32 crosses to the host instead of the whole score vector
(1001 floats for MobileNet).  ``ImageLabelDecoder.device_reduce_spec``
pushes it into the upstream filter's forward.
"""

from __future__ import annotations

import torch


def top1(scores: torch.Tensor) -> torch.Tensor:
    """Flattened argmax as a ``(1,)`` int32 tensor — the image_labeling
    reduction.  Ties go to the first maximal index, as ``jnp.argmax``."""
    return torch.argmax(scores.reshape(-1)).to(torch.int32).reshape(1)


def topk_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Top-k flattened indices, descending, as ``(k,)`` int32 — the
    multi-label generalization.  Equal scores keep the lower index first,
    as ``lax.top_k`` does (a stable sort: ``torch.topk`` on CUDA promises
    no order among ties)."""
    _, idx = torch.sort(scores.reshape(-1), descending=True, stable=True)
    return idx[:k].to(torch.int32)
