"""Training steps of a reference model in plain PyTorch: the mean
negative log-likelihood of the float32 logits at one label a frame, and
Adam (Kingma and Ba 2014) with the bias corrections applied before
``eps`` is added, as ``torch.optim.Adam`` and ``optax.adam`` compute it.
State that no optimizer trains (BatchNorm's statistics) stays fixed."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F


def train(forward: Callable, w0: Dict[str, torch.Tensor], cfg: dict,
          batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
          trainable: Callable[[str], bool], lr: float,
          betas: Tuple[float, float], eps: float,
          cast: Callable[[torch.Tensor], torch.Tensor] = lambda t: t
          ) -> Tuple[List[float], Dict[str, torch.Tensor],
                     Dict[str, torch.Tensor]]:
    """One Adam step a batch from ``w0``.  Returns the losses, the first
    step's gradient and the trained tensors after the last step."""
    b1, b2 = betas
    params = {n: t.detach().float().clone().requires_grad_(True)
              for n, t in w0.items() if trainable(n)}
    fixed = {n: t for n, t in w0.items() if not trainable(n)}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, first = [], None
    for t, (frames, labels) in enumerate(batches, start=1):
        logits = forward({**fixed, **params}, frames, cfg, cast)
        loss = F.cross_entropy(logits.float(), labels.long())
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first is None:
            first = {n: g.detach().clone() for n, g in zip(params, grads)}
        with torch.no_grad():
            for (n, p), g in zip(params.items(), grads):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = (v[n] / (1 - b2 ** t)).sqrt_().add_(eps)
                p.sub_(lr / (1 - b1 ** t) * m[n] / denom)
    return losses, first, {n: p.detach() for n, p in params.items()}
