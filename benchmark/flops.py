"""Model FLOPs counted by ``torch.utils.flop_counter`` over the
benchmark's own reference model, on meta tensors at the cell's shapes:
the products of convolutions, dense layers and attention (what a model's
FLOP count conventionally holds; normalisation and activations are not
counted)."""

from __future__ import annotations

import torch

from . import spec as bench_spec


def _meta_weights(ref, cfg: dict, grad: bool) -> dict:
    w = {}
    for name, shape, draw in ref.spec(cfg):
        if draw[0] == "zeros":
            w[name] = torch.zeros(shape, dtype=torch.int64, device="meta")
            continue
        t = torch.empty(shape, dtype=torch.float32, device="meta")
        w[name] = t.requires_grad_(grad and bench_spec.trainable(name))
    return w


def count(cfg: dict, batch: int, train: bool) -> float:
    """FLOPs of one forward (``train``: forward and backward, with the
    mean NLL loss) of ``batch`` frames, per frame."""
    from torch.utils.flop_counter import FlopCounterMode

    ref = bench_spec.reference(cfg)
    size = int(cfg["image_size"])
    frames = torch.empty((batch, size, size, 3), dtype=torch.uint8,
                         device="meta")
    w = _meta_weights(ref, cfg, train)
    counter = FlopCounterMode(display=False)
    with counter:
        logits = ref.forward(w, frames, cfg)
        if train:
            labels = torch.zeros((batch,), dtype=torch.int64, device="meta")
            torch.nn.functional.cross_entropy(logits, labels).backward()
    return counter.get_total_flops() / batch
