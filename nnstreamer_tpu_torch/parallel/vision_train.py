"""Training step for registry vision models, data parallel over ``dp``.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/vision_train.py``.
The JAX package replicates the parameters over a ``dp`` mesh, shards the
batch, vmaps the model's per-frame forward and lets XLA insert the
gradient reduction.  The port runs the model's batched forward on this
process's device: on a process mesh (:mod:`.multihost`) each member takes
its dp block of the global batch, and the gradients and the loss are
averaged over dp before the update, so the step equals the one-member
step on the global batch; parameters and Adam state stay replicated.
For ViT every attention layer is one launch of the flash kernels with
the batch in their grid, forward and backward; for MobileNetV2 the frame
normalization is K1 (``use_pallas:1``).  On one card the whole step —
forward, backward and the Adam update — is one CUDA graph per batch
signature (:class:`~.._cuda.GraphedStep`); a multi-rank step runs
eagerly.

Kept from the JAX package:

- Adam with ``optax.adam``'s formula (``eps`` after bias correction), which
  ``torch.optim.Adam`` computes; on the card with ``capturable=True`` in
  graph and eager runs alike (its step count and bias correction live on
  the device), so both run the same optimizer arithmetic;
- the loss, the mean NLL of the f32 logits;
- frozen ``batch_stats``: BatchNorm statistics are buffers here, never
  optimized, and the module stays in eval mode so they are only read;
- f32 parameters: the model must be built in its training form
  (``get_model(..., trainable=True)``), whose products cast them to the
  compute dtype per call.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple

import numpy as np
import torch

from .collectives import psum_
from .mesh import Mesh, local_device, shard


def _param_labels(variables) -> Any:
    """'adam' for trainable collections, 'freeze' for batch_stats —
    running BN statistics are not gradient-trained (flax convention).
    Over a nested dict (or list) of leaves, as the JAX package labels a
    flax variable tree."""
    def label(tree, name):
        if isinstance(tree, dict):
            return {k: label(v, name) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(label(v, name) for v in tree)
        return name

    if isinstance(variables, dict):
        return {k: label(v, "freeze" if k == "batch_stats" else "adam")
                for k, v in variables.items()}
    return label(variables, "adam")


def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, 1, labels.long()[:, None]).mean()


def make_vision_train_step(mesh: Mesh, model, lr: float = 1e-3
                           ) -> Tuple[Callable, Any, Any, torch.device]:
    """Returns ``(step, module, opt, device)``.

    ``step(module, opt, frames, labels) -> (module, opt, loss)`` where
    ``frames`` is a uint8 ``(B, H, W, 3)`` batch and ``labels`` int
    ``(B,)`` class ids (host or device; B divides by the dp size, and each
    member takes its block); the module's parameters and the optimizer
    state update in place (the JAX package donates them), and the step is
    bound to the module and optimizer it returns.  ``loss`` is the global
    batch's, a 0-d f32 tensor on the device, on the card the graph's
    static output: read it before the next step.  ``model``: a registry
    model in its training form, on this process's device."""
    from .._cuda import GraphedStep

    device = local_device(mesh)
    ranks = mesh if mesh.procs is not None else None
    dp = mesh.axis_size("dp")
    module = model.module
    params = list(module.parameters())
    if any(p.dtype != torch.float32 for p in params):
        raise ValueError(f"{model.name}: training needs f32 parameters — "
                         "build the model with get_model(..., "
                         "trainable=True)")
    if any(p.device != device for p in params):
        raise ValueError(f"{model.name}: parameters are not on {device}")
    module.eval()                   # BatchNorm statistics stay frozen
    opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                           capturable=device.type == "cuda")

    def body(frames, labels):
        # before the backward: it then stores each gradient anew (in the
        # graph's memory pool under capture) instead of adding to one
        opt.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = _nll(module(frames)[0], labels)
            loss.backward()
        loss = loss.detach()
        if ranks is not None:
            # the global batch's mean: the members' means averaged
            grads = [p.grad for p in params] + [loss]
            psum_(grads, mesh, "dp")
            for g in grads:
                g.div_(dp)
        opt.step()
        return loss

    graphed = GraphedStep(body, device, eager=ranks is not None,
                          shard=None if ranks is None else
                          lambda batch: [shard(x, mesh, ("dp",))
                                         for x in batch])

    def step(module_, opt_, frames, labels):
        if module_ is not module or opt_ is not opt:
            raise ValueError("this step updates the module and optimizer "
                             "make_vision_train_step returned, in place; "
                             "it takes no others")
        return module, opt, graphed(frames, labels)

    step.graphed = graphed
    return step, module, opt, device


def pad_to_multiple(batch: np.ndarray, m: int) -> np.ndarray:
    """Repeat-pad axis 0 up to a multiple of ``m`` (dp size) so a
    stream tail still shards evenly; loss over repeated samples is a
    reweighting, not a correctness issue, for the trailing batch.
    Cycles the batch as many times as needed — a 3-frame tail on a
    dp=8 mesh pads to 8, not 6."""
    b = batch.shape[0]
    pad = (-b) % m
    if not pad:
        return batch
    filler = np.concatenate([batch] * -(-pad // b), axis=0)[:pad]
    return np.concatenate([batch, filler], axis=0)
