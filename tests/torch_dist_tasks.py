"""Work run on every rank of a ``LocalWorld`` by
``tests/test_torch_distributed.py``: torch and the port only (the ranks
never import JAX).  Each function takes the GLOBAL inputs (numpy), runs
this rank's share through the port over the process group, and returns
numpy results the test holds to the JAX package's."""

import numpy as np
import torch
import torch.distributed as dist

from nnstreamer_tpu_torch.parallel import make_mesh, multihost
from nnstreamer_tpu_torch.parallel.collectives import (all_to_all, ppermute,
                                                       psum, unshard)

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def collectives(xs, gs):
    """Each collective over a one-axis mesh of the world: ``xs``/``gs``
    (n, ...) are every member's input and cotangent; returns this
    member's outputs and input gradients."""
    n = dist.get_world_size()
    mesh = make_mesh(axis_sizes={"dp": n}, devices=[CPU])
    r = mesh.axis_index("dp")
    out = {}
    cases = {
        "psum": lambda x: psum(x, mesh, "dp"),
        "psum_sq": lambda x: psum(x * x, mesh, "dp"),
        "a2a": lambda x: all_to_all(x, mesh, "dp", 0, 1),
        "a2a_swap": lambda x: all_to_all(x, mesh, "dp", 1, 0),
        "ring": lambda x: ppermute(x, mesh, "dp",
                                   [(i, (i + 1) % n) for i in range(n)]),
        "one": lambda x: ppermute(x, mesh, "dp", [(0, n - 1)]),
    }
    for name, fn in cases.items():
        x = _t(xs[r]).requires_grad_()
        y = fn(x)
        g = _t(gs[name][r])
        (dx,) = torch.autograd.grad(y, x, g)
        out[name] = (y.detach().numpy(), dx.numpy())
    return out


def attention(kind, q, k, v, g, causal, flash):
    """Ring or Ulysses attention over an ``sp`` mesh of the world on
    batched (B, T, H, D) inputs; returns this member's sequence block of
    the output and of each input gradient."""
    from nnstreamer_tpu_torch.parallel import (ring_attention,
                                               ulysses_attention)

    n = dist.get_world_size()
    mesh = make_mesh(axis_sizes={"sp": n}, devices=[CPU])
    r = mesh.axis_index("sp")
    t = q.shape[1] // n
    blk = [_t(x[:, r * t:(r + 1) * t]).requires_grad_() for x in (q, k, v)]
    fn = ring_attention if kind == "ring" else ulysses_attention
    out = fn(*blk, "sp", causal=causal, flash=flash, mesh=mesh)
    grads = torch.autograd.grad(out, blk, _t(g[:, r * t:(r + 1) * t]))
    return [out.detach().numpy()] + [x.numpy() for x in grads]


def lm_steps(sizes, cfg_kw, params, batches, pipeline=False,
             microbatches=None):
    """Adam steps of the StreamFormer (or its pp form) on a process mesh
    of ``sizes``, from the JAX package's global ``params``; returns the
    losses and, gathered, the global parameters after the last step."""
    from nnstreamer_tpu_torch.parallel import pipeline_parallel as pp
    from nnstreamer_tpu_torch.parallel import train_step as ts

    cfg = ts.StreamFormerConfig(dtype=torch.float32, **cfg_kw)
    if pipeline:
        mesh = make_mesh(axis_sizes=sizes, axes=pp.PP_AXES, devices=[CPU])
        step, p, opt, specs = pp.make_pp_train_step(
            mesh, cfg, microbatches=microbatches, params=params)
        named = [(n, p[n], specs[n]) for n in pp._LEAVES]
    else:
        mesh = make_mesh(axis_sizes=sizes, devices=[CPU])
        step, p, opt, specs = ts.make_train_step(mesh, cfg, params=params)
        spec_of = dict(ts.leaves(specs))
        named = [(n, x, spec_of[n]) for n, x in ts.leaves(p)]
    losses = []
    for toks, labs in batches:
        _, _, loss = step(p, opt, toks, labs)
        losses.append(float(loss))
    return losses, {n: unshard(x, mesh, spec).numpy()
                    for n, x, spec in named}, mesh.shape


def lm_grads(sizes, cfg_kw, params, tokens, labels):
    """The StreamFormer step's loss and synced gradients (before Adam) on
    a process mesh of ``sizes``, gathered whole."""
    from nnstreamer_tpu_torch.parallel import train_step as ts
    from nnstreamer_tpu_torch.parallel.mesh import shard

    cfg = ts.StreamFormerConfig(dtype=torch.float32, **cfg_kw)
    mesh = make_mesh(axis_sizes=sizes, devices=[CPU])
    _, p, _, specs = ts.make_train_step(mesh, cfg, params=params)
    toks, labs = (_t(shard(x, mesh, ("dp", "sp"))) for x in (tokens,
                                                           labels))
    loss, grads = ts.value_and_grad(p, toks, labs, cfg, mesh=mesh)
    spec_of = dict(ts.leaves(specs))
    return float(loss), {n: unshard(g, mesh, spec_of[n]).numpy()
                         for n, g in grads.items()}


def vision_steps(name, props, variables, batches, lr=1e-3):
    """``make_vision_train_step`` data parallel over the world, from the
    JAX package's ``variables`` (None: the port's seeded init); returns
    the losses and the module's state after the last step."""
    from nnstreamer_tpu_torch.models import mobilenet_v2, vit
    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.parallel.vision_train import \
        make_vision_train_step

    n = dist.get_world_size()
    model = get_model(name, props, device=CPU, trainable=True)
    if variables is not None:
        {"vit": vit.load_flax,
         "mobilenet_v2": mobilenet_v2.load_flax}[name](model.module,
                                                       variables)
    mesh = make_mesh(n_devices=n, axis_sizes={"dp": n}, devices=[CPU])
    step, module, opt, _ = make_vision_train_step(mesh, model, lr=lr)
    losses = []
    for frames, labels in batches:
        _, _, loss = step(module, opt, frames, labels)
        losses.append(float(loss))
    return losses, {k: v.numpy().copy()
                    for k, v in module.state_dict().items()}


def trainer_pipeline(framework, custom, caps, frames, path):
    """The same ``tensor_trainer`` pipeline on every rank, with
    ``model-save-path``; returns the summary, the losses, how many times
    this rank wrote a checkpoint, and the state after training."""
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.elements.trainer import TensorTrainer
    from nnstreamer_tpu_torch.models import registry
    from nnstreamer_tpu_torch.pipeline import AppSrc, Pipeline
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    writes = []
    real = registry.save_checkpoint

    def counting(model, p):
        writes.append(p)
        real(model, p)

    registry.save_checkpoint = counting
    try:
        trainer = TensorTrainer("tr", framework=framework, **{
            "custom": custom, "model-save-path": path})
        pl = Pipeline()
        src = AppSrc("src", caps=caps)
        sink = TensorSink("out")
        pl.add(src, trainer, sink)
        pl.link(src, trainer, sink)
        for i, tensors in enumerate(frames):
            src.push_buffer(TensorBuffer(tensors=list(tensors), pts=i))
        src.end_of_stream()
        pl.run(timeout=300)
    finally:
        registry.save_checkpoint = real
    state = {k: v.detach().cpu().numpy().copy()
             for k, v in trainer.trainer.state_tensors().items()}
    return (trainer.summary, list(trainer.trainer.losses), len(writes),
            state, len(sink.results))


def info():
    """This rank's ``multihost.process_info()`` and mesh coordinates."""
    n = dist.get_world_size()
    mesh = make_mesh(n_devices=n, devices=[CPU])
    return multihost.process_info(), mesh.shape, mesh.procs.coords, n
