"""Pipeline parallelism (the ``pp`` axis): GPipe-scheduled stage sharding.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/pipeline_parallel.py``:

- **stage sharding**: the StreamFormer's dense layers are STACKED on a
  leading axis and sharded over ``pp`` — each member owns ``L/pp``
  consecutive layers; embed/head are replicated (their gradients are
  nonzero only on the members that use them; the sync psum recovers the
  whole);
- **GPipe fill-drain**: the batch splits into ``M`` microbatches and the
  schedule runs ``M + pp − 1`` ticks.  At each tick every member applies
  its stage to the activation it received and hands the result to the
  next member through :func:`~.collectives.ppermute` (one hop a tick);
- **backward**: autograd runs the reversed schedule, each hand-off's
  gradient going back through the inverse ppermute;
- it composes with **dp** (batch), **sp** (ring attention over the
  sequence) and **tp** (heads/hidden) on the same mesh.

As in the JAX package every member computes every tick and the schedule
selects with ``where`` (member 0 ingests a fresh microbatch, the last
member emits a loss), so the collectives pair up across members in both
directions.  The stage is the dense StreamFormer layer (attention + MLP;
the MoE stays with ``ep`` in :mod:`.train_step`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .collectives import ppermute, psum, psum_
from .mesh import Mesh, local_device, shard
from .ring_attention import ring_attention
from .train_step import StreamFormerConfig, _gelu, _ln, adam_update

#: the pp mesh's axes, in the JAX package's order
PP_AXES = ("dp", "sp", "tp", "pp")
_LEAVES = ("embed", "pos", "head", "ln_f", "ln1", "ln2", "wqkv", "wo",
           "w1", "w2")


def stacked_param_specs() -> Dict[str, Any]:
    """The partition spec per leaf: the layer stacks shard over pp
    (leading axis), tp shards heads/hidden within each stage."""
    return {
        "embed": (), "pos": (), "head": (), "ln_f": (),
        "ln1": ("pp", None),
        "ln2": ("pp", None),
        "wqkv": ("pp", None, None, "tp", None),
        "wo": ("pp", "tp", None, None),
        "w1": ("pp", None, "tp"),
        "w2": ("pp", "tp", None),
    }


def init_stacked_params(cfg: StreamFormerConfig, seed: int = 0
                        ) -> Dict[str, torch.Tensor]:
    """The JAX package's stacked tree as f32 CPU tensors, normal(0, 0.02)
    drawn in its order from a ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))
    d, h, hd, f, n = cfg.dim, cfg.heads, cfg.head_dim, cfg.mlp, cfg.layers

    def norm(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * 0.02

    return {
        "embed": norm(cfg.vocab, d), "pos": norm(cfg.max_seq, d),
        "head": norm(d, cfg.vocab), "ln_f": torch.ones(d),
        "ln1": torch.ones(n, d), "ln2": torch.ones(n, d),
        "wqkv": norm(n, d, 3, h, hd), "wo": norm(n, h, hd, d),
        "w1": norm(n, d, f), "w2": norm(n, f, d),
    }


def _stage_forward(params, x, cfg: StreamFormerConfig, mesh, flash):
    """This member's layer stack over activations (mb, T_local, D)."""
    dt = cfg.dtype
    for i in range(params["ln1"].shape[0]):
        y = _ln(x.float(), params["ln1"][i]).to(dt)
        qkv = torch.einsum("btd,dchn->btchn", y, params["wqkv"][i].to(dt))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = ring_attention(q, k, v, "sp", causal=True, flash=flash,
                              mesh=mesh)
        o = torch.einsum("bthn,hnd->btd", attn, params["wo"][i].to(dt))
        x = x + psum(o, mesh, "tp")
        y = _ln(x.float(), params["ln2"][i]).to(dt)
        hcore = _gelu(torch.einsum("btd,df->btf", y,
                                   params["w1"][i].to(dt)))
        m = torch.einsum("btf,fd->btd", hcore, params["w2"][i].to(dt))
        x = x + psum(m, mesh, "tp")
    return x


def _pp_loss_local(params, tokens, labels, cfg: StreamFormerConfig,
                   n_stages: int, microbatches: int, mesh, flash=None):
    """The GPipe fill-drain loss of this member's (B_local, T_local)
    block, ``B_local = microbatches · mb``: the mean NLL over the (dp, sp)
    tokens, psum'd over (dp, sp, pp)."""
    r = 0 if mesh is None else mesh.axis_index("pp")
    sp_idx = 0 if mesh is None else mesh.axis_index("sp")
    b, t = tokens.shape
    mb = b // microbatches
    toks = tokens.reshape(microbatches, mb, t).long()
    labs = labels.reshape(microbatches, mb, t).long()
    pos = params["pos"][sp_idx * t:sp_idx * t + t]
    dev = tokens.device
    perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]

    def flag(v: bool) -> torch.Tensor:
        return torch.full((), bool(v), dtype=torch.bool, device=dev)

    x_out = torch.zeros(mb, t, cfg.dim, dtype=cfg.dtype, device=dev)
    nll_sum = torch.zeros((), device=dev)
    for s in range(microbatches + n_stages - 1):
        # hand the previous tick's output to the next stage
        x_in = ppermute(x_out, mesh, "pp", perm)
        # member 0 ingests microbatch s (when one remains)
        fresh = (F.embedding(toks[min(s, microbatches - 1)],
                             params["embed"]) + pos[None]).to(cfg.dtype)
        x_in = torch.where(flag(r == 0 and s < microbatches), fresh, x_in)
        x_out = _stage_forward(params, x_in, cfg, mesh, flash)
        # the last member emits microbatch s - (pp - 1)'s loss (when valid)
        mb_out = min(max(s - (n_stages - 1), 0), microbatches - 1)
        xf = _ln(x_out.float(), params["ln_f"])
        logp = torch.log_softmax(xf @ params["head"], dim=-1)
        nll = -torch.gather(logp, -1, labs[mb_out][..., None])[..., 0]
        emit = flag(r == n_stages - 1 and s >= n_stages - 1)
        nll_sum = nll_sum + torch.where(emit, nll.sum(),
                                        torch.zeros_like(nll_sum))
    total = psum(nll_sum, mesh, ("dp", "sp", "pp"))
    n = tokens.numel() * (1 if mesh is None
                          else mesh.axis_size(("dp", "sp")))
    return total / n


def make_pp_train_step(mesh: Mesh, cfg: Optional[StreamFormerConfig] = None,
                       microbatches: Optional[int] = None, seed: int = 0,
                       params: Optional[Dict[str, Any]] = None,
                       flash: Optional[bool] = None
                       ) -> Tuple[Any, Dict, Dict, Dict]:
    """Build ``(step, params, opt, specs)`` for a mesh with a ``pp`` axis
    (plus any of dp/sp/tp); ``step(params, opt, tokens, labels) ->
    (params, opt, loss)`` on the global (B, T) batch, as
    :func:`~.train_step.make_train_step`'s.  ``params``: a global stacked
    tree to start from (the JAX package's) instead of
    :func:`init_stacked_params`."""
    from .._cuda import GraphedStep

    cfg = cfg or StreamFormerConfig()
    sizes = mesh.shape
    missing = set(PP_AXES) - set(mesh.axis_names)
    if missing:
        raise ValueError(f"pp mesh must name axes dp/sp/tp/pp (size-1 "
                         f"axes are fine); missing {sorted(missing)}")
    n_stages = sizes.get("pp", 1)
    if cfg.layers % n_stages:
        raise ValueError(f"pp={n_stages} must divide layers={cfg.layers} "
                         "(each stage holds layers/pp consecutive layers)")
    m_count = microbatches or max(2, n_stages)
    device = local_device(mesh)
    ranks = mesh if mesh.procs is not None else None
    specs = stacked_param_specs()
    start = params if params is not None else init_stacked_params(cfg, seed)

    def put(name):
        x = start[name]
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x, dtype=np.float32))
        if ranks is not None:
            x = shard(x, mesh, specs[name])
        return x.detach().to(device=device, dtype=torch.float32).clone()

    params = {n: put(n) for n in _LEAVES}
    opt = {"m": {n: torch.zeros_like(p) for n, p in params.items()},
           "v": {n: torch.zeros_like(p) for n, p in params.items()},
           "step": torch.zeros((), dtype=torch.int32, device=device)}

    def body(tokens, labels):
        ps = [params[n] for n in _LEAVES]
        for p in ps:
            p.requires_grad_(True)
        try:
            with torch.enable_grad():
                loss = _pp_loss_local(params, tokens, labels, cfg,
                                      n_stages, m_count, ranks, flash)
                grads = dict(zip(_LEAVES, torch.autograd.grad(loss, ps)))
        finally:
            for p in ps:
                p.requires_grad_(False)
        by_axes: Dict[Tuple[str, ...], list] = {}
        for name in _LEAVES:
            used = {a for a in specs[name] if a}
            by_axes.setdefault(tuple(a for a in PP_AXES if a not in used),
                               []).append(grads[name])
        if ranks is not None:
            for axes, gs in by_axes.items():
                psum_(gs, mesh, axes)
        opt["step"].add_(1)
        adam_update(ps, [opt["m"][n] for n in _LEAVES],
                    [opt["v"][n] for n in _LEAVES],
                    [grads[n] for n in _LEAVES], opt["step"], cfg.lr)
        return loss.detach()

    graphed = GraphedStep(body, device, eager=ranks is not None,
                          shard=None if ranks is None else
                          lambda batch: [shard(x, mesh, ("dp", "sp"))
                                         for x in batch])

    def step(params_, opt_, tokens, labels):
        if params_ is not params or opt_ is not opt:
            raise ValueError("this step updates the trees make_pp_train_"
                             "step returned, in place; it takes no others")
        return params, opt, graphed(tokens, labels)

    step.graphed = graphed
    return step, params, opt, specs
