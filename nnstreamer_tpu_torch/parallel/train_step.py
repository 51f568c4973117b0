"""StreamFormer: the LM and its train step over a dp/sp/tp/ep mesh.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/train_step.py``:
:class:`StreamFormerConfig` (with a torch dtype), a seeded
:func:`init_params` with the JAX package's tree and shapes, the bias-free
LayerNorm :func:`_ln`, the Switch MoE :func:`_moe_switch`, the training
forward and loss, and :func:`make_train_step`.

The JAX package shard_maps one jitted step over the mesh.  The port runs
the same per-member step in every process of a process mesh
(:mod:`.multihost`), with the JAX package's collectives and their
gradients (:mod:`.collectives`):

- **dp**: the batch is sharded, gradients are psum'd;
- **sp**: the sequence is sharded; attention is the ring
  (:func:`~.ring_attention.ring_attention`) or Ulysses
  (:func:`~.ulysses.ulysses_attention`), by ``cfg.seq_parallel``;
- **tp**: heads and the MLP's hidden units are sharded, the attention
  and MLP outputs psum'd;
- **ep**: the experts are sharded; each member routes all its tokens,
  runs its own experts and psums the result; the capacity is computed
  from the member's own tokens, the aux loss over the (dp, sp) tokens.

Every member draws the global parameters from the seed and keeps its
block (``_param_specs``), so a tp=2 run starts where tp=1 does; the loss
is psum'd over (dp, sp); each gradient is psum'd over the axes its leaf
is replicated on.  On a local mesh of one device (every axis of size 1)
the collectives are identities and the step runs on the card as one CUDA
graph per batch signature (:class:`~.._cuda.GraphedStep`); a multi-rank
step runs eagerly (a collective of the process group cannot be captured).
What it keeps:

- f32 parameters with ``cfg.dtype`` compute: each matmul weight is cast at
  its use, so the gradient flows back through the cast;
- attention through the flash kernels K2/K3/K4 on the card, with the
  batch in their grid;
- the hand-written Adam of the JAX package, which adds ``eps`` to the
  *uncorrected* ``sqrt(v)`` — ``p − lr·corr·m/(sqrt(v) + eps)`` with
  ``corr = sqrt(1 − β₂ᵗ)/(1 − β₁ᵗ)`` — unlike ``torch.optim.Adam``; its
  step count ``t`` is a 0-d int32 tensor on the device, as in the JAX
  package's optimizer state, so a replayed step corrects with its own
  ``t``.

The step updates the parameter and optimizer tensors in place (the JAX
package donates them into its executable) and returns the same trees.
Torch and JAX draw different numbers from one seed, so two packages agree
only when one's tree is carried over to the other (``params=`` here, or
``models.streamformer_lm.params_from_jax``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .collectives import psum, psum_
from .mesh import Mesh, local_device, shard
from .ring_attention import ring_attention


@dataclasses.dataclass
class StreamFormerConfig:
    vocab: int = 256
    dim: int = 128
    heads: int = 8
    head_dim: int = 16
    mlp: int = 512
    layers: int = 2
    experts: int = 2          # MoE experts
    capacity_factor: float = 1.25  # per-expert token capacity (training)
    aux_coef: float = 0.01    # Switch load-balance aux loss weight (training)
    max_seq: int = 1024
    dtype: torch.dtype = torch.bfloat16
    lr: float = 1e-3
    #: long-context strategy over the sp axis (training): "ring" or
    #: "ulysses"
    seq_parallel: str = "ring"


def init_params(cfg: StreamFormerConfig, seed: int = 0) -> Dict[str, Any]:
    """The JAX package's tree — ``embed (V, D)``, ``pos (max_seq, D)``,
    ``head (D, V)``, ``ln_f (D,)`` and per layer ``ln1``, ``ln2``,
    ``wqkv (D, 3, H, Dh)``, ``wo (H, Dh, D)``, ``w1 (D, F)``, ``w2 (F,
    D)``, ``gate (D, E)``, ``we1 (E, D, F)``, ``we2 (E, F, D)`` — as f32
    CPU tensors, normal(0, 0.02) drawn in the JAX package's order from a
    ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator().manual_seed(int(seed))

    def norm(*shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32) * 0.02

    d, h, hd, f, e = cfg.dim, cfg.heads, cfg.head_dim, cfg.mlp, cfg.experts
    params: Dict[str, Any] = {
        "embed": norm(cfg.vocab, d),
        "pos": norm(cfg.max_seq, d),
        "head": norm(d, cfg.vocab),
        "ln_f": torch.ones(d),
        "layers": [],
    }
    for _ in range(cfg.layers):
        params["layers"].append({
            "ln1": torch.ones(d),
            "ln2": torch.ones(d),
            "wqkv": norm(d, 3, h, hd),
            "wo": norm(h, hd, d),
            "w1": norm(d, f),
            "w2": norm(f, d),
            "gate": norm(d, e),
            "we1": norm(e, d, f),
            "we2": norm(e, f, d),
        })
    return params


def _ln(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Bias-free LayerNorm: eps 1e-5, two-pass (population) variance."""
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, unbiased=False)
    return (x - mu) * torch.rsqrt(var + 1e-5) * scale


def _param_specs(cfg: StreamFormerConfig) -> Dict[str, Any]:
    """The JAX package's partition spec per parameter leaf, as tuples of
    axis names (tp shards heads/hidden; ep shards experts; everything is
    replicated over dp and sp)."""
    layer = {
        "ln1": (), "ln2": (),
        "wqkv": (None, None, "tp", None),    # (D, 3, H, Dh)
        "wo": ("tp", None, None),            # (H, Dh, D)
        "w1": (None, "tp"),                  # (D, F)
        "w2": ("tp", None),                  # (F, D)
        "gate": (),                          # (D, E)
        "we1": ("ep", None, None),           # (E_local, D, F)
        "we2": ("ep", None, None),           # (E_local, F, D)
    }
    return {
        "embed": (), "pos": (), "head": (), "ln_f": (),
        "layers": [dict(layer) for _ in range(cfg.layers)],
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")      # jax.nn.gelu's default


def _moe_switch(y: torch.Tensor, lyr: Dict[str, torch.Tensor],
                cfg: StreamFormerConfig, mesh: Optional[Mesh] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-Transformer top-1 routed MoE, capacity-capped, experts
    sharded over ``ep``.

    Each token goes to the expert of its largest router probability; an
    expert takes at most ``cap = ceil(n/E · capacity_factor)`` of this
    member's ``n`` tokens, in token order, and drops the rest (the
    residual passes them through).  This member runs its ``E/ep``
    experts on the tokens routed to them and the psum over ``ep`` brings
    the others' in.  The JAX package dispatches with a one-hot (N, E, C)
    einsum; each slot there sums exactly one token, so an index gather
    and scatter give the same values and the same gradients.

    Returns (moe_out (B, T, D), aux), aux the Switch load-balance loss
    ``E · Σ_e f_e·P_e`` over the (dp, sp) members' tokens."""
    b, t, d = y.shape
    n = b * t
    e = cfg.experts
    tokens = y.reshape(n, d)
    logits = tokens.float() @ lyr["gate"].float()
    probs = torch.softmax(logits, dim=-1)            # (N, E) f32
    gate_val, exp_idx = probs.max(dim=-1)            # first max, as argmax
    onehot = F.one_hot(exp_idx, e).float()
    cap = max(1, int(np.ceil(n / e * cfg.capacity_factor)))
    # 1-based slot of each token within its expert, in token order (the
    # scan runs along the tokens of each expert's row: a scan over the
    # outer axis of an (N, E) tensor would run on E threads)
    pos = (onehot.t().cumsum(dim=1).t() * onehot).sum(-1).long()
    e_local = lyr["we1"].shape[0]
    local = exp_idx - (0 if mesh is None else mesh.axis_index("ep")) \
        * e_local
    keep = (pos <= cap) & (local >= 0) & (local < e_local)
    # row of (E_local·C + 1, D) each token goes to; tokens over their
    # expert's capacity, and those of other members' experts, share the
    # last row, which is dropped (no host sync here)
    slot = torch.where(keep, local * cap + pos - 1,
                       torch.full_like(pos, e_local * cap))
    dt = cfg.dtype
    xe = torch.zeros(e_local * cap + 1, d, dtype=dt,
                     device=y.device).index_put((slot,), tokens.to(dt))[:-1]
    he = _gelu(torch.einsum("ecd,edf->ecf", xe.view(e_local, cap, d),
                            lyr["we1"].to(dt)))
    oe = torch.einsum("ecf,efd->ecd", he, lyr["we2"].to(dt))
    rows = torch.cat([oe.reshape(e_local * cap, d), oe.new_zeros(1, d)])
    # index_select's backward adds into each row once (every kept token
    # has its own slot), where advanced indexing's sorts the indices
    out = rows.index_select(0, slot) * gate_val.to(dt)[:, None]
    out = psum(out, mesh, "ep")
    # load-balance aux (Switch eq. 4): fraction routed x mean router prob,
    # over the (dp, sp) token set so every member agrees on the value
    f_sum = psum(onehot.sum(0), mesh, ("dp", "sp"))
    p_sum = psum(probs.sum(0), mesh, ("dp", "sp"))
    n_tot = n * (1 if mesh is None else mesh.axis_size(("dp", "sp")))
    aux = e * torch.sum((f_sum / n_tot) * (p_sum / n_tot))
    return out.reshape(b, t, d), aux


def _seq_attention(cfg: StreamFormerConfig):
    if cfg.seq_parallel == "ulysses":
        from .ulysses import ulysses_attention

        return ulysses_attention
    if cfg.seq_parallel == "ring":
        return ring_attention
    raise ValueError(f"seq_parallel={cfg.seq_parallel!r}: ring | ulysses")


def _forward_local(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: StreamFormerConfig, flash: Optional[bool] = None,
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B_local, T_local) int → (logits (B_local, T_local, vocab)
    f32, mean aux loss): the JAX package's per-member forward.  Heads and
    MLP hidden units are this member's tp block, the sequence its sp
    block (causal attention crosses sp; the flash kernels for tensors on
    the card unless ``flash`` says otherwise), the experts its ep
    block."""
    dt = cfg.dtype
    seq_attn = _seq_attention(cfg)
    b, t = tokens.shape
    start = 0 if mesh is None else mesh.axis_index("sp") * t
    # this block's positions: a slice of the table, whose gradient is a
    # copy
    x = (F.embedding(tokens.long(), params["embed"])
         + params["pos"][start:start + t][None]).to(dt)
    aux = torch.zeros((), device=tokens.device)
    for lyr in params["layers"]:
        y = _ln(x.float(), lyr["ln1"]).to(dt)
        qkv = torch.einsum("btd,dchn->btchn", y, lyr["wqkv"].to(dt))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = seq_attn(q, k, v, "sp", causal=True, flash=flash, mesh=mesh)
        o = torch.einsum("bthn,hnd->btd", attn, lyr["wo"].to(dt))
        x = x + psum(o, mesh, "tp")           # combine head shards
        y = _ln(x.float(), lyr["ln2"]).to(dt)
        hcore = _gelu(torch.einsum("btd,df->btf", y, lyr["w1"].to(dt)))
        m = psum(torch.einsum("btf,fd->btd", hcore, lyr["w2"].to(dt)),
                 mesh, "tp")
        moe, aux_l = _moe_switch(y, lyr, cfg, mesh)
        aux = aux + aux_l
        x = x + m + moe
    x = _ln(x.float(), params["ln_f"])
    logits = torch.einsum("btd,dv->btv", x, params["head"])
    return logits, aux / max(1, len(params["layers"]))


def _loss_local(params, tokens, labels, cfg, flash=None,
                mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Mean next-token NLL over the (dp, sp) members' tokens plus
    ``aux_coef`` x the Switch aux loss."""
    logits, aux = _forward_local(params, tokens, cfg, flash, mesh)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    s = psum(nll.sum(), mesh, ("dp", "sp"))
    n = nll.numel() * (1 if mesh is None else mesh.axis_size(("dp", "sp")))
    return s / n + cfg.aux_coef * aux


def leaves(tree: Dict[str, Any]) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every leaf of a StreamFormer tree, in a fixed
    order (``layers.<i>.<name>`` for the per-layer leaves)."""
    for name in ("embed", "pos", "head", "ln_f"):
        yield name, tree[name]
    for i, lyr in enumerate(tree["layers"]):
        for name in sorted(lyr):
            yield f"layers.{i}.{name}", lyr[name]


def value_and_grad(params: Dict[str, Any], tokens: torch.Tensor,
                   labels: torch.Tensor, cfg: StreamFormerConfig,
                   flash: Optional[bool] = None,
                   mesh: Optional[Mesh] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The step's loss and its gradient, ``{path: grad}`` over
    :func:`leaves`, without updating anything.  On a process mesh
    ``tokens``/``labels`` are this member's block, and each gradient is
    psum'd over the axes its leaf is replicated on (the JAX package's
    sync)."""
    named = list(leaves(params))
    for _, p in named:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = _loss_local(params, tokens, labels, cfg, flash, mesh)
            grads = torch.autograd.grad(loss, [p for _, p in named])
    finally:
        for _, p in named:
            p.requires_grad_(False)
    grads = {n: g for (n, _), g in zip(named, grads)}
    if mesh is not None:
        specs = dict(leaves(_param_specs(cfg)))
        by_axes: Dict[Tuple[str, ...], List[torch.Tensor]] = {}
        for name, g in grads.items():
            used = {a for part in specs[name] if part
                    for a in ((part,) if isinstance(part, str) else part)}
            axes = tuple(a for a in ("dp", "sp", "tp", "ep")
                         if a not in used)
            by_axes.setdefault(axes, []).append(g)
        for axes, gs in by_axes.items():
            psum_(gs, mesh, axes)
    return loss.detach(), grads


def _map_tree(fn: Callable[[torch.Tensor], torch.Tensor],
              tree: Dict[str, Any]) -> Dict[str, Any]:
    return _map_named(lambda _, x: fn(x), tree)


def _map_named(fn: Callable[[str, Any], torch.Tensor],
               tree: Dict[str, Any]) -> Dict[str, Any]:
    """The tree of ``fn(path, leaf)``, paths as :func:`leaves` names
    them."""
    return {**{n: fn(n, tree[n]) for n in ("embed", "pos", "head", "ln_f")},
            "layers": [{n: fn(f"layers.{i}.{n}", w) for n, w in lyr.items()}
                       for i, lyr in enumerate(tree["layers"])]}


def make_train_step(mesh: Mesh, cfg: Optional[StreamFormerConfig] = None,
                    seed: int = 0, params: Optional[Dict[str, Any]] = None,
                    flash: Optional[bool] = None):
    """Build ``(step, params, opt, specs)`` on this process's device.

    ``step(params, opt, tokens, labels) -> (params, opt, loss)``: one Adam
    step on the global (B, T) int tokens/labels (host or device; on a
    process mesh each member takes its (dp, sp) block), updating
    ``params`` and ``opt`` — this member's blocks — in place; the step is
    bound to the trees it returns and refuses others.  ``loss`` is a 0-d
    f32 tensor on the device, on the card the graph's static output: read
    it (the step's one sync) before the next step.  ``params``: a global
    tree to start from (the JAX package's, as numpy or jax arrays, or the
    port's) instead of ``init_params(cfg, seed)``.  ``flash``: attention
    through the flash kernels (default: on the card) or plain
    attention."""
    from .._cuda import GraphedStep

    cfg = cfg or StreamFormerConfig()
    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if cfg.experts % axis_sizes.get("ep", 1):
        raise ValueError("experts must divide ep axis size")
    device = local_device(mesh)
    ranks = mesh if mesh.procs is not None else None
    specs = _param_specs(cfg)
    start = params if params is not None else init_params(cfg, seed)
    spec_of = dict(leaves(specs))

    def put(name, x):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x, dtype=np.float32))
        if ranks is not None:
            x = shard(x, mesh, spec_of[name])
        return x.detach().to(device=device, dtype=torch.float32).clone()

    params = _map_named(put, start)
    opt = {"m": _map_tree(torch.zeros_like, params),
           "v": _map_tree(torch.zeros_like, params),
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    named = list(leaves(params))

    def body(tokens, labels):
        loss, grads = value_and_grad(params, tokens, labels, cfg, flash,
                                     ranks)
        opt["step"].add_(1)
        adam_update([p for _, p in named], [m for _, m in leaves(opt["m"])],
                    [v for _, v in leaves(opt["v"])],
                    [grads[n] for n, _ in named], opt["step"], cfg.lr)
        return loss

    graphed = GraphedStep(body, device, eager=ranks is not None,
                          shard=None if ranks is None else
                          lambda batch: [shard(x, mesh, ("dp", "sp"))
                                         for x in batch])

    def step(params_, opt_, tokens, labels):
        if params_ is not params or opt_ is not opt:
            raise ValueError("this step updates the trees make_train_step "
                             "returned, in place; it takes no others")
        return params, opt, graphed(tokens, labels)

    step.graphed = graphed
    return step, params, opt, specs


def adam_update(params: List[torch.Tensor], ms: List[torch.Tensor],
                vs: List[torch.Tensor], grads: List[torch.Tensor],
                t: torch.Tensor, lr: float) -> None:
    """The JAX package's hand-written Adam step ``t`` (1-based; a 0-d
    integer tensor on the parameters' device), in place: ``eps`` on the
    *uncorrected* ``sqrt(v)``, ``corr = sqrt(1 − β₂ᵗ)/(1 − β₁ᵗ)`` in f32
    — not ``torch.optim.Adam``'s formula."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    t_f = t.to(torch.float32)
    corr = (torch.sqrt(1 - torch.full_like(t_f, b2) ** t_f)
            / (1 - torch.full_like(t_f, b1) ** t_f))
    lr_corr = lr * corr
    with torch.no_grad():
        for p, m, v, g in zip(params, ms, vs, grads):
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).add_(g * g, alpha=1 - b2)
            p.sub_(lr_corr * m / (v.sqrt() + eps))


def make_data_sharding(mesh: Mesh) -> torch.device:
    """Where a step's (B, T) batch blocks go: this process's device (the
    JAX package's ``NamedSharding(mesh, P("dp", "sp"))``; each member
    takes its block, :func:`~.mesh.shard`)."""
    return local_device(mesh)
