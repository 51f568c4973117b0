"""StreamFormer: the LM and its train step on one card.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/train_step.py``:
:class:`StreamFormerConfig` (with a torch dtype), a seeded
:func:`init_params` with the JAX package's tree and shapes, the bias-free
LayerNorm :func:`_ln`, the Switch MoE :func:`_moe_switch`, the training
forward and loss, and :func:`make_train_step`.

The JAX package shard_maps one jitted step over a dp/sp/tp/ep mesh.  The
port runs the step on the mesh's one device (every axis of size 1,
:func:`~.mesh.require_single_card`), on the card as one CUDA graph per
batch signature (:class:`~.._cuda.GraphedStep`); the collectives over axes
of size one are identities and are left out.  What it keeps:

- f32 parameters with ``cfg.dtype`` compute: each matmul weight is cast at
  its use, so the gradient flows back through the cast;
- attention through :func:`~.ring_attention.ring_attention` (the flash
  kernels K2/K3/K4 on the card, with the batch in their grid);
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

from .mesh import Mesh, require_single_card
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
    replicated over dp and sp).  On one card every leaf is whole; the
    specs say how a multi-card step would split them."""
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
                cfg: StreamFormerConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Switch-Transformer top-1 routed MoE, capacity-capped.

    Each token goes to the expert of its largest router probability; an
    expert takes at most ``cap = ceil(n/E · capacity_factor)`` tokens, in
    token order, and drops the rest (the residual passes them through).
    The JAX package dispatches with a one-hot (N, E, C) einsum; each slot
    there sums exactly one token, so an index gather and scatter give the
    same values and the same gradients.

    Returns (moe_out (B, T, D), aux), aux the Switch load-balance loss
    ``E · Σ_e f_e·P_e`` over the step's tokens."""
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
    # row of (E·C + 1, D) each token goes to; tokens over their expert's
    # capacity share the last row, which is dropped (no host sync here)
    slot = torch.where(pos <= cap, exp_idx * cap + pos - 1,
                       torch.full_like(pos, e * cap))
    dt = cfg.dtype
    xe = torch.zeros(e * cap + 1, d, dtype=dt, device=y.device).index_put(
        (slot,), tokens.to(dt))[:-1]
    he = _gelu(torch.einsum("ecd,edf->ecf", xe.view(e, cap, d),
                            lyr["we1"].to(dt)))
    oe = torch.einsum("ecf,efd->ecd", he, lyr["we2"].to(dt))
    rows = torch.cat([oe.reshape(e * cap, d), oe.new_zeros(1, d)])
    # index_select's backward adds into each row once (every kept token
    # has its own slot), where advanced indexing's sorts the indices
    out = rows.index_select(0, slot) * gate_val.to(dt)[:, None]
    # load-balance aux (Switch eq. 4): fraction routed x mean router prob
    aux = e * torch.sum((onehot.sum(0) / n) * (probs.sum(0) / n))
    return out.reshape(b, t, d), aux


def _forward_local(params: Dict[str, Any], tokens: torch.Tensor,
                   cfg: StreamFormerConfig, flash: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, T) int → (logits (B, T, vocab) f32, mean aux loss).

    The JAX package's per-device forward with every mesh axis of size 1:
    causal attention is a one-member ring (the flash kernels for tensors
    on the card unless ``flash`` says otherwise)."""
    dt = cfg.dtype
    b, t = tokens.shape
    # positions 0..T-1: a slice of the table, whose gradient is a copy
    x = (F.embedding(tokens.long(), params["embed"])
         + params["pos"][:t][None]).to(dt)
    aux = torch.zeros((), device=tokens.device)
    for lyr in params["layers"]:
        y = _ln(x.float(), lyr["ln1"]).to(dt)
        qkv = torch.einsum("btd,dchn->btchn", y, lyr["wqkv"].to(dt))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = ring_attention(q, k, v, "sp", causal=True, flash=flash)
        x = x + torch.einsum("bthn,hnd->btd", attn, lyr["wo"].to(dt))
        y = _ln(x.float(), lyr["ln2"]).to(dt)
        hcore = _gelu(torch.einsum("btd,df->btf", y, lyr["w1"].to(dt)))
        m = torch.einsum("btf,fd->btd", hcore, lyr["w2"].to(dt))
        moe, aux_l = _moe_switch(y, lyr, cfg)
        aux = aux + aux_l
        x = x + m + moe
    x = _ln(x.float(), params["ln_f"])
    logits = torch.einsum("btd,dv->btv", x, params["head"])
    return logits, aux / max(1, len(params["layers"]))


def _loss_local(params, tokens, labels, cfg, flash=None) -> torch.Tensor:
    """Mean next-token NLL plus ``aux_coef`` x the Switch aux loss."""
    logits, aux = _forward_local(params, tokens, cfg, flash)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return nll.sum() / nll.numel() + cfg.aux_coef * aux


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
                   flash: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The step's loss and its gradient, ``{path: grad}`` over
    :func:`leaves`, without updating anything."""
    named = list(leaves(params))
    for _, p in named:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss = _loss_local(params, tokens, labels, cfg, flash)
            grads = torch.autograd.grad(loss, [p for _, p in named])
    finally:
        for _, p in named:
            p.requires_grad_(False)
    return loss.detach(), {n: g for (n, _), g in zip(named, grads)}


def _map_tree(fn: Callable[[torch.Tensor], torch.Tensor],
              tree: Dict[str, Any]) -> Dict[str, Any]:
    return {**{n: fn(tree[n]) for n in ("embed", "pos", "head", "ln_f")},
            "layers": [{n: fn(w) for n, w in lyr.items()}
                       for lyr in tree["layers"]]}


def make_train_step(mesh: Mesh, cfg: Optional[StreamFormerConfig] = None,
                    seed: int = 0, params: Optional[Dict[str, Any]] = None,
                    flash: Optional[bool] = None):
    """Build ``(step, params, opt, specs)`` on the mesh's one device.

    ``step(params, opt, tokens, labels) -> (params, opt, loss)``: one Adam
    step on (B, T) int tokens/labels (host or device), updating ``params``
    and ``opt`` in place; the step is bound to the trees it returns and
    refuses others.  ``loss`` is a 0-d f32 tensor on the device, on the
    card the graph's static output: read it (the step's one sync) before
    the next step.  ``params``: a tree to start from (the JAX package's,
    as numpy or jax arrays, or the port's) instead of ``init_params(cfg,
    seed)``.  ``flash``: attention through the flash kernels (default: on
    the card) or plain attention."""
    from .._cuda import GraphedStep

    cfg = cfg or StreamFormerConfig()
    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if cfg.experts % axis_sizes.get("ep", 1):
        raise ValueError("experts must divide ep axis size")
    device = require_single_card(mesh)
    specs = _param_specs(cfg)
    start = params if params is not None else init_params(cfg, seed)

    def put(x):
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x, dtype=np.float32))
        return x.detach().to(device=device, dtype=torch.float32).clone()

    params = _map_tree(put, start)
    opt = {"m": _map_tree(torch.zeros_like, params),
           "v": _map_tree(torch.zeros_like, params),
           "step": torch.zeros((), dtype=torch.int32, device=device)}
    named = list(leaves(params))

    def body(tokens, labels):
        loss, grads = value_and_grad(params, tokens, labels, cfg, flash)
        opt["step"].add_(1)
        adam_update([p for _, p in named], [m for _, m in leaves(opt["m"])],
                    [v for _, v in leaves(opt["v"])],
                    [grads[n] for n, _ in named], opt["step"], cfg.lr)
        return loss

    graphed = GraphedStep(body, device)

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
    """Where a step's (B, T) batches go: the mesh's one device (the JAX
    package's ``NamedSharding(mesh, P("dp", "sp"))``)."""
    return require_single_card(mesh)
