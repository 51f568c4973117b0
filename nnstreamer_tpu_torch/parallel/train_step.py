"""StreamFormer: config, LayerNorm and parameter tree.

The serving half of ``nnstreamer_tpu/parallel/train_step.py``:
:class:`StreamFormerConfig` (with a torch dtype), the bias-free
LayerNorm :func:`_ln` and a seeded :func:`init_params` with the same tree
and shapes.  Torch and JAX draw different numbers from one seed, so two
packages agree only when one's tree is carried over to the other
(``models.streamformer_lm.params_from_jax``).  The sharded train step,
the switch MoE and the mesh wait for the training slice (ROADMAP A12).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


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
