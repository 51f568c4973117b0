"""ViT-S/16 (Dosovitskiy et al. 2020; DeiT-S, Touvron et al. 2020,
arXiv:2012.12877) in plain PyTorch.

The benchmark's reference for the ``vit`` configurations: the forward
pass written out in float32 from the papers, with plain attention
(``softmax(q kᵀ / sqrt(d)) v``) and no kernel, batching or cache of the
program under test.

- a 16x16 stride-16 patch convolution with bias; the patches in row-major
  order after a class token; a learned position embedding;
- pre-norm blocks: ``x + proj(attn(LN(x)))`` with a fused QKV projection
  laid out as (3, heads, head dim), then ``x + fc2(gelu(fc1(LN(x))))``;
- a final LayerNorm and a dense head on the class token;
- the frame, uint8 RGB, scaled to [-1, 1] as ``x / 127.5 - 1``.

Departures, as the configuration file states them: GELU is the
configuration's (``gelu_approximation``: ``tanh``, flax's default, where
DeiT uses the exact erf form); LayerNorm's epsilon is
``layer_norm_eps``.

Weights are a flat mapping of name -> tensor (PyTorch's ``Linear``,
``Conv2d`` and LayerNorm names); :func:`spec` lists them.  ``cast`` is
applied to both operands of every product and to the residual stream:
the identity for the reference, a lower precision for the control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F


def tokens(cfg: dict) -> int:
    """Sequence length: the patches and the class token."""
    return (int(cfg["image_size"]) // int(cfg["patch_size"])) ** 2 + 1


def spec(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, draw) of every tensor: LeCun-normal kernels, small
    uniform biases and LayerNorm affines near the identity, normal(0.02)
    class token and position embedding."""
    d, p = int(cfg["hidden_size"]), int(cfg["patch_size"])
    mlp, classes = int(cfg["intermediate_size"]), int(cfg["num_classes"])

    def dense(name, cout, cin):
        return [(f"{name}.weight", (cout, cin),
                 ("normal", 1.0 / math.sqrt(cin))),
                (f"{name}.bias", (cout,), ("uniform", -0.1, 0.1))]

    def norm(name):
        return [(f"{name}.weight", (d,), ("uniform", 0.8, 1.2)),
                (f"{name}.bias", (d,), ("uniform", -0.1, 0.1))]

    out = [("patch_embed.weight", (d, 3, p, p),
            ("normal", 1.0 / math.sqrt(3 * p * p))),
           ("patch_embed.bias", (d,), ("uniform", -0.1, 0.1)),
           ("cls", (1, d), ("normal", 0.02)),
           ("pos_embed", (tokens(cfg), d), ("normal", 0.02))]
    for i in range(int(cfg["num_hidden_layers"])):
        pre = f"blocks.{i}."
        out += norm(pre + "ln1") + dense(pre + "attn.qkv", 3 * d, d)
        out += dense(pre + "attn.proj", d, d) + norm(pre + "ln2")
        out += dense(pre + "fc1", mlp, d) + dense(pre + "fc2", d, mlp)
    out += norm("norm") + dense("head", classes, d)
    return out


def features(w: Dict[str, torch.Tensor], frames: torch.Tensor, cfg: dict,
             cast: Callable[[torch.Tensor], torch.Tensor] = lambda t: t
             ) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` frames -> the class token after the final
    LayerNorm, float32 ``(B, dim)``: what the head reads."""
    d, heads = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    hd = d // heads
    eps = float(cfg["layer_norm_eps"])
    gelu = cfg["gelu_approximation"]

    def dense(x, name):
        return F.linear(cast(x), cast(w[name + ".weight"].float()),
                        w[name + ".bias"].float())

    def norm(x, name):
        return F.layer_norm(x, (d,), w[name + ".weight"].float(),
                            w[name + ".bias"].float(), eps)

    x = frames.float() * (1.0 / 127.5) - 1.0
    x = F.conv2d(cast(x.permute(0, 3, 1, 2)),
                 cast(w["patch_embed.weight"].float()),
                 w["patch_embed.bias"].float(), int(cfg["patch_size"]))
    x = x.flatten(2).transpose(1, 2)
    cls = w["cls"].float().expand(x.shape[0], 1, d)
    x = cast(torch.cat([cls, x], dim=1) + w["pos_embed"].float())
    b, t = x.shape[:2]
    for i in range(int(cfg["num_hidden_layers"])):
        pre = f"blocks.{i}."
        qkv = dense(norm(x, pre + "ln1"), pre + "attn.qkv")
        q, k, v = qkv.reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
        s = cast(q) @ cast(k).transpose(-1, -2) * (1.0 / math.sqrt(hd))
        a = cast(torch.softmax(s, dim=-1)) @ cast(v)
        x = cast(x + dense(a.transpose(1, 2).reshape(b, t, d),
                           pre + "attn.proj"))
        y = F.gelu(dense(norm(x, pre + "ln2"), pre + "fc1"),
                   approximate=gelu)
        x = cast(x + dense(y, pre + "fc2"))
    return norm(x, "norm")[:, 0]


def forward(w: Dict[str, torch.Tensor], frames: torch.Tensor, cfg: dict,
            cast: Callable[[torch.Tensor], torch.Tensor] = lambda t: t
            ) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` frames -> float32 logits ``(B, classes)``."""
    x = features(w, frames, cfg, cast)
    return F.linear(cast(x), cast(w["head.weight"].float()),
                    w["head.bias"].float())


def leaves(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves a training check compares: every tensor, with each fused
    QKV projection as its three projections, as the papers write them
    (the key's bias, which softmax ignores, so becomes a leaf of its
    own)."""
    out = {}
    for name, t in tensors.items():
        if ".attn.qkv." in name:
            for part, piece in zip("qkv", t.chunk(3, dim=0)):
                out[f"{name}[{part}]"] = piece
        else:
            out[name] = t
    return out
