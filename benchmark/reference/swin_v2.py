"""SwinV2 (Liu et al. 2022, "Swin Transformer V2", arXiv:2111.09883) in
plain PyTorch.

The benchmark's reference for the ``swin_v2`` configurations: the forward
pass written out in float32 after the Swin codebase
(``github.com/microsoft/Swin-Transformer``, ``models/swin_transformer_v2.py``
and ``configs/swinv2/``), with plain attention and no kernel, batching or
cache of the program under test.

- the frame, uint8 RGB, scaled to [0, 1] and normalised by ImageNet's mean
  and standard deviation;
- a ``patch_size`` stride convolution with bias and a LayerNorm; tokens
  row-major;
- stages of ``depths`` blocks at widths ``embed_dim`` x 2^i with
  ``num_heads`` heads, each stage but the last closed by patch merging
  (x[0::2, 0::2], x[1::2, 0::2], x[0::2, 1::2], x[1::2, 1::2]
  concatenated, a dense layer 4C -> 2C without bias, a LayerNorm);
- a block (res-post-norm): ``x + LN(attn(x))``, ``x + LN(fc2(gelu(fc1(x))))``
  with the exact GELU.  Attention runs in ``window_size`` windows; every
  second block rolls the map by half a window and masks (-100) pairs from
  different regions of the ``img_mask`` construction; a map no larger
  than the window takes the map as its window and does not roll.  Scores:
  ``cos(q, k) exp(min(logit_scale, log 100)) + 16 sigmoid(cpb)``, where
  the continuous position bias ``cpb`` is ``Linear(2, 512)``, ReLU,
  ``Linear(512, heads)`` (no bias) of the log-spaced relative coordinates
  ``sign(t) log2(1 + 8 |t| / (w - 1)) / log2 8``; the qkv projection has
  no bias of its own, q and v biases are parameters, k has none;
- the final LayerNorm, the mean over tokens, a dense head.

Departures, as the configuration file states them: no stochastic depth;
weights drawn from the run's seed (LeCun-normal kernels, small uniform
biases, LayerNorm affines near the identity, ``logit_scale`` near log 10).

Weights are a flat mapping of name -> tensor (the codebase's names);
:func:`spec` lists them.  ``cast`` is applied to both operands of every
product and to the residual stream: the identity for the reference, a
lower precision for the control.  With gradients on real tensors each
block is recomputed in the backward (``torch.utils.checkpoint``), so the
reference's three f32 steps at the cell's batch fit the card; on the
``meta`` device (the FLOP count) nothing is recomputed.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def stages(cfg: dict) -> List[dict]:
    """Each stage's width, depth, heads, map side, window and whether its
    odd blocks roll."""
    side = int(cfg["image_size"]) // int(cfg["patch_size"])
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        s = side >> i
        w = int(cfg["window_size"])
        out.append({"dim": int(cfg["embed_dim"]) << i, "depth": int(depth),
                    "heads": int(heads), "side": s,
                    "window": min(w, s), "shift": s > w})
    return out


def spec(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, draw) of every tensor."""
    p, c0 = int(cfg["patch_size"]), int(cfg["embed_dim"])
    hidden = int(cfg["cpb_hidden"])
    ratio = int(cfg["mlp_ratio"])

    def dense(name, cout, cin, bias=True):
        out = [(f"{name}.weight", (cout, cin),
                ("normal", 1.0 / math.sqrt(cin)))]
        if bias:
            out.append((f"{name}.bias", (cout,), ("uniform", -0.1, 0.1)))
        return out

    def norm(name, d):
        return [(f"{name}.weight", (d,), ("uniform", 0.8, 1.2)),
                (f"{name}.bias", (d,), ("uniform", -0.1, 0.1))]

    out = [("patch_embed.proj.weight", (c0, 3, p, p),
            ("normal", 1.0 / math.sqrt(3 * p * p))),
           ("patch_embed.proj.bias", (c0,), ("uniform", -0.1, 0.1))]
    out += norm("patch_embed.norm", c0)
    st = stages(cfg)
    for i, s in enumerate(st):
        d, h = s["dim"], s["heads"]
        for j in range(s["depth"]):
            pre = f"layers.{i}.blocks.{j}."
            out += [(pre + "attn.logit_scale", (h, 1, 1),
                     ("uniform", math.log(10) - 0.05, math.log(10) + 0.05))]
            out += dense(pre + "attn.cpb_mlp.0", hidden, 2)
            out += dense(pre + "attn.cpb_mlp.2", h, hidden, bias=False)
            out += dense(pre + "attn.qkv", 3 * d, d, bias=False)
            out += [(pre + "attn.q_bias", (d,), ("uniform", -0.1, 0.1)),
                    (pre + "attn.v_bias", (d,), ("uniform", -0.1, 0.1))]
            out += dense(pre + "attn.proj", d, d) + norm(pre + "norm1", d)
            out += dense(pre + "mlp.fc1", ratio * d, d)
            out += dense(pre + "mlp.fc2", d, ratio * d)
            out += norm(pre + "norm2", d)
        if i < len(st) - 1:
            pre = f"layers.{i}.downsample."
            out += dense(pre + "reduction", 2 * d, 4 * d, bias=False)
            out += norm(pre + "norm", 2 * d)
    last = st[-1]["dim"]
    out += norm("norm", last) + dense("head", int(cfg["num_classes"]), last)
    return out


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    b, h, wd, c = x.shape
    x = x.view(b, h // w, w, wd // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(-1, w, w, c)


def window_reverse(windows: torch.Tensor, w: int, h: int,
                   wd: int) -> torch.Tensor:
    b = int(windows.shape[0] / (h * wd / w / w))
    x = windows.view(b, h // w, wd // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(b, h, wd, -1)


def attn_mask(side: int, w: int, shift: int) -> torch.Tensor:
    """The codebase's ``attn_mask`` of a rolled ``side x side`` map:
    ``(windows, w², w²)``, -100 between tokens of different regions of
    ``img_mask``."""
    img_mask = torch.zeros((1, side, side, 1))
    cnt = 0
    for hs in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
        for ws in (slice(0, -w), slice(-w, -shift), slice(-shift, None)):
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mask_windows = window_partition(img_mask, w).view(-1, w * w)
    mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return mask.masked_fill(mask != 0, -100.0).masked_fill(mask == 0, 0.0)


def coords_and_index(w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The codebase's ``relative_coords_table`` ((2w - 1)², 2) and
    ``relative_position_index`` (w², w²) of a window of ``w``."""
    rh = torch.arange(-(w - 1), w, dtype=torch.float32)
    table = torch.stack(torch.meshgrid([rh, rh], indexing="ij"))
    table = table.permute(1, 2, 0).contiguous()
    table[:, :, 0] /= (w - 1)
    table[:, :, 1] /= (w - 1)
    table *= 8
    table = torch.sign(table) * torch.log2(torch.abs(table) + 1.0) / math.log2(8)
    coords = torch.stack(torch.meshgrid([torch.arange(w), torch.arange(w)],
                                        indexing="ij"))
    flat = torch.flatten(coords, 1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += w - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return table.view(-1, 2), rel.sum(-1)


def _block(w, x, pre, s, shift, eps, cast):
    """One block on ``(B, L, C)``; ``shift`` 0 or half the window."""
    b, length, c = x.shape
    side, win, heads = s["side"], s["window"], s["heads"]
    hd = c // heads

    def dense(t, name, bias=True):
        return F.linear(cast(t), cast(w[name + ".weight"].float()),
                        w[name + ".bias"].float() if bias else None)

    def norm(t, name):
        return F.layer_norm(t, (c,), w[name + ".weight"].float(),
                            w[name + ".bias"].float(), eps)

    y = x.view(b, side, side, c)
    if shift:
        y = torch.roll(y, shifts=(-shift, -shift), dims=(1, 2))
    y = window_partition(y, win).view(-1, win * win, c)
    n, t = y.shape[:2]
    qkv_bias = torch.cat([w[pre + "attn.q_bias"].float(),
                          torch.zeros_like(w[pre + "attn.v_bias"].float()),
                          w[pre + "attn.v_bias"].float()])
    qkv = F.linear(cast(y), cast(w[pre + "attn.qkv.weight"].float()),
                   qkv_bias)
    q, k, v = qkv.reshape(n, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    attn = cast(F.normalize(q, dim=-1)) @ cast(F.normalize(k, dim=-1)
                                               ).transpose(-2, -1)
    scale = torch.clamp(w[pre + "attn.logit_scale"].float(),
                        max=math.log(1.0 / 0.01)).exp()
    attn = attn * scale
    table, index = coords_and_index(win)
    table, index = table.to(x.device), index.to(x.device)
    cpb = F.linear(cast(table), cast(w[pre + "attn.cpb_mlp.0.weight"].float()),
                   w[pre + "attn.cpb_mlp.0.bias"].float())
    cpb = F.linear(cast(torch.relu(cpb)),
                   cast(w[pre + "attn.cpb_mlp.2.weight"].float()))
    rpb = cpb[index.view(-1)].view(t, t, -1).permute(2, 0, 1).contiguous()
    attn = attn + 16 * torch.sigmoid(rpb).unsqueeze(0)
    if shift:
        mask = attn_mask(side, win, shift).to(x.device)
        nw = mask.shape[0]
        attn = attn.view(n // nw, nw, heads, t, t) + mask.unsqueeze(1)[None]
        attn = attn.view(-1, heads, t, t)
    attn = torch.softmax(attn, dim=-1)
    y = (cast(attn) @ cast(v)).transpose(1, 2).reshape(n, t, c)
    y = dense(y, pre + "attn.proj").view(-1, win, win, c)
    y = window_reverse(y, win, side, side)
    if shift:
        y = torch.roll(y, shifts=(shift, shift), dims=(1, 2))
    x = cast(x + norm(y.reshape(b, length, c), pre + "norm1"))
    h = F.gelu(dense(x, pre + "mlp.fc1"))
    return cast(x + norm(dense(h, pre + "mlp.fc2"), pre + "norm2"))


def _merge(w, x, pre, side, eps, cast):
    b, _, c = x.shape
    x = x.view(b, side, side, c)
    x = torch.cat([x[:, 0::2, 0::2, :], x[:, 1::2, 0::2, :],
                   x[:, 0::2, 1::2, :], x[:, 1::2, 1::2, :]], -1)
    x = F.linear(cast(x.view(b, -1, 4 * c)),
                 cast(w[pre + "reduction.weight"].float()))
    return cast(F.layer_norm(x, (2 * c,), w[pre + "norm.weight"].float(),
                             w[pre + "norm.bias"].float(), eps))


def features(w: Dict[str, torch.Tensor], frames: torch.Tensor, cfg: dict,
             cast: Callable[[torch.Tensor], torch.Tensor] = lambda t: t
             ) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` frames -> the mean token after the final
    LayerNorm, float32 ``(B, C)``: what the head reads."""
    eps = float(cfg["layer_norm_eps"])
    mean = torch.tensor(MEAN, device=frames.device)
    std = torch.tensor(STD, device=frames.device)
    x = (frames.float() / 255.0 - mean) / std
    x = F.conv2d(cast(x.permute(0, 3, 1, 2)),
                 cast(w["patch_embed.proj.weight"].float()),
                 w["patch_embed.proj.bias"].float(), int(cfg["patch_size"]))
    x = x.flatten(2).transpose(1, 2)
    c0 = x.shape[-1]
    x = cast(F.layer_norm(x, (c0,), w["patch_embed.norm.weight"].float(),
                          w["patch_embed.norm.bias"].float(), eps))
    recompute = torch.is_grad_enabled() and x.device.type != "meta"
    st = stages(cfg)
    for i, s in enumerate(st):
        for j in range(s["depth"]):
            shift = s["window"] // 2 if s["shift"] and j % 2 else 0
            args = (w, x, f"layers.{i}.blocks.{j}.", s, shift, eps, cast)
            x = (checkpoint(_block, *args, use_reentrant=False) if recompute
                 else _block(*args))
        if i < len(st) - 1:
            x = _merge(w, x, f"layers.{i}.downsample.", s["side"], eps, cast)
    c = x.shape[-1]
    x = F.layer_norm(x, (c,), w["norm.weight"].float(), w["norm.bias"].float(),
                     eps)
    return x.mean(1)


def forward(w: Dict[str, torch.Tensor], frames: torch.Tensor, cfg: dict,
            cast: Callable[[torch.Tensor], torch.Tensor] = lambda t: t
            ) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` frames -> float32 logits ``(B, classes)``."""
    x = features(w, frames, cfg, cast)
    return F.linear(cast(x), cast(w["head.weight"].float()),
                    w["head.bias"].float())


def leaves(tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The leaves a training check compares: every tensor, with each qkv
    projection as its q, k and v projections."""
    out = {}
    for name, t in tensors.items():
        if name.endswith(".attn.qkv.weight"):
            for part, piece in zip("qkv", t.chunk(3, dim=0)):
                out[f"{name}[{part}]"] = piece
        else:
            out[name] = t
    return out
