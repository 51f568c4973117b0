"""SwinV2 classifier: shifted-window cosine attention with a learned
continuous position bias (Liu et al. 2022, "Swin Transformer V2",
arXiv:2111.09883), as the Swin codebase builds it
(``github.com/microsoft/Swin-Transformer``, ``models/swin_transformer_v2.py``).

The default is SwinV2-B at window 16 and 256x256
(``configs/swinv2/swinv2_base_patch4_window16_256.yaml``): patch 4,
embedding 128, depths 2-2-18-2, heads 4-8-16-32 (head dim 32 throughout),
MLP ratio 4, 1000 classes.  ``custom=`` keys: ``dim``, ``depths`` and
``heads`` (dash lists, a number a stage), ``window``, ``patch``,
``input_size``, ``num_classes``, ``seed``, ``dtype``.

- frames: uint8 ``([B,] H, W, 3)`` RGB, normalised by ImageNet's mean and
  standard deviation as the codebase's transforms do, then cast to the
  compute dtype;
- a patch convolution and a LayerNorm, then stages of blocks, each stage
  but the last closed by patch merging (each 2x2 neighbourhood's tokens
  concatenated, ``Linear(4C, 2C)`` without bias, LayerNorm(2C));
- a block is res-post-norm: ``x + LN(attn(x))``, then ``x +
  LN(mlp(x))`` with the exact (erf) GELU;
- attention runs in windows of ``window x window`` tokens; every second
  block rolls the map by half a window first, and a pair of tokens from
  different regions of the rolled map is masked (-100).  Where a stage's
  map is no larger than the window, the window shrinks to the map and
  nothing rolls.  Scores are cosine similarities times a learned per-head
  scale ``exp(min(logit_scale, log 100))``, plus ``16 sigmoid`` of a
  bias that an MLP (``Linear(2, 512)``, ReLU, ``Linear(512, heads)``)
  makes from the log-spaced relative coordinates of the window's pairs;
  q and v projections have biases, k none;
- the final LayerNorm, the mean over tokens and a dense head.

On the card attention is the flash kernels' biased variant
(ops/flash_attention.py: the bias and the region labels go in, the
bias's gradient comes out), one launch a layer with every window of the
batch in its grid; no plain-attention route is taken there.  On the CPU
the same call takes the plain expression.  LayerNorms (eps 1e-5) are
ops/layer_norm.py's kernels.  The model has f32 parameters and applies
the compute dtype per call (the training form of ViT, models/vit.py);
the serving form is the same module in eval mode.  The position-bias MLP
runs in f32, so the kernels read the f32 bias it makes.

Weights are deterministic random from ``custom=seed:N`` (the codebase's
init in kind: truncated normal(0.02) dense kernels, zero biases, identity
LayerNorms, ``logit_scale`` log 10).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, parse_dtype, resolve_device
from ..ops.flash_attention import flash_attention
from ..tensor.info import TensorInfo, TensorsInfo
from ..tensor.types import TensorType
from .registry import Model, register_model
from .vit import _Conv, _Dense, _LayerNorm

_LN_EPS = 1e-5
#: the MLP's hidden width over the block's
MLP_RATIO = 4
#: the position-bias MLP's hidden width
CPB_HIDDEN = 512
#: the per-head scale's ceiling, log(1 / 0.01)
LOGIT_MAX = math.log(100.0)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def stage_list(value) -> Tuple[int, ...]:
    """A ``custom=`` dash list (``"4-8-16-32"``), a number a stage."""
    return tuple(int(p) for p in str(value).split("-"))


def window_partition(x: torch.Tensor, w: int) -> torch.Tensor:
    """``(B, H, W, C)`` -> ``(B H W / w², w², C)``: windows row-major in each
    image, tokens row-major in each window."""
    b, h, wd, c = x.shape
    x = x.view(b, h // w, w, wd // w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, w * w, c)


def window_reverse(x: torch.Tensor, w: int, h: int, wd: int) -> torch.Tensor:
    """The inverse of :func:`window_partition`: ``(B, H, W, C)``."""
    c = x.shape[-1]
    x = x.view(-1, h // w, wd // w, w, w, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, h, wd, c)


def relative_coords_table(w: int) -> torch.Tensor:
    """``((2w - 1)², 2)`` f32: each relative offset (dy, dx) of a w x w
    window, scaled to [-8, 8] and log-spaced, ``sign(t) log2(1 + |t|) /
    log2 8``."""
    r = torch.arange(-(w - 1), w, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), dim=-1)
    t = t / max(w - 1, 1) * 8.0
    return (torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8.0)
            ).reshape(-1, 2)


def relative_position_index(w: int) -> torch.Tensor:
    """``(w², w²)`` int64: the row of :func:`relative_coords_table` that
    holds token i's offset to token j."""
    ys, xs = torch.meshgrid(torch.arange(w), torch.arange(w), indexing="ij")
    ys, xs = ys.flatten(), xs.flatten()
    dy = ys[:, None] - ys[None, :] + (w - 1)
    dx = xs[:, None] - xs[None, :] + (w - 1)
    return dy * (2 * w - 1) + dx


def shift_regions(h: int, wd: int, w: int, shift: int) -> torch.Tensor:
    """``(windows, w²)`` int32 region labels of a map rolled by ``shift``:
    the codebase's ``img_mask`` (3 x 3 regions, cut at ``-w`` and
    ``-shift`` on each axis) partitioned into windows.  Two tokens of one
    window are masked where their labels differ."""
    def band(n):
        lab = torch.zeros(n, dtype=torch.int32)
        lab[n - w:] = 1
        lab[n - shift:] = 2
        return lab

    img = band(h)[:, None] * 3 + band(wd)[None, :]
    return window_partition(img[None, :, :, None], w)[..., 0].contiguous()


def _norm(dim: int) -> _LayerNorm:
    """LayerNorm over the last axis at SwinV2's eps, f32 scale and bias
    (ops/layer_norm.py: the kernels on the card)."""
    return _LayerNorm(dim, _LN_EPS)


class _PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int) -> None:
        super().__init__()
        self.proj = _Conv(3, dim, patch, stride=patch)
        self.norm = _norm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` -> ``(B, H W / patch², dim)``."""
        x = self.proj(x.permute(0, 3, 1, 2))
        return self.norm(x.flatten(2).transpose(1, 2))


class _WindowAttention(nn.Module):
    """Cosine attention over the windows of a batch with the continuous
    position bias and, where the map was rolled, the region mask."""

    def __init__(self, dim: int, heads: int, window: int) -> None:
        super().__init__()
        self.heads = heads
        self.tokens = window * window
        self.logit_scale = nn.Parameter(
            torch.full((heads, 1, 1), math.log(10.0)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, CPB_HIDDEN), nn.ReLU(),
                                     nn.Linear(CPB_HIDDEN, heads, bias=False))
        self.qkv = _Dense(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = _Dense(dim, dim)
        self.register_buffer("coords", relative_coords_table(window),
                             persistent=False)
        self.register_buffer("index", relative_position_index(window),
                             persistent=False)

    def position_bias(self) -> torch.Tensor:
        """``(heads, T, T)`` f32: ``16 sigmoid`` of the MLP's bias of each
        (query, key) pair's offset."""
        table = self.cpb_mlp(self.coords)                # ((2w-1)², heads)
        t = self.tokens
        b = table[self.index.reshape(-1)].reshape(t, t, self.heads)
        return 16.0 * torch.sigmoid(b.permute(2, 0, 1))

    def forward(self, x: torch.Tensor,
                regions: Optional[torch.Tensor]) -> torch.Tensor:
        """``(windows, T, dim)`` -> the same; ``regions`` ``(G, T)``, window
        b's labels in row b mod G, or None."""
        n, t, dim = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias),
                          self.v_bias])
        qkv = F.linear(x, self.qkv.weight.to(x.dtype), bias.to(x.dtype))
        qkv = qkv.reshape(n, t, 3, self.heads, dim // self.heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        tau = torch.clamp(self.logit_scale, max=LOGIT_MAX).exp()
        q = (F.normalize(q.float(), dim=-1) * tau.reshape(self.heads, 1)
             ).to(x.dtype)
        k = F.normalize(k.float(), dim=-1).to(x.dtype)
        out = flash_attention(q, k, v, scale=1.0, bias=self.position_bias(),
                              regions=regions)
        return self.proj(out.reshape(n, t, dim))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = _Dense(dim, hidden)
        self.fc2 = _Dense(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _Block(nn.Module):
    """A res-post-norm block over a ``side x side`` map: window attention
    (rolled by ``shift`` where it is not 0), then the MLP."""

    def __init__(self, dim: int, heads: int, side: int, window: int,
                 shift: int) -> None:
        super().__init__()
        if side <= window:          # the window shrinks to the map
            window, shift = side, 0
        if side % window:
            raise ValueError(f"swin_v2: a {side}x{side} map does not split "
                             f"into windows of {window}")
        self.side, self.window, self.shift = side, window, shift
        self.attn = _WindowAttention(dim, heads, window)
        self.norm1 = _norm(dim)
        self.mlp = _Mlp(dim, MLP_RATIO * dim)
        self.norm2 = _norm(dim)
        self.register_buffer(
            "regions", shift_regions(side, side, window, shift)
            if shift else None, persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, c = x.shape
        s, w = self.side, self.window
        y = x.view(b, s, s, c)
        if self.shift:
            y = torch.roll(y, (-self.shift, -self.shift), (1, 2))
        y = self.attn(window_partition(y, w), self.regions)
        y = window_reverse(y, w, s, s)
        if self.shift:
            y = torch.roll(y, (self.shift, self.shift), (1, 2))
        x = x + self.norm1(y.reshape(b, length, c))
        return x + self.norm2(self.mlp(x))


class _Merge(nn.Module):
    """Patch merging: each 2x2 neighbourhood's tokens concatenated (the
    codebase's order), ``Linear(4C, 2C)`` without bias, LayerNorm(2C)."""

    def __init__(self, dim: int, side: int) -> None:
        super().__init__()
        self.side = side
        self.reduction = _Dense(4 * dim, 2 * dim, bias=False)
        self.norm = _norm(2 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        x = x.view(b, self.side, self.side, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1).reshape(b, -1, 4 * c)
        return self.norm(self.reduction(x))


class _Stage(nn.Module):
    def __init__(self, dim: int, depth: int, heads: int, side: int,
                 window: int, merge: bool) -> None:
        super().__init__()
        self.blocks = nn.ModuleList(
            _Block(dim, heads, side, window, window // 2 if i % 2 else 0)
            for i in range(depth))
        self.downsample = _Merge(dim, side) if merge else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for blk in self.blocks:
            x = blk(x)
        return x if self.downsample is None else self.downsample(x)


class SwinV2(nn.Module):
    """SwinV2-B at window 16 and 256x256 by default (module doc)."""

    def __init__(self, num_classes: int = 1000, patch: int = 4,
                 dim: int = 128, depths: Sequence[int] = (2, 2, 18, 2),
                 heads: Sequence[int] = (4, 8, 16, 32), window: int = 16,
                 input_size: int = 256,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        if input_size % patch or (input_size // patch) % 2 ** (
                len(depths) - 1):
            raise ValueError(f"swin_v2: input_size {input_size} does not "
                             f"halve {len(depths) - 1} times after patches "
                             f"of {patch}")
        self.dtype = dtype
        self.patch_embed = _PatchEmbed(patch, dim)
        side = input_size // patch
        self.layers = nn.ModuleList()
        for i, (depth, h) in enumerate(zip(depths, heads)):
            self.layers.append(_Stage(dim << i, depth, h, side >> i, window,
                                      i < len(depths) - 1))
        width = dim << (len(depths) - 1)
        self.norm = _norm(width)
        self.head = _Dense(width, num_classes)
        self.register_buffer("mean", torch.tensor(IMAGENET_MEAN),
                             persistent=False)
        self.register_buffer("std", torch.tensor(IMAGENET_STD),
                             persistent=False)

    def logits(self, frames: torch.Tensor) -> torch.Tensor:
        """uint8 ``(B, H, W, 3)`` -> f32 logits ``(B, num_classes)``."""
        x = ((frames.float() * (1.0 / 255.0) - self.mean) / self.std
             ).to(self.dtype)
        x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x)
        return self.head(self.norm(x).mean(1)).float()

    def forward(self, frame: torch.Tensor) -> Tuple[torch.Tensor]:
        """frame: uint8 ``(H, W, 3)`` -> ``(logits_f32[num_classes],)``; a
        batch ``(B, H, W, 3)`` -> ``(logits_f32[B, num_classes],)``."""
        if frame.dim() == 3:
            return (self.logits(frame[None])[0],)
        return (self.logits(frame),)


def init_weights(module: SwinV2, generator: torch.Generator) -> None:
    """The codebase's init in kind: dense kernels normal(0.02) cut at two
    standard deviations, zero biases, identity LayerNorms; the patch
    convolution LeCun-normal."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                m.weight.clamp_(-0.04, 0.04)
                if m.bias is not None:
                    m.bias.zero_()
        w = module.patch_embed.proj.weight
        w.normal_(0.0, 1.0 / math.sqrt(w[0].numel()), generator=generator)
        module.patch_embed.proj.bias.zero_()


def build_swin_v2(custom_props: Dict[str, str], device: DeviceLike = None,
                  trainable: bool = False) -> Model:
    """The registry model: f32 parameters, the compute dtype per call (the
    default bf16 on the card, f32 on the CPU); serving is the same module
    in eval mode."""
    device = resolve_device(device)
    depths = stage_list(custom_props.get("depths", "2-2-18-2"))
    heads = stage_list(custom_props.get("heads", "4-8-16-32"))
    if len(heads) != len(depths):
        raise ValueError(f"swin_v2: heads {heads} and depths {depths} name "
                         f"different numbers of stages")
    size = int(custom_props.get("input_size", 256))
    num_classes = int(custom_props.get("num_classes", 1000))
    module = SwinV2(num_classes=num_classes,
                    patch=int(custom_props.get("patch", 4)),
                    dim=int(custom_props.get("dim", 128)), depths=depths,
                    heads=heads, window=int(custom_props.get("window", 16)),
                    input_size=size,
                    dtype=parse_dtype(custom_props.get("dtype"), device))
    init_weights(module, torch.Generator().manual_seed(
        int(custom_props.get("seed", 0))))
    module = module.to(device=device)
    if not trainable:
        module.eval()
    in_info = TensorsInfo([TensorInfo(TensorType.UINT8, (3, size, size))])
    out_info = TensorsInfo([TensorInfo(TensorType.FLOAT32, (num_classes,))])
    return Model(name="swin_v2", module=module, device=device,
                 in_info=in_info, out_info=out_info, batched=module)


register_model("swin_v2", trainable=True)(build_swin_v2)
