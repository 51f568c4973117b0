"""Vision Transformer classifier — the attention-based vision family.

The PyTorch counterpart of ``nnstreamer_tpu/models/vit.py``:

- ViT-S/16 by default (dim 384, depth 12, 6 heads x 64, patch 16, 1000
  classes); every knob is a ``custom=`` prop with the JAX package's
  grammar, including ``attn:flash|naive``;
- bf16 on the card, f32 on the CPU; ``forward`` keeps the JAX contract, a
  uint8 ``(H, W, 3)`` frame in and ``(logits_f32[num_classes],)`` out,
  with the preprocessing cast before it scales, as the JAX model does; a
  batch ``(B, H, W, 3)`` runs every attention layer as one kernel launch
  with the batch in its grid (the JAX package's ``jax.vmap``);
- a training form (``trainable``): f32 parameters with the compute dtype
  applied per call, as flax's ``Dense(dtype=...)`` does;
- attention runs the hand-written flash kernel (ops/flash_attention.py)
  for tensors on the card and plain attention off it, unless ``attn``
  says otherwise.  At T = 197 (196 patches + CLS) every frame exercises
  the kernel's ragged-tail masking.

Flax's numerics, kept here: LayerNorm with eps 1e-6 and the *fast*
variance E[x²] − E[x]² in f32, clipped at 0; GELU's tanh approximation;
the fused QKV projection split as (3, H, Dh); patch tokens in row-major
order of the NHWC convolution's output.

Weights are deterministic random from ``custom=seed:N``, drawn from an
explicit ``torch.Generator``; :func:`params_from_flax` carries the JAX
model's variables over where the two must agree.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, parse_dtype, resolve_device
from ..ops.layer_norm import layer_norm
from ..tensor.info import TensorInfo, TensorsInfo
from ..tensor.types import TensorType
from .registry import Model, register_model

_LN_EPS = 1e-6


class _LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: statistics in f32 with the fast variance,
    eps 1e-6 unless given, the result cast back to the input's dtype
    (ops/layer_norm.py: the hand-written kernels on the card, the plain
    expression on the CPU)."""

    def __init__(self, dim: int, eps: float = _LN_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class _Dense(nn.Linear):
    """flax ``Dense(dtype=...)``: the kernel and bias (where it has one)
    are cast to the compute dtype (the input's) at each call, so f32
    parameters train through a bf16 product and the gradient flows back
    through the cast.  The serving module's weights are already in that
    dtype: no cast."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class _Conv(nn.Conv2d):
    """flax ``Conv(dtype=...)`` with the same per-call cast."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype),
                        self.stride)


class _Attention(nn.Module):
    def __init__(self, dim: int, heads: int,
                 flash: Optional[bool] = None) -> None:
        super().__init__()
        self.heads = heads
        self.flash = flash
        self.qkv = _Dense(dim, 3 * dim)
        self.proj = _Dense(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``([B,] T, dim)``, one frame's tokens or a batch's; a batch
        is one kernel launch with the batch in the grid."""
        *lead, t, dim = x.shape
        qkv = self.qkv(x).reshape(*lead, t, 3, self.heads, dim // self.heads)
        # ([B,] T, H, D) views
        q, k, v = qkv[..., 0, :, :], qkv[..., 1, :, :], qkv[..., 2, :, :]
        flash = self.flash
        if flash is None:
            from ..ops.flash_attention import flash_wins

            flash = flash_wins(t, x)
        if flash:
            from ..ops.flash_attention import flash_attention

            attn = flash_attention(q, k, v, causal=False)
        else:
            from ..parallel.ring_attention import local_attention

            attn = local_attention(q, k, v, causal=False)
        return self.proj(attn.to(x.dtype).reshape(*lead, t, dim))


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: int = 4,
                 flash: Optional[bool] = None) -> None:
        super().__init__()
        self.ln1 = _LayerNorm(dim)
        self.attn = _Attention(dim, heads, flash)
        self.ln2 = _LayerNorm(dim)
        self.fc1 = _Dense(dim, mlp_ratio * dim)
        self.fc2 = _Dense(mlp_ratio * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        y = F.gelu(self.fc1(self.ln2(x)), approximate="tanh")
        return x + self.fc2(y)


class ViT(nn.Module):
    """ViT-S/16 by default."""

    def __init__(self, num_classes: int = 1000, patch: int = 16,
                 dim: int = 384, depth: int = 12, heads: int = 6,
                 input_size: int = 224, dtype: torch.dtype = torch.bfloat16,
                 flash: Optional[bool] = None) -> None:
        super().__init__()
        self.dtype = dtype
        n_tok = (input_size // patch) ** 2
        self.patch_embed = _Conv(3, dim, patch, stride=patch)
        self.cls = nn.Parameter(torch.zeros(1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(n_tok + 1, dim))
        self.blocks = nn.ModuleList(
            _Block(dim, heads, flash=flash) for _ in range(depth))
        self.norm = _LayerNorm(dim)
        self.head = _Dense(dim, num_classes)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x: ``([B,] H, W, 3)`` in [-1, 1], compute dtype → f32 logits
        ``([B,] num_classes)``."""
        batched = x.dim() == 4
        xb = x if batched else x[None]
        # NCHW convolution; flattening (h', w') row-major gives the NHWC
        # model's token order
        x = self.patch_embed(xb.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)          # (B, n_tok, dim)
        if not batched:
            x = x[0]                              # one frame: (n_tok, dim)
        cls = self.cls.to(x.dtype).expand(*x.shape[:-2], 1, x.shape[-1])
        x = torch.cat([cls, x], dim=-2)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.norm(x)[..., 0, :]).float()

    def forward(self, frame: torch.Tensor) -> Tuple[torch.Tensor]:
        """frame: uint8 ``(H, W, 3)`` → ``(logits_f32[num_classes],)``; a
        batch ``(B, H, W, 3)`` → ``(logits_f32[B, num_classes],)``."""
        from ..ops.preprocess import cast_then_scale

        return (self.logits(cast_then_scale(frame, self.dtype)),)


def init_weights(module: ViT, generator: torch.Generator) -> None:
    """Deterministic random init, flax's defaults in kind: LeCun-normal
    kernels, zero biases, identity LayerNorm, zero CLS, normal(0.02)
    position embedding."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                m.bias.zero_()
        module.pos_embed.normal_(0.0, 0.02, generator=generator)


# ---------------------------------------------------------------------------
# flax → torch parameter map
# ---------------------------------------------------------------------------

def _dense(path: Tuple[str, ...], key: str):
    yield ("params",) + path + ("kernel",), key + ".weight", (1, 0)
    yield ("params",) + path + ("bias",), key + ".bias", None


def _norm(path: Tuple[str, ...], key: str):
    yield ("params",) + path + ("scale",), key + ".weight", None
    yield ("params",) + path + ("bias",), key + ".bias", None


def _targets(model: ViT) -> Iterator[Tuple[Tuple[str, ...], str, object]]:
    """(flax leaf path, torch state_dict key, transpose) for every leaf."""
    yield ("params", "patch_embed", "kernel"), "patch_embed.weight", \
        (3, 2, 0, 1)                                       # HWIO → OIHW
    yield ("params", "patch_embed", "bias"), "patch_embed.bias", None
    yield ("params", "cls"), "cls", None
    yield ("params", "pos_embed"), "pos_embed", None
    for i in range(len(model.blocks)):
        blk, pre = (f"_Block_{i}",), f"blocks.{i}."
        yield from _norm(blk + ("LayerNorm_0",), pre + "ln1")
        yield from _dense(blk + ("_Attention_0", "qkv"), pre + "attn.qkv")
        yield from _dense(blk + ("_Attention_0", "proj"), pre + "attn.proj")
        yield from _norm(blk + ("LayerNorm_1",), pre + "ln2")
        yield from _dense(blk + ("Dense_0",), pre + "fc1")
        yield from _dense(blk + ("Dense_1",), pre + "fc2")
    yield from _norm(("LayerNorm_0",), "norm")
    yield from _dense(("head",), "head")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def params_from_flax(variables: Mapping, model: ViT
                     ) -> Dict[str, torch.Tensor]:
    """Map the JAX package's ViT variables (``{"params": ...}``, leaves as
    numpy arrays) onto ``model``'s ``state_dict`` keys: ``patch_embed``
    HWIO → OIHW, each Dense ``kernel (in, out)`` → ``Linear.weight (out,
    in)``, LayerNorm ``scale``/``bias`` → ``weight``/``bias``, ``cls`` and
    ``pos_embed`` as they are.  Every flax leaf must be used exactly once
    and every tensor of the model's state filled: anything else raises."""
    leaves = _flatten(variables)
    state = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for path, key, perm in _targets(model):
        if path not in leaves:
            raise KeyError(f"flax variables lack {'/'.join(path)}")
        arr = np.asarray(leaves.pop(path), dtype=np.float32)
        if perm is not None:
            arr = arr.transpose(perm)
        want = tuple(state[key].shape)
        if arr.shape != want:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                             f"{key} {want}")
        out[key] = torch.tensor(arr)     # a copy: flax leaves may be read-only
    if leaves:
        raise ValueError("flax leaves left unmapped: "
                         + ", ".join("/".join(p) for p in sorted(leaves)))
    missing = sorted(set(state) - set(out))
    if missing:
        raise ValueError(f"model state left unfilled: {missing}")
    return out


def load_flax(model: ViT, variables: Mapping) -> ViT:
    """Copy the JAX package's variables into ``model`` in place (cast to
    the model's dtype and device)."""
    model.load_state_dict(params_from_flax(variables, model))
    return model


# ---------------------------------------------------------------------------
# registry builder
# ---------------------------------------------------------------------------

def build_vit(custom_props: Dict[str, str], device: DeviceLike = None,
              trainable: bool = False) -> Model:
    """The registry model.  Serving (default): every weight but the
    LayerNorms' cast once to the compute dtype.  ``trainable``: the
    training form — f32 parameters (flax's) with the compute dtype applied
    per call, as the JAX package trains them; training the serving form's
    rounded bf16 weights would drift from it."""
    device = resolve_device(device)
    seed = int(custom_props.get("seed", 0))
    num_classes = int(custom_props.get("num_classes", 1000))
    size = int(custom_props.get("input_size", 224))
    dtype = parse_dtype(custom_props.get("dtype"), device)
    flash: Optional[bool] = None
    if "attn" in custom_props:    # attn:flash / attn:naive overrides
        flash = custom_props["attn"] == "flash"
    module = ViT(num_classes=num_classes,
                 patch=int(custom_props.get("patch", 16)),
                 dim=int(custom_props.get("dim", 384)),
                 depth=int(custom_props.get("depth", 12)),
                 heads=int(custom_props.get("heads", 6)),
                 input_size=size, dtype=dtype, flash=flash)
    init_weights(module, torch.Generator().manual_seed(seed))
    if trainable:
        module = module.to(device=device)
    else:
        module = module.to(device=device, dtype=dtype).eval()
        for m in module.modules():
            if isinstance(m, _LayerNorm):
                m.float()      # flax applies LayerNorm's params in f32
    in_info = TensorsInfo([TensorInfo(TensorType.UINT8, (3, size, size))])
    out_info = TensorsInfo([TensorInfo(TensorType.FLOAT32, (num_classes,))])
    return Model(name="vit", module=module, device=device,
                 in_info=in_info, out_info=out_info, batched=module)


register_model("vit", trainable=True)(build_vit)
