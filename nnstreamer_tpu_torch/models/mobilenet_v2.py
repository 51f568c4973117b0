"""MobileNetV2 image classifier — the flagship/benchmark model.

The PyTorch counterpart of ``nnstreamer_tpu/models/mobilenet_v2.py``:

- the same config table and channel rounding, so the same ``width``
  gives the same layer shapes;
- inference-mode BatchNorm over running stats (eps 1e-5, flax's default);
- bf16 on the card, f32 on the CPU; ``channels_last`` activations (NHWC
  in memory, the layout cuDNN's tensor-core convolutions prefer);
- ``forward`` keeps the JAX contract: a uint8 ``(H, W, 3)`` frame in,
  ``(logits_f32[num_classes],)`` out.  ``use_pallas`` routes the
  preprocessing through the hand-written normalize kernel
  (ops/preprocess.py); without it the frame is cast before it is scaled,
  the order of the JAX package's plain path;
- 1001-way logits (background + 1000 ImageNet classes).

Weights are deterministic random from ``custom=seed:N``, drawn from an
explicit ``torch.Generator`` (torch and JAX draw different numbers from
one seed: carry the JAX package's params over with
:func:`params_from_flax` where the two must agree).

flax ``padding="SAME"`` pads a stride-2 3x3 convolution over an even size
by (0, 1), not (1, 1); :class:`_SameConv2d` reproduces it exactly.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import DeviceLike, parse_dtype, resolve_device
from ..tensor.info import TensorInfo, TensorsInfo
from ..tensor.types import TensorType
from .registry import Model, register_model

# (expansion t, out channels c, repeats n, stride s) — standard V2 config
_INVERTED_RESIDUAL_CFG: Sequence[Tuple[int, int, int, int]] = (
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
)

_BN_EPS = 1e-5


class _SameConv2d(nn.Conv2d):
    """Bias-free convolution with TensorFlow/flax ``SAME`` padding: the
    output is ``ceil(n / stride)`` and the odd pixel of padding goes at
    the end (bottom/right)."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1) -> None:
        super().__init__(cin, cout, kernel, stride=stride, padding=0,
                         groups=groups, bias=False)

    @staticmethod
    def _pads(n: int, k: int, s: int) -> Tuple[int, int]:
        total = max((math.ceil(n / s) - 1) * s + k - n, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, s = self.kernel_size[0], self.stride[0]
        top, bottom = self._pads(x.shape[-2], k, s)
        left, right = self._pads(x.shape[-1], k, s)
        if top == bottom and left == right:
            return F.conv2d(x, self.weight, None, self.stride, (top, left),
                            1, self.groups)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, None, self.stride, 0, 1, self.groups)


class _ConvBN(nn.Module):
    """Conv → BatchNorm → ReLU6 (the JAX package's ``_ConvBN``)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 groups: int = 1) -> None:
        super().__init__()
        self.conv = _SameConv2d(cin, cout, kernel, stride, groups)
        self.bn = nn.BatchNorm2d(cout, eps=_BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.hardtanh(self.bn(self.conv(x)), 0.0, 6.0)


class _InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand: int) -> None:
        super().__init__()
        hidden = cin * expand
        self.expand = _ConvBN(cin, hidden, 1) if expand != 1 else None
        self.depthwise = _ConvBN(hidden, hidden, 3, stride, groups=hidden)
        self.project = _SameConv2d(hidden, cout, 1)
        self.project_bn = nn.BatchNorm2d(cout, eps=_BN_EPS)
        self.residual = stride == 1 and cin == cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = self.project_bn(self.project(self.depthwise(y)))
        return y + x if self.residual else y


class MobileNetV2(nn.Module):
    """MobileNetV2 classifier over one uint8 HWC frame."""

    def __init__(self, num_classes: int = 1001, width: float = 1.0,
                 dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False) -> None:
        super().__init__()

        def c(ch):
            return max(8, int(ch * width + 4) // 8 * 8)

        self.dtype = dtype
        self.use_pallas = use_pallas
        self.stem = _ConvBN(3, c(32), 3, 2)
        blocks: List[nn.Module] = []
        cin = c(32)
        for t, ch, n, s in _INVERTED_RESIDUAL_CFG:
            for i in range(n):
                blocks.append(_InvertedResidual(cin, c(ch), s if i == 0 else 1,
                                                t))
                cin = c(ch)
        self.blocks = nn.Sequential(*blocks)
        last = c(1280) if width > 1.0 else 1280
        self.head = _ConvBN(cin, last, 1)
        self.classifier = nn.Linear(last, num_classes)

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """x: NCHW in [-1, 1] in the model dtype → f32 logits (N, classes)."""
        x = self.head(self.blocks(self.stem(x)))
        x = x.mean(dim=(2, 3))          # global average pool
        return self.classifier(x).float()

    def preprocess(self, frame: torch.Tensor) -> torch.Tensor:
        """uint8 ``([B,] H, W, 3)`` → the same shape in [-1, 1], model
        dtype (one K1 launch for a whole batch)."""
        from ..ops.preprocess import cast_then_scale, normalize_frame

        if self.use_pallas:
            return normalize_frame(frame, dtype=self.dtype)
        return cast_then_scale(frame, self.dtype)

    def forward(self, frame: torch.Tensor) -> Tuple[torch.Tensor]:
        """frame: uint8 ``(H, W, 3)`` → ``(logits_f32[num_classes],)``; a
        batch ``(B, H, W, 3)`` → ``(logits_f32[B, num_classes],)``."""
        x = self.preprocess(frame)
        if frame.dim() == 3:
            # HWC → NCHW view whose memory is already channels_last
            return (self.logits(x.permute(2, 0, 1).unsqueeze(0))[0],)
        return (self.logits(x.permute(0, 3, 1, 2)),)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Deterministic random init (flax's defaults in kind: LeCun-normal
    kernels, zero biases, identity BatchNorm)."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                m.weight.normal_(0.0, 1.0 / math.sqrt(fan_in),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()


# ---------------------------------------------------------------------------
# flax → torch parameter map
# ---------------------------------------------------------------------------

def _conv_targets(prefix: str, path: Tuple[str, ...]):
    # HWIO → OIHW; depthwise (3,3,1,C) → (C,1,3,3) is the same transpose
    yield ("params",) + path + ("Conv_0", "kernel"), prefix + "weight", \
        (3, 2, 0, 1)


def _bn_targets(prefix: str, path: Tuple[str, ...]):
    yield ("params",) + path + ("BatchNorm_0", "scale"), prefix + "weight", None
    yield ("params",) + path + ("BatchNorm_0", "bias"), prefix + "bias", None
    yield ("batch_stats",) + path + ("BatchNorm_0", "mean"), \
        prefix + "running_mean", None
    yield ("batch_stats",) + path + ("BatchNorm_0", "var"), \
        prefix + "running_var", None


def _convbn_targets(prefix: str, path: Tuple[str, ...]):
    yield from _conv_targets(prefix + "conv.", path)
    yield from _bn_targets(prefix + "bn.", path)


def _targets(model: MobileNetV2) -> Iterator[Tuple[Tuple[str, ...], str, Any]]:
    """(flax leaf path, torch state_dict key, transpose) for every leaf,
    in the order flax auto-names the submodules."""
    yield from _convbn_targets("stem.", ("_ConvBN_0",))
    for i, blk in enumerate(model.blocks):
        path = (f"_InvertedResidual_{i}",)
        pre = f"blocks.{i}."
        n = 0
        if blk.expand is not None:
            yield from _convbn_targets(pre + "expand.",
                                       path + (f"_ConvBN_{n}",))
            n += 1
        yield from _convbn_targets(pre + "depthwise.",
                                   path + (f"_ConvBN_{n}",))
        yield from _conv_targets(pre + "project.", path)
        yield from _bn_targets(pre + "project_bn.", path)
    yield from _convbn_targets("head.", ("_ConvBN_1",))
    yield ("params", "Dense_0", "kernel"), "classifier.weight", (1, 0)
    yield ("params", "Dense_0", "bias"), "classifier.bias", None


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def params_from_flax(variables: Mapping, model: MobileNetV2
                     ) -> Dict[str, torch.Tensor]:
    """Map the JAX package's MobileNetV2 variables (``{"params": ...,
    "batch_stats": ...}``, leaves as numpy arrays) onto ``model``'s
    ``state_dict`` keys:

    - conv kernels HWIO → OIHW (depthwise ``(3,3,1,C)`` → ``(C,1,3,3)``);
    - Dense ``(in, out)`` → Linear ``(out, in)``;
    - BatchNorm ``scale``/``bias`` + ``batch_stats`` ``mean``/``var`` →
      ``weight``/``bias``/``running_mean``/``running_var``.

    Every flax leaf must be used exactly once, and every float tensor of
    the model's state must be filled: anything else raises."""
    leaves = _flatten(variables)
    state = model.state_dict()
    used = set()
    out: Dict[str, torch.Tensor] = {}
    for path, key, perm in _targets(model):
        if path not in leaves:
            raise KeyError(f"flax variables lack {'/'.join(path)}")
        if path in used or key in out:
            raise ValueError(f"{'/'.join(path)} mapped twice")
        used.add(path)
        arr = np.asarray(leaves[path], dtype=np.float32)
        if perm is not None:
            arr = arr.transpose(perm)
        want = tuple(state[key].shape)
        if arr.shape != want:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} != "
                             f"{key} {want}")
        out[key] = torch.tensor(arr)     # a copy: flax leaves may be read-only
    unused = set(leaves) - used
    if unused:
        raise ValueError("flax leaves left unmapped: "
                         + ", ".join("/".join(p) for p in sorted(unused)))
    missing = [k for k, v in state.items()
               if v.is_floating_point() and k not in out]
    if missing:
        raise ValueError(f"model state left unfilled: {missing}")
    return out


def load_flax(model: MobileNetV2, variables: Mapping) -> MobileNetV2:
    """Copy the JAX package's variables into ``model`` in place."""
    model.load_state_dict(params_from_flax(variables, model), strict=False)
    return model


# ---------------------------------------------------------------------------
# registry builder
# ---------------------------------------------------------------------------

def build_mobilenet_v2(custom_props: Dict[str, str],
                       device: DeviceLike = None) -> Model:
    from ..utils.conf import parse_bool

    device = resolve_device(device)
    seed = int(custom_props.get("seed", 0))
    num_classes = int(custom_props.get("num_classes", 1001))
    size = int(custom_props.get("input_size", 224))
    dtype = parse_dtype(custom_props.get("dtype"), device)
    use_pallas = parse_bool(custom_props.get("use_pallas", "0"))
    module = MobileNetV2(num_classes=num_classes, dtype=dtype,
                         use_pallas=use_pallas)
    init_weights(module, torch.Generator().manual_seed(seed))
    module = module.to(device=device, dtype=dtype,
                       memory_format=torch.channels_last).eval()
    in_info = TensorsInfo([TensorInfo(TensorType.UINT8, (3, size, size))])
    out_info = TensorsInfo([TensorInfo(TensorType.FLOAT32, (num_classes,))])
    return Model(name="mobilenet_v2", module=module, device=device,
                 in_info=in_info, out_info=out_info, batched=module)


register_model("mobilenet_v2")(build_mobilenet_v2)
