"""MobileNetV2 (Sandler et al. 2018, arXiv:1801.04381) in plain PyTorch.

The benchmark's reference for the ``mobilenet_v2`` configurations: the
forward pass of the published architecture written out in float32 from
the paper and the TF-slim ``mobilenet_v2_1.0_224`` definition, with no
kernel, batching or cache of the program under test.

- the stem, a 3x3 stride-2 convolution of 32 channels; the inverted
  residual stages ``(t, c, n, s)`` of Table 2; a 1x1 convolution to 1280
  channels; global average pooling and a dense layer to the classes;
- every convolution bias-free and followed by BatchNorm over running
  statistics, ReLU6 after all but the projection of each block, a
  residual where a block keeps its stride 1 and its channels;
- TensorFlow's ``SAME`` padding: an even input size pads a stride-2
  convolution by one pixel at the end, not one on each side;
- the frame, uint8 RGB, scaled to [-1, 1] as ``x / 127.5 - 1``.

Departures, as the configuration file states them: BatchNorm's epsilon is
the configuration's (``batch_norm_eps``), not TF-slim's 0.001.

Weights are a flat mapping of name -> tensor with the names of PyTorch's
own ``Conv2d``/``BatchNorm2d``/``Linear`` state; :func:`spec` lists them
with their shapes and how the benchmark draws them.  ``cast`` is applied
to both operands of every convolution and of the dense layer, and to the
sum of each residual: the identity for the reference, a lower precision
for the control.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterator, List, Tuple

import torch
import torch.nn.functional as F

#: (expansion t, output channels c, repeats n, first stride s), Table 2
STAGES = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
          (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


def _channels(ch: int, width: float) -> int:
    """The slim rounding of ``ch * width`` to a multiple of 8."""
    return max(8, int(ch * width + 4) // 8 * 8)


def _blocks(cfg: dict) -> Iterator[Tuple[int, int, int, int, int]]:
    """(index, in channels, out channels, stride, expansion) of each
    inverted residual block."""
    width = float(cfg["width_multiplier"])
    cin, i = _channels(32, width), 0
    for t, c, n, s in STAGES:
        for r in range(n):
            cout = _channels(c, width)
            yield i, cin, cout, s if r == 0 else 1, t
            cin, i = cout, i + 1


def _last(cfg: dict) -> int:
    width = float(cfg["width_multiplier"])
    return _channels(1280, width) if width > 1.0 else 1280


def spec(cfg: dict) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, draw) of every tensor.  ``draw``: ``("normal", std)``
    (He's std before a ReLU6, LeCun's otherwise), ``("uniform", lo,
    hi)`` or ``("zeros",)``; BatchNorm's statistics are drawn near the
    identity so that the forward neither explodes nor vanishes."""
    out: List[Tuple[str, tuple, tuple]] = []

    def conv(name, cout, cin_group, k, relu):
        fan_in = cin_group * k * k
        out.append((name, (cout, cin_group, k, k),
                    ("normal", math.sqrt((2.0 if relu else 1.0) / fan_in))))

    def bn(prefix, c):
        out.extend([(f"{prefix}.weight", (c,), ("uniform", 0.8, 1.2)),
                    (f"{prefix}.bias", (c,), ("uniform", -0.1, 0.1)),
                    (f"{prefix}.running_mean", (c,), ("uniform", -0.1, 0.1)),
                    (f"{prefix}.running_var", (c,), ("uniform", 0.8, 1.2)),
                    (f"{prefix}.num_batches_tracked", (), ("zeros",))])

    width = float(cfg["width_multiplier"])
    stem = _channels(32, width)
    conv("stem.conv.weight", stem, 3, 3, True)
    bn("stem.bn", stem)
    cin = stem
    for i, cin, cout, _, t in _blocks(cfg):
        hidden = cin * t
        if t != 1:
            conv(f"blocks.{i}.expand.conv.weight", hidden, cin, 1, True)
            bn(f"blocks.{i}.expand.bn", hidden)
        conv(f"blocks.{i}.depthwise.conv.weight", hidden, 1, 3, True)
        bn(f"blocks.{i}.depthwise.bn", hidden)
        conv(f"blocks.{i}.project.weight", cout, hidden, 1, False)
        bn(f"blocks.{i}.project_bn", cout)
        cin = cout
    last = _last(cfg)
    conv("head.conv.weight", last, cin, 1, True)
    bn("head.bn", last)
    classes = int(cfg["num_classes"])
    out.append(("classifier.weight", (classes, last),
                ("normal", 1.0 / math.sqrt(last))))
    out.append(("classifier.bias", (classes,), ("uniform", -0.1, 0.1)))
    return out


def _same(n: int, k: int, s: int) -> Tuple[int, int]:
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def features(w: Dict[str, torch.Tensor], frames: torch.Tensor, cfg: dict,
             cast: Callable[[torch.Tensor], torch.Tensor] = lambda t: t,
             calibrating: bool = False) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` frames -> the pooled float32 features
    ``(B, last channels)`` the classifier reads.  ``calibrating``: each
    BatchNorm first sets its running mean, in place in ``w``, to its
    input's over the batch (see :func:`calibrate`)."""
    eps = float(cfg["batch_norm_eps"])

    def conv(x, name, stride=1, groups=1):
        weight = w[name].float()
        k = weight.shape[-1]
        top, bottom = _same(x.shape[-2], k, stride)
        left, right = _same(x.shape[-1], k, stride)
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(cast(x), cast(weight), None, stride, 0, 1, groups)

    def bn(x, prefix):
        if calibrating:
            w[f"{prefix}.running_mean"].copy_(x.mean(dim=(0, 2, 3)))
        mean = w[f"{prefix}.running_mean"].float()[:, None, None]
        var = w[f"{prefix}.running_var"].float()[:, None, None]
        gamma = w[f"{prefix}.weight"].float()[:, None, None]
        beta = w[f"{prefix}.bias"].float()[:, None, None]
        return (x - mean) * torch.rsqrt(var + eps) * gamma + beta

    def relu6(x):
        return x.clamp(0.0, 6.0)

    x = frames.float() * (1.0 / 127.5) - 1.0
    x = x.permute(0, 3, 1, 2)
    x = relu6(bn(conv(x, "stem.conv.weight", 2), "stem.bn"))
    for i, cin, cout, stride, t in _blocks(cfg):
        y = x
        if t != 1:
            y = relu6(bn(conv(y, f"blocks.{i}.expand.conv.weight"),
                         f"blocks.{i}.expand.bn"))
        y = relu6(bn(conv(y, f"blocks.{i}.depthwise.conv.weight", stride,
                          groups=y.shape[1]), f"blocks.{i}.depthwise.bn"))
        y = bn(conv(y, f"blocks.{i}.project.weight"), f"blocks.{i}.project_bn")
        x = cast(y + x) if stride == 1 and cin == cout else y
    x = relu6(bn(conv(x, "head.conv.weight"), "head.bn"))
    return x.mean(dim=(2, 3))


def forward(w: Dict[str, torch.Tensor], frames: torch.Tensor, cfg: dict,
            cast: Callable[[torch.Tensor], torch.Tensor] = lambda t: t
            ) -> torch.Tensor:
    """uint8 ``(B, H, W, 3)`` frames -> float32 logits ``(B, classes)``."""
    x = features(w, frames, cfg, cast)
    return F.linear(cast(x), cast(w["classifier.weight"].float()),
                    w["classifier.bias"].float())


def calibrate(w: Dict[str, torch.Tensor], frames: torch.Tensor,
              cfg: dict) -> None:
    """BatchNorm's running means measured on ``frames`` in one pass, as
    training leaves them: each layer's from its input over the batch,
    after the layers before it are set (the stored values, in ``w``'s
    types, are those the next layers see); the variances stay as drawn.
    A deep random network whose means are drawn drifts to one common
    activation that swamps what tells frames apart, and labels nearly
    every frame alike (2-4 classes over 256 scenes); with its data's
    means removed it labels them 3-9 ways, and without turning chaotic, as
    it does when the variances are measured too (rounding at bfloat16
    then flips a fifth of the labels)."""
    with torch.no_grad():
        features(w, frames, cfg, calibrating=True)
