"""The training step of the ``swin_v2`` configurations, counted for their
readers: the biased window attention (``k2_bias_roofline_pct``,
``k34_bias_roofline_pct``, ``attn_bias_ms_per_step``) and the LayerNorms
(``ln_roofline_pct.swin``).  Each layer's shape at a cell's batch, the
least time of one call at it, and the traced calls cut into whole passes.

An attention layer attends within windows: ``windows`` rows of
``tokens`` tokens, ``heads`` heads of ``head_dim``, every row sharing one
f32 ``(heads, tokens, tokens)`` bias; a shifted layer also reads an int32
region label a token of each window of an image.  A least time is
``roofline.bound_s`` of the bytes a call must move and the operations it
must compute:

- forward: q, k, v read and out written once, the f32 log-sum-exp
  written, the bias and the labels read once; 4 x head dim operations a
  (query, key) pair;
- backward: K3 reads q, k, v, dO, the log-sum-exp and delta, the bias
  and the labels once and writes dq and dbias once, 6 x head dim a pair
  (s, dO.v, ds.k); K4 reads the same and writes dk and dv, 8 x head dim
  (s, dO.v, p.dO, ds.q).  The partials of dbias that a design sums are
  not counted.

A LayerNorm call is counted as ``ln_roofline_pct.train`` counts one, at
its own rows and width: the patch embedding's norm, two a block, each
patch merging's (twice the stage's width, a quarter of its rows) and the
final one.

A step launches a mechanism's forwards in layer order and its backwards
in the reverse order.  The traced window may open or close inside a step,
so the calls are cut into passes (a pass: a run of forward calls, or of
backward calls, in time order) and only a whole pass, one call of each
layer, is counted: it holds every layer once, whichever call is which.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

from . import roofline
from . import spec as bench_spec
from .readers import ITEMSIZE

#: a part of the name of every biased kernel; of the forward's; of the
#: backward's (K3, K4 and the partials' sum); of K3's; of K4's
KERNELS = ("flash_biased_",)
FORWARD = ("flash_biased_fwd",)
BACKWARD = ("flash_biased_bwd",)
K3 = ("flash_biased_bwd_dq",)
K4 = ("flash_biased_bwd_dkv",)
#: the LayerNorm kernels' forward; their backward and its partial sum;
#: the backward alone
NORM_FORWARD = ("layer_norm_fwd",)
NORM_BACKWARD = ("layer_norm_bwd", "layer_norm_param_sum")
NORM_K = ("layer_norm_bwd",)


def layers(cfg: dict, batch: int) -> List[dict]:
    """The attention layers of a step's forward, in order, at ``batch``
    images: windows, tokens, heads, head dim and the region labels read
    (0 where the layer does not roll)."""
    side = int(cfg["image_size"]) // int(cfg["patch_size"])
    out = []
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        s = side >> i
        w = min(int(cfg["window_size"]), s)
        per_image = (s // w) ** 2
        dim = int(cfg["embed_dim"]) << i
        for j in range(int(depth)):
            shifted = s > w and j % 2 == 1
            out.append({"windows": batch * per_image, "tokens": w * w,
                        "heads": int(heads), "head_dim": dim // int(heads),
                        "labels": per_image * w * w if shifted else 0})
    return out


def norms(cfg: dict, batch: int) -> List[Tuple[int, int]]:
    """The LayerNorms of a step's forward, in order, at ``batch`` images:
    (rows, width) of each."""
    side = int(cfg["image_size"]) // int(cfg["patch_size"])
    dim = int(cfg["embed_dim"])
    out = [(batch * side * side, dim)]
    stages = len(cfg["depths"])
    for i, depth in enumerate(cfg["depths"]):
        rows, width = batch * (side >> i) ** 2, dim << i
        out += [(rows, width)] * (2 * int(depth))
        if i < stages - 1:
            out.append((rows // 4, 2 * width))
    return out + [(batch * (side >> (stages - 1)) ** 2, dim << (stages - 1))]


def _fixed_bytes(layer: dict) -> int:
    """The bias and the region labels, read once."""
    t = layer["tokens"]
    return layer["heads"] * t * t * 4 + layer["labels"] * 4


def forward_least(layer: dict, dtype: str) -> Tuple[float, str]:
    """Least seconds of one biased forward call, and what binds it."""
    item = ITEMSIZE[dtype]
    n, t, h, d = (layer[k] for k in ("windows", "tokens", "heads",
                                     "head_dim"))
    nbytes = n * (4 * t * h * d * item + h * t * 4) + _fixed_bytes(layer)
    return roofline.bound_s(nbytes, 4.0 * d * n * h * t * t, item)


def backward_least(which: str, layer: dict, dtype: str
                   ) -> Tuple[float, str]:
    """Least seconds of one K3 (``which`` ``"dq"``, dbias among its
    outputs) or K4 (``"dkv"``) call, and what binds it."""
    item = ITEMSIZE[dtype]
    n, t, h, d = (layer[k] for k in ("windows", "tokens", "heads",
                                     "head_dim"))
    rows = 4 * t * h * d * item + 2 * h * t * 4
    out = (1 if which == "dq" else 2) * t * h * d * item
    nbytes = n * (rows + out) + _fixed_bytes(layer)
    if which == "dq":
        nbytes += h * t * t * 4
    per_pair = 6.0 if which == "dq" else 8.0
    return roofline.bound_s(nbytes, per_pair * d * n * h * t * t, item)


def norm_least_s(which: str, rows: int, width: int, dtype: str) -> float:
    """One LayerNorm forward (``"fwd"``) or backward (``"bwd"``) call,
    counted by ``ln_roofline_pct.train``."""
    vit = bench_spec.load_module(os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "metrics",
        "ln_roofline_pct.train.py"))
    return vit.least_s(which, rows, width, dtype)


def _has(name: str, parts: Sequence[str]) -> bool:
    return any(p in name for p in parts)


def whole_passes(window: dict, forward: Sequence[str],
                 backward: Sequence[str], counted: Sequence[str],
                 layers: int) -> List[Tuple[bool, int]]:
    """(forward or not, device nanoseconds) of each whole pass of a
    mechanism's traced calls (the module doc), in time order: a run of
    calls whose names hold a part of ``forward``, or of ``backward``, that
    holds ``layers`` forward calls, or ``layers`` calls of each part in
    ``counted``."""
    got = sorted((s, n, d) for n, s, d in window["kernels"]
                 if _has(n, forward) or _has(n, backward))
    runs: List[Tuple[bool, list]] = []
    for _, name, dur in got:
        ahead = _has(name, forward)
        if not runs or runs[-1][0] != ahead:
            runs.append((ahead, []))
        runs[-1][1].append((name, dur))
    out = []
    for ahead, calls in runs:
        kinds = [forward] if ahead else [(p,) for p in counted]
        if all(sum(_has(n, k) for n, _ in calls) == layers for k in kinds):
            out.append((ahead, sum(d for _, d in calls)))
    return out


def mean_pass_s(window: dict, forward: Sequence[str],
                backward: Sequence[str], counted: Sequence[str],
                layers: int) -> Tuple[Optional[float], Optional[float]]:
    """Mean device seconds of the window's whole forward passes and of its
    whole backward passes (``whole_passes``); None where it has none."""
    passes = whole_passes(window, forward, backward, counted, layers)
    out = []
    for ahead in (True, False):
        took = [ns for way, ns in passes if way == ahead]
        out.append(sum(took) / len(took) / 1e9 if took else None)
    return out[0], out[1]


def _attention(window: dict) -> Tuple[List[dict], str, Tuple]:
    """The cell's attention layers, its compute type, and the mean whole
    forward and backward passes of the biased kernels."""
    cfg = window["config"]
    ls = layers(cfg, int(window["traffic"]["batch"]))
    return (ls, cfg["train"]["compute_dtype"],
            mean_pass_s(window, FORWARD, BACKWARD, K3 + K4, len(ls)))


def forward_roofline_pct(window: dict) -> Optional[float]:
    """The biased forwards of a whole pass, each at its layer's shape,
    against the pass's device time, in percent."""
    ls, dtype, (fwd, _) = _attention(window)
    if fwd is None:
        return None
    return roofline.percent(sum(forward_least(x, dtype)[0] for x in ls),
                            fwd)


def backward_roofline_pct(window: dict) -> Optional[float]:
    """The biased K3 and K4 calls of a whole pass, each at its layer's
    shape, against the device time of every biased backward kernel of the
    pass (the partials' sums among them), in percent."""
    ls, dtype, (_, bwd) = _attention(window)
    if bwd is None:
        return None
    return roofline.percent(sum(backward_least(w, x, dtype)[0] for x in ls
                                for w in ("dq", "dkv")), bwd)


def ms_per_step(window: dict) -> Optional[float]:
    """Device milliseconds of the biased kernels a step: the mean whole
    forward pass plus the mean whole backward pass."""
    _, _, (fwd, bwd) = _attention(window)
    if fwd is None or bwd is None:
        return None
    return (fwd + bwd) * 1e3


def norm_roofline_pct(window: dict) -> Optional[float]:
    """The LayerNorm calls of a whole forward and a whole backward pass,
    each at its rows and width, against the device time of the mean whole
    pass of each (the backward's partial sums among it), in percent."""
    cfg = window["config"]
    ns = norms(cfg, int(window["traffic"]["batch"]))
    fwd, bwd = mean_pass_s(window, NORM_FORWARD, NORM_BACKWARD, NORM_K,
                           len(ns))
    if fwd is None or bwd is None:
        return None
    dtype = cfg["train"]["compute_dtype"]
    least = sum(norm_least_s(w, r, c, dtype) for r, c in ns
                for w in ("fwd", "bwd"))
    return roofline.percent(least, fwd + bwd)
