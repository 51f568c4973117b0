"""The arithmetic that per-layer readers of more than one kind of cell
share; each file under ``metrics/`` names its quantity, its unit of work
and its kernels, and calls these."""

from __future__ import annotations

from typing import Optional, Tuple

from . import flops, roofline
from .trace import kernel_calls

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def idle_pct(window) -> Optional[float]:
    """Share of the traced window in which no operation ran on the card
    (the union of the profiler's device intervals against the window's
    length on the host's clock), in percent."""
    if not window["kernels"] or window["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - window["busy_s"] / window["window_s"])


def device_seconds_per(window, unit: str) -> Optional[float]:
    """Device time of every traced operation over the ``unit``s (frames,
    steps) that ended in the window."""
    n = window.get(unit, 0)
    if not n or not window["kernels"]:
        return None
    return sum(d for _, _, d in window["kernels"]) / 1e9 / n


def host_calls_per(window, unit: str) -> Optional[float]:
    """Host calls that put work on the card over the ``unit``s (buckets,
    steps) of the window."""
    n = window.get(unit, 0)
    if not n:
        return None
    return sum(window["host_calls"].values()) / n


def mfu(window, unit: str, train: bool) -> Optional[float]:
    """``unit``s (frames, samples) done in the traced window times the
    reference model's FLOPs of one (forward; ``train``: forward and
    backward), over the window's seconds and the dense bf16 peak, in
    percent."""
    n = window.get(unit, 0)
    if not n or window["window_s"] <= 0:
        return None
    one = flops.count(window["config"], int(window["traffic"]["batch"]),
                      train=train)
    return 100.0 * n * one / window["window_s"] / roofline.BF16_FLOPS


def attention_shape(cfg: dict) -> Tuple[int, int, int]:
    """A ViT configuration's (tokens, heads, head dim)."""
    heads = int(cfg["num_attention_heads"])
    tokens = (int(cfg["image_size"]) // int(cfg["patch_size"])) ** 2 + 1
    return tokens, heads, int(cfg["hidden_size"]) // heads


def k2_least_s(batch: int, tokens: int, heads: int, head_dim: int,
               dtype: str, lse: bool) -> float:
    """Least time of one flash-attention forward with no causal mask: q,
    k and v read once, the output (``lse``: and the float32 log-sum-exp
    a row) written once; 4 x head dim operations a (query, key) pair."""
    item = ITEMSIZE[dtype]
    nbytes = batch * (4 * tokens * heads * head_dim * item
                      + (heads * tokens * 4 if lse else 0))
    ops = 4.0 * head_dim * batch * heads * tokens * tokens
    return roofline.bound_s(nbytes, ops, item)[0]


def k2_roofline_pct(window, kernels, dtype: str, lse: bool
                    ) -> Optional[float]:
    """The traced calls of the K2 ``kernels`` (parts of their names)
    against as many least times at the cell's batch and the
    configuration's attention shape, in percent."""
    calls, took = kernel_calls(window, kernels)
    if not calls:
        return None
    one = k2_least_s(int(window["traffic"]["batch"]),
                     *attention_shape(window["config"]), dtype, lse)
    return roofline.percent(calls * one, took)
