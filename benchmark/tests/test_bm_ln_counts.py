"""The LayerNorm roofline reader against numbers worked out by hand: the
least bytes of a call at ViT-S/16's training shape, and the reduction of
a device trace window with and without the LayerNorm kernels."""

from __future__ import annotations

import pytest

from benchmark import spec as bench_spec

BENCH = bench_spec.Benchmark()
HBM = 3.35e12


def metric(name):
    return bench_spec.load_module(f"{BENCH.base}/metrics/{name}.py")


def test_layer_norm_least_bytes_at_vit_s16():
    """(32 x 197, 384) bf16 with f32 weight and bias: the forward reads x,
    the weight and the bias and writes y; the backward reads x, dy and
    the weight and writes dx, dweight and dbias."""
    ln = metric("ln_roofline_pct.train")
    act = 32 * 197 * 384 * 2                      # 4,841,472 B
    assert ln.least_bytes("fwd", 32 * 197, 384, "bfloat16") == \
        2 * act + 2 * 384 * 4 == 9_686_016
    assert ln.least_bytes("bwd", 32 * 197, 384, "bfloat16") == \
        3 * act + 3 * 384 * 4 == 14_529_024
    assert ln.least_s("fwd", 32 * 197, 384, "bfloat16") == pytest.approx(
        9_686_016 / HBM)


def test_layer_norm_roofline_of_a_trace_window():
    """Forward and backward calls counted apart by name, the partial sum's
    time counted with theirs; a window with no such kernel (a program
    without them) reads nothing."""
    ln = metric("ln_roofline_pct.train")
    cell = BENCH.cell("vit-train-b32")
    window = {"kernels": [
        ("void (anonymous namespace)::layer_norm_fwd_kernel<bf16, 8, 2>",
         0, 4_000),
        ("void (anonymous namespace)::layer_norm_bwd_kernel<bf16, 8, 2>",
         0, 6_000),
        ("void (anonymous namespace)::layer_norm_param_sum_kernel", 0,
         2_000),
        ("flash_bwd_dkv", 0, 50_000)],
        "traffic": cell["traffic"], "config": cell["config"]}
    least = (9_686_016 + 14_529_024) / HBM
    assert ln.read(window) == pytest.approx(100 * least / 12e-6)
    window["kernels"] = [("flash_bwd_dkv", 0, 50_000),
                         ("vectorized_elementwise_kernel", 0, 9_000)]
    assert ln.read(window) is None
