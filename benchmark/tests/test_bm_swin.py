"""The SwinV2 cell's counting (``benchmark/swin.py`` and the readers of
the biased flash kernels and of its LayerNorms) against numbers worked
out by hand, and the cell at a tiny size through the harness on the
CPU."""

from __future__ import annotations

import pytest

from benchmark import swin as ba
from benchmark import roofline
from benchmark import spec as bench_spec
from benchmark import train
from benchmark.tests.conftest import add_cell, copy_benchmark

BENCH = bench_spec.Benchmark()
CELL = BENCH.cell("swinv2-train-b128")
HBM = 3.35e12
BF16 = 989.4e12


def metric(name):
    return bench_spec.load_module(f"{BENCH.base}/metrics/{name}.py")


def test_layers_of_swinv2_b_at_batch_128():
    """SwinV2-B's stages: stage 1 64 x 64 in 16 windows of 256 tokens, 4 x
    32 heads; stage 2 4 windows, 8 heads; stage 3 one window, 16 heads, 18
    layers; stage 4 one window of 64 tokens, 32 heads; the odd blocks of
    stages 1 and 2 rolled (labels of their 16 and 4 windows)."""
    ls = ba.layers(CELL["config"], 128)
    assert len(ls) == 24
    shape = [(x["windows"], x["tokens"], x["heads"], x["head_dim"])
             for x in ls]
    assert shape == ([(2048, 256, 4, 32)] * 2 + [(512, 256, 8, 32)] * 2
                     + [(128, 256, 16, 32)] * 18 + [(128, 64, 32, 32)] * 2)
    assert [x["labels"] for x in ls] == ([0, 16 * 256, 0, 4 * 256]
                                         + [0] * 20)


def test_forward_least_time_at_stage_1():
    """(2048 windows, 256, 4, 32) bf16: q, k, v, out 4 x 2048 x 256 x 128 x
    2 bytes, lse 2048 x 4 x 256 x 4, the bias 4 x 256² x 4 and the labels
    16 x 256 x 4 once, which bind (at head dim 32 a pair's 4 x 32
    operations do not outweigh its bytes); 4 x 32 x 2048 x 4 x 256²
    operations."""
    layer = ba.layers(CELL["config"], 128)[1]
    nbytes = (4 * 2048 * 256 * 128 * 2 + 2048 * 4 * 256 * 4
              + 4 * 256 * 256 * 4 + 16 * 256 * 4)
    ops = 4.0 * 32 * 2048 * 4 * 256 * 256
    assert roofline.bound_s(nbytes, ops, 2)[1] == "bytes"
    assert ba.forward_least(layer, "bfloat16")[0] == pytest.approx(
        nbytes / HBM)
    # stage 4: 64 tokens, bytes bind
    last = ba.layers(CELL["config"], 128)[-1]
    nbytes = (128 * (4 * 64 * 1024 * 2 + 32 * 64 * 4) + 32 * 64 * 64 * 4)
    assert ba.forward_least(last, "bfloat16")[0] == pytest.approx(
        max(nbytes / HBM, 4.0 * 32 * 128 * 32 * 64 * 64 / BF16))


def test_backward_least_time_counts_dbias_once_in_k3():
    layer = {"windows": 10, "tokens": 64, "heads": 2, "head_dim": 32,
             "labels": 0}
    rows = 4 * 64 * 2 * 32 * 2 + 2 * 2 * 64 * 4
    dq = 10 * (rows + 64 * 2 * 32 * 2) + 2 * 64 * 64 * 4 * 2
    dkv = 10 * (rows + 2 * 64 * 2 * 32 * 2) + 2 * 64 * 64 * 4
    assert ba.backward_least("dq", layer, "bfloat16")[0] == pytest.approx(
        max(dq / HBM, 6.0 * 32 * 10 * 2 * 64 * 64 / BF16))
    assert ba.backward_least("dkv", layer, "bfloat16")[0] == pytest.approx(
        max(dkv / HBM, 8.0 * 32 * 10 * 2 * 64 * 64 / BF16))


def _step(t, n, fwd_us=50, dq_us=60, dkv_us=70, sum_us=5):
    """One step's biased calls from ``t`` ns on: each of the ``n``
    layers' forward in order, then each layer's K3, partials' sum and K4
    in reverse order."""
    out = []
    for _ in range(n):
        out.append(("void (anonymous namespace)::flash_biased_fwd_"
                    "kernel<__nv_bfloat16, 32>", t, fwd_us * 1000))
        t += 100_000
    out.append(("void at::native::elementwise_kernel", t, 9_000))
    for _ in range(n):
        for name, us in (("flash_biased_bwd_dq_kernel", dq_us),
                         ("flash_biased_bwd_dbias_sum_kernel", sum_us),
                         ("flash_biased_bwd_dkv_kernel", dkv_us)):
            out.append((f"void (anonymous namespace)::{name}<b, 32>", t,
                        us * 1000))
            t += 100_000
    return out, t


def _window(steps, **us):
    """A traced window of ``steps`` whole steps."""
    kernels, t = [], 0
    n = len(ba.layers(CELL["config"], 128))
    for _ in range(steps):
        got, t = _step(t, n, **us)
        kernels += got
    return {"kernels": kernels, "units": steps, "traffic": CELL["traffic"],
            "config": CELL["config"]}


def test_readers_of_a_trace_window():
    """A whole pass holds each layer once; the partials' sum in the
    backward's time; a window with no biased kernel (a program without
    them) reads nothing."""
    ls = ba.layers(CELL["config"], 128)
    w = _window(2)
    fwd = sum(ba.forward_least(x, "bfloat16")[0] for x in ls)
    assert metric("k2_bias_roofline_pct").read(w) == pytest.approx(
        100 * fwd / (24 * 50e-6))
    bwd = sum(ba.backward_least("dq", x, "bfloat16")[0]
              + ba.backward_least("dkv", x, "bfloat16")[0] for x in ls)
    assert metric("k34_bias_roofline_pct").read(w) == pytest.approx(
        100 * bwd / (24 * 135e-6))
    assert metric("attn_bias_ms_per_step").read(w) == pytest.approx(
        24 * (50 + 135) / 1000)
    parent = {"kernels": [("flash_forward_tc_kernel", 0, 5_000),
                          ("flash_bwd_dq_tc_kernel", 0, 5_000)],
              "units": 2, "traffic": CELL["traffic"],
              "config": CELL["config"]}
    for name in ("k2_bias_roofline_pct", "k34_bias_roofline_pct",
                 "attn_bias_ms_per_step", "ln_roofline_pct.swin"):
        assert metric(name).read(parent) is None


@pytest.mark.parametrize("cut", [3, 24 + 7 * 3 + 1, 24 + 24 * 3 + 5])
def test_a_window_that_opens_and_closes_inside_a_step(cut):
    """A window that opens ``cut`` calls into a step (mid-forward,
    mid-backward, mid-forward of the next step) and closes inside another
    reads as the whole passes alone: stage 1's slow calls cut off at the
    start or the end move nothing."""
    n = len(ba.layers(CELL["config"], 128))
    kernels, t = [], 0
    for _ in range(4):
        # stage 1's calls (the first two layers) take four times as long
        got, t = _step(t, n)
        kernels += [(k, s, d * 4 if j < 2 or j >= len(got) - 6 else d)
                    for j, (k, s, d) in enumerate(got)]
    whole = {"kernels": kernels, "units": 4, "traffic": CELL["traffic"],
             "config": CELL["config"]}
    calls = [k for k in kernels if "flash_biased" in k[0]]
    first, last = calls[cut], calls[-cut]
    cut_w = dict(whole, kernels=[k for k in kernels
                                 if first[1] <= k[1] <= last[1]], units=3)
    for name in ("k2_bias_roofline_pct", "k34_bias_roofline_pct",
                 "attn_bias_ms_per_step"):
        assert metric(name).read(cut_w) == pytest.approx(
            metric(name).read(whole))
    passes = ba.whole_passes(cut_w, ba.FORWARD, ba.BACKWARD, ba.K3 + ba.K4,
                             n)
    assert 2 <= len(passes) < len(ba.whole_passes(
        whole, ba.FORWARD, ba.BACKWARD, ba.K3 + ba.K4, n))


def test_the_shares_stay_below_100_at_the_least_times():
    """A trace whose calls take exactly their least times reads 100 %."""
    ls = ba.layers(CELL["config"], 128)
    kernels = [("flash_biased_fwd_kernel", i,
                int(round(ba.forward_least(x, "bfloat16")[0] * 1e9)))
               for i, x in enumerate(ls)]
    w = {"kernels": kernels, "units": 1, "traffic": CELL["traffic"],
         "config": CELL["config"]}
    assert metric("k2_bias_roofline_pct").read(w) == pytest.approx(100,
                                                                   rel=1e-3)


def test_norms_of_swinv2_b_at_batch_128():
    """The patch embedding's norm (64² tokens, 128 wide), two a block at
    each stage's rows and width, each merging's at a quarter of the rows
    and twice the width, and the final one (8² tokens, 1024 wide): 53."""
    ns = ba.norms(CELL["config"], 128)
    b = 128
    want = ([(b * 4096, 128)] * 5 + [(b * 1024, 256)] * 5
            + [(b * 256, 512)] * 37 + [(b * 64, 1024)] * 6)
    assert ns == want
    assert sorted({c for _, c in ns}) == [128, 256, 512, 1024]


def test_the_norm_reader_counts_each_call_at_its_width():
    """A forward pass of the 53 norms, then their backward (each with its
    partial sum), twice, and a cut-off pass at each end: each call's
    bytes (``ln_roofline_pct.train``'s count) at its own shape over the
    whole passes' time."""
    ns = ba.norms(CELL["config"], 128)
    kernels, t = [("layer_norm_bwd_kernel", -50, 7_000)], 0
    for _ in range(2):
        for _ in ns:
            kernels.append(("layer_norm_fwd_kernel<bf16>", t, 20_000))
            t += 1_000
        for _ in ns:
            kernels += [("layer_norm_bwd_kernel<bf16>", t, 30_000),
                        ("layer_norm_param_sum_kernel", t + 1, 2_000)]
            t += 1_000
    kernels.append(("layer_norm_fwd_kernel<bf16>", t, 20_000))
    w = {"kernels": kernels, "traffic": CELL["traffic"],
         "config": CELL["config"]}
    least = 0
    for rows, width in ns:
        act = rows * width * 2
        least += (2 * act + 2 * width * 4 + 3 * act + 3 * width * 4) / HBM
    took = len(ns) * (20e-6 + 32e-6)
    assert metric("ln_roofline_pct.swin").read(w) == pytest.approx(
        100 * least / took)


def test_a_tiny_swin_cell_is_correct_through_the_harness(tmp_path):
    """SwinV2 at a tiny size (stage 1 rolled, stage 2 one window) trained
    through ``appsrc ! tensor_trainer`` on the CPU, held to the reference
    by the cell's own limits."""
    root = copy_benchmark(str(tmp_path))
    add_cell(root, "swin-tiny-train", "swin-tiny", "train-b128",
             "swinv2-b-w16-256",
             {"embed_dim": 32, "depths": [2, 2], "num_heads": [2, 4],
              "window_size": 4, "image_size": 32, "num_classes": 10},
             "dim:32,depths:2-2,heads:2-4,window:4,patch:4,input_size:32,"
             "num_classes:10")
    cell = bench_spec.Benchmark(root=root).cell("swin-tiny-train")
    cell["traffic"]["batch"] = 8
    out = train.run(cell, 2 ** 31 + 77, 0.5, False, "cpu", 0.0)
    assert out["correct"], out["checks"]
    assert out["checks"]["loss_gap"]["value"] <= 1e-5
    # a step ran in the window; whether it ended there depends on the
    # host's load (a tiny CPU step took 1.2-2.3 s beside other tests)
    assert out["attempted"] >= 8
    assert out["end_to_end"]["train_samples_per_s"] >= 0
