"""The yardstick against numbers worked out by hand: the kernels' bytes
and operations, the models' FLOPs, and the reduction of a device trace."""

from __future__ import annotations

import math
from types import SimpleNamespace

import pytest

from benchmark import flops, roofline, trace
from benchmark import spec as bench_spec

#: the held labeling cells' configurations are counted too
BENCH = bench_spec.Benchmark(held=True)
HBM, BF16 = 3.35e12, 989.4e12


def metric(name):
    return bench_spec.load_module(f"{BENCH.base}/metrics/{name}.py")


def test_k1_bucket_is_bound_by_its_bytes():
    # 32 frames of 224x224x3 uint8 read once, as many bf16 written once
    nbytes = 32 * 224 * 224 * 3 * (1 + 2)
    assert metric("k1_roofline_pct").least_s(32, 224, "bfloat16") == \
        pytest.approx(nbytes / HBM)


def test_k2_serving_call_at_vit_s16():
    b, t, h, d = 32, 197, 6, 64
    nbytes = b * 4 * t * h * d * 2         # q, k, v in, out written
    ops = 4 * d * b * h * t * t            # q.k and p.v
    want = max(nbytes / HBM, ops / BF16)
    assert want == nbytes / HBM            # bytes bind at T = 197
    assert metric("k2_roofline_pct.label").least_s(b, t, h, d, "bfloat16") \
        == pytest.approx(want)
    assert want * 1e3 == pytest.approx(0.005781, rel=1e-3)


def test_k2_training_call_counts_the_logsumexp():
    b, t, h, d = 32, 197, 6, 64
    nbytes = b * (4 * t * h * d * 2 + h * t * 4)
    assert metric("k2_roofline_pct.train").least_s(b, t, h, d, "bfloat16") \
        == pytest.approx(nbytes / HBM)


def test_k3_and_k4_at_vit_s16():
    b, t, h, d = 32, 197, 6, 64
    rows = 4 * t * h * d * 2 + 2 * h * t * 4     # q, k, v, dO, lse, delta
    k34 = metric("k34_roofline_pct")
    assert k34.least_s("dq", b, t, h, d, "bfloat16") == pytest.approx(
        b * (rows + t * h * d * 2) / HBM)
    assert k34.least_s("dkv", b, t, h, d, "bfloat16") == pytest.approx(
        b * (rows + 2 * t * h * d * 2) / HBM)


def test_f32_operations_take_the_faster_of_cuda_and_tensor_cores():
    ops = 1e12
    assert roofline.bound_s(0, ops, 4) == (3 * ops / roofline.TF32_FLOPS,
                                           "operations")
    assert roofline.percent(1.0, 0.0) is None


def _vit_flops(cfg, train):
    d, mlp, p = cfg["hidden_size"], cfg["intermediate_size"], \
        cfg["patch_size"]
    n = (cfg["image_size"] // p) ** 2
    t, layers, c = n + 1, cfg["num_hidden_layers"], cfg["num_classes"]
    fwd = 2 * n * 3 * p * p * d + 2 * d * c + layers * (
        2 * t * d * 3 * d + 2 * t * d * d + 2 * 2 * t * d * mlp
        + 2 * 2 * t * t * d)
    # the backward of a product is two products, the patch convolution's
    # less its frames' gradient, which no one asks for
    return fwd if not train else 3 * fwd - 2 * n * 3 * p * p * d


@pytest.mark.parametrize("train", [False, True])
def test_vit_s16_flops_by_hand(train):
    cfg = BENCH.cell("vit-label-b32")["config"]
    got = flops.count(cfg, 2, train)
    assert got == pytest.approx(_vit_flops(cfg, train), rel=1e-9)
    if not train:
        assert got == pytest.approx(9.2e9, rel=0.01)   # 4.6 GMACs


def test_mobilenet_v2_flops_by_hand():
    """The paper's 300M multiply-adds at 224 (1000 classes), and one more
    class's 1280."""
    cfg = BENCH.cell("mnv2-label-b32")["config"]
    got = flops.count(cfg, 2, False)
    assert got / 2 == pytest.approx(300.8e6 + 1280, rel=0.01)


def _ev(name, start, dur, cuda=False):
    return SimpleNamespace(
        name=lambda: name, start_ns=lambda: start, duration_ns=lambda: dur,
        device_type=lambda: "DeviceType.CUDA" if cuda else "DeviceType.CPU",
        is_user_annotation=lambda: False)


def test_trace_reduction_unions_kernels_and_names_the_gaps():
    events = [_ev("k_a", 100, 50, True), _ev("k_b", 120, 60, True),
              _ev("k_c", 400, 100, True), _ev("k_late", 2_000, 10, True),
              _ev("cudaGraphLaunch", 90, 5), _ev("cudaLaunchKernel", 95, 2),
              _ev("aten::item", 150, 300)]
    got = trace.reduce_events(events, 0, 1_000)
    assert got["busy_s"] == pytest.approx((80 + 100) / 1e9)
    assert got["window_s"] == pytest.approx(1e-6)
    assert got["host_calls"] == {"cudaGraphLaunch": 1, "cudaLaunchKernel": 1}
    assert [n for n, _ in got["breakdown"]["device_ops"]] == \
        ["k_c", "k_b", "k_a"]
    assert got["breakdown"]["idle_gaps"] == [["aten::item", 220 / 1e9]]
    assert trace.kernel_calls(got, ("k_a", "k_b")) == (2, 110 / 1e9)


def test_shares_of_a_trace_window():
    window = {"kernels": [("normalize_frame_kernel", 0, 10_000),
                          ("other_kernel", 0, 20_000)],
              "busy_s": 30e-6, "window_s": 100e-6, "frames": 64,
              "buckets": 2, "host_calls": {"cudaGraphLaunch": 2,
                                           "cudaMemcpyAsync": 6},
              "elements": {"filter": (3.0, 2), "src": (0.5, 64),
                           "out": (0.25, 64)},
              "traffic": {"batch": 32}, "config": BENCH.cell(
                  "mnv2-label-b32")["config"]}
    assert metric("device_idle_pct.label").read(window) == pytest.approx(70)
    assert metric("device_busy_us_per_frame").read(window) == \
        pytest.approx(30 / 64)
    assert metric("host_launches_per_bucket").read(window) == 4
    assert metric("filter_host_ms_per_bucket").read(window) == 1.5
    assert metric("pipeline_host_us_per_frame").read(window) == \
        pytest.approx(750 / 64)
    k1 = metric("k1_roofline_pct")
    assert k1.read(window) == pytest.approx(
        100 * k1.least_s(32, 224, "bfloat16") / 10e-6)
    assert metric("k2_roofline_pct.label").read(window) is None
    assert math.isclose(metric("mfu.label").read(window),
                        100 * 64 * flops.count(window["config"], 32, False)
                        / 100e-6 / BF16)
