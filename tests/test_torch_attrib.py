"""The port's wait-state attribution and profiler (``obs/attrib.py``,
``obs/profile.py``) against the JAX package's.

Host logic is compared exactly: the same seeded synthetic span lists go
through both packages' engines and must give equal per-frame
attributions, blame reports and folded stacks.  The port's cost counter
(a meta-device pass; XLA's ``cost_analysis`` has no torch counterpart)
is held to the closed-form 2 x MAC count of a narrow MobileNetV2 and of
the MLP.  Live pipelines of the port conserve time per frame (state sums
equal end-to-end wall time) on the same paths the JAX package's own
tests pin, and name the same states.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nnstreamer_tpu.obs import attrib as jax_attrib
from nnstreamer_tpu.obs.span import Span as JaxSpan
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.models.registry import (_MODELS, Model, get_model,
                                                  register_model)
from nnstreamer_tpu_torch.obs import attrib
from nnstreamer_tpu_torch.obs.metrics import REGISTRY
from nnstreamer_tpu_torch.obs.profile import Profiler, attribution_block
from nnstreamer_tpu_torch.obs.span import Span
from nnstreamer_tpu_torch.pipeline.graph import Pipeline
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsInfo
from nnstreamer_tpu_torch.tensor.types import TensorType

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
         "types=float32,framerate=0/1")
#: conservation tolerance: attribution partitions integer-ns intervals
#: exactly; 1 µs a frame is generous
TOL_NS = 1_000
#: JAX MobileNetV2's inverted-residual table, for the closed form
MBV2_CFG = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))


# ---------------------------------------------------------------------------
# seeded synthetic span lists, built in both packages
# ---------------------------------------------------------------------------

NAMES = ("src_el", "conv", "filt", "q", "qc", "out", "state:serialize",
         "state:device-invoke", "state:queue-wait", "state:reorder-wait",
         "filt:invoke")
STATES = {"src_el": "element-compute", "conv": "element-compute",
          "filt": "element-compute", "q": "queue-wait", "qc": "wire",
          "out": "sink", "filt:invoke": "element-compute"}
TRANSIT = {"out": "queue-wait"}


def synthetic_spans(seed: int, frames: int = 12):
    """(name, tid, start_ns, dur_ns, seq, trace_id) rows: per frame a
    birth marker and nested/overlapping element and state spans, a few
    off-frame (seq -1) annotations, and with seed % 3 == 0 one colliding
    multi-source seq."""
    rng = np.random.default_rng(seed)
    rows = []
    t = 0
    for seq in range(frames):
        t += int(rng.integers(1_000, 50_000))
        rows.append(("src:s", 1, t, 0, seq, 7))
        cur = t + int(rng.integers(0, 5_000))
        for _ in range(int(rng.integers(2, 7))):
            name = NAMES[int(rng.integers(0, len(NAMES)))]
            dur = int(rng.integers(100, 20_000))
            rows.append((name, int(rng.integers(1, 4)), cur, dur, seq, 7))
            if rng.random() < 0.5:   # a nested annotation
                inner = int(rng.integers(1, max(2, dur // 2)))
                rows.append(("state:device-invoke", 1,
                             cur + int(rng.integers(0, dur - inner + 1)),
                             inner, seq, 7))
            cur += dur + int(rng.integers(-dur // 2, 3_000))
        t = cur
        if rng.random() < 0.3:
            rows.append(("state:admission-wait", 1,
                         t - int(rng.integers(0, 4_000)),
                         int(rng.integers(10, 3_000)), -1, 0))
    if seed % 3 == 0:
        rows.append(("src:other", 2, t + 10, 0, 1, 9))
    return rows


def both_spans(rows):
    return ([JaxSpan(*r) for r in rows], [Span(*r) for r in rows])


def _frames_key(frames):
    return [(fr.seq, fr.t0, fr.t1, sorted(fr.spans)) for fr in frames]


def _attributed_key(attributed):
    return [(fr.seq, fr.t0, fr.t1, sorted(states.items()))
            for fr, states in attributed]


@pytest.mark.parametrize("seed", range(6))
def test_attribution_equals_jax(seed):
    jspans, pspans = both_spans(synthetic_spans(seed))
    jamb, pamb = [], []
    ja = jax_attrib.attribute_frames(jspans, STATES, TRANSIT,
                                     ambiguous=jamb)
    pa = attrib.attribute_frames(pspans, STATES, TRANSIT, ambiguous=pamb)
    assert _attributed_key(pa) == _attributed_key(ja)
    assert pamb == jamb
    for fr, states in pa:   # conservation, exactly
        assert sum(states.values()) == fr.t1 - fr.t0


@pytest.mark.parametrize("seed", range(4))
def test_blame_and_folded_stacks_equal_jax(seed):
    jspans, pspans = both_spans(synthetic_spans(seed, frames=20))
    jblame = jax_attrib.blame_from_spans(jspans, STATES, TRANSIT)
    pblame = attrib.blame_from_spans(pspans, STATES, TRANSIT)
    assert pblame == jblame
    jfolded = jax_attrib.folded_stacks(jax_attrib.group_frames(jspans),
                                       STATES, TRANSIT)
    pfolded = attrib.folded_stacks(attrib.group_frames(pspans),
                                   STATES, TRANSIT)
    assert pfolded == jfolded


@pytest.mark.parametrize("seed", range(3))
def test_remote_spans_carve_wire_like_jax(seed):
    rng = np.random.default_rng(100 + seed)
    local, remote = [], []
    for seq in range(8):
        t0 = seq * 100_000
        rtt = int(rng.integers(5_000, 40_000))
        local += [("src:s", 1, t0, 0, seq, 9),
                  ("qc", 1, t0 + 100, rtt, seq, 9)]
        srv = int(rng.integers(100, rtt - 200))
        remote.append(("st", 7, t0 + 200 + int(rng.integers(0, rtt - srv)),
                       srv, 0, 9))
    jl, pl = both_spans(local)
    jr, pr = both_spans(remote)
    ja = jax_attrib.attribute_frames(jl, {"qc": "wire"}, remote_spans=jr)
    pa = attrib.attribute_frames(pl, {"qc": "wire"}, remote_spans=pr)
    assert _attributed_key(pa) == _attributed_key(ja)
    assert all("element-compute" in st for _, st in pa)


@pytest.mark.parametrize("window", [1_000, 20_000, 400_000])
def test_busy_fraction_equals_jax(window):
    jspans, pspans = both_spans(synthetic_spans(5, frames=30))
    now = max(s.start_ns + s.dur_ns for s in pspans)
    for name in ("filt", "q", "conv"):
        assert attrib.busy_fraction(pspans, name, now, window) == \
            jax_attrib.busy_fraction(jspans, name, now, window)


def test_group_frames_equal_jax_and_state_table_identical():
    jspans, pspans = both_spans(synthetic_spans(3))
    assert _frames_key(attrib.group_frames(pspans)) == \
        _frames_key(jax_attrib.group_frames(jspans))
    assert attrib.STATES == jax_attrib.STATES
    for name in ("state:wire", "state:bogus", "my_queue", "qc",
                 "query_client0", "tensor_sink3", "conv"):
        assert attrib.classify_span(name) == jax_attrib.classify_span(name)


def test_queueing_evidence_equals_jax():
    report = {"nns_slo_latency_us{class=\"a\"}": {"count": 3, "p99": 900.0},
              "nns_query_service_us{class=\"a\"}": {"count": 3,
                                                     "p99": 250.5}}
    assert attrib.queueing_evidence(report) == \
        jax_attrib.queueing_evidence(report)


# ---------------------------------------------------------------------------
# peaks and the cost counter
# ---------------------------------------------------------------------------

def test_peaks_are_the_h100_datasheet_and_nothing_else(monkeypatch):
    monkeypatch.delenv("NNS_PEAK_FLOPS", raising=False)
    monkeypatch.delenv("NNS_PEAK_BW", raising=False)
    assert attrib.device_peaks("NVIDIA H100 80GB HBM3") == (989.4e12,
                                                            3.35e12)
    for other in ("cpu", None, "NVIDIA H100 PCIe", "TPU v5e",
                  "NVIDIA A100-SXM4-80GB"):
        assert attrib.device_peaks(other) == (0.0, 0.0)
    assert attrib.device_peaks(torch.device("cpu")) == (0.0, 0.0)
    # no TPU row was carried over
    assert not set(attrib.PEAK_FLOPS) & set(jax_attrib.PEAK_FLOPS)
    assert not set(attrib.PEAK_BW) & set(jax_attrib.PEAK_BW)


def test_peak_overrides_are_the_jax_package_knobs(monkeypatch):
    monkeypatch.setenv("NNS_PEAK_FLOPS", "42.0")
    monkeypatch.setenv("NNS_PEAK_BW", "7.5")
    assert attrib.device_peaks("cpu") == (42.0, 7.5)

    class FakeTpu:
        platform = "tpu"
        device_kind = "TPU v5e"

    assert jax_attrib.device_peaks(FakeTpu()) == (42.0, 7.5)


def mbv2_flops(size: int, width: float, classes: int) -> int:
    """2 x MACs of MobileNetV2's convolutions and classifier (SAME
    padding: each stride-s layer outputs ceil(n / s))."""
    def c(ch):
        return max(8, int(ch * width + 4) // 8 * 8)

    h = math.ceil(size / 2)
    cin = c(32)
    macs = h * h * cin * 3 * 9                       # stem 3x3 s2
    for t, ch, n, s in MBV2_CFG:
        for i in range(n):
            hid = cin * t
            if t != 1:
                macs += h * h * cin * hid             # expand 1x1
            h = math.ceil(h / (s if i == 0 else 1))
            macs += h * h * hid * 9                   # depthwise 3x3
            macs += h * h * hid * c(ch)               # project 1x1
            cin = c(ch)
    last = c(1280) if width > 1.0 else 1280
    macs += h * h * cin * last + last * classes       # head + classifier
    return 2 * macs


@pytest.mark.parametrize("size,classes", [(32, 10), (64, 1001)])
def test_cost_counter_equals_closed_form_mobilenet(size, classes):
    m = get_model("mobilenet_v2", {"input_size": str(size),
                                   "num_classes": str(classes)}, "cpu")
    flops, nbytes = attrib.module_cost(m.module, m.in_info)
    assert flops == mbv2_flops(size, 1.0, classes)
    # every weight is read at least once, and the frame too
    weights = sum(p.numel() * p.element_size()
                  for p in m.module.parameters())
    assert nbytes > weights + size * size * 3
    # the live module was not touched by the meta pass
    assert all(p.device.type == "cpu" for p in m.module.parameters())


@pytest.mark.parametrize("size", [64, 112])
def test_cost_counter_beside_xla_cost_analysis(size, monkeypatch):
    """XLA's ``cost_analysis`` of the JAX MobileNetV2 (what the JAX
    filter's ``nns_mfu`` reads) counts the convolutions and the
    classifier as the port's counter does, plus the elementwise work
    (BatchNorm, ReLU6, the residual adds, the preprocessing), so it is
    larger; its bytes are after fusion, the port's each dispatched op's.
    The numbers print with ``-s``."""
    import jax

    import nnstreamer_tpu.models.mobilenet_v2 as jax_mbv2
    from nnstreamer_tpu.models.registry import get_model as jax_get_model

    custom = {"input_size": str(size)}
    monkeypatch.setattr(jax_mbv2, "host_init", jax.eval_shape)
    ref = jax_get_model("mobilenet_v2", custom)
    x = jax.ShapeDtypeStruct(ref.in_info[0].np_shape, np.uint8)
    cost = jax.jit(ref.forward).lower(ref.params, x).compile() \
        .cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    xla_flops, xla_bytes = cost["flops"], cost["bytes accessed"]
    m = get_model("mobilenet_v2", custom, "cpu")
    flops, nbytes = attrib.module_cost(m.module, m.in_info)
    print(f"mobilenet_v2 {size}x{size}: port {flops:.0f} FLOPs "
          f"{nbytes:.0f} B; XLA {xla_flops:.0f} FLOPs {xla_bytes:.0f} B")
    assert flops == mbv2_flops(size, 1.0, 1001)
    assert flops < xla_flops < 1.5 * flops
    assert 0.5 < nbytes / xla_bytes < 2.0


def mlp_cost(in_dim, width, depth, out_dim):
    """Closed form of the MLP's forward on one f32 row: 2 x MACs, and
    the bytes each op reads and writes (mm: row + weight in, row out;
    bias add: two rows in, one out; relu: one in, one out)."""
    dims = [in_dim] + [width] * depth + [out_dim]
    flops = nbytes = 0
    for i, (a, b) in enumerate(zip(dims, dims[1:])):
        flops += 2 * a * b
        nbytes += 4 * ((a + a * b + b) + 3 * b)
        if i < len(dims) - 2:
            nbytes += 4 * 2 * b
    return flops, nbytes


@pytest.mark.parametrize("dims", [(8, 16, 2, 4), (64, 1024, 4, 16)])
def test_cost_counter_equals_closed_form_mlp(dims):
    in_dim, width, depth, out_dim = dims
    m = get_model("mlp", {"in_dim": str(in_dim), "width": str(width),
                          "depth": str(depth), "out_dim": str(out_dim)},
                  "cpu")
    assert attrib.module_cost(m.module, m.in_info) == \
        tuple(float(v) for v in mlp_cost(*dims))


class _TreeWeights(torch.nn.Module):
    """Weights kept as a plain tree on an attribute, as the LM keeps
    them: not parameters, not buffers."""

    def __init__(self, width):
        super().__init__()
        self.params = {"w": [torch.ones(4, width)]}

    def forward(self, x):
        w = self.params["w"][0]
        assert w.device.type == "meta", w.device
        return (x @ w,)


def test_plain_tree_weights_are_counted_on_meta_copies():
    info = TensorsInfo([TensorInfo(TensorType.FLOAT32, (4,))])
    narrow, wide = _TreeWeights(8), _TreeWeights(16)
    # mm: the row and the weight in, the row out (the views move nothing)
    assert attrib.module_cost(narrow, info) == (64.0, 4.0 * (4 + 32 + 8))
    assert attrib.module_cost(wide, info) == (128.0, 4.0 * (4 + 64 + 16))
    assert narrow.params["w"][0].device.type == "cpu"


def test_meta_frame_takes_the_shape_only_path_only_while_counting():
    from nnstreamer_tpu_torch.ops.preprocess import normalize_frame

    frame = torch.empty((5, 7, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        normalize_frame(frame, dtype=torch.bfloat16)
    seen = []
    flops, nbytes = attrib.count_cost(
        lambda x: seen.append(normalize_frame(x, dtype=torch.bfloat16)),
        frame)
    assert seen[0].device.type == "meta" and seen[0].dtype == torch.bfloat16
    assert tuple(seen[0].shape) == (5, 7, 3)
    # the kernel's traffic: the uint8 frame in, the bf16 frame out
    assert (flops, nbytes) == (0.0, float(5 * 7 * 3 * (1 + 2)))


# ---------------------------------------------------------------------------
# live pipelines: conservation and the filter's spans and gauges
# ---------------------------------------------------------------------------

class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(
            torch.arange(32, dtype=torch.float32).reshape(4, 8))

    def forward(self, x):
        return (x.float() @ self.w,)


@pytest.fixture()
def tiny_model():
    def build(custom, device=None):
        module = _Tiny().eval()
        return Model(
            name="tiny_attrib", module=module, device=torch.device("cpu"),
            in_info=TensorsInfo([TensorInfo(TensorType.FLOAT32, (4,))]),
            out_info=TensorsInfo([TensorInfo(TensorType.FLOAT32, (8,))]),
            batched=module)

    register_model("tiny_attrib")(build)
    yield
    _MODELS.pop("tiny_attrib", None)


def _assert_conserved(profiler, min_frames=1):
    attributed = profiler.attributed()
    assert len(attributed) >= min_frames
    for fr, states in attributed:
        assert abs(sum(states.values()) - (fr.t1 - fr.t0)) <= TOL_NS, (
            fr.seq, states)
    return attributed


def _run_appsrc(desc, n, profile=True):
    p = parse_launch(desc)
    prof = Profiler(p, register_gauges=False) if profile else None
    src = p.get("in")
    for i in range(n):
        src.push_buffer(TensorBuffer(tensors=[np.full(4, i, np.float32)],
                                     pts=i))
    src.end_of_stream()
    p.play()
    try:
        p.wait(timeout=60)
    finally:
        p.stop()
    return p, prof


FILTER = (f"appsrc caps={CAPS4} name=in ! tensor_filter framework=xla "
          "model=tiny_attrib accelerator=true:cpu name=f {opts} ! "
          "tensor_sink name=out")


def test_device_invoke_annotated_per_frame(tiny_model):
    _, prof = _run_appsrc(FILTER.format(opts=""), 8)
    attributed = _assert_conserved(prof, min_frames=8)
    assert all("device-invoke" in st or "device-compile" in st
               for _, st in attributed)
    # the first dispatch of a signature is the compile, the rest invokes
    assert sum("device-invoke" in st for _, st in attributed) >= 7
    prof.close()


def test_batched_filter_names_queue_and_device_waits(tiny_model):
    n = 16
    _, prof = _run_appsrc(FILTER.format(opts="batch=4"), n)
    attributed = _assert_conserved(prof, min_frames=n)
    per_frame = [set(st) for _, st in attributed]
    assert all("device-invoke" in st or "device-compile" in st
               for st in per_frame)
    assert sum("queue-wait" in st for st in per_frame) >= n - 4
    prof.close()


def test_workers_reorder_and_invoke_spans_conserve(tiny_model):
    n = 24
    _, prof = _run_appsrc(FILTER.format(opts="workers=3"), n)
    attributed = _assert_conserved(prof, min_frames=n)
    names = {name for fr, _ in attributed for name, _, _ in fr.spans}
    assert "f:invoke" in names
    prof.close()


TRANSFORM_PIPE = ("videotestsrc num-buffers=40 pattern=random ! "
                  "video/x-raw,format=RGB,width=24,height=24 ! "
                  "tensor_converter ! tensor_transform mode=arithmetic "
                  "option=add:1 ! queue max-size-buffers=4 ! "
                  "tensor_sink name=out")


@pytest.mark.parametrize("fuse", [False, True])
def test_executors_conserve_with_the_jax_core_states(fuse):
    p = parse_launch(TRANSFORM_PIPE, Pipeline(fuse=fuse))
    prof = Profiler(p, register_gauges=False)
    try:
        p.run(timeout=60)
        attributed = _assert_conserved(prof, min_frames=40)
    finally:
        prof.close()
        p.stop()
    report = attrib.blame(attributed)
    significant = {s for s, row in report["states"].items()
                   if row["pct"] >= 1.0}
    assert {"source-pacing", "element-compute", "queue-wait"} \
        <= significant, significant


def test_profiler_maps_match_jax_for_the_same_string():
    from nnstreamer_tpu import parse_launch as jax_parse_launch
    from nnstreamer_tpu.obs.profile import pipeline_maps as jax_maps

    from nnstreamer_tpu_torch.obs.profile import pipeline_maps

    desc = ("videotestsrc name=v num-buffers=1 ! video/x-raw,format=RGB,"
            "width=8,height=8 ! tensor_converter name=c ! queue name=q ! "
            "tensor_transform name=t mode=typecast option=float32 ! "
            "tensor_sink name=out")

    def named(maps):   # the capsfilter's generated name differs
        return [{k: v for k, v in m.items() if not k.startswith("capsf")}
                for m in maps]

    assert named(pipeline_maps(parse_launch(desc))) == \
        named(jax_maps(jax_parse_launch(desc)))


def test_filter_gauges_live_and_mfu_is_rate_times_flops_over_peak(
        tiny_model, monkeypatch):
    monkeypatch.setenv("NNS_PEAK_FLOPS", "1e9")
    p = parse_launch(FILTER.format(opts=""))
    src = p.get("in")
    for i in range(20):
        src.push_buffer(TensorBuffer(tensors=[np.full(4, i, np.float32)],
                                     pts=i))
    src.end_of_stream()
    p.play()
    try:
        p.wait(timeout=60)
        fw = p.get("f").fw
        flops, nbytes = attrib.estimate_jit_cost(fw)
        assert flops == 2 * 4 * 8        # the 4x8 matmul, once per frame
        assert nbytes > 0
        report = REGISTRY.report()
        mfu = [v for k, v in report.items() if k.startswith("nns_mfu")]
        assert len(mfu) == 1, report.keys()
        # the first scrape reads the lifetime rate by contract
        expect = fw.stats.throughput * flops / 1e9
        assert mfu[0] == pytest.approx(expect, rel=0.25)
        for fam in ("nns_device_bytes_per_s", "nns_device_mem_bytes",
                    "nns_filter_batch_size", "nns_filter_xbatch_frames"):
            assert any(k.startswith(fam) for k in report), fam
        assert 'device="cpu"' in next(k for k in report
                                      if k.startswith("nns_mfu"))
    finally:
        p.stop()
    assert not any(k.startswith(("nns_mfu", "nns_filter_"))
                   for k in REGISTRY.report())


def test_mfu_reads_zero_without_a_peak(tiny_model, monkeypatch):
    """No peak for the CPU: no MFU claim (the bytes/s gauge still reads
    the cost counter)."""
    monkeypatch.delenv("NNS_PEAK_FLOPS", raising=False)
    p = parse_launch(FILTER.format(opts=""))
    src = p.get("in")
    for i in range(4):
        src.push_buffer(TensorBuffer(tensors=[np.full(4, i, np.float32)],
                                     pts=i))
    src.end_of_stream()
    p.play()
    try:
        p.wait(timeout=60)
        assert [v for k, v in REGISTRY.report().items()
                if k.startswith("nns_mfu")] == [0.0]
        assert any(v > 0 for k, v in REGISTRY.report().items()
                   if k.startswith("nns_device_bytes_per_s"))
    finally:
        p.stop()


def test_occupancy_gauges_live_and_dropped_at_close():
    p = parse_launch("videotestsrc num-buffers=30 pattern=random ! "
                     "video/x-raw,format=RGB,width=24,height=24 ! "
                     "tensor_converter ! tensor_sink name=out")
    prof = Profiler(p, occupancy_window_s=0.5)
    p.run(timeout=60)
    occ = {k: v for k, v in REGISTRY.report().items()
           if k.startswith("nns_element_occupancy")}
    assert occ and any(v > 0 for v in occ.values())
    assert all(0.0 <= v <= 1.0 for v in occ.values())
    prof.close()
    p.stop()
    assert not any(k.startswith("nns_element_occupancy")
                   for k in REGISTRY.report())


def test_launch_profile_emits_artifacts(tmp_path):
    out = tmp_path / "prof"
    r = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.launch",
         "videotestsrc num-buffers=30 pattern=random ! "
         "video/x-raw,format=RGB,width=24,height=24 ! "
         "tensor_converter ! queue ! tensor_sink name=out",
         "--profile", "--profile-out", str(out), "--quiet"],
        capture_output=True, text=True, timeout=180, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "profile:" in r.stderr and "state" in r.stderr
    doc = json.loads((out / "profile.json").read_text())
    blame = doc["profile"]["blame"]
    assert blame["frames"] >= 30
    assert blame["conservation"]["attributed_pct"] >= 90.0
    assert json.loads((out / "trace.json").read_text())
    folded = (out / "flame.folded").read_text().splitlines()
    assert folded and all(len(ln.rsplit(" ", 1)) == 2 for ln in folded)


def test_attribution_block_from_a_bare_tracer():
    p = parse_launch("videotestsrc num-buffers=20 pattern=random ! "
                     "video/x-raw,format=RGB,width=16,height=16 ! "
                     "tensor_converter ! tensor_sink name=out")
    tracer = p.enable_tracing(spans=True)
    p.run(timeout=60)
    block = attribution_block(tracer)
    assert block["frames"] >= 20 and block["attributed_pct"] >= 90.0
    q = parse_launch("videotestsrc num-buffers=3 ! video/x-raw,format=RGB,"
                     "width=16,height=16 ! tensor_converter ! tensor_sink")
    counters_only = q.enable_tracing()
    q.run(timeout=60)
    assert attribution_block(counters_only) == {}
    assert attribution_block(None) == {}
