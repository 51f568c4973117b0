"""The port's SLO harness (``slo/``) against the JAX package's.

Host logic is compared exactly: one seed gives both packages the same
Poisson and constant arrival schedules, the same snapshot sequences
give the same burn-rate evaluations and verdicts (the verdict JSON
schema included), the same breach writes the same flight-recorder bundle
layout, and the specs round-trip across packages.  Then short live runs
on the CPU: the open-loop generator against a port query server, the
token mode against a port ``tensor_llm``, the query client's hooks, and
the CLI's ``--soak --slo`` exit codes.  Every wait is an event or a
bounded run; nothing sleeps.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest

from nnstreamer_tpu import slo as jax_slo
from nnstreamer_tpu.obs import metrics as jax_metrics
from nnstreamer_tpu.slo import flightrec as jax_flightrec
from nnstreamer_tpu.slo import loadgen as jax_loadgen
from nnstreamer_tpu.slo import spec as jax_spec
from nnstreamer_tpu_torch import parse_launch, slo
from nnstreamer_tpu_torch.obs import metrics
from nnstreamer_tpu_torch.obs.metrics import MetricsRegistry
from nnstreamer_tpu_torch.query import QueryConnection, shutdown_server
from nnstreamer_tpu_torch.slo import flightrec, loadgen, spec
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
         "types=float32,framerate=0/1")
PKGS = {"torch": (slo, spec, metrics, flightrec, loadgen),
        "jax": (jax_slo, jax_spec, jax_metrics, jax_flightrec,
                jax_loadgen)}


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate,dur,seed", [(2.0, 30.0, 1), (50.0, 4.0, 7),
                                           (0.3, 100.0, 123)])
def test_schedules_equal_jax(rate, dur, seed):
    assert loadgen.poisson_schedule(rate, dur, random.Random(seed)) == \
        jax_loadgen.poisson_schedule(rate, dur, random.Random(seed))
    for phase in (0.0, 0.013):
        assert loadgen.constant_schedule(rate, dur, phase) == \
            jax_loadgen.constant_schedule(rate, dur, phase)


@pytest.mark.parametrize("schedule", ["poisson", "constant"])
def test_generator_schedules_and_qos_split_equal_jax(schedule):
    def gen(mod, reg):
        return mod.LoadGenerator(
            "127.0.0.1", 1, clients=8, rate_hz=3.0, duration_s=5.0,
            schedule=schedule, seed=99, registry=reg, qos=True,
            classes=(("gold", 1.0), ("silver", 2.0), ("bronze", 5.0)))

    port = gen(loadgen, MetricsRegistry())
    ref = gen(jax_loadgen, jax_metrics.MetricsRegistry())
    assert [port._make_schedule(i) for i in range(8)] == \
        [ref._make_schedule(i) for i in range(8)]
    assert port._qos_assignment() == ref._qos_assignment()


# ---------------------------------------------------------------------------
# burn-rate evaluation
# ---------------------------------------------------------------------------

def spec_of(mod, window_fast=60.0, window_slow=600.0):
    return mod.SLOSpec(
        name="t", window_fast_s=window_fast, window_slow_s=window_slow,
        burn_threshold=2.0, objectives=(
            mod.Objective("avail", "availability", target=0.95),
            mod.Objective("err", "error_rate", target=0.9,
                          request_class="gold"),
            mod.Objective("p99", "latency", target=0.9,
                          threshold_us=50_000.0),
            mod.Objective("ttft", "ttft", target=0.9,
                          threshold_us=100_000.0),
            mod.Objective("el", "latency", target=0.9,
                          threshold_us=1_000.0,
                          metric="nns_element_proctime_us",
                          match='element="snk"')))


def drive(pkg: str, seed: int):
    """Evaluate a seeded snapshot sequence (healthy, a burst of errors
    and slow requests, recovery) through package ``pkg``: every tick's
    evaluation and the final verdict."""
    s, sp, m, _, _ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    reg = m.MetricsRegistry()
    ev = s.Evaluator(spec_of(sp), registry=reg)
    req = {c: reg.counter(sp.REQUESTS_TOTAL, **{"class": c})
           for c in ("gold", "bronze")}
    err = {c: reg.counter(sp.ERRORS_TOTAL, **{"class": c})
           for c in ("gold", "bronze")}
    lat = reg.histogram(sp.LATENCY_US, **{"class": "gold"})
    ttft = reg.histogram(sp.TTFT_US, **{"class": "gold"})
    el = reg.histogram("nns_element_proctime_us", element="snk")
    evals = [ev.tick(now=0.0)]
    t = 0.0
    for step in range(40):
        t += float(rng.integers(5, 40))
        bad = 10 <= step < 22 and rng.random() < 0.8
        for c in ("gold", "bronze"):
            n = int(rng.integers(20, 80))
            req[c].inc(n)
            err[c].inc(int(n * (0.5 if bad else rng.random() * 0.02)))
        for v in rng.lognormal(9.5 if bad else 8.0, 0.5, 30):
            lat.observe(float(v))
            ttft.observe(float(v) * 2)
        for v in rng.lognormal(7.5 if bad else 5.0, 0.4, 10):
            el.observe(float(v))
        evals.append(ev.tick(now=t))
    return evals, ev.verdict()


@pytest.mark.parametrize("seed", range(4))
def test_burn_rate_evaluations_and_verdict_equal_jax(seed):
    got_evals, got = drive("torch", seed)
    want_evals, want = drive("jax", seed)
    assert got_evals == want_evals
    assert got == want
    json.dumps(got)
    assert set(got) == {"slo", "verdict", "pass", "burn_threshold",
                        "windows", "ticks", "duration_s", "objectives",
                        "breaches"}


def test_specs_round_trip_across_packages(tmp_path):
    for duration in (2.0, 60.0, 600.0):
        assert spec.demo_spec(duration).to_dict() == \
            jax_spec.demo_spec(duration).to_dict()
    path = str(tmp_path / "s.json")
    jax_spec.SLOSpec.dump(spec_of(jax_spec), path)
    assert spec.load_spec(path).to_dict() == spec_of(spec).to_dict()
    spec_of(spec).dump(path)
    assert jax_spec.load_spec(path).to_dict() == spec_of(jax_spec).to_dict()
    assert spec.load_spec(None, 30.0) == spec.demo_spec(30.0)
    with pytest.raises(ValueError):
        spec.Objective("x", "ttft", target=0.9)
    with pytest.raises(ValueError):
        spec.SLOSpec("x", (), 1.0, 2.0)


def _shape(obj):
    """The key structure of a JSON value (values dropped)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(obj[0])] if obj else []
    return type(obj).__name__


def _bundle(pkg: str, out_dir: str):
    s, sp, m, fr, _ = PKGS[pkg]
    tracing = __import__(
        "nnstreamer_tpu_torch.pipeline.tracing" if pkg == "torch"
        else "nnstreamer_tpu.pipeline.tracing", fromlist=["Tracer"])
    reg = m.MetricsRegistry()
    tracer = tracing.Tracer(spans=True)
    tracer.enter("hot_element", None)
    tracer.exit()
    rec = fr.FlightRecorder(out_dir, tracer=tracer, registry=reg)
    ev = s.Evaluator(sp.SLOSpec(name="fr", objectives=(
        sp.Objective("err", "error_rate", target=0.9),),
        window_fast_s=10.0, window_slow_s=20.0),
        registry=reg, on_breach=rec.on_breach)
    ev.on_tick = rec.record
    req = reg.counter(sp.REQUESTS_TOTAL, **{"class": "default"})
    err = reg.counter(sp.ERRORS_TOTAL, **{"class": "default"})
    ev.tick(now=0.0)
    for t in (10.0, 20.0, 30.0):
        req.inc(10)
        err.inc(10)
        ev.tick(now=t)
    [bundle] = rec.dumps
    files = sorted(os.listdir(bundle))
    docs = {}
    for name in files:
        with open(os.path.join(bundle, name), encoding="utf-8") as fh:
            docs[name] = ([json.loads(ln) for ln in fh]
                          if name.endswith(".jsonl") else json.load(fh))
    return os.path.basename(bundle), files, docs


@pytest.fixture
def quiet_resilience_stats():
    """Both packages' process-wide query resilience counters, emptied
    for the test and restored after it.  ``MetricsRegistry.report()``
    appends every non-zero ``STATS`` counter to any registry's report,
    so a counter left by an earlier test in the same process (the gRPC
    reconnect retries) would show in one package's timeline only."""
    from nnstreamer_tpu.query import resilience as jax_resilience
    from nnstreamer_tpu_torch.query import resilience

    saved = [(s, s.snapshot()) for s in (resilience.STATS,
                                         jax_resilience.STATS)]
    for s, _ in saved:
        with s._lock:
            s._counts.clear()
    yield
    for s, counts in saved:
        with s._lock:
            s._counts.clear()
            s._counts.update(counts)


def test_flight_recorder_bundle_layout_equals_jax(tmp_path,
                                                  quiet_resilience_stats):
    name, files, docs = _bundle("torch", str(tmp_path / "port"))
    jname, jfiles, jdocs = _bundle("jax", str(tmp_path / "jax"))
    assert name == jname and files == jfiles
    # no frame in the ring (the span carries no buffer): no blame.json
    assert files == ["breach.json", "manifest.json", "metrics_final.json",
                     "metrics_timeline.jsonl", "trace.json"]
    for f in ("breach.json", "manifest.json", "metrics_timeline.jsonl"):
        assert _shape(docs[f]) == _shape(jdocs[f]), f
    assert docs["breach.json"] == jdocs["breach.json"]
    assert any(e["name"] == "hot_element"
               for e in docs["trace.json"]["traceEvents"]
               if e["ph"] == "X")


def test_max_dumps_cap_and_bounded_ring(tmp_path):
    reg = MetricsRegistry()
    rec = flightrec.FlightRecorder(str(tmp_path), registry=reg,
                                   max_dumps=1, capacity=16)
    ev = slo.Evaluator(spec.SLOSpec(name="fr", objectives=(
        spec.Objective("err", "error_rate", target=0.9),),
        window_fast_s=10.0, window_slow_s=20.0), registry=reg,
        on_breach=rec.on_breach)
    ev.on_tick = rec.record
    req = reg.counter(spec.REQUESTS_TOTAL, **{"class": "default"})
    err = reg.counter(spec.ERRORS_TOTAL, **{"class": "default"})
    ev.tick(now=0.0)
    t = 0.0
    for _ in range(3):          # breach / recover / breach again
        for bad in (True,) * 3 + (False,) * 4:
            t += 10
            req.inc(10)
            err.inc(10 if bad else 0)
            ev.tick(now=t)
    assert len(ev.verdict()["breaches"]) >= 2
    assert len(rec.dumps) == 1
    assert len(rec._ring) == 16


# ---------------------------------------------------------------------------
# live runs on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture()
def echo_server():
    sid = 1961
    p = parse_launch(f"tensor_query_serversrc name=qsrc id={sid} port=0 "
                     f"caps={CAPS4} ! tensor_query_serversink id={sid}")
    p.play()
    try:
        yield p.get("qsrc").bound_port
    finally:
        p.stop()
        shutdown_server(sid)


def test_mini_soak_passes_its_slo(echo_server):
    reg = MetricsRegistry()
    ev = slo.Evaluator(spec.demo_spec(2.0), registry=reg)
    monitor = slo.SLOMonitor(ev, tick_s=0.25)
    gen = slo.LoadGenerator("127.0.0.1", echo_server, clients=8,
                            rate_hz=5.0, duration_s=2.0,
                            schedule="poisson", seed=7, timeout=5.0,
                            registry=reg,
                            classes=(("interactive", 0.5),
                                     ("batch", 0.5)))
    monitor.start()
    try:
        summary = gen.run(warmup_s=0.3)
    finally:
        monitor.stop(final_tick=True)
    assert summary["peak_live_clients"] == 8
    assert summary["sent"] > 30 and summary["errors"] == 0
    report = reg.report()
    for cls in ("interactive", "batch"):
        assert report.get(
            f'{spec.REQUESTS_TOTAL}{{class="{cls}"}}', 0) > 0
    assert any(k.startswith(spec.LATENCY_US) for k in report)
    assert any(k.startswith(loadgen.SERVICE_US) for k in report)
    v = ev.verdict()
    assert v["pass"] and v["ticks"] >= 4, json.dumps(v, indent=2)


def test_on_outcome_hook_with_class_tag(echo_server):
    conn = QueryConnection("127.0.0.1", echo_server, timeout=5.0)
    outcomes = []
    conn.on_outcome = lambda c, lat, ok: outcomes.append((c, lat, ok))
    conn.connect()
    try:
        buf = TensorBuffer(tensors=[np.ones(4, np.float32)])
        buf.extra["nns_class"] = "gold"
        np.testing.assert_array_equal(conn.query(buf).np(0),
                                      np.ones(4, np.float32))
        conn.query(TensorBuffer(tensors=[np.ones(4, np.float32)]))
    finally:
        conn.close()
    assert [(c, ok) for c, _, ok in outcomes] == [("gold", True),
                                                  ("default", True)]
    assert all(lat > 0 for _, lat, _ in outcomes)


def test_on_outcome_records_failures():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    conn = QueryConnection("127.0.0.1", dead, timeout=0.3, max_retries=1)
    outcomes = []
    conn.on_outcome = lambda c, lat, ok: outcomes.append((c, ok))
    try:
        with pytest.raises((TimeoutError, ConnectionError)):
            conn.query(TensorBuffer(tensors=[np.ones(4, np.float32)]))
    finally:
        conn.close()
    assert outcomes == [("default", False)]


def test_server_connection_gauges(echo_server):
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY

    conn = QueryConnection("127.0.0.1", echo_server, timeout=5.0)
    conn.connect()
    try:
        conn.query(TensorBuffer(tensors=[np.ones(4, np.float32)]))
        report = REGISTRY.report()
        assert report[f'nns_query_server_clients{{port="{echo_server}"}}'] \
            >= 1
        assert report[f'nns_query_server_accepted_total{{port='
                      f'"{echo_server}"}}'] >= 1
    finally:
        conn.close()


def test_token_mode_against_tensor_llm():
    sid = 1962
    req = 3 + 16
    custom = ("vocab:64,dim:32,heads:2,head_dim:16,mlp:64,layers:2,"
              "experts:2,max_seq:64,device:cpu")
    p = parse_launch(
        f"tensor_query_serversrc name=qsrc id={sid} port=0 caps=other/"
        f"tensors,format=static,num_tensors=1,dimensions={req},types=int32,"
        f"framerate=0/1 ! tensor_llm name=llm custom={custom} seed=0 "
        f"slots=4 batch=4 max-new-tokens=8 id={sid} ! "
        f"tensor_query_serversink id={sid}")
    p.play()
    try:
        reg = MetricsRegistry()
        sp = spec.SLOSpec(name="tok", window_fast_s=0.5, window_slow_s=5.0,
                          tick_s=0.1, objectives=(
                              spec.Objective("ttft", "ttft", target=0.9,
                                             threshold_us=5e6),
                              spec.Objective("itl", "itl", target=0.9,
                                             threshold_us=5e6)))
        ev = slo.Evaluator(sp, registry=reg)
        gen = loadgen.TokenLoadGenerator(
            "127.0.0.1", p.get("qsrc").bound_port, prompt=np.arange(5),
            max_new=6, frame_len=req, clients=3, rate_hz=4.0,
            duration_s=1.5, seed=3, timeout=30.0, registry=reg,
            classes=(("gold", 1.0),), qos=True)
        ev.tick()
        summary = gen.run(warmup_s=0.2)
        ev.tick()
    finally:
        p.stop()
        shutdown_server(sid)
    assert summary["sent"] >= 3 and summary["errors"] == 0
    assert summary["ok"] == summary["sent"] and summary["shed"] == 0
    lat = summary["token_latency"]
    assert lat["ttft_us"]["p50"] > 0 and lat["itl_us"]["p50"] > 0
    assert ev.verdict()["pass"]


def _soak(tmp_path, sp_dict, n=1_000_000):
    path = tmp_path / "spec.json"
    path.write_text(json.dumps(sp_dict))
    return subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.launch",
         f"videotestsrc num-buffers={n} ! video/x-raw,format=RGB,width=8,"
         "height=8,framerate=30/1 ! tensor_converter ! tensor_sink name=snk",
         "--soak", "2.5", "--slo", str(path), "--slo-out",
         str(tmp_path / "fr"), "--trace-out", str(tmp_path / "t.json"),
         "--quiet"], capture_output=True, text=True, timeout=180,
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO))


@pytest.mark.parametrize("threshold_us,rc", [(1.0, 3), (1e9, 0)])
def test_cli_soak_slo_exit_codes(tmp_path, threshold_us, rc):
    """``--soak --slo``: a spec the run cannot meet (every element's time
    over 1 µs) exits 3 with a FAIL verdict and a bundle; a loose one
    exits 0."""
    sp = spec.SLOSpec(name="cli", window_fast_s=0.5, window_slow_s=1.0,
                      tick_s=0.1, objectives=(spec.Objective(
                          "el", "latency", target=0.9,
                          threshold_us=threshold_us,
                          metric="nns_element_proctime_us"),))
    r = _soak(tmp_path, sp.to_dict())
    assert r.returncode == rc, r.stderr[-1500:]
    verdict = json.loads(r.stderr[r.stderr.index("{"):])
    assert verdict["verdict"] == ("FAIL" if rc else "PASS")
    assert os.path.isdir(tmp_path / "fr") == bool(rc)
