"""The port's metrics endpoint (``obs/httpd.py``) and ``nns-top`` view
(``obs/dashboard.py``) against the JAX package's.

The same seeded registry contents render the same ``/metrics`` text in
both packages, the same health sources give the same ``/healthz``
report, and the same time-series ring (or synthetic flat history) gives
the same dashboard frame, compared exactly.  The port's pipelines drive
the endpoint's lifecycle (``NNS_METRICS_PORT`` at ``play()``, a health
source from ``play()`` to ``stop()``) as the JAX package's do.
"""

import json
import os
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest

from nnstreamer_tpu.obs import dashboard as jax_dash
from nnstreamer_tpu.obs import httpd as jax_httpd
from nnstreamer_tpu.obs import metrics as jax_metrics
from nnstreamer_tpu.obs import timeseries as jax_ts
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.obs import dashboard, httpd, metrics, timeseries
from nnstreamer_tpu_torch.pipeline.graph import AppSrc, Pipeline
from nnstreamer_tpu_torch.elements import TensorSink
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
         "types=float32,framerate=0/1")


def fill_registry(mod, seed: int):
    """A fresh registry of ``mod`` (either package's ``obs.metrics``)
    with seeded counters, gauges and histograms."""
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    for i in range(3):
        reg.counter("nns_test_requests_total", **{"class": f"c{i}"}).inc(
            int(rng.integers(0, 1000)))
        reg.gauge("nns_test_depth", fn=None, queue=f"q{i}").set(
            float(rng.integers(0, 64)))
        hist = reg.histogram("nns_test_latency_us", element=f"e{i}")
        for v in rng.lognormal(7.0, 1.0, int(rng.integers(5, 200))):
            hist.observe(float(v))
    reg.gauge("nns_test_lazy", fn=lambda: 0.25)
    return reg


@pytest.fixture()
def endpoints():
    """Both packages' endpoints stopped before and after (each is a
    process-wide singleton exporting ``NNS_METRICS_BOUND_PORT``)."""
    httpd.stop_metrics_server()
    jax_httpd.stop_metrics_server()
    yield
    httpd.stop_metrics_server()
    jax_httpd.stop_metrics_server()


@pytest.fixture
def quiet_resilience_stats():
    """Both packages' process-wide query resilience counters, emptied
    for the test and restored after it: every non-zero ``STATS``
    counter rides any registry's exposition, so one left by an earlier
    test in the same process (a refused connect) would show in one
    package's text only."""
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


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


@pytest.mark.parametrize("seed", range(3))
def test_metrics_text_equals_jax(seed, endpoints, quiet_resilience_stats):
    preg, jreg = fill_registry(metrics, seed), fill_registry(jax_metrics,
                                                              seed)
    assert preg.render_prometheus() == jreg.render_prometheus()
    port = httpd.start_metrics_server(0, registry=preg).server_address[1]
    jport = jax_httpd.start_metrics_server(
        0, registry=jreg).server_address[1]
    got = _get(f"http://127.0.0.1:{port}/metrics")
    want = _get(f"http://127.0.0.1:{jport}/metrics")
    assert got == want and got[0] == 200
    assert _get(f"http://127.0.0.1:{port}/nope")[0] == 404


SOURCES = [
    [],
    [("a", "serving")],
    [("a", "serving"), ("b", "degraded")],
    [("a", "starting"), ("b", "draining"), ("c", "serving")],
    [("a", "bogus"), ("b", "serving")],
    [("a", RuntimeError), ("b", "degraded")],
]


def _provider(state):
    if state is RuntimeError:
        def dead():
            raise RuntimeError("stopped under the scrape")
        return dead
    return lambda: state


@pytest.mark.parametrize("sources", SOURCES,
                         ids=lambda s: "+".join(str(x[1]) for x in s)
                         or "none")
def test_health_report_equals_jax(sources):
    tokens = [(httpd.register_health_source(_provider(st), label=lbl),
               jax_httpd.register_health_source(_provider(st), label=lbl))
              for lbl, st in sources]
    try:
        got, want = httpd.health_report(), jax_httpd.health_report()
        assert got == want
        assert got["ready"] == (got["state"] in ("starting", "serving"))
    finally:
        for t, jt in tokens:
            httpd.unregister_health_source(t)
            jax_httpd.unregister_health_source(jt)


def test_healthz_answers_503_while_degraded(endpoints):
    port = httpd.start_metrics_server(0).server_address[1]
    status, body = _get(f"http://127.0.0.1:{port}/healthz")
    assert status == 200 and json.loads(body)["ready"] is True
    token = httpd.register_health_source(lambda: "degraded", label="t")
    try:
        status, body = _get(f"http://127.0.0.1:{port}/healthz")
        assert status == 503 and json.loads(body)["state"] == "degraded"
    finally:
        httpd.unregister_health_source(token)


def test_port_zero_binds_ephemeral_and_exports(endpoints):
    server = httpd.start_metrics_server(0)
    port = server.server_address[1]
    assert port != 0 and httpd.bound_metrics_port() == port
    assert os.environ.get("NNS_METRICS_BOUND_PORT") == str(port)
    assert httpd.start_metrics_server(0) is server      # idempotent
    httpd.stop_metrics_server()
    assert httpd.bound_metrics_port() is None
    assert "NNS_METRICS_BOUND_PORT" not in os.environ


@pytest.mark.parametrize("raw,starts", [("0", True), ("bogus", False),
                                        ("", False)])
def test_maybe_start_from_env(raw, starts, endpoints, monkeypatch):
    monkeypatch.setattr(httpd, "_ENV_TRIED", False)
    monkeypatch.setenv("NNS_METRICS_PORT", raw)
    server = httpd.maybe_start_from_env()
    assert (server is not None) == starts
    # checked once a process
    assert httpd.maybe_start_from_env() is server


def test_play_starts_the_endpoint_from_env(endpoints, monkeypatch):
    monkeypatch.setattr(httpd, "_ENV_TRIED", False)
    monkeypatch.setenv("NNS_METRICS_PORT", "0")
    p = parse_launch("videotestsrc num-buffers=2 ! video/x-raw,format=RGB,"
                     "width=8,height=8,framerate=30/1 ! tensor_converter ! "
                     "queue name=q ! tensor_sink name=out")
    p.run(timeout=60)
    port = httpd.bound_metrics_port()
    assert port is not None
    assert _get(f"http://127.0.0.1:{port}/metrics")[0] == 200


def test_pipeline_lifecycle_states():
    p = Pipeline("hz-port")
    src = AppSrc("src", caps=CAPS4)
    sink = TensorSink("out")
    p.add(src, sink)
    p.link(src, sink)
    assert p.health_state() == "starting"
    src.push_buffer(TensorBuffer(tensors=[np.zeros(4, np.float32)]))
    src.end_of_stream()
    p.play()
    try:
        assert p.health_state() == "serving"
        assert httpd.health_report()["sources"]["pipeline:hz-port"] == \
            "serving"
        p.wait(timeout=15)
    finally:
        p.stop()
    assert p.health_state() == "draining"
    assert "pipeline:hz-port" not in httpd.health_report()["sources"]


def test_cli_metrics_port_names_its_endpoint():
    r = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.launch",
         "videotestsrc num-buffers=3 ! video/x-raw,format=RGB,width=8,"
         "height=8,framerate=30/1 ! tensor_converter ! tensor_sink",
         "--metrics-port", "0", "--top", "0.1"],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-1500:]
    assert "metrics endpoint on http://127.0.0.1:" in r.stderr
    assert "nns-top" in r.stderr


# ---------------------------------------------------------------------------
# nns-top
# ---------------------------------------------------------------------------

def synthetic_history(seed: int):
    """Six flat samples of the families the dashboard reads, seeded."""
    rng = np.random.default_rng(seed)
    samples = []
    admitted = shed = 0.0
    for t in range(6):
        admitted += float(rng.integers(0, 100))
        shed += float(rng.integers(0, 10))
        samples.append((float(t), {
            'nns_query_server_admitted_total{origin="a:1",qos="gold"}':
                admitted,
            'nns_query_server_shed_total{origin="a:1",qos="bronze"}': shed,
            'nns_query_server_queue_depth{origin="a:1"}':
                float(rng.integers(0, 16)),
            'nns_element_occupancy{element="f",origin="a:1"}':
                float(rng.random()),
            'nns_element_proctime_us{element="f",quantile="0.99"}':
                float(rng.integers(100, 5000)),
            'nns_mfu{origin="a:1"}': float(rng.random() * 1e-3),
            'nns_signal_state{signal="sustained_shed",origin="a:1"}':
                float(rng.integers(0, 3)),
            'nns_query_server_clients{origin="b:2"}':
                float(rng.integers(1, 32)),
            'nns_fleet_role{origin="a:1",role="router"}': 1.0,
        }))
    return samples


@pytest.mark.parametrize("seed", range(3))
def test_dashboard_frame_equals_jax(seed):
    samples = synthetic_history(seed)
    view = dashboard.build_view(samples, window_s=10.0)
    assert view == jax_dash.build_view(samples, window_s=10.0)
    assert dashboard.render_frame(view, clock=0.0) == \
        jax_dash.render_frame(view, clock=0.0)


def _ring(mod_metrics, mod_ts, seed: int):
    rng = np.random.default_rng(seed)
    reg = mod_metrics.MetricsRegistry()
    ring = mod_ts.TimeSeriesRing(reg, registry=reg)
    ring.add_signal(mod_ts.SustainedSignal(
        "shed", "nns_query_server_shed_rate", threshold=0.2,
        min_hold_s=1.0, kind="gauge"))
    shed = reg.gauge("nns_query_server_shed_rate", fn=None)
    admitted = reg.counter("nns_query_server_admitted_total", qos="gold")
    hist = reg.histogram("nns_element_proctime_us", element="f")
    for t in range(8):
        shed.set(float(rng.random()))
        admitted.inc(int(rng.integers(0, 50)))
        for v in rng.lognormal(6.0, 1.0, 20):
            hist.observe(float(v))
        ring.capture(now=float(t))
    return ring


@pytest.mark.parametrize("seed", range(3))
def test_ring_dashboard_frame_equals_jax(seed):
    ring = _ring(metrics, timeseries, seed)
    jring = _ring(jax_metrics, jax_ts, seed)
    frame = dashboard.RingSource(ring, label="t").frame(10.0)
    assert frame == jax_dash.RingSource(jring, label="t").frame(10.0)
    assert dashboard.render_frame(frame, clock=0.0) == \
        jax_dash.render_frame(frame, clock=0.0)
    loop = dashboard.TopLoop(dashboard.RingSource(ring, label="t"),
                             ansi=False)
    assert "nns-top — t" in loop.render_once()


def test_parse_prometheus_sparkline_and_bar_equal_jax():
    text = fill_registry(metrics, 4).render_prometheus()
    assert dashboard.parse_prometheus(text) == \
        jax_dash.parse_prometheus(text)
    for points in ([], [0, 1, 2, 3], [5.0] * 20, [3, 1, 4, 1, 5, 9, 2]):
        assert dashboard.sparkline(points) == jax_dash.sparkline(points)
    for frac in (-1.0, 0.0, 0.33, 0.5, 2.0):
        assert dashboard.bar(frac) == jax_dash.bar(frac)


def test_scrape_source_reads_the_port_endpoint(endpoints):
    reg = fill_registry(metrics, 5)
    port = httpd.start_metrics_server(0, registry=reg).server_address[1]
    src = dashboard.ScrapeSource(f"127.0.0.1:{port}")
    src.frame(10.0)
    frame = src.frame(10.0)
    assert frame["samples"] == 2 and not src.scrape_errors
