"""The port's metric federation (``obs/federation.py``) against the JAX
package's, across packages both ways.

The two packages share the query wire, so a publisher of either package
pushes into a collector of the other: the ``T_METRICS`` frames of both
publishers are byte-equal for the same registry contents (clock and
incarnation pinned), collectors of both packages merge the same scripted
push sequences (duplicates, reordering, restarts, poisoned entries,
stale origins) into the same federated state, exposition text and
health, and a port CLI worker's ``--push-metrics`` lands in a port
collector with its counters intact.  Waits are event-driven: each
collector signals every ingest.
"""

import json
import os
import socket
import subprocess
import sys
import threading

import numpy as np
import pytest

from nnstreamer_tpu import native as jax_native
from nnstreamer_tpu.obs import federation as jax_fed
from nnstreamer_tpu.obs import metrics as jax_metrics
from nnstreamer_tpu_torch import native as port_native
from nnstreamer_tpu_torch.obs import federation as fed
from nnstreamer_tpu_torch.obs import httpd, metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL_US = 1_700_000_000_000_000
CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
         "types=float32,framerate=0/1")


@pytest.fixture(scope="module", autouse=True)
def settled_native():
    """Both packages' CRC libraries loaded before any byte comparison:
    until a build lands its package frames with CRC 0."""
    jax_native.available()
    port_native.available()


def fill_registry(mod, seed: int):
    rng = np.random.default_rng(seed)
    reg = mod.MetricsRegistry()
    for i in range(3):
        reg.counter("nns_req_total", **{"class": f"c{i}"}).inc(
            int(rng.integers(0, 1000)))
        reg.gauge("nns_depth", fn=None, queue=f"q{i}").set(
            float(rng.integers(0, 64)))
        hist = reg.histogram("nns_lat_us", element=f"e{i}")
        for v in rng.lognormal(7.0, 1.0, int(rng.integers(5, 100))):
            hist.observe(float(v))
    return reg


def collector_of(mod, **kw):
    """A collector of package ``mod`` that signals each ingest."""
    class _Signalling(mod.MetricsCollector):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.cv = threading.Condition()
            self.ingests = 0

        def ingest(self, payload, now=None):
            ok = super().ingest(payload, now)
            with self.cv:
                self.ingests += 1
                self.cv.notify_all()
            return ok

        def wait_ingests(self, n: int, timeout: float = 15.0) -> bool:
            with self.cv:
                return self.cv.wait_for(lambda: self.ingests >= n,
                                        timeout)

    kw.setdefault("registry", None)
    kw.setdefault("local_origin", "collector:0")
    return _Signalling(**kw)


def _frames(mod, reg, pushes, monkeypatch) -> bytes:
    """The bytes a publisher of ``mod`` writes for ``pushes`` pushes of
    ``reg`` (wall clock and incarnation pinned; the offset ping it
    sends after the first push is answered by nobody)."""
    monkeypatch.setattr(mod, "wall_us", lambda: WALL_US)
    a, b = socket.socketpair()
    try:
        a.settimeout(0.05)
        pub = mod.MetricsPublisher("127.0.0.1", 1, registry=reg,
                                   origin="w:1")
        pub.epoch = 12345
        pub._sock = a
        out = b""
        for step in pushes:
            step(reg)
            assert pub.push()
        b.setblocking(False)
        while True:
            try:
                chunk = b.recv(1 << 20)
            except BlockingIOError:
                break
            if not chunk:
                break
            out += chunk
        return out
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("seed", range(3))
def test_metrics_frames_byte_equal_to_jax(seed, monkeypatch):
    def bump(reg):
        reg.counter("nns_req_total", **{"class": "c0"}).inc(seed + 1)

    pushes = [lambda reg: None, bump, lambda reg: None]
    got = _frames(fed, fill_registry(metrics, seed), pushes, monkeypatch)
    want = _frames(jax_fed, fill_registry(jax_metrics, seed), pushes,
                   monkeypatch)
    assert got == want and len(got) > 100


def _serve_and_push(col_mod, pub_mod, reg, pushes):
    col = collector_of(col_mod)
    srv = col_mod.CollectorServer(col)
    pub = pub_mod.MetricsPublisher("127.0.0.1", srv.port, registry=reg,
                                   origin="w:1", full_every=1000)
    try:
        for step in pushes:
            step(reg)
            assert pub.push()
        assert col.wait_ingests(len(pushes))
    finally:
        pub.stop(final_push=False)
        srv.close()
    return col


@pytest.mark.parametrize("seed", range(2))
def test_cross_package_federation_both_ways(seed):
    """A JAX publisher into a port collector and a port publisher into a
    JAX collector: the two federated views and expositions are equal,
    and equal to the worker registry's own counts."""
    def bump(reg):
        reg.counter("nns_req_total", **{"class": "c1"}).inc(7)

    pushes = [lambda reg: None, bump]
    port_col = _serve_and_push(fed, jax_fed, fill_registry(jax_metrics,
                                                           seed), pushes)
    jax_col = _serve_and_push(jax_fed, fed, fill_registry(metrics, seed),
                              pushes)
    assert port_col.snapshot_state() == jax_col.snapshot_state()
    assert port_col.render_prometheus() == jax_col.render_prometheus()
    own = fill_registry(metrics, seed)
    bump(own)
    for key, st in own.snapshot_state().items():
        name, brace, labels = key.partition("{")
        fkey = (f'{name}{{{labels[:-1]},origin="w:1"}}' if brace
                else f'{name}{{origin="w:1"}}')
        # as the wire carries it: JSON, tuples as lists
        assert port_col.snapshot_state()[fkey] == \
            json.loads(json.dumps(st))


def payload(origin="w:1", seq=1, epoch="e1", full=True, state=None,
            health="serving"):
    return {"origin": origin, "seq": seq, "epoch": epoch, "full": full,
            "wall_us": 1_000_000, "offset_us": 0, "health": health,
            "state": state if state is not None else
            {"nns_x_total": {"kind": "counter", "value": seq}}}


def scripted_pushes(seed: int):
    """A seeded push sequence over three origins: full and delta pushes,
    duplicates and late arrivals, a restart (new epoch), poisoned
    entries, malformed payloads, and injected arrival times."""
    rng = np.random.default_rng(seed)
    out = []
    seqs = {"w:1": 0, "w:2": 0, "w:3": 0}
    epochs = {o: "e0" for o in seqs}
    t = 1000.0
    for _ in range(40):
        t += float(rng.integers(1, 30))
        origin = list(seqs)[int(rng.integers(0, 3))]
        r = rng.random()
        if r < 0.08:
            out.append((b"not json", t))
            continue
        if r < 0.15:                        # a restart: new epoch, full
            epochs[origin] = f"e{int(rng.integers(1, 1000))}"
            seqs[origin] = 0
        seq = seqs[origin] + 1
        if r > 0.9 and seqs[origin] > 2:    # a late or duplicate push
            seq = seqs[origin] - int(rng.integers(0, 2))
        else:
            seqs[origin] = seq
        state = {f"nns_c{i}_total": {"kind": "counter",
                                     "value": int(rng.integers(0, 99))}
                 for i in range(int(rng.integers(1, 4)))}
        state["nns_g"] = {"kind": "gauge", "value": float(rng.random())}
        if rng.random() < 0.2:
            state["nns_bad"] = {"kind": "gauge", "value": None}
        if rng.random() < 0.3:
            counts = [0] * 128
            counts[int(rng.integers(0, 128))] = int(rng.integers(1, 50))
            state["nns_lat_us"] = {"kind": "histogram",
                                   "count": sum(counts), "total": 5e4,
                                   "counts": counts}
        out.append((payload(origin, seq, epochs[origin],
                            full=bool(r < 0.15 or rng.random() < 0.3),
                            state=state,
                            health=["serving", "degraded", "draining"][
                                int(rng.integers(0, 3))]), t))
    return out, t


@pytest.mark.parametrize("seed", range(5))
def test_collector_merge_equals_jax(seed):
    script, t_end = scripted_pushes(seed)
    cols = [m.MetricsCollector(registry=None, local_origin="me:0",
                               stale_after_s=200.0)
            for m in (fed, jax_fed)]
    results = [[c.ingest(p, now=t) for p, t in script] for c in cols]
    assert results[0] == results[1]
    port_col, jax_col = cols
    assert port_col.evict_stale(now=t_end) == \
        jax_col.evict_stale(now=t_end)
    assert port_col.origins(now=t_end) == jax_col.origins(now=t_end)
    with port_col._lock, jax_col._lock:
        for o in (port_col, jax_col):
            for origin in o._origins.values():
                origin.last_push_mono = 0.0    # pin the age clock
    assert port_col.snapshot_state() == jax_col.snapshot_state()
    assert port_col.render_prometheus() == jax_col.render_prometheus()
    assert port_col.report() == jax_col.report()


def test_query_server_piggyback_takes_a_jax_publisher():
    from nnstreamer_tpu_torch.query.server import QueryServer

    worker = jax_metrics.MetricsRegistry()
    worker.counter("nns_pig_total").inc(3)
    col = collector_of(fed)
    srv = QueryServer(port=0)
    srv.collector = col
    pub = jax_fed.MetricsPublisher("127.0.0.1", srv.port, registry=worker,
                                   origin="w:9")
    try:
        assert pub.push()
        assert col.wait_ingests(1)
        assert col.snapshot_state()[
            'nns_pig_total{origin="w:9"}']["value"] == 3
    finally:
        pub.stop(final_push=False)
        srv.close()


def test_collector_health_rides_healthz():
    col = fed.MetricsCollector(registry=None)
    token = col.register_health()
    try:
        col.ingest(payload(origin="w:1", health="serving"))
        assert httpd.health_report()["ready"]
        col.ingest(payload(origin="w:1", seq=2, health="draining"))
        report = httpd.health_report()
        assert report["state"] == "draining" and not report["ready"]
        assert report["sources"]["federation"] == "draining"
    finally:
        httpd.unregister_health_source(token)


def test_cli_worker_pushes_into_a_port_collector(tmp_path):
    """A port CLI worker (an echo query server under ``--soak``) pushes
    its registry with ``--push-metrics``; this process sends it frames.
    The federated counters equal the worker's own (``--trace-out``)."""
    from nnstreamer_tpu_torch.query import QueryConnection
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    col = collector_of(fed)
    srv = fed.CollectorServer(col)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / "w.json"
    child = subprocess.Popen(
        [sys.executable, "-m", "nnstreamer_tpu_torch.launch",
         f"tensor_query_serversrc id=1 port={port} caps={CAPS4} ! "
         "tensor_query_serversink id=1", "--soak", "4",
         "--push-metrics", f"127.0.0.1:{srv.port}", "--push-interval",
         "0.2", "--trace-out", str(out), "--quiet"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        stderr=subprocess.PIPE, text=True)
    try:
        conn = QueryConnection("127.0.0.1", port, timeout=30.0,
                               max_retries=60)
        conn.connect()
        try:
            for k in range(12):
                got = conn.query(TensorBuffer(
                    tensors=[np.full(4, k, np.float32)]))
                np.testing.assert_array_equal(got.np(0),
                                              np.full(4, k, np.float32))
        finally:
            conn.close()
        _, err = child.communicate(timeout=120)
        assert child.returncode == 0, err[-1500:]
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        srv.close()
    own = json.loads(out.read_text())["metrics"]
    fam = "nns_query_server_admitted_total"
    federated = sum(st["value"] for k, st in col.snapshot_state().items()
                    if k.startswith(fam))
    assert federated == sum(v for k, v in own.items()
                            if k.startswith(fam)) == 12
    assert len(col.origins()) == 1
