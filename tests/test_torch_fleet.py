"""The port's serving fleet (``fleet/``) against the JAX package's.

Host logic is compared exactly: the same ``(seed, vnodes, members)``
places the same keys on both rings, the same signal sequences give the
same autoscaler decisions at the same ticks, and the same scripted
fake-process runs (seeded jitter on the clock) give the same pool
decisions.  The router is driven across packages over real sockets:
the JAX client through the port's router to a port worker, and the
port's client through the port's router to a JAX worker.  Then the
port's dashboard over the live router's gauges, ``--check`` on a fleet
document, and one kill leg of the port's fleet soak with three real
worker processes on the CPU.  Every comparison here is exact.
"""

import json
import signal

import numpy as np
import pytest

from nnstreamer_tpu import fleet as jax_fleet
from nnstreamer_tpu.elements import TensorTransform as JaxTransform
from nnstreamer_tpu.obs import metrics as jax_metrics
from nnstreamer_tpu.obs import timeseries as jax_timeseries
from nnstreamer_tpu.pipeline import Pipeline as JaxPipeline
from nnstreamer_tpu.query import client as jax_client
from nnstreamer_tpu.query import server as jax_server
from nnstreamer_tpu.query import shutdown_server as jax_shutdown_server
from nnstreamer_tpu.query.overload import ShedError as JaxShedError
from nnstreamer_tpu.tensor import TensorBuffer as JaxTensorBuffer
from nnstreamer_tpu_torch import fleet
from nnstreamer_tpu_torch.elements import TensorTransform
from nnstreamer_tpu_torch.fleet import soak
from nnstreamer_tpu_torch.obs import metrics, timeseries
from nnstreamer_tpu_torch.pipeline import Pipeline
from nnstreamer_tpu_torch.query import client, server
from nnstreamer_tpu_torch.query import shutdown_server
from nnstreamer_tpu_torch.query.overload import ShedError
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

#: per package: the fleet, its metrics and time-series modules, the
#: query client and server modules, the transform element, Pipeline,
#: shutdown_server, ShedError and TensorBuffer
PKGS = {
    "torch": (fleet, metrics, timeseries, client, server, TensorTransform,
              Pipeline, shutdown_server, ShedError, TensorBuffer),
    "jax": (jax_fleet, jax_metrics, jax_timeseries, jax_client, jax_server,
            JaxTransform, JaxPipeline, jax_shutdown_server, JaxShedError,
            JaxTensorBuffer),
}
CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
         "types=float32,framerate=0/1")


# ---------------------------------------------------------------------------
# consistent-hash ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,vnodes,members", [
    ("nns-fleet", 64, 3), ("nns-fleet", 16, 5), ("fleet-b", 1, 4),
    ("x" * 80, 128, 7)])
def test_ring_places_keys_as_jax(seed, vnodes, members):
    rng = np.random.default_rng(len(seed) * 1000 + vnodes + members)
    names = [f"10.0.{rng.integers(256)}.{rng.integers(256)}:"
             f"{rng.integers(1024, 65535)}" for _ in range(members + 1)]
    keys = [f"model-{rng.integers(1 << 30)}" for _ in range(1000)]
    # insertion order differs between the two: placement must not
    ring = fleet.ConsistentHashRing(names[:members], vnodes=vnodes,
                                    seed=seed)
    jring = jax_fleet.ConsistentHashRing(names[:members][::-1],
                                         vnodes=vnodes, seed=seed)

    def same():
        assert ring.members == jring.members
        assert ring.assignment(keys) == jring.assignment(keys)
        for k in keys[:100]:
            assert ring.lookup_n(k, 3) == jring.lookup_n(k, 3)

    same()
    assert ring.add(names[members]) == jring.add(names[members]) is True
    same()
    assert ring.remove(names[0]) == jring.remove(names[0]) is True
    same()
    assert ring.remove("nobody") == jring.remove("nobody") is False
    assert fleet.ConsistentHashRing().lookup("k") is None


# ---------------------------------------------------------------------------
# worker pool (fake processes, injected clock)
# ---------------------------------------------------------------------------

class FakeProc:
    def __init__(self, pid):
        self.pid = pid
        self.rc = None
        self.signals = []
        self.killed = False

    def poll(self):
        return self.rc

    def send_signal(self, sig):
        self.signals.append(int(sig))

    def kill(self):
        self.killed = True
        self.rc = -9

    def wait(self, timeout=None):
        return self.rc

    def exit(self, rc=0):
        self.rc = rc


class PoolHarness:
    """One package's WorkerPool over fake processes on an injected
    clock; ``log`` records every callback and spawn in order."""

    def __init__(self, mod, fail_spawns=(), **kw):
        self.clock = [0.0]
        self.procs = []
        self.log = []
        self.ports = iter(range(7000, 7999))
        self.fail_spawns = set(fail_spawns)
        kw.setdefault("ready_fn", lambda w: True)
        self.pool = mod.WorkerPool(
            spawn_fn=self._spawn,
            port_fn=lambda: next(self.ports),
            clock=lambda: self.clock[0],
            on_up=lambda w: self.log.append(("up", w.key)),
            on_draining=lambda w: self.log.append(("draining", w.key)),
            on_down=lambda w: self.log.append(("down", w.key)),
            **kw)

    def _spawn(self, host, port):
        n = len(self.procs) + len(self.log)
        if n in self.fail_spawns:
            self.fail_spawns.discard(n)
            self.log.append(("spawn-failed", port))
            raise OSError("no fds")
        proc = FakeProc(50000 + len(self.procs))
        self.procs.append(proc)
        self.log.append(("spawn", port))
        return proc

    def tick(self, t):
        self.clock[0] = t
        self.pool.tick(t)

    def record(self):
        return {"log": self.log, "events": list(self.pool.events),
                "workers": self.pool.workers(),
                "target": self.pool.target,
                "serving": self.pool.serving_count(),
                "streak": self.pool._crash_streak,
                "procs": [(p.signals, p.killed) for p in self.procs]}


def _script(seed: int, steps: int = 60):
    """A seeded run: the clock advances by a jittered step each time,
    and each step does one of tick / crash a worker / scale up / scale
    down / age or evict an origin."""
    rng = np.random.default_rng(seed)
    t, ops = 0.0, []
    for _ in range(steps):
        t += float(rng.uniform(0.05, 2.5))
        op = rng.choice(["tick", "tick", "tick", "crash", "up", "down",
                         "age", "exit"])
        ops.append((round(t, 3), str(op), int(rng.integers(1 << 16)),
                    float(rng.uniform(0.0, 40.0))))
    return ops


def _drive(mod, ops, ages, **kw):
    h = PoolHarness(mod, **kw)
    h.pool.start()
    for t, op, pick, age in ops:
        h.clock[0] = t
        live = [p for p in h.procs if p.rc is None]
        if op == "crash" and live:
            live[pick % len(live)].exit(1)
        elif op == "exit" and live:
            live[pick % len(live)].exit(0)
        elif op == "up":
            h.pool.scale_up(t)
        elif op == "down":
            h.pool.scale_down(t)
        elif op == "age":
            ages["age"] = None if pick % 5 == 0 else age
        h.tick(t)
    return h.record()


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
def test_pool_seeded_run_equals_jax(seed):
    """Spawns, restarts with backoff, crash streaks, stale and evicted
    origins, ready timeouts, drains and reaps: the same script gives
    the same decisions, event for event."""
    ops = _script(seed)
    runs = []
    for mod in (fleet, jax_fleet):
        ages = {"age": 0.5}
        kw = dict(min_workers=2, max_workers=4, restart_backoff_s=0.7,
                  restart_backoff_max_s=6.0, stale_kill_s=15.0,
                  ready_timeout_s=5.0, drain_grace_s=2.0,
                  origin_age_fn=lambda w, a=ages: a["age"],
                  fail_spawns={3, 11})
        if seed % 2:
            # readiness from the origin's age (the federation default)
            kw["ready_fn"] = None
        runs.append(_drive(mod, ops, ages, **kw))
    assert runs[0] == runs[1]
    assert any(e["event"] == "crashed" for e in runs[0]["events"])


@pytest.mark.parametrize("case", [
    "start", "crash_backoff", "streak_reset", "scale_down_order",
    "min_max", "stale_kill", "evicted", "ready_timeout",
    "spawn_failure"])
def test_pool_decisions_equal_jax(case):
    """The JAX pool tests' scenarios, run on both packages."""
    def run(mod):
        ages = {"age": 0.0}
        if case == "start":
            h = PoolHarness(mod, min_workers=3, max_workers=5)
            h.pool.start()
            h.tick(1.0)
        elif case == "crash_backoff":
            h = PoolHarness(mod, min_workers=1, max_workers=2,
                            restart_backoff_s=2.0)
            h.pool.start()
            h.tick(1.0)
            h.procs[0].exit(1)
            for t in (2.0, 3.0, 4.5, 5.0):
                h.tick(t)
        elif case == "streak_reset":
            h = PoolHarness(mod, min_workers=1, max_workers=2,
                            restart_backoff_s=1.0,
                            restart_backoff_max_s=8.0)
            h.pool.start()
            h.tick(0.5)
            h.procs[-1].exit(1)
            h.tick(1.0)
            h.tick(2.1)
            h.procs[-1].exit(1)
            for t in (2.2, 4.3, 4.4):
                h.tick(t)
        elif case == "scale_down_order":
            h = PoolHarness(mod, min_workers=1, max_workers=3)
            h.pool.start()
            h.tick(1.0)
            h.pool.scale_up(1.0)
            h.tick(2.0)
            assert h.pool.scale_down(3.0) is not None
            assert h.procs[-1].signals == [int(signal.SIGTERM)]
            h.procs[-1].exit(0)
            h.tick(4.0)
        elif case == "min_max":
            h = PoolHarness(mod, min_workers=2, max_workers=2)
            h.pool.start()
            h.tick(1.0)
            assert h.pool.scale_down(2.0) is None
            assert h.pool.scale_up(2.0) is None
        elif case in ("stale_kill", "evicted"):
            ages["age"] = 0.5
            h = PoolHarness(mod, min_workers=1, max_workers=2,
                            restart_backoff_s=1.0, stale_kill_s=10.0,
                            origin_age_fn=lambda w: ages["age"])
            h.pool.ready_fn = None
            h.pool.start()
            h.tick(1.0)
            ages["age"] = 30.0 if case == "stale_kill" else None
            h.tick(2.0)
            h.tick(3.5)
            ages["age"] = 0.1
            h.tick(4.0)
        elif case == "ready_timeout":
            h = PoolHarness(mod, min_workers=1, max_workers=2,
                            ready_fn=lambda w: False, ready_timeout_s=5.0)
            h.pool.start()
            h.tick(6.0)
            h.tick(8.0)
        else:
            h = PoolHarness(mod, fail_spawns={0, 1}, min_workers=1,
                            max_workers=3, restart_backoff_s=5.0)
            h.pool.start()                      # the spawn fails
            assert h.pool.scale_up(1.0) is None  # inside the backoff
            h.clock[0] = 10.0
            assert h.pool.scale_up(10.0) is None  # fails again
            h.tick(16.0)                        # respawn after backoff
        return h.record()

    got, want = run(fleet), run(jax_fleet)
    assert got == want


def test_pool_config_guards_equal_jax():
    for mod in (fleet, jax_fleet):
        with pytest.raises(ValueError, match="fleet-zero-workers"):
            PoolHarness(mod, min_workers=0, max_workers=2)
        with pytest.raises(ValueError, match="fleet-minmax"):
            PoolHarness(mod, min_workers=3, max_workers=2)


# ---------------------------------------------------------------------------
# autoscaler (injected clock + synthetic ring captures)
# ---------------------------------------------------------------------------

class AscHarness:
    """One package's pool on fakes + ring over a private registry +
    autoscaler, all on ONE injected clock (the JAX tests' harness)."""

    def __init__(self, pkg, min_workers=1, max_workers=3):
        mod, mets, ts = PKGS[pkg][:3]
        self.cfg = mod.AutoscalerConfig(
            occupancy_high=0.0, queue_high_frac=0.0,
            rate_high_rps=50.0, rate_low_rps=1.0,
            hold_s=3.0, idle_hold_s=4.0,
            spawn_cooldown_s=10.0, drain_cooldown_s=5.0,
            post_spawn_guard_s=8.0)
        self.pool_h = PoolHarness(mod, min_workers=min_workers,
                                  max_workers=max_workers)
        self.registry = mets.MetricsRegistry()
        self.counter = self.registry.counter(
            "nns_query_server_admitted_total")
        self.ring = ts.TimeSeriesRing(self.registry, interval_s=1.0)
        signals = mod.default_autoscaler_signals(self.ring, self.cfg)
        self.asc = mod.Autoscaler(self.pool_h.pool, signals["up"],
                                  signals["down"], cfg=self.cfg,
                                  clock=lambda: self.pool_h.clock[0]
                                  ).attach(self.ring)
        self.pool_h.pool.start()
        self.step(0.0, rps=0)

    def step(self, t, rps=0):
        self.pool_h.clock[0] = t
        self.counter.inc(int(rps))
        self.ring.capture(now=t)
        self.pool_h.pool.tick(t)
        self.asc.tick(t)

    def record(self):
        return {"decisions": list(self.asc.decisions),
                "report": self.asc.report(),
                "pool": self.pool_h.record()}


#: the JAX autoscaler tests' signal sequences: (second, admitted/s)
ASC_SEQUENCES = {
    "sustained_vs_blip": [(1, 0), (2, 200), (3, 0), (4, 0)]
    + [(t, 200) for t in range(5, 12)],
    "cooldown_to_max": [(t, 200) for t in range(1, 40)],
    "idle_drains_after_guard": [(t, 200) for t in range(1, 8)]
    + [(t, 0) for t in range(8, 50)],
    "idle_never_during_load": [(t, 30) for t in range(1, 20)],
    "seeded": None,
}


@pytest.mark.parametrize("name", sorted(ASC_SEQUENCES))
def test_autoscaler_decisions_equal_jax(name):
    seq = ASC_SEQUENCES[name]
    if seq is None:
        rng = np.random.default_rng(7)
        seq = [(t, int(rng.choice([0, 0, 30, 200, 400])))
               for t in range(1, 80)]
    got, want = AscHarness("torch"), AscHarness("jax")
    for t, rps in seq:
        got.step(float(t), rps=rps)
        want.step(float(t), rps=rps)
        assert got.asc.decisions == want.asc.decisions, t
    assert got.record() == want.record()


# ---------------------------------------------------------------------------
# router across packages (real sockets, in-process workers)
# ---------------------------------------------------------------------------

def serve(pkg, sid, mul=2, **src_props):
    """One in-process serving pipeline of ``pkg``; (pipeline, port)."""
    _, _, _, _, srv, transform, pipeline = PKGS[pkg][:7]
    p = pipeline(f"fleet-server-{sid}")
    src = srv.TensorQueryServerSrc("qsrc", id=sid, port=0, caps=CAPS4,
                                   **src_props)
    t = transform("t", mode="arithmetic", option=f"mul:{mul}")
    sink = srv.TensorQueryServerSink("qsink", id=sid)
    p.add(src, t, sink)
    p.link(src, t, sink)
    p.play()
    return p, src.bound_port


def stop(pkg, *served):
    for p, sid in served:
        try:
            p.stop()
        except Exception:   # noqa: BLE001 — already stopped by the test
            pass
        PKGS[pkg][7](sid)


def qframe(pkg, value=1.0):
    return PKGS[pkg][9](tensors=[np.full(4, value, np.float32)])


def connect(pkg, port, **kw):
    conn = PKGS[pkg][3].QueryConnection("127.0.0.1", port, **kw)
    conn.connect()
    return conn


def model_with_first(router, key):
    """A model name whose ring preference order starts at ``key``."""
    for i in range(256):
        cands = router.ring.lookup_n(f"m{i}", max(
            1, router.replicas or len(router.ring)))
        if cands and cands[0] == key:
            return f"m{i}"
    raise AssertionError("no model hashing to the wanted worker")


#: (client package, worker package): the JAX client through the port's
#: router to a port worker, and the port's client to a JAX worker
LEGS = [("jax", "torch"), ("torch", "jax")]


@pytest.mark.parametrize("cli,wrk", LEGS)
def test_router_round_trip_and_caps(cli, wrk):
    sid = 1240 + (cli == "torch")
    p, port = serve(wrk, sid, mul=2)
    r = fleet.TensorQueryRouter(port=0)
    try:
        r.add_worker("127.0.0.1", port)
        conn = connect(cli, r.port, timeout=5.0)
        assert conn.wait_server_caps(5.0) == CAPS4
        out = conn.query(qframe(cli, 2.0))
        np.testing.assert_array_equal(out.np(0), np.full(4, 4.0,
                                                         np.float32))
        assert r.workers()[0]["routed"] == 1
        conn.close()
    finally:
        r.close()
        stop(wrk, (p, sid))


@pytest.mark.parametrize("cli,wrk", LEGS)
def test_router_kill_rotates_zero_client_errors(cli, wrk):
    base = 1250 + 2 * (cli == "torch")
    (pa, port_a), (pb, port_b) = serve(wrk, base, 2), serve(wrk, base + 1,
                                                            3)
    r = fleet.TensorQueryRouter(port=0, replicas=2)
    try:
        ka = r.add_worker("127.0.0.1", port_a)
        r.add_worker("127.0.0.1", port_b)
        conn = connect(cli, r.port, timeout=10.0,
                       model=model_with_first(r, ka))
        assert float(conn.query(qframe(cli)).np(0)[0]) == 2.0
        # hard-stop the worker this client is routed to: the failover
        # leg rotates and the client sees only a slower answer
        stop(wrk, (pa, base))
        for _ in range(3):
            assert float(conn.query(qframe(cli)).np(0)[0]) == 3.0
        conn.close()
    finally:
        r.close()
        stop(wrk, (pa, base), (pb, base + 1))


@pytest.mark.parametrize("cli,wrk", LEGS)
def test_router_drain_rebalances_live_client(cli, wrk):
    base = 1260 + 2 * (cli == "torch")
    (pa, port_a), (pb, port_b) = serve(wrk, base, 2), serve(wrk, base + 1,
                                                            3)
    r = fleet.TensorQueryRouter(port=0, replicas=1)
    try:
        ka = r.add_worker("127.0.0.1", port_a)
        kb = r.add_worker("127.0.0.1", port_b)
        conn = connect(cli, r.port, timeout=5.0,
                       model=model_with_first(r, ka))
        assert float(conn.query(qframe(cli)).np(0)[0]) == 2.0
        r.mark_draining(ka)        # route away BEFORE any SIGTERM
        assert float(conn.query(qframe(cli)).np(0)[0]) == 3.0
        rows = {w["worker"]: w for w in r.workers()}
        assert rows[ka]["draining"] is True
        assert rows[kb]["draining"] is False
        assert rows[kb]["routed"] == 1
        conn.close()
    finally:
        r.close()
        stop(wrk, (pa, base), (pb, base + 1))


@pytest.mark.parametrize("cli,wrk", LEGS)
def test_router_rehello_rebinds(cli, wrk):
    base = 1270 + 2 * (cli == "torch")
    (pa, port_a), (pb, port_b) = serve(wrk, base, 2), serve(wrk, base + 1,
                                                            3)
    r = fleet.TensorQueryRouter(port=0, replicas=1)
    try:
        ka = r.add_worker("127.0.0.1", port_a)
        kb = r.add_worker("127.0.0.1", port_b)
        conn = connect(cli, r.port, timeout=5.0,
                       model=model_with_first(r, ka))
        assert float(conn.query(qframe(cli)).np(0)[0]) == 2.0
        # re-negotiate the model mid-connection: the router rebinds the
        # backend leg to the NEW model's candidate set at once
        from nnstreamer_tpu.query import protocol as jax_protocol
        from nnstreamer_tpu_torch.query import protocol

        proto = protocol if cli == "torch" else jax_protocol
        conn.model = model_with_first(r, kb)
        conn._send(proto.Message(proto.T_HELLO,
                                 payload=conn._hello_payload()))
        assert float(conn.query(qframe(cli)).np(0)[0]) == 3.0
        conn.close()
    finally:
        r.close()
        stop(wrk, (pa, base), (pb, base + 1))


@pytest.mark.parametrize("cli,wrk", LEGS)
def test_router_shed_passes_through(cli, wrk):
    """A worker with a ~zero-rate token bucket sheds the second query;
    with no alternate the router forwards that exact T_SHED."""
    sid = 1280 + (cli == "torch")
    p, port = serve(wrk, sid, 2, **{"capacity-rps": 0.001})
    r = fleet.TensorQueryRouter(port=0)
    try:
        r.add_worker("127.0.0.1", port)
        conn = connect(cli, r.port, timeout=5.0)
        conn.query(qframe(cli))             # the burst token
        with pytest.raises(PKGS[cli][8]) as exc:
            conn.query(qframe(cli))
        assert exc.value.retry_after_s > 0
        conn.close()
    finally:
        r.close()
        stop(wrk, (p, sid))


def test_router_gauges_cleaned_up_on_close():
    p, port = serve("torch", 1290)
    r = fleet.TensorQueryRouter(port=0)
    r.add_worker("127.0.0.1", port)
    assert any(k.startswith("nns_fleet_role")
               for k in metrics.REGISTRY.report())
    r.close()
    stop("torch", (p, 1290))
    assert [k for k in metrics.REGISTRY.report()
            if k.startswith("nns_fleet_")] == []


def test_router_gauge_families_equal_jax():
    """Both routers export the same nns_fleet_* series for the same
    membership (the dashboard reads either)."""
    keys = []
    for mod, mets in ((fleet, metrics), (jax_fleet, jax_metrics)):
        r = mod.TensorQueryRouter(port=0)
        try:
            r.add_worker("127.0.0.1", 65001)
            r.add_worker("127.0.0.1", 65002)
            r.mark_draining("127.0.0.1:65002")
            rep = mets.REGISTRY.report()
            keys.append(sorted(k.replace(str(r.port), "P") for k in rep
                               if k.startswith("nns_fleet_")))
        finally:
            r.close()
    assert keys[0] == keys[1] and keys[0]


# ---------------------------------------------------------------------------
# dashboard fleet view, --check on a fleet document
# ---------------------------------------------------------------------------

def test_live_router_rides_scrape_shape():
    """The router's own gauges flatten into exactly the keys the port's
    dashboard parses: its fleet rows come from the live router."""
    from nnstreamer_tpu_torch.obs.dashboard import build_view, render_frame

    r = fleet.TensorQueryRouter(port=0)
    try:
        r.add_worker("127.0.0.1", 65001)
        r.add_worker("127.0.0.1", 65002)
        r.mark_draining("127.0.0.1:65002")
        flat = timeseries.flatten_state(metrics.REGISTRY.snapshot_state(
            prefix="nns_fleet"))
        view = build_view([(0.0, flat)])
        assert [(w["worker"], w["draining"]) for w in view["fleet"]] == \
            [("127.0.0.1:65001", False), ("127.0.0.1:65002", True)]
        text = render_frame(view, clock=0.0)
        assert "127.0.0.1:65002" in text and "draining" in text
    finally:
        r.close()


GOOD_CONFIG = {
    "worker_launch": "tensor_query_serversrc port={port} caps=x ! "
                     "tensor_query_serversink",
    "min_workers": 2, "max_workers": 4,
    "drain_grace_s": 10.0, "worker_batch_timeout_ms": 30.0,
}


def test_check_cli_on_fleet_json(tmp_path, capsys):
    from nnstreamer_tpu import launch as jax_launch
    from nnstreamer_tpu_torch import launch

    path = tmp_path / "fleet.json"
    for doc, rc in ((dict(GOOD_CONFIG, min_workers=9, max_workers=2), 1),
                    (GOOD_CONFIG, 0)):
        path.write_text(json.dumps(doc))
        assert launch.main([str(path), "--check"]) == rc
        err = capsys.readouterr().err
        assert jax_launch.main([str(path), "--check"]) == rc
        assert err == capsys.readouterr().err
        assert ("fleet-minmax" in err) == bool(rc)


def test_exports_equal_jax():
    assert sorted(fleet.__all__) == sorted(jax_fleet.__all__)


# ---------------------------------------------------------------------------
# the fleet soak's kill leg with real worker processes
# ---------------------------------------------------------------------------

def test_soak_kill_leg_with_three_real_workers(tmp_path):
    """Three ``python -m nnstreamer_tpu_torch.launch --soak`` workers of
    the light template (host elements only) behind the router; open-loop
    load, one worker SIGKILLed mid-leg: zero client errors, the pool
    restarts it, the restarted worker serves, every reply is the
    frame x 2."""
    replies, bad = [], []

    def on_reply(c, i, out):
        replies.append((c, i))
        if not np.array_equal(out.np(0), np.full(4, 2.0 * (c + i),
                                                 np.float32)):
            bad.append((c, i))

    f = soak.SoakFleet(3, log_dir=str(tmp_path / "workers"))
    try:
        assert f.start(up_timeout_s=40.0), list(f.pool.events)
        gen = metrics_free_load(f.router.port, on_reply)
        leg = soak.kill_leg(f, gen, 8.0, recover_s=40.0)
        summary = leg["loadgen"]
        assert summary["errors"] == 0, summary
        assert summary["sent"] == summary["ok"] + summary["shed"]
        assert leg["kill"] and leg["recovered"], leg
        assert leg["restarted"] is not None, list(f.pool.events)
        assert len(replies) == summary["ok"] and not bad
        assert f.pool.serving_count() == 3
        killed = leg["kill"]["worker"]
        assert killed not in [w["worker"] for w in f.router.workers()]
        times = f.event_times()
        assert len(times["ready_s"]) == 4
    finally:
        f.close()


def metrics_free_load(port, on_reply):
    """16 open-loop clients at 40 requests/s through the router; request
    ``i`` of client ``c`` carries ``c + i`` in every element."""
    from nnstreamer_tpu_torch.slo import LoadGenerator

    return LoadGenerator(
        "127.0.0.1", port, clients=16, rate_hz=40.0 / 16, duration_s=8.0,
        seed=3, timeout=5.0,
        payload_fn=lambda c, i: np.full(4, float(c + i), np.float32),
        on_reply=on_reply, registry=metrics.MetricsRegistry())


TERM_CHILD = """
import signal, sys, threading, time
from nnstreamer_tpu_torch import launch

def term_from_another_thread():
    time.sleep(3.0)
    # a thread-directed SIGTERM: the C-level handler runs in THIS thread,
    # as when the kernel hands a process signal to a CUDA runtime thread
    signal.pthread_kill(threading.get_ident(), signal.SIGTERM)

threading.Thread(target=term_from_another_thread, daemon=True).start()
t0 = time.monotonic()
try:
    rc = launch.main(sys.argv[1:])
except SystemExit as exc:
    rc = exc.code
print("exit", rc, round(time.monotonic() - t0, 1))
"""


def test_sigterm_drains_when_another_thread_takes_the_signal():
    """A worker's SIGTERM drain runs although the signal lands on a
    thread other than the main one (seen on a GPU host): the main
    thread waits in short slices, so the drain runs within a second,
    not at the end of ``--soak``."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    line = soak.FLEET_WORKER_TEMPLATE.format(port=0)
    r = subprocess.run(
        [sys.executable, "-c", TERM_CHILD, line, "--soak", "60",
         "--drain-grace", "1", "--quiet"], capture_output=True, text=True,
        timeout=120, cwd=repo, env=dict(os.environ, PYTHONPATH=repo))
    assert "SIGTERM: draining" in r.stderr, r.stderr[-1500:]
    rc, took = r.stdout.split()[-2:]
    assert rc == "0" and float(took) < 20.0, r.stdout
