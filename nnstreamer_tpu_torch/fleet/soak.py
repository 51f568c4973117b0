"""Fleet acceptance soak: a real multi-process fleet under load, three legs.

The port of ``tools/soak.py --fleet`` (``run_fleet`` and the helpers it
needs from that file): a :class:`~.router.TensorQueryRouter` in this
process, ``workers`` ``python -m nnstreamer_tpu_torch.launch --soak``
processes spawned by a :class:`~.pool.WorkerPool` and federating into
this process's collector, open-loop load
(:class:`~nnstreamer_tpu_torch.slo.loadgen.LoadGenerator`) through the
router's one endpoint:

1. **kill leg** — load under the demo latency SLO; mid-leg one worker is
   SIGKILLed.  The pool restarts it and the router's failover legs
   rotate its clients: the gate is ZERO client errors (sheds allowed)
   with the admitted-latency objective held;
2. **scale-up leg** — offered load past the autoscaler's sustained
   admitted-rate watermark: the serving count must reach N+1;
3. **idle leg** — load stops; the ``fleet_idle`` below-threshold
   signal holds and one worker drains back (route-away, SIGTERM
   drain, reap).

Rate thresholds derive from a capacity probe through the router, so
the soak is honest on any host.  It prints ONE verdict line (``"metric":
"soak_fleet"``) and writes ``verdict.json`` under the output directory;
exit 0 = PASS, 1 = FAIL, 2 = the fleet never came up.

The worker template is a parameter (``{port}`` is filled per worker).
The default is the light demo serving pipeline on the host, so the
soak exercises fleet mechanics, not model compile time::

    python -m nnstreamer_tpu_torch.fleet.soak --duration 40 --out soak_out

Embedders (``run_fleet``) may also hand in their own spawn function,
readiness test, capacity probe and per-request payloads and reply
hook, to run the same legs over a model on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..obs.clock import mono_ns

DEMO_CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
             "types=float32,framerate=0/1")
FLEET_SERVER_ID = 94

#: the fleet workers' launch template (``launch_spawn_fn`` fills
#: {port}): the light demo serving pipeline on the host (its
#: tensor_transform runs on the CPU), so the soak exercises fleet
#: mechanics — routing, kill/rebalance, autoscaling — not model compile
#: time
FLEET_WORKER_TEMPLATE = (
    f"tensor_query_serversrc name=qsrc id={FLEET_SERVER_ID} "
    "port={port} caps=" + DEMO_CAPS + " ! "
    "tensor_transform mode=arithmetic option=mul:2 ! "
    f"tensor_query_serversink id={FLEET_SERVER_ID}")


def _mono_s() -> float:
    return mono_ns() / 1e9


def measure_capacity(host: str, port: int, seconds: float = 2.0,
                     concurrency: int = 8, payload=None) -> float:
    """Closed-loop capacity probe: ``concurrency`` connections issuing
    queries back-to-back measure the serving path's sustainable
    CONCURRENT rate.  A single-stream probe overstates it (no
    GIL/scheduler contention from a client population).  Gold class,
    and concurrency stays under the gold watermark, so the probe itself
    is never shed."""
    from ..query.client import QueryConnection
    from ..tensor.buffer import TensorBuffer

    if payload is None:
        payload = np.arange(4, dtype=np.float32)
    counts = [0] * concurrency
    stop = threading.Event()

    def _probe(i):
        conn = QueryConnection(host, port, timeout=5.0, qos="gold")
        conn.connect()
        try:
            while not stop.is_set():
                conn.query(TensorBuffer(tensors=[payload]))
                counts[i] += 1
        except (ConnectionError, TimeoutError, OSError):
            pass
        finally:
            conn.close()

    threads = [threading.Thread(target=_probe, args=(i,), daemon=True)
               for i in range(concurrency)]
    t0 = _mono_s()
    for t in threads:
        t.start()
    stop.wait(seconds)        # bounded run, event-driven
    stop.set()
    for t in threads:
        t.join(timeout=10)
    dt = max(1e-9, _mono_s() - t0)
    return sum(counts) / dt


def wait_query_ready(host: str, port: int, payload,
                     timeout_s: float = 60.0, proc=None) -> bool:
    """Block until a query round trip succeeds against host:port.
    ``proc`` (the serving Popen) fails fast when the process died at
    startup instead of spinning out the whole timeout."""
    from ..query.client import QueryConnection
    from ..tensor.buffer import TensorBuffer

    pause = threading.Event()
    deadline = _mono_s() + timeout_s
    while _mono_s() < deadline:
        if proc is not None and proc.poll() is not None:
            return False
        try:
            conn = QueryConnection(host, port, timeout=10.0,
                                   max_retries=1)
            conn.connect()
            try:
                if conn.query(TensorBuffer(
                        tensors=[np.asarray(payload)])) is not None:
                    return True
            finally:
                conn.close()
        except (ConnectionError, TimeoutError, OSError):
            pause.wait(0.25)
    return False


def peak_serving(events) -> int:
    """Most workers serving at once, replayed from a pool's event log
    (``serving`` joins; ``crashed`` and ``draining`` leave)."""
    serving, peak = set(), 0
    for e in events:
        if e["event"] == "serving":
            serving.add(e["wid"])
        elif e["event"] in ("crashed", "draining", "reaped"):
            serving.discard(e.get("wid"))
        peak = max(peak, len(serving))
    return peak


def _wait_until(cond: Callable[[], bool], timeout_s: float,
                step_s: float = 0.5) -> bool:
    """Event-paced wait for ``cond()`` (checked every ``step_s``)."""
    pause = threading.Event()
    deadline = _mono_s() + timeout_s
    while not cond() and _mono_s() < deadline:
        pause.wait(step_s)
    return cond()


class SoakFleet:
    """The fleet under soak: a federation collector, the router in this
    process and a :class:`~.pool.WorkerPool` whose membership callbacks
    drive it (route-away before SIGTERM), ``workers`` to ``workers + 1``
    workers.  ``make_spawn(collector_port)`` builds the pool's spawn
    function; the default is :func:`~.pool.launch_spawn_fn` over
    ``template``, federating into the collector."""

    def __init__(self, workers: int = 3,
                 template: str = FLEET_WORKER_TEMPLATE,
                 make_spawn: Optional[Callable[[int], Callable[
                     [str, int], Any]]] = None,
                 ready_fn: Optional[Callable[[Any], bool]] = None,
                 ready_timeout_s: float = 120.0,
                 router_timeout_s: float = 5.0,
                 drain_grace_s: float = 5.0, soak_s: float = 3600.0,
                 log_dir: Optional[str] = None) -> None:
        from ..obs.federation import CollectorServer, MetricsCollector
        from .pool import WorkerPool, launch_spawn_fn
        from .router import TensorQueryRouter

        self.n = max(3, int(workers))
        self.collector = MetricsCollector()
        self.collector_server = CollectorServer(self.collector, port=0)
        self.router = TensorQueryRouter(port=0, replicas=2,
                                        timeout=router_timeout_s,
                                        collector=self.collector)
        if make_spawn is None:
            spawn_fn = launch_spawn_fn(
                template, collector_port=self.collector_server.port,
                push_interval_s=0.5, drain_grace_s=drain_grace_s,
                soak_s=soak_s, log_dir=log_dir)
        else:
            spawn_fn = make_spawn(self.collector_server.port)
        router = self.router
        self.pool = WorkerPool(
            spawn_fn, min_workers=self.n, max_workers=self.n + 1,
            collector=self.collector, ready_fn=ready_fn,
            ready_timeout_s=ready_timeout_s,
            restart_backoff_s=0.5, stale_kill_s=10.0,
            drain_grace_s=drain_grace_s,
            on_up=lambda w: router.add_worker(w.host, w.port),
            on_draining=lambda w: router.mark_draining(w.key),
            on_down=lambda w: router.remove_worker(w.key))
        self.loop = None

    def start(self, up_timeout_s: float = 180.0) -> bool:
        """Spawn the initial workers and start the maintenance loop;
        True once all of them serve."""
        from .pool import FleetLoop

        self.pool.start()
        self.loop = FleetLoop([self.pool.tick], interval_s=0.5).start()
        return _wait_until(lambda: self.pool.serving_count() >= self.n,
                           up_timeout_s)

    def event_times(self) -> Dict[str, Any]:
        """Per-worker lifecycle times from the pool's event log: spawn
        to serving (``ready_s``) and draining to reaped (``drain_s``)."""
        seen: Dict[int, Dict[str, float]] = {}
        for e in self.pool.events:
            if "wid" in e:
                seen.setdefault(e["wid"], {})[e["event"]] = e["t"]
        ready = [round(ev["serving"] - ev["spawned"], 3)
                 for ev in seen.values()
                 if "serving" in ev and "spawned" in ev]
        drain = [round(ev["reaped"] - ev["draining"], 3)
                 for ev in seen.values()
                 if "reaped" in ev and "draining" in ev]
        return {"ready_s": ready, "drain_s": drain}

    def close(self, drain: bool = False) -> None:
        if self.loop is not None:
            self.loop.stop()
        self.pool.stop(drain=drain)
        self.router.close()
        self.collector_server.close()


def kill_leg(fleet: SoakFleet, gen, leg_s: float,
             slo: Optional[str] = None,
             recover_s: float = 60.0) -> Dict[str, Any]:
    """Run ``gen`` (a LoadGenerator through the router) under the
    latency SLO and SIGKILL the worker holding the most routed clients
    at 40 % of the leg; then wait for the pool to serve ``fleet.n``
    workers again.  Returns the load summary, the SLO verdict, what was
    killed and whether (and how fast) the pool recovered."""
    from ..slo import Evaluator, SLOMonitor, load_spec

    router, pool = fleet.router, fleet.pool
    evaluator = Evaluator(load_spec(slo, duration_s=leg_s))
    monitor = SLOMonitor(evaluator)
    kill_info: Dict[str, Any] = {}

    def _kill_one():
        # SIGKILL (not the graceful SIGTERM): this leg proves the CRASH
        # path — no drain, no shed hints, just a dead socket the
        # failover legs must rotate through
        rows = sorted(router.workers(), key=lambda r: -r["routed"])
        if not rows:
            return
        key = rows[0]["worker"]
        with pool._lock:
            victim = next((w for w in pool._workers.values()
                           if w.key == key), None)
        if victim is None:
            return
        kill_info.update({"worker": victim.key, "wid": victim.wid,
                          "pid": getattr(victim.proc, "pid", None),
                          "routed_at_kill": rows[0]["routed"],
                          "at_s": round(_mono_s() - t0, 1),
                          "mono": _mono_s()})
        victim.proc.kill()

    t0 = _mono_s()
    killer = threading.Timer(0.4 * leg_s, _kill_one)
    killer.daemon = True
    killer.start()
    monitor.start()
    try:
        summary = gen.run()
    finally:
        killer.cancel()
        monitor.stop(final_tick=True)
    verdict = evaluator.verdict()
    # pool recovery: the respawned worker must be serving again
    recovered = _wait_until(lambda: pool.serving_count() >= fleet.n,
                            recover_s)
    killed_at = kill_info.pop("mono", None)
    restarted = [e for e in pool.events
                 if e["event"] == "serving" and killed_at is not None
                 and e["t"] >= killed_at - 1e-3
                 and e.get("wid") != kill_info.get("wid")]
    return {"loadgen": summary, "slo": verdict, "kill": kill_info,
            "recovered": recovered,
            "restarted": restarted[0] if restarted else None}


def run_fleet(out_dir: str = "soak_out",
              template: str = FLEET_WORKER_TEMPLATE,
              workers: int = 3, duration_s: float = 60.0,
              clients: int = 32, seed: int = 1234,
              schedule: str = "poisson", timeout_s: float = 2.0,
              slo: Optional[str] = None, drain_grace_s: float = 5.0,
              payload=None,
              make_spawn: Optional[Callable[[int], Callable[
                  [str, int], Any]]] = None,
              ready_fn: Optional[Callable[[Any], bool]] = None,
              ready_timeout_s: float = 120.0,
              up_timeout_s: float = 180.0,
              router_timeout_s: float = 5.0,
              capacity_fn: Optional[Callable[[int], float]] = None,
              payload_fn: Optional[Callable[[int, int], Any]] = None,
              on_reply: Optional[Callable[[int, int, Any], None]] = None,
              kill_leg_s: Optional[float] = None,
              scale_leg_s: Optional[float] = None,
              recover_s: float = 60.0, spawn_wait_s: float = 30.0,
              stop_drain: bool = False) -> int:
    """The three-leg fleet soak; prints the verdict line and returns the
    exit code (0 PASS, 1 FAIL, 2 the fleet never came up).

    ``make_spawn(collector_port)`` builds the function that starts a
    worker (default: :func:`~.pool.launch_spawn_fn` over ``template``),
    ``ready_fn``
    overrides the pool's federation readiness, ``capacity_fn(port)``
    the closed-loop probe through the router, ``payload_fn`` /
    ``on_reply`` the load's per-request frames and reply hook.
    ``kill_leg_s`` / ``scale_leg_s`` shorten the legs below the
    defaults derived from ``duration_s``; ``recover_s`` and
    ``spawn_wait_s`` bound the waits for the restarted and the added
    worker to serve (workers that warm up longer need more);
    ``stop_drain`` ends the
    surviving workers with the SIGTERM drain instead of a kill.  The
    whole verdict goes to ``out_dir/verdict.json``."""
    from ..obs.metrics import REGISTRY
    from ..obs.timeseries import RingSampler, TimeSeriesRing
    from ..query.server import DEFAULT_QUEUE_DEPTH
    from ..slo import LoadGenerator
    from .autoscaler import Autoscaler, default_autoscaler_signals
    from .config import AutoscalerConfig

    os.makedirs(out_dir, exist_ok=True)
    duration = max(40.0, duration_s)
    phase_a = kill_leg_s or max(24.0, 0.5 * duration)
    phase_b = scale_leg_s or max(16.0, 0.3 * duration)
    if payload is None:
        payload = np.arange(4, dtype=np.float32)
    probe_payload = payload if payload_fn is None else payload_fn(0, 0)

    fleet = SoakFleet(workers, template, make_spawn, ready_fn,
                      ready_timeout_s, router_timeout_s, drain_grace_s,
                      soak_s=duration + 600.0,
                      log_dir=os.path.join(out_dir, "workers"))
    n, router, pool = fleet.n, fleet.router, fleet.pool
    ring = sampler = None
    try:
        t_up = _mono_s()
        if not fleet.start(up_timeout_s):
            print(json.dumps({
                "metric": "soak_fleet", "verdict": "INFRA_DEAD",
                "pass": False, "status": "infra_dead",
                "vs_baseline": None, "pool_events": list(pool.events),
                "reason": f"only {pool.serving_count()}/{n} workers "
                          "came up (see the workers' logs)"}), flush=True)
            return 2
        fleet_up_s = _mono_s() - t_up
        if not wait_query_ready("127.0.0.1", router.port, probe_payload,
                                timeout_s=30.0):
            print(json.dumps({
                "metric": "soak_fleet", "verdict": "INFRA_DEAD",
                "pass": False, "status": "infra_dead",
                "vs_baseline": None,
                "reason": "router endpoint never served a round "
                          "trip"}), flush=True)
            return 2

        # honest thresholds on any host: probe the ROUTED capacity,
        # size the kill leg at ~30% of it (comfortably under the SLO),
        # the spawn watermark in the gap, and the scale-up leg past the
        # watermark but still under ~2/3 of capacity (the autoscale leg
        # must prove scaling on sustained RATE, not queueing collapse)
        if capacity_fn is None:
            measure_capacity("127.0.0.1", router.port, seconds=2.0,
                             payload=payload)               # warm-up
            capacity = measure_capacity("127.0.0.1", router.port,
                                        seconds=3.0, payload=payload)
        else:
            capacity = capacity_fn(router.port)
        rate_a = min(150.0, 0.30 * capacity)
        up_rps = 1.5 * rate_a
        rate_b = 2.2 * rate_a
        asc_cfg = AutoscalerConfig(
            rate_high_rps=up_rps, rate_low_rps=1.0,
            hold_s=4.0, idle_hold_s=6.0,
            spawn_cooldown_s=15.0, drain_cooldown_s=10.0,
            post_spawn_guard_s=10.0)
        ring = TimeSeriesRing(fleet.collector, interval_s=0.5,
                              retention_s=duration + 120.0,
                              registry=REGISTRY)
        signals = default_autoscaler_signals(
            ring, asc_cfg, queue_depth=DEFAULT_QUEUE_DEPTH)
        autoscaler = Autoscaler(pool, signals["up"], signals["down"],
                                cfg=asc_cfg).attach(ring)
        sampler = RingSampler(ring).start()
        fleet.loop.fns.append(autoscaler.tick)

        def load(rate: float, leg_s: float, leg_seed: int):
            return LoadGenerator(
                "127.0.0.1", router.port, clients=clients,
                rate_hz=rate / clients, duration_s=leg_s,
                schedule=schedule, seed=leg_seed,
                timeout=max(timeout_s, 3.0), payload=payload,
                payload_fn=payload_fn, on_reply=on_reply)

        # -- leg 1: kill under the latency SLO ----------------------------
        leg_a = kill_leg(fleet, load(rate_a, phase_a, seed), phase_a,
                         slo=slo, recover_s=recover_s)
        summary_a = leg_a["loadgen"]

        # -- leg 2: sustained load -> spawn -------------------------------
        summary_b = load(rate_b, phase_b, seed + 1).run()
        # read off the pool's event log, not a polled count: once the new
        # worker serves, an idle fleet may drain it within the same
        # maintenance pass
        _wait_until(lambda: peak_serving(pool.events) >= n + 1,
                    spawn_wait_s)
        scaled_up = (autoscaler.spawns >= 1
                     and peak_serving(pool.events) >= n + 1)

        # -- leg 3: idle -> route-away, SIGTERM drain, reap ---------------
        t_idle = _mono_s()
        _wait_until(lambda: autoscaler.drains >= 1
                    and pool.serving_count() <= n
                    and any(e["event"] == "reaped" for e in pool.events),
                    max(40.0, asc_cfg.idle_hold_s
                        + asc_cfg.post_spawn_guard_s + 20.0
                        + drain_grace_s))
        idle_to_reaped_s = _mono_s() - t_idle
        reaped = [e for e in pool.events if e["event"] == "reaped"]
        scaled_down = (autoscaler.drains >= 1
                       and pool.serving_count() <= n and bool(reaped))

        if sampler is not None:
            sampler.stop(final_capture=True)
            sampler = None
        checks = {
            "three_plus_workers": n >= 3,
            "zero_client_errors": summary_a["errors"] == 0
            and summary_b["errors"] == 0,
            "latency_slo_held": bool(leg_a["slo"]["pass"]),
            "worker_killed_mid_run": bool(leg_a["kill"]),
            "pool_recovered": leg_a["recovered"],
            "spawn_on_sustained_load": scaled_up,
            "drain_on_idle": scaled_down,
        }
        verdict = {
            "metric": "soak_fleet", "status": "live",
            "pass": all(checks.values()),
            "verdict": "PASS" if all(checks.values()) else "FAIL",
            "checks": checks,
            "fleet": {
                "workers": n, "clients": clients,
                "capacity_routed_rps": round(capacity, 1),
                "rate_kill_leg_rps": round(rate_a, 1),
                "rate_autoscale_leg_rps": round(rate_b, 1),
                "spawn_watermark_rps": round(up_rps, 1),
                "drain_grace_s": drain_grace_s,
                "replicas": router.replicas,
                "peak_serving": peak_serving(pool.events),
            },
            "kill": leg_a["kill"],
            "restarted": leg_a["restarted"],
            "kill_leg": {"loadgen": summary_a, "slo": leg_a["slo"]},
            "autoscale_leg": {"loadgen": summary_b},
            "idle_leg": {"reaped": reaped,
                         "idle_to_reaped_s": idle_to_reaped_s},
            "times": {"fleet_up_s": fleet_up_s, **fleet.event_times()},
            "router_workers": router.workers(),
            "pool_events": list(pool.events),
            "autoscaler": autoscaler.report(),
            "signals": ring.signal_report(),
            "federation_origins": fleet.collector.origins(),
        }
        with open(os.path.join(out_dir, "verdict.json"), "w",
                  encoding="utf-8") as fh:
            json.dump(verdict, fh, indent=2)
        line = {"metric": "soak_fleet", "verdict": verdict["verdict"],
                "pass": verdict["pass"], "status": "live",
                "workers": n,
                "kill": leg_a["kill"],
                "errors": summary_a["errors"] + summary_b["errors"],
                "sheds": summary_a.get("shed", 0)
                + summary_b.get("shed", 0),
                "kill_leg_latency_us": summary_a["latency_us"],
                "spawns": autoscaler.spawns,
                "drains": autoscaler.drains,
                "checks": checks,
                "artifact": os.path.join(out_dir, "verdict.json")}
        print(json.dumps(line), flush=True)
        return 0 if verdict["pass"] else 1
    finally:
        if sampler is not None:
            sampler.stop(final_capture=False)
        if ring is not None:
            ring.close()
        fleet.close(drain=stop_drain)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nns-torch-fleet-soak",
        description="fleet acceptance soak: kill, scale-up and idle legs "
                    "through a router over managed launch.py workers")
    ap.add_argument("--template", default=FLEET_WORKER_TEMPLATE,
                    help="worker launch string; {port} is filled per "
                         "worker (default: the light demo server)")
    ap.add_argument("--fleet-workers", type=int, default=3,
                    help="initial fleet size (min 3; the autoscale leg "
                         "grows it by one)")
    ap.add_argument("--fleet-drain-grace", type=float, default=5.0,
                    help="worker SIGTERM drain budget, seconds")
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--duration", type=float, default=60.0,
                    help="soak length; the kill leg takes half (>= 24 s) "
                         "and the scale-up leg 0.3 (>= 16 s)")
    ap.add_argument("--schedule", choices=("poisson", "constant"),
                    default="poisson")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--timeout", type=float, default=2.0,
                    help="per-request client timeout, seconds (>= 3)")
    ap.add_argument("--slo", default=None, metavar="FILE",
                    help="SLO spec JSON for the kill leg (default: the "
                         "demo spec scaled to the leg)")
    ap.add_argument("--out", default="soak_out", metavar="DIR",
                    help="verdict.json and the workers' logs")
    args = ap.parse_args(argv)
    return run_fleet(out_dir=args.out, template=args.template,
                     workers=args.fleet_workers,
                     duration_s=args.duration, clients=args.clients,
                     seed=args.seed, schedule=args.schedule,
                     timeout_s=args.timeout, slo=args.slo,
                     drain_grace_s=args.fleet_drain_grace)


if __name__ == "__main__":
    sys.exit(main())
