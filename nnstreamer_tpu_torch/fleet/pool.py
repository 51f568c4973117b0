"""Managed worker pool: spawn, watch, restart, drain ``launch.py``
serving processes.

Every worker is an ordinary ``python -m nnstreamer_tpu_torch.launch``
process (the serving lifecycle applies unchanged: SIGTERM = graceful
drain, exit 0) pushing its metrics registry into the fleet's
federation collector (``--push-metrics``).  That one wire gives the
pool its whole health model for free:

- **readiness** — a worker is serving once its origin appears in the
  collector (the publisher only starts after ``play()`` succeeded);
- **liveness** — federation staleness: an origin silent past
  ``stale_kill_s`` is a wedged process (the publisher heartbeats empty
  deltas, so silence is dead-not-idle) and is killed + respawned;
- **crashes** — ``proc.poll()`` + exponential restart backoff with a
  streak reset on the first healthy readiness, so a crash-looping
  worker config cannot hot-spin the host.

Membership callbacks (``on_up`` / ``on_draining`` / ``on_down``) drive
the router: ``on_draining`` fires BEFORE the SIGTERM goes out, so the
router has already routed away by the time the worker starts shedding —
scale-down order is route-away → drain → reap, never the reverse.

Everything is injectable (``spawn_fn``, ``clock``, ``origin_age_fn``)
so the tier-1 tests drive the whole state machine with fake processes
and an injected clock — no wall-clock flakiness.
"""

from __future__ import annotations

import os
import socket as _socket
import subprocess
import sys
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from ..analysis.sanitizer import make_lock
from ..obs.clock import mono_ns
from ..obs.timeseries import DeadlineLoop
from ..utils.log import logger

#: worker lifecycle states
W_STARTING, W_SERVING, W_DRAINING, W_DEAD = ("starting", "serving",
                                             "draining", "dead")


def _mono_s() -> float:
    return mono_ns() / 1e9


def free_port(host: str = "127.0.0.1") -> int:
    s = _socket.socket()
    s.bind((host, 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch_spawn_fn(launch_template: str,
                    collector_port: Optional[int] = None,
                    push_interval_s: float = 0.5,
                    drain_grace_s: float = 10.0,
                    soak_s: float = 3600.0,
                    log_dir: Optional[str] = None,
                    env_extra: Optional[Dict[str, str]] = None
                    ) -> Callable[[str, int], Any]:
    """Standard real-process spawner: ``launch_template.format(port=)``
    as a ``launch.py --soak`` worker, federating into the collector and
    flagged ``NNS_FLEET_ROLE=worker`` (the dashboard's role column)."""

    def _spawn(host: str, port: int):
        line = launch_template.format(port=port, host=host)
        cmd = [sys.executable, "-m", "nnstreamer_tpu_torch.launch", line,
               "--soak", str(soak_s), "--quiet",
               "--drain-grace", str(drain_grace_s)]
        if collector_port:
            cmd += ["--push-metrics", f"127.0.0.1:{collector_port}",
                    "--push-interval", str(push_interval_s)]
        # the worker runs where its launch string puts it: on the card
        # by default, on the CPU where the filter says
        # accelerator=true:cpu
        env = dict(os.environ)
        env["NNS_FLEET_ROLE"] = "worker"
        env.update(env_extra or {})
        stdout = subprocess.DEVNULL
        log = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            log = open(os.path.join(log_dir, f"worker-{port}.log"),
                       "w", encoding="utf-8")
            stdout = log
        root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        try:
            return subprocess.Popen(cmd, stdout=stdout, stderr=stdout,
                                    env=env, cwd=root)
        finally:
            if log is not None:
                # the child holds its own dup of the fd; keeping the
                # parent's open would leak one fd per spawn — a
                # crash-looping worker config would walk the pool
                # process into EMFILE and kill its ability to respawn
                log.close()

    return _spawn


class ManagedWorker:
    """One worker's pool-side record."""

    __slots__ = ("wid", "host", "port", "proc", "state", "spawned_at",
                 "ready_at", "drain_started", "exit_code",
                 "origin_seen")

    def __init__(self, wid: int, host: str, port: int, proc: Any,
                 now: float) -> None:
        self.wid = wid
        self.host = host
        self.port = port
        self.proc = proc
        self.state = W_STARTING
        self.spawned_at = now
        self.ready_at: Optional[float] = None
        self.drain_started: Optional[float] = None
        self.exit_code: Optional[int] = None
        #: its federation origin answered at least once (gates the
        #: evicted-origin staleness verdict: never-seen != vanished)
        self.origin_seen = False

    @property
    def key(self) -> str:
        return f"{self.host}:{self.port}"

    def row(self, now: float) -> Dict[str, Any]:
        return {"wid": self.wid, "worker": self.key,
                "state": self.state,
                "pid": getattr(self.proc, "pid", None),
                "uptime_s": round(now - self.spawned_at, 1),
                "exit_code": self.exit_code}


class WorkerPool:
    """Spawn/watch/restart/drain a target number of workers.

    ``target`` is the desired serving count (the autoscaler's knob via
    :meth:`scale_up`/:meth:`scale_down`, clamped to
    ``[min_workers, max_workers]``); :meth:`tick` converges the live
    set toward it — restarting crashes with backoff, reaping drains,
    killing wedged (federation-stale) workers.
    """

    def __init__(self, spawn_fn: Callable[[str, int], Any],
                 min_workers: int = 1, max_workers: int = 4,
                 host: str = "127.0.0.1",
                 collector=None,
                 ready_fn: Optional[Callable[[ManagedWorker], bool]] = None,
                 origin_age_fn: Optional[
                     Callable[[ManagedWorker], Optional[float]]] = None,
                 ready_timeout_s: float = 120.0,
                 restart_backoff_s: float = 1.0,
                 restart_backoff_max_s: float = 30.0,
                 stale_kill_s: float = 20.0,
                 drain_grace_s: float = 10.0,
                 on_up: Optional[Callable[[ManagedWorker], None]] = None,
                 on_draining: Optional[
                     Callable[[ManagedWorker], None]] = None,
                 on_down: Optional[Callable[[ManagedWorker], None]] = None,
                 port_fn: Optional[Callable[[], int]] = None,
                 clock: Callable[[], float] = _mono_s) -> None:
        if min_workers < 1:
            raise ValueError(
                "min_workers must be >= 1 (fleet-zero-workers): a pool "
                "allowed to reach zero serves nothing behind a live "
                "router")
        if max_workers < min_workers:
            raise ValueError(
                f"min_workers={min_workers} > max_workers={max_workers} "
                "(fleet-minmax)")
        self.spawn_fn = spawn_fn
        self.min_workers = int(min_workers)
        self.max_workers = int(max_workers)
        self.host = host
        self.collector = collector
        self.ready_fn = ready_fn
        self.origin_age_fn = origin_age_fn
        self.ready_timeout_s = float(ready_timeout_s)
        self.restart_backoff_s = float(restart_backoff_s)
        self.restart_backoff_max_s = float(restart_backoff_max_s)
        self.stale_kill_s = float(stale_kill_s)
        self.drain_grace_s = float(drain_grace_s)
        self.on_up = on_up
        self.on_draining = on_draining
        self.on_down = on_down
        self.port_fn = port_fn or (lambda: free_port(host))
        self.clock = clock
        self.target = self.min_workers
        self._workers: Dict[int, ManagedWorker] = {}
        self._next_wid = 1
        self._crash_streak = 0
        self._next_spawn_at = 0.0
        self._lock = make_lock("fleet.pool")
        #: bounded event log (soak verdict / test surface)
        self.events: "deque[Dict[str, Any]]" = deque(maxlen=256)

    # -- introspection -------------------------------------------------------
    def workers(self) -> List[Dict[str, Any]]:
        now = self.clock()
        with self._lock:
            return [w.row(now) for w in self._workers.values()]

    def serving_count(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers.values()
                       if w.state == W_SERVING)

    def alive_count(self) -> int:
        with self._lock:
            return sum(1 for w in self._workers.values()
                       if w.state in (W_STARTING, W_SERVING))

    def _log(self, event: str, w: Optional[ManagedWorker] = None,
             **extra) -> None:
        row = {"t": round(self.clock(), 3), "event": event, **extra}
        if w is not None:
            row.update({"wid": w.wid, "worker": w.key})
        self.events.append(row)
        logger.info("fleet pool: %s %s", event,
                    w.key if w is not None else extra)

    # -- scaling knob --------------------------------------------------------
    def scale_up(self, now: Optional[float] = None) -> Optional[int]:
        """Raise the target and spawn immediately; None at max, inside
        the crash/spawn-failure backoff, or when the spawn itself
        fails.  A failed spawn reverts the target: leaving it raised
        would let the caller's next attempt ratchet it again (the
        autoscaler treats None as not-actuated and skips its cooldown,
        so transient spawn failures would walk target straight to
        max)."""
        if now is None:
            now = self.clock()
        with self._lock:
            if self.target >= self.max_workers \
                    or now < self._next_spawn_at:
                return None
            self.target += 1
            w = self._spawn_locked(now)
            if w is None:
                self.target -= 1
        return w.wid if w is not None else None

    def scale_down(self, now: Optional[float] = None) -> Optional[int]:
        """Lower the target and drain the newest serving worker (route
        away first, SIGTERM second); None at min."""
        if now is None:
            now = self.clock()
        with self._lock:
            serving = [w for w in self._workers.values()
                       if w.state == W_SERVING]
            if self.target <= self.min_workers or len(serving) <= \
                    self.min_workers:
                return None
            self.target -= 1
            victim = max(serving, key=lambda w: w.spawned_at)
            self._drain_locked(victim, now)
        return victim.wid

    def _drain_locked(self, w: ManagedWorker, now: float) -> None:
        w.state = W_DRAINING
        w.drain_started = now
        self._log("draining", w)
        # route-away BEFORE the SIGTERM: by the time the worker starts
        # shedding, the router must already prefer its peers
        if self.on_draining is not None:
            self.on_draining(w)
        try:
            import signal as _signal

            w.proc.send_signal(_signal.SIGTERM)
        except (OSError, ValueError):
            pass

    # -- spawning ------------------------------------------------------------
    def _spawn_locked(self, now: float) -> Optional[ManagedWorker]:
        port = self.port_fn()
        try:
            proc = self.spawn_fn(self.host, port)
        except OSError as exc:
            self._log("spawn-failed", error=repr(exc))
            self._crash_streak += 1
            self._next_spawn_at = now + self._backoff()
            return None
        w = ManagedWorker(self._next_wid, self.host, port, proc, now)
        self._next_wid += 1
        self._workers[w.wid] = w
        self._log("spawned", w)
        return w

    def _backoff(self) -> float:
        return min(self.restart_backoff_max_s,
                   self.restart_backoff_s
                   * (2 ** max(0, self._crash_streak - 1)))

    def start(self) -> None:
        """Spawn the initial target synchronously (readiness converges
        via tick)."""
        now = self.clock()
        with self._lock:
            while self.alive_count_locked() < self.target:
                if self._spawn_locked(now) is None:
                    break

    def alive_count_locked(self) -> int:
        return sum(1 for w in self._workers.values()
                   if w.state in (W_STARTING, W_SERVING))

    # -- health --------------------------------------------------------------
    def _origin_age(self, w: ManagedWorker) -> Optional[float]:
        """Seconds since the worker's origin last pushed (federation
        staleness), None when it never appeared (or was evicted).
        Marks ``origin_seen`` on every observation, so a later None is
        distinguishable as vanished-after-seen."""
        age = None
        if self.origin_age_fn is not None:
            age = self.origin_age_fn(w)
        elif self.collector is not None:
            pid = getattr(w.proc, "pid", None)
            for row in self.collector.origins():
                if row.get("pid") == pid \
                        and row.get("health") != "local":
                    age = row.get("age_s")
                    break
        if age is not None:
            w.origin_seen = True
        return age

    def _is_ready(self, w: ManagedWorker) -> bool:
        if self.ready_fn is not None:
            return bool(self.ready_fn(w))
        # federation readiness: the publisher only starts after play()
        # succeeded, so the origin's first push IS the serving signal
        return self._origin_age(w) is not None

    # -- the maintenance tick ------------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """One maintenance pass (injectable clock; production drives it
        from a :class:`FleetLoop`)."""
        if now is None:
            now = self.clock()
        with self._lock:
            for w in list(self._workers.values()):
                if w.state in (W_STARTING, W_SERVING):
                    rc = w.proc.poll()
                    if rc is not None:
                        self._on_crash_locked(w, now, rc)
                        continue
                if w.state == W_STARTING:
                    if self._is_ready(w):
                        w.state = W_SERVING
                        w.ready_at = now
                        self._crash_streak = 0
                        self._log("serving", w)
                        if self.on_up is not None:
                            self.on_up(w)
                    elif now - w.spawned_at > self.ready_timeout_s:
                        self._log("ready-timeout", w)
                        self._kill(w)
                        self._on_crash_locked(w, now, None)
                elif w.state == W_SERVING:
                    age = self._origin_age(w)
                    evicted = age is None and w.origin_seen
                    if evicted or (age is not None
                                   and age > self.stale_kill_s):
                        # wedged: alive but silent past the heartbeat
                        # horizon — its gauges are lies and its clients
                        # are stalling; replace it.  A VANISHED origin
                        # counts too: the collector evicts origins at
                        # its own staleness horizon (often shorter than
                        # stale_kill_s), after which the age reads None
                        # forever — eviction of a once-ready origin IS
                        # the staleness verdict, not absence of one
                        self._log("stale-kill", w,
                                  age_s=(round(age, 1)
                                         if age is not None
                                         else "evicted"))
                        self._kill(w)
                        self._on_crash_locked(w, now, None)
                elif w.state == W_DRAINING:
                    rc = w.proc.poll()
                    if rc is not None:
                        self._reap_locked(w, now, rc)
                    elif now - w.drain_started > self.drain_grace_s + 5.0:
                        self._log("drain-overdue", w)
                        self._kill(w)
                        self._reap_locked(w, now, None)
            # converge toward target: one respawn per tick, gated by
            # the crash backoff so a bad config cannot hot-loop
            if self.alive_count_locked() < self.target \
                    and now >= self._next_spawn_at:
                self._spawn_locked(now)

    def _on_crash_locked(self, w: ManagedWorker, now: float,
                         rc: Optional[int]) -> None:
        w.state = W_DEAD
        w.exit_code = rc
        del self._workers[w.wid]
        self._crash_streak += 1
        self._next_spawn_at = now + self._backoff()
        self._log("crashed", w, exit_code=rc,
                  backoff_s=round(self._backoff(), 2))
        if self.on_down is not None:
            self.on_down(w)

    def _reap_locked(self, w: ManagedWorker, now: float,
                     rc: Optional[int]) -> None:
        w.state = W_DEAD
        w.exit_code = rc
        del self._workers[w.wid]
        self._log("reaped", w, exit_code=rc)
        if self.on_down is not None:
            self.on_down(w)

    @staticmethod
    def _kill(w: ManagedWorker) -> None:
        try:
            w.proc.kill()
        except (OSError, ValueError):
            pass
        try:
            w.proc.wait(timeout=10)
        except Exception:   # noqa: BLE001 — already-reaped fakes
            pass

    # -- teardown ------------------------------------------------------------
    def stop(self, drain: bool = True, grace_s: Optional[float] = None
             ) -> None:
        """Drain (``SIGTERM`` + grace) or kill every worker and wait
        for exits.  ``drain=False`` kills immediately — workers run
        ``--soak`` loops that never exit on their own, so waiting out
        a grace with no signal sent would just stall teardown."""
        grace = self.drain_grace_s if grace_s is None else grace_s
        with self._lock:
            workers = list(self._workers.values())
            self._workers.clear()
        for w in workers:
            if w.proc.poll() is not None:
                continue
            if drain:
                try:
                    import signal as _signal

                    w.proc.send_signal(_signal.SIGTERM)
                except (OSError, ValueError):
                    pass
            else:
                self._kill(w)
        for w in workers:
            try:
                w.proc.wait(timeout=(grace + 5.0) if drain else 10.0)
            except Exception:   # noqa: BLE001 — hard stop after grace
                self._kill(w)
            if self.on_down is not None:
                self.on_down(w)


class FleetLoop(DeadlineLoop):
    """Fleet maintenance on the shared absolute-deadline loop
    (obs/timeseries.py :class:`DeadlineLoop`): ``pool.tick`` +
    ``autoscaler.tick`` + anything else the fleet owner registers (a
    raising tick is logged and survived — a dead loop would stop crash
    restarts)."""

    def __init__(self, fns, interval_s: float = 0.5) -> None:
        super().__init__(fns, interval_s, name="fleet-maint")
