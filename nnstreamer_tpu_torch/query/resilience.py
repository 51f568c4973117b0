"""Resilience substrate for the distributed query layer (L5).

The reference's among-device elements survive flaky edge links with
reconnect loops inside libnnstreamer-edge (nnstreamer-edge/src/
libnnstreamer-edge/nnstreamer-edge-internal.c: connection retries,
keep-alive) — our reproduction centralizes that story in three policies
shared by every transport in ``nnstreamer_tpu_torch.query``:

- :class:`RetryPolicy` — exponential backoff with decorrelated jitter and
  a per-request deadline budget.  Used for connects (client, edge pub/sub,
  gRPC redial) and for send-retry on publisher sockets.
- :class:`CircuitBreaker` — closed/open/half-open with consecutive-failure
  and failure-rate tracking over a sliding window.  One breaker per remote
  endpoint stops a dead server from eating a full timeout per frame.
- :class:`HealthMonitor` — heartbeat scheduler pinging endpoints over the
  wire protocol's ``T_PING``/``T_PONG`` messages; tracks RTT (EWMA) and
  liveness (alive → suspect → dead) per endpoint and fires callbacks on
  state changes, driving multi-endpoint failover in the query client.

Every retry / failure / breaker transition / failover increments a named
counter in :data:`STATS`;
:class:`~nnstreamer_tpu_torch.pipeline.tracing.Tracer`
snapshots the counters at attach and reports the per-run delta, so
``launch.py --trace`` surfaces resilience activity next to proctime.

This module depends only on the stdlib (no pipeline imports) so it can be
used from any layer without cycles.
"""

from __future__ import annotations

import collections
import random
import threading
import time
from typing import Callable, Deque, Dict, Optional, Tuple


class ResilienceStats:
    """Thread-safe named counters (retries, failures, breaker trips…)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def incr(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def delta(self, since: Dict[str, int]) -> Dict[str, int]:
        """Counters accumulated after ``since`` (a prior snapshot)."""
        now = self.snapshot()
        return {k: v - since.get(k, 0) for k, v in now.items()
                if v - since.get(k, 0)}


#: process-wide counter registry (one query layer per process)
STATS = ResilienceStats()


class RetryExhausted(ConnectionError):
    """All attempts of a :class:`RetryPolicy` run failed (or the deadline
    budget ran out); ``__cause__`` carries the last underlying error."""


class RetryPolicy:
    """Exponential backoff + jitter + per-request deadline budget.

    ``delay(attempt)`` grows ``base * multiplier**attempt`` capped at
    ``max_delay``, each delay randomized by ±``jitter`` fraction (full
    determinism for tests via an injectable ``rng``).  ``run(fn)`` drives
    the whole loop: attempts are bounded by ``max_attempts`` AND by
    ``deadline`` seconds of total elapsed time — whichever is hit first.
    """

    def __init__(self, max_attempts: int = 4, base_delay: float = 0.05,
                 max_delay: float = 1.0, multiplier: float = 2.0,
                 jitter: float = 0.25,
                 deadline: Optional[float] = None) -> None:
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = int(max_attempts)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = None if deadline is None else float(deadline)

    @classmethod
    def parse(cls, spec: "str | RetryPolicy | None") -> "RetryPolicy":
        """Element-property form: ``attempts=5,base=0.05,cap=1.0,
        mult=2.0,jitter=0.25,deadline=10`` (any subset; unknown keys are
        loud so launch-line typos don't silently change behavior)."""
        if spec is None or spec == "":
            return cls()
        if isinstance(spec, RetryPolicy):
            return spec
        kw: Dict[str, float] = {}
        names = {"attempts": "max_attempts", "base": "base_delay",
                 "cap": "max_delay", "mult": "multiplier",
                 "jitter": "jitter", "deadline": "deadline"}
        for part in str(spec).split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            if not sep or key.strip() not in names:
                raise ValueError(f"retry spec: bad token {part!r} "
                                 f"(want {'/'.join(names)}=value)")
            kw[names[key.strip()]] = float(val)
        if "max_attempts" in kw:
            kw["max_attempts"] = int(kw["max_attempts"])
        return cls(**kw)

    def with_deadline(self, deadline: float) -> "RetryPolicy":
        """Same policy, bounded by ``deadline`` seconds of total elapsed
        time (the per-request budget form used by reconnect paths)."""
        return RetryPolicy(max_attempts=self.max_attempts,
                           base_delay=self.base_delay,
                           max_delay=self.max_delay,
                           multiplier=self.multiplier,
                           jitter=self.jitter, deadline=deadline)

    def delay(self, attempt: int,
              rng: Callable[[], float] = random.random) -> float:
        d = min(self.base_delay * self.multiplier ** attempt,
                self.max_delay)
        if self.jitter:
            d *= 1.0 - self.jitter + 2.0 * self.jitter * rng()
        return d

    def run(self, fn: Callable[[], object], *,
            retry_on: Tuple[type, ...] = (OSError, ConnectionError,
                                          TimeoutError),
            counter: str = "retry",
            sleep: Callable[[float], None] = time.sleep,
            clock: Callable[[], float] = time.monotonic,
            rng: Callable[[], float] = random.random):
        """Call ``fn`` until it succeeds, backing off between attempts.
        Raises :class:`RetryExhausted` (chained to the last error) when
        attempts or the deadline budget run out."""
        start = clock()
        last: Optional[BaseException] = None
        for attempt in range(self.max_attempts):
            try:
                return fn()
            except retry_on as exc:  # noqa: PERF203 - retry loop
                last = exc
                STATS.incr(f"{counter}.failures")
                if attempt + 1 >= self.max_attempts:
                    break
                d = self.delay(attempt, rng)
                if (self.deadline is not None
                        and clock() - start + d > self.deadline):
                    break
                STATS.incr(f"{counter}.retries")
                sleep(d)
        raise RetryExhausted(
            f"gave up after {self.max_attempts} attempt(s): "
            f"{last!r}") from last


class CircuitOpenError(ConnectionError):
    """The breaker is OPEN: the endpoint is skipped without a network
    round trip (fail-fast instead of one timeout per frame)."""


class CircuitBreaker:
    """Closed / open / half-open breaker with failure-rate tracking.

    Opens when either ``failure_threshold`` consecutive failures occur or
    the failure fraction over the last ``window`` calls reaches
    ``failure_rate`` (with at least ``window`` samples).  After
    ``cooldown`` seconds an OPEN breaker lets ``half_open_max`` trial
    calls through (HALF_OPEN); a trial success closes it, a trial failure
    re-opens it and restarts the cooldown.  Thread-safe; the clock is
    injectable so tests never sleep.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, failure_threshold: int = 5,
                 failure_rate: float = 0.5, window: int = 10,
                 cooldown: float = 30.0, half_open_max: int = 1,
                 clock: Callable[[], float] = time.monotonic,
                 name: str = "") -> None:
        self.failure_threshold = int(failure_threshold)
        self.failure_rate = float(failure_rate)
        self.window = int(window)
        self.cooldown = float(cooldown)
        self.half_open_max = int(half_open_max)
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._outcomes: Deque[bool] = collections.deque(maxlen=self.window)
        self._consecutive = 0
        self._opened_at = 0.0
        self._trials = 0

    @property
    def state(self) -> str:
        with self._lock:
            self._maybe_half_open()
            return self._state

    def _maybe_half_open(self) -> None:
        if (self._state == self.OPEN
                and self._clock() - self._opened_at >= self.cooldown):
            self._state = self.HALF_OPEN
            self._trials = 0
            STATS.incr("breaker.half_open")

    def allow(self) -> bool:
        """May a call proceed right now?  (HALF_OPEN admits at most
        ``half_open_max`` concurrent trials.)"""
        with self._lock:
            self._maybe_half_open()
            if self._state == self.CLOSED:
                return True
            if self._state == self.HALF_OPEN \
                    and self._trials < self.half_open_max:
                self._trials += 1
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._reset(self.CLOSED)
                STATS.incr("breaker.closed")
                return
            self._consecutive = 0
            self._outcomes.append(True)

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._trip()           # trial failed: back to OPEN
                return
            if self._state == self.OPEN:
                return
            self._consecutive += 1
            self._outcomes.append(False)
            rate_tripped = (len(self._outcomes) >= self.window
                            and self._outcomes.count(False)
                            >= self.failure_rate * len(self._outcomes))
            if self._consecutive >= self.failure_threshold or rate_tripped:
                self._trip()

    def _trip(self) -> None:
        self._state = self.OPEN
        self._opened_at = self._clock()
        self._trials = 0
        STATS.incr("breaker.open")

    def _reset(self, state: str) -> None:
        self._state = state
        self._outcomes.clear()
        self._consecutive = 0
        self._trials = 0

    def call(self, fn: Callable[[], object]):
        """Gate ``fn`` through the breaker: raises
        :class:`CircuitOpenError` without calling when disallowed,
        records the outcome otherwise (the original error re-raises)."""
        if not self.allow():
            raise CircuitOpenError(
                f"circuit breaker {self.name or id(self)} is open")
        try:
            result = fn()
        except BaseException:
            self.record_failure()
            raise
        self.record_success()
        return result


class EndpointHealth:
    """Mutable per-endpoint liveness record kept by the monitor."""

    ALIVE, SUSPECT, DEAD = "alive", "suspect", "dead"

    __slots__ = ("state", "rtt_ms", "missed", "pings", "pongs")

    def __init__(self) -> None:
        self.state = self.ALIVE
        self.rtt_ms: Optional[float] = None
        self.missed = 0
        self.pings = 0
        self.pongs = 0

    def as_dict(self) -> Dict[str, object]:
        return {"state": self.state, "rtt_ms": self.rtt_ms,
                "missed": self.missed, "pings": self.pings,
                "pongs": self.pongs}


class HealthMonitor:
    """Heartbeat scheduler: pings each watched endpoint every
    ``interval`` seconds via its registered ``ping_fn`` (which returns
    the RTT in seconds or raises on timeout/failure).

    ``max_missed`` consecutive misses flip the endpoint ALIVE → DEAD
    (passing through SUSPECT) and fire ``on_down(key)``; the first
    successful ping afterwards fires ``on_up(key)``.  RTT is smoothed
    with an EWMA (alpha 0.3) so the report is stable under jitter.
    """

    _EWMA_ALPHA = 0.3

    def __init__(self, interval: float = 1.0, max_missed: int = 3,
                 on_down: Optional[Callable[[str], None]] = None,
                 on_up: Optional[Callable[[str], None]] = None,
                 name: str = "health") -> None:
        self.interval = float(interval)
        self.max_missed = int(max_missed)
        self.on_down = on_down
        self.on_up = on_up
        self.name = name
        self._lock = threading.Lock()
        self._endpoints: Dict[str, Callable[[], float]] = {}
        self._health: Dict[str, EndpointHealth] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, key: str, ping_fn: Callable[[], float]) -> None:
        with self._lock:
            self._endpoints[key] = ping_fn
            h = self._health.setdefault(key, EndpointHealth())
            # a (re-)watch is a fresh liveness assumption: without the
            # reset, a record stuck on DEAD from a previous watch could
            # never transition into DEAD again, so on_down would not
            # refire for the endpoint's next death
            h.missed = 0
            h.state = EndpointHealth.ALIVE

    def unwatch(self, key: str) -> None:
        with self._lock:
            self._endpoints.pop(key, None)

    def health(self, key: str) -> Optional[EndpointHealth]:
        with self._lock:
            return self._health.get(key)

    def report(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            return {k: h.as_dict() for k, h in self._health.items()}

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"heartbeat:{self.name}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)
        self._thread = None

    def _loop(self) -> None:
        while not self._stop.wait(self.interval):
            for key, ping_fn in list(self._endpoints.items()):
                if self._stop.is_set():
                    return
                self.check_now(key, ping_fn)

    def check_now(self, key: str,
                  ping_fn: Optional[Callable[[], float]] = None) -> bool:
        """One synchronous probe of ``key`` (also used by tests to drive
        the monitor without waiting for the scheduler).  Returns True
        when the endpoint answered."""
        with self._lock:
            fn = ping_fn or self._endpoints.get(key)
            h = self._health.setdefault(key, EndpointHealth())
        if fn is None:
            return False
        try:
            rtt = fn()
        except Exception:  # noqa: BLE001 - any ping failure is a miss
            STATS.incr("heartbeat.missed")
            with self._lock:
                h.pings += 1
                h.missed += 1
                if h.missed >= self.max_missed:
                    went_down = h.state != EndpointHealth.DEAD
                    h.state = EndpointHealth.DEAD
                else:
                    went_down = False
                    if h.state == EndpointHealth.ALIVE:
                        h.state = EndpointHealth.SUSPECT
            if went_down:
                STATS.incr("heartbeat.endpoint_down")
                if self.on_down is not None:
                    self.on_down(key)
            return False
        with self._lock:
            h.pings += 1
            h.pongs += 1
            h.missed = 0
            came_up = h.state == EndpointHealth.DEAD
            h.state = EndpointHealth.ALIVE
            rtt_ms = rtt * 1e3
            h.rtt_ms = (rtt_ms if h.rtt_ms is None else
                        (1 - self._EWMA_ALPHA) * h.rtt_ms
                        + self._EWMA_ALPHA * rtt_ms)
        if came_up:
            STATS.incr("heartbeat.endpoint_up")
            if self.on_up is not None:
                self.on_up(key)
        return True
