"""Overload protection for the query serving plane: QoS classes,
token-bucket + watermark admission control, and hysteretic load
shedding.

The code of ``nnstreamer_tpu/query/overload.py`` (which imports no JAX),
unchanged: the port keeps its own copy, as it keeps of every module it
needs.  The LLM slot pool admits through it (``llm/pool.py``).

The among-device layer (tensor_query_*) assumed a well-behaved client
population; the soak harness proved the opposite — 64 loopback
clients saturate the single-threaded serving path, and an unbounded
``QueryServer.incoming`` absorbed the excess as unbounded memory growth
and unbounded latency.  This module makes overload an *explicit,
measurable* degradation instead:

- **QoS classes** — every connection carries one of ``gold`` /
  ``silver`` / ``bronze`` (negotiated in the ``T_HELLO`` capability
  handshake as a ``qos=<class>`` payload; unnegotiated connections
  default to ``silver``).  Clients that never set an explicit class
  inherit one from the loadgen's ``buf.extra["nns_class"]`` tagging via
  :func:`qos_of_class`.
- **Admission control** — :class:`AdmissionController` decides
  admit-or-shed per request from (a) an optional :class:`TokenBucket`
  capacity limit and (b) a pluggable :class:`ShedPolicy` driven by the
  serving gauges (queue depth, p99 proctime).  The decision reads the
  message header only — an overloaded request is refused BEFORE its
  tensors are deserialized into pooled slabs.
- **Load shedding** — a shed is answered with an explicit ``T_SHED``
  wire reply carrying a retry-after hint; the client maps it into the
  client fallback machinery (:class:`ShedError` is a ``ConnectionError``
  so ``fallback=error|passthrough|drop`` all apply) WITHOUT tripping
  circuit breakers — a shed proves the server is alive and protecting
  itself; it is not a failure.
- **Hysteresis** — the default :class:`WatermarkShedPolicy` arms
  shedding per class at a high queue-depth watermark and disarms at a
  low one (like the SLO burn-rate evaluator's arming), so the
  shed/admit boundary does not flap at the watermark.  Bronze sheds
  first, gold last.

Depends only on the stdlib + the sanitizer lock wrappers so every
transport layer can use it without cycles.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

from ..analysis.sanitizer import make_lock

#: QoS classes ordered by privilege: bronze sheds first, gold last.
QOS_CLASSES: Tuple[str, ...] = ("gold", "silver", "bronze")
#: shed priority rank: higher rank sheds earlier
QOS_RANK: Dict[str, int] = {"gold": 0, "silver": 1, "bronze": 2}
#: class an unnegotiated connection gets
DEFAULT_QOS = "silver"

#: loadgen/request-class tags that imply a QoS class (the
#: ``buf.extra["nns_class"]`` vocabulary the load generator already
#: writes); identity for the QoS names themselves
_CLASS_ALIASES: Dict[str, str] = {
    "gold": "gold", "silver": "silver", "bronze": "bronze",
    "interactive": "gold", "realtime": "gold",
    "default": "silver",
    "batch": "bronze", "bulk": "bronze", "background": "bronze",
}


def qos_of_class(name: Optional[str]) -> Optional[str]:
    """QoS class implied by a request-class tag, or None when the tag
    carries no QoS meaning (the connection then stays unnegotiated and
    the server applies :data:`DEFAULT_QOS`)."""
    if not name:
        return None
    return _CLASS_ALIASES.get(str(name).lower())


#: cross-stream batching residency budgets, as a fraction of the
#: bucket's ``batch-timeout-ms``: how long a frame of each class may sit
#: in a COLLECTING bucket waiting for peers before the bucket must
#: dispatch.  Gold waits a quarter of the configured deadline, bronze
#: the whole of it — so a gold frame landing in a bucket that bronze
#: traffic opened pulls the dispatch deadline IN (the bucket fires at
#: the minimum over resident frames' budgets) and never waits out a
#: bronze-sized fill window.  Admission (shed-or-admit) stays a separate,
#: earlier decision — budgets only shape who waits for whom AFTER
#: admission.
XBATCH_BUDGET_FACTOR: Dict[str, float] = {
    "gold": 0.25, "silver": 0.5, "bronze": 1.0}


def bucket_budget(qos: Optional[str], timeout_s: float) -> float:
    """Residency budget (seconds) of one admitted frame in a collecting
    cross-stream bucket: the configured coalesce deadline scaled by the
    frame's QoS class (:data:`XBATCH_BUDGET_FACTOR`).  ``timeout_s <= 0``
    (greedy batching — dispatch whatever is queued, never wait) returns
    0.0 for every class."""
    if timeout_s <= 0:
        return 0.0
    return timeout_s * XBATCH_BUDGET_FACTOR.get(qos or DEFAULT_QOS, 1.0)


class ShedError(ConnectionError):
    """The server answered ``T_SHED``: the request was refused by
    admission control, NOT failed.  ``retry_after_s`` is the server's
    hint for when capacity should exist again.

    Subclasses :class:`ConnectionError` so the tensor_query_client
    fallback machinery (``fallback=error|passthrough|drop``) applies
    unchanged — but resilience code must catch it FIRST and keep
    circuit breakers closed: a shed proves liveness.
    """

    def __init__(self, retry_after_s: float = 0.1, qos: str = "",
                 message: str = "") -> None:
        self.retry_after_s = float(retry_after_s)
        self.qos = qos
        super().__init__(
            message or f"request shed (qos={qos or '?'}, "
                       f"retry after {self.retry_after_s:.3f}s)")


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill, ``burst`` cap.

    ``take()`` is the admission primitive: True consumes one token;
    False returns how long until one exists (the retry-after hint).
    O(1), one lock, refill computed lazily from the monotonic clock
    (injectable for tests).
    """

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if rate <= 0:
            raise ValueError("rate must be > 0 tokens/s")
        self.rate = float(rate)
        self.burst = float(burst if burst is not None
                           else max(1.0, rate / 4.0))
        self._clock = clock
        self._tokens = self.burst
        self._t_last = clock()
        self._lock = make_lock("query.overload")

    def take(self, n: float = 1.0) -> Tuple[bool, float]:
        """Try to consume ``n`` tokens.  Returns ``(True, 0.0)`` on
        success or ``(False, wait_s)`` with the time until ``n`` tokens
        will have refilled."""
        now = self._clock()
        with self._lock:
            self._tokens = min(
                self.burst, self._tokens + (now - self._t_last) * self.rate)
            self._t_last = now
            if self._tokens >= n:
                self._tokens -= n
                return True, 0.0
            return False, (n - self._tokens) / self.rate


class ShedPolicy:
    """Decide admit-or-shed for one request.  Subclass hook for
    alternative shedding strategies (CoDel-style sojourn targets,
    per-class token buckets, cost-based admission…).

    ``decide(qos, depth, capacity)`` returns ``None`` to admit or a
    retry-after hint in seconds to shed.  Called on the per-connection
    reader thread for every DATA frame — keep it O(1).
    """

    def decide(self, qos: str, depth: int,
               capacity: int) -> Optional[float]:
        raise NotImplementedError


class WatermarkShedPolicy(ShedPolicy):
    """Queue-depth watermarks with per-class hysteresis, optionally
    compounded by a p99-latency signal.

    Each QoS class has an ARM watermark (fraction of queue capacity);
    when the queue depth reaches it, that class sheds until depth falls
    back under the DISARM watermark (default: half the arm point) —
    the same arm/disarm shape as the SLO burn-rate evaluator, so the
    admit/shed boundary cannot flap once per frame at the threshold.
    Bronze arms lowest (sheds first), gold highest (sheds last).

    ``p99_us_fn`` (optional) supplies a latency signal — e.g. a lazy
    read of the ``nns_element_proctime_us`` histogram's p99 or the
    server's service histogram.  While it exceeds ``p99_threshold_us``,
    bronze-tier traffic sheds even below its depth watermark (latency
    overload can precede queue growth when requests are large); the
    latch releases at 80 % of the threshold.
    """

    #: arm watermark per class, as a fraction of queue capacity
    ARM = {"gold": 0.90, "silver": 0.70, "bronze": 0.45}

    def __init__(self, arm: Optional[Dict[str, float]] = None,
                 disarm_ratio: float = 0.5,
                 retry_after_s: float = 0.1,
                 p99_us_fn: Optional[Callable[[], float]] = None,
                 p99_threshold_us: float = 0.0) -> None:
        self.arm = dict(arm or self.ARM)
        self.disarm_ratio = float(disarm_ratio)
        self.retry_after_s = float(retry_after_s)
        self.p99_us_fn = p99_us_fn
        self.p99_threshold_us = float(p99_threshold_us)
        self._armed: Dict[str, bool] = {c: False for c in self.arm}
        self._p99_armed = False
        self._lock = make_lock("query.overload")

    def _retry_after(self, qos: str) -> float:
        # lower tiers wait longer before retrying: the backoff itself
        # is priority-ordered, so recovering capacity reaches gold first
        return self.retry_after_s * (1 + QOS_RANK.get(qos, 1))

    def decide(self, qos: str, depth: int,
               capacity: int) -> Optional[float]:
        qos = qos if qos in self.arm else DEFAULT_QOS
        cap = max(1, int(capacity))
        frac = depth / cap
        with self._lock:
            armed = self._armed.get(qos, False)
            arm_at = self.arm.get(qos, 0.7)
            if armed:
                if frac <= arm_at * self.disarm_ratio:
                    self._armed[qos] = armed = False
            elif frac >= arm_at:
                self._armed[qos] = armed = True
            if armed:
                return self._retry_after(qos)
            # latency signal: sheds the bronze tier ahead of queue
            # growth; hysteretic like the depth latch
            if self.p99_us_fn is not None and self.p99_threshold_us > 0 \
                    and QOS_RANK.get(qos, 1) >= QOS_RANK["bronze"]:
                try:
                    p99 = float(self.p99_us_fn())
                except Exception:   # noqa: BLE001 — dead gauge: no signal
                    p99 = 0.0
                if self._p99_armed:
                    if p99 < 0.8 * self.p99_threshold_us:
                        self._p99_armed = False
                elif p99 > self.p99_threshold_us:
                    self._p99_armed = True
                if self._p99_armed:
                    return self._retry_after(qos)
        return None


class AdmissionController:
    """Admit-or-shed decisions for one serving endpoint.

    Composes the two admission signals in cost order: the token bucket
    (pure arithmetic) runs first, the shed policy (reads the queue
    depth gauge) second.  ``admit(qos, depth, capacity)`` returns
    ``None`` to admit or a retry-after hint in seconds.

    While :meth:`start_drain` is in effect EVERYTHING sheds with a
    retry-after sized to the drain deadline — the wire-visible half of
    graceful drain (clients route away instead of timing out).
    """

    def __init__(self, policy: Optional[ShedPolicy] = None,
                 bucket: Optional[TokenBucket] = None) -> None:
        self.policy = policy if policy is not None else WatermarkShedPolicy()
        self.bucket = bucket
        self._drain_until: Optional[float] = None
        self._drain_clock: Callable[[], float] = time.monotonic

    def start_drain(self, deadline_s: float,
                    clock: Callable[[], float] = time.monotonic) -> None:
        # keep the clock: admit() must compute the remaining drain with
        # the SAME clock or an injected one would yield nonsense hints
        self._drain_clock = clock
        self._drain_until = clock() + max(0.0, deadline_s)

    @property
    def draining(self) -> bool:
        return self._drain_until is not None

    def admit(self, qos: str, depth: int,
              capacity: int) -> Optional[float]:
        drain_until = self._drain_until
        if drain_until is not None:
            # drain retry-after: clients should come back after the
            # replacement had time to take over (≥ remaining drain)
            return max(0.1, drain_until - self._drain_clock() + 0.5)
        # policy first, bucket second: a policy-shed request must not
        # burn a token, or shed floods would starve the capacity the
        # bucket is supposed to guarantee the admitted tiers
        verdict = self.policy.decide(qos, depth, capacity)
        if verdict is not None:
            return verdict
        if self.bucket is not None:
            ok, wait = self.bucket.take()
            if not ok:
                return max(wait, 0.01)
        return None
