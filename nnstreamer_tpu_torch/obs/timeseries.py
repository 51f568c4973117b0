"""On-host metrics time series: a bounded ring of registry snapshots
plus sustained-signal detection.

The PyTorch counterpart of ``nnstreamer_tpu/obs/timeseries.py``, pure
host code, the JAX package's own.  The instrument stack answers "what is
the value NOW" (lazy gauges, cumulative counters, live histograms); a
consumer that wants to *act* on telemetry needs "what has the value
BEEN": a windowed shed rate, a queue depth held above watermark for
10 s.  Periodic :meth:`MetricsRegistry.snapshot_state` captures diffed
with :func:`~nnstreamer_tpu_torch.obs.metrics.state_delta` make a ring
any consumer can query:

- :class:`TimeSeriesRing` — bounded (interval × retention) store of
  snapshots with windowed counter rates, histogram
  quantiles-over-window, and per-capture flattened series.
- :class:`SustainedSignal` — threshold × min-hold-duration × disarm
  hysteresis: a startup blip or one hot scrape must NEVER fire; only a
  condition that holds continuously for ``min_hold_s`` does, and once
  fired the signal stays armed until the value recovers past a *lower*
  disarm threshold (no flapping at the boundary).  Samples whose window
  delta carries ``reset: True`` (a worker restarted — counters went
  backwards) are skipped entirely: a restart artifact is neither load
  nor recovery.  The LLM tier's default signals
  (``llm/tokenobs.default_llm_signals``) are of this kind.
- :class:`SignalBus` — subscribable fan-out of signal transitions
  (``armed``/``fired``/``cleared``).
- :class:`RingSampler` — the background capture loop
  (absolute-deadline pacing, ``Event.wait`` — no ``time.sleep``
  polling).

Every signal also exports its state as a lazy gauge
(``nns_signal_state{signal=...}``: 0 idle, 1 holding, 2 fired), so
signal states travel through /metrics scrapes.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis.sanitizer import make_lock
from .clock import mono_ns, wall_us
from .metrics import (REGISTRY, quantile_from_counts, state_delta)

#: signal lifecycle states (exported via the nns_signal_state gauge)
SIGNAL_IDLE, SIGNAL_HOLDING, SIGNAL_FIRED = "idle", "holding", "fired"
_SIGNAL_STATE_NUM = {SIGNAL_IDLE: 0, SIGNAL_HOLDING: 1, SIGNAL_FIRED: 2}


def _family(key: str) -> str:
    return key.partition("{")[0]


def _key_match(key: str, family: str, match: Optional[str]) -> bool:
    if _family(key) != family:
        return False
    return not match or match in key


class SignalBus:
    """Subscribable signal-event fan-out.

    ``subscribe(fn)`` registers a callable receiving every event dict;
    events are delivered synchronously from the capture thread, OUTSIDE
    every ring/signal lock (a slow subscriber delays the next capture,
    never deadlocks it).  A subscriber that raises is dropped from that
    event's delivery but stays subscribed — telemetry consumers must
    not kill the sampler."""

    def __init__(self) -> None:
        self._lock = make_lock("leaf")
        self._subs: List[Callable[[Dict[str, Any]], None]] = []
        #: bounded recent-events ring (verdict/debug surface for
        #: consumers that poll instead of subscribing)
        self.events: "deque[Dict[str, Any]]" = deque(maxlen=256)

    def subscribe(self, fn: Callable[[Dict[str, Any]], None]
                  ) -> Callable[[], None]:
        """Register ``fn``; returns an unsubscribe callable."""
        with self._lock:
            self._subs.append(fn)

        def _unsubscribe() -> None:
            with self._lock:
                try:
                    self._subs.remove(fn)
                except ValueError:
                    pass
        return _unsubscribe

    def publish(self, event: Dict[str, Any]) -> None:
        with self._lock:
            subs = list(self._subs)
            self.events.append(event)
        for fn in subs:
            try:
                fn(event)
            except Exception:   # noqa: BLE001 — a consumer must not
                pass            # kill the capture thread


class SustainedSignal:
    """One sustained condition over one metric family.

    ``kind`` picks how the value is computed from the ring at each
    capture:

    - ``"gauge"`` — aggregate (``agg``: max | sum | mean) of the NEWEST
      sample's matching gauge values;
    - ``"rate"`` — summed matching counter deltas over ``window_s``,
      divided by the window span (events/s);
    - ``"p99"``/``"p95"``/``"p50"`` — windowed histogram quantile over
      ``window_s`` (summed matching bucket vectors).

    Lifecycle: value ``>= threshold`` starts the hold clock
    (``holding``); held CONTINUOUSLY for ``min_hold_s`` → ``fired``
    (latched; ``firings`` increments once per onset); value ``<=
    disarm_below`` (default ``threshold / 2``) → ``cleared`` back to
    idle, re-armable.  A dip below threshold but above ``disarm_below``
    while holding resets the hold clock without a ``cleared`` event —
    hysteresis, not flapping.

    ``direction="below"`` inverts the comparison for *idle* conditions
    (a drain-on-idle signal): the condition holds
    while ``value <= threshold`` and disarms at ``value >=
    disarm_above`` (default ``2 x threshold``, or ``1.0`` when the
    threshold is 0 — "any traffic at all clears idleness").  Same
    state machine, same reset discipline, mirrored band.

    Reset discipline: when any matching key's window delta carries
    ``reset: True`` (state_delta detected counters going backwards — a
    worker restart), the tick is SKIPPED: the hold clock neither
    advances nor resets, and no transition fires.  A restart artifact
    must never page and must never read as recovery.
    """

    def __init__(self, name: str, metric: str, *, threshold: float,
                 min_hold_s: float, kind: str = "gauge",
                 window_s: float = 10.0,
                 disarm_below: Optional[float] = None,
                 direction: str = "above",
                 disarm_above: Optional[float] = None,
                 agg: str = "max", match: Optional[str] = None) -> None:
        if kind not in ("gauge", "rate", "p99", "p95", "p50"):
            raise ValueError(f"signal {name}: kind={kind!r}")
        if agg not in ("max", "sum", "mean"):
            raise ValueError(f"signal {name}: agg={agg!r}")
        if direction not in ("above", "below"):
            raise ValueError(f"signal {name}: direction={direction!r}")
        self.name = name
        self.metric = metric
        self.kind = kind
        self.direction = direction
        self.threshold = float(threshold)
        self.min_hold_s = float(min_hold_s)
        self.window_s = float(window_s)
        if direction == "below":
            if disarm_below is not None:
                raise ValueError(
                    f"signal {name}: direction=below disarms ABOVE the "
                    "threshold — use disarm_above")
            self.disarm_above = (float(disarm_above) if disarm_above
                                 is not None
                                 else (self.threshold * 2.0
                                       or 1.0))
            self.disarm_below = None
            if self.disarm_above < self.threshold:
                raise ValueError(
                    f"signal {name}: disarm_above {self.disarm_above} "
                    f"under threshold {self.threshold} (an idle signal "
                    "must disarm ABOVE where it arms)")
        else:
            if disarm_above is not None:
                raise ValueError(
                    f"signal {name}: direction=above disarms BELOW the "
                    "threshold — use disarm_below")
            self.disarm_above = None
            self.disarm_below = (float(disarm_below) if disarm_below
                                 is not None else self.threshold / 2.0)
            if self.disarm_below > self.threshold:
                raise ValueError(
                    f"signal {name}: disarm_below {self.disarm_below} "
                    f"above threshold {self.threshold} (hysteresis "
                    "must disarm BELOW where it arms)")
        self.agg = agg
        self.match = match
        self.state = SIGNAL_IDLE
        self.firings = 0
        self.value: Optional[float] = None
        #: OBSERVED seconds the condition has held (accumulated over
        #: valid ticks only — a skipped tick's gap contributes nothing,
        #: so an unobserved restart window can never satisfy min_hold)
        self._held_s = 0.0
        self._last_valid_t: Optional[float] = None
        self._fired_at: Optional[float] = None

    # -- value extraction ----------------------------------------------------
    def _value_from(self, newest: Dict[str, Any],
                    delta: Dict[str, Any], span_s: float
                    ) -> Tuple[Optional[float], bool]:
        """(value, reset_seen) for this capture; value None = the
        metric is absent (signal stays wherever it is)."""
        if self.kind == "gauge":
            vals = [st["value"] for key, st in newest.items()
                    if st.get("kind") == "gauge"
                    and _key_match(key, self.metric, self.match)]
            if not vals:
                return None, False
            if self.agg == "max":
                return max(vals), False
            if self.agg == "sum":
                return sum(vals), False
            return sum(vals) / len(vals), False
        reset = False
        if self.kind == "rate":
            total = 0
            seen = False
            for key, st in delta.items():
                if st.get("kind") != "counter" \
                        or not _key_match(key, self.metric, self.match):
                    continue
                seen = True
                reset = reset or bool(st.get("reset"))
                total += st["value"]
            if not seen:
                return None, reset
            return total / max(span_s, 1e-9), reset
        # windowed quantile
        q = {"p99": 0.99, "p95": 0.95, "p50": 0.50}[self.kind]
        counts: Optional[List[int]] = None
        for key, st in delta.items():
            if st.get("kind") != "histogram" \
                    or not _key_match(key, self.metric, self.match):
                continue
            reset = reset or bool(st.get("reset"))
            if counts is None:
                counts = list(st["counts"])
            else:
                for i, c in enumerate(st["counts"]):
                    counts[i] += c
        if counts is None or not sum(counts):
            return None, reset
        return quantile_from_counts(counts, q), reset

    def _breaches(self, value: float) -> bool:
        if self.direction == "below":
            return value <= self.threshold
        return value >= self.threshold

    def _disarms(self, value: float) -> bool:
        if self.direction == "below":
            return value >= self.disarm_above
        return value <= self.disarm_below

    # -- lifecycle -----------------------------------------------------------
    def evaluate(self, now: float, newest: Dict[str, Any],
                 delta: Dict[str, Any], span_s: float,
                 reset_keys: frozenset = frozenset()
                 ) -> List[Dict[str, Any]]:
        """One capture's worth of state machine; returns the transition
        events to publish (possibly several: holding→fired in one tick
        when min_hold_s is 0).  ``reset_keys`` carries the keys whose
        ADJACENT-sample delta detected a counter reset this capture —
        the windowed delta alone can mask a mid-window restart (base →
        newest may still be net-positive across it)."""
        skip = (any(_key_match(k, self.metric, self.match)
                    for k in reset_keys))
        value = None
        if not skip:
            value, reset = self._value_from(newest, delta, span_s)
            skip = reset
        if skip or value is None:
            # worker restart inside the window (or the metric is
            # absent this tick): skip entirely — the hold PROGRESS is
            # kept but the unobserved gap must not count toward
            # min_hold, so the next valid tick re-anchors instead of
            # crediting time nobody measured
            self._last_valid_t = None
            return []
        self.value = value
        if self.state == SIGNAL_HOLDING and self._last_valid_t is not None \
                and self._breaches(value):
            self._held_s += now - self._last_valid_t
        events: List[Dict[str, Any]] = []

        def _event(state: str) -> Dict[str, Any]:
            return {"signal": self.name, "state": state,
                    "t": round(now, 3), "value": round(value, 6),
                    "threshold": self.threshold,
                    "direction": self.direction,
                    "metric": self.metric, "kind": self.kind,
                    "held_s": round(self._held_s, 3)}

        if self.state == SIGNAL_IDLE:
            if self._breaches(value):
                self.state = SIGNAL_HOLDING
                self._held_s = 0.0
                events.append(_event("armed"))
        elif self.state == SIGNAL_HOLDING:
            if self._disarms(value):
                self.state = SIGNAL_IDLE
                self._held_s = 0.0
                events.append(_event("cleared"))
                self._last_valid_t = now
                return events
            if not self._breaches(value):
                # hysteresis band: dip resets the hold clock but the
                # signal stays watching (no cleared event)
                self._held_s = 0.0
        if self.state == SIGNAL_HOLDING \
                and self._held_s >= self.min_hold_s \
                and self._breaches(value):
            self.state = SIGNAL_FIRED
            self.firings += 1
            self._fired_at = now
            events.append(_event("fired"))
        elif self.state == SIGNAL_FIRED:
            if self._disarms(value):
                self.state = SIGNAL_IDLE
                self._held_s = 0.0
                self._fired_at = None
                events.append(_event("cleared"))
        self._last_valid_t = now
        return events

    def report(self) -> Dict[str, Any]:
        return {"signal": self.name, "metric": self.metric,
                "kind": self.kind, "threshold": self.threshold,
                "direction": self.direction,
                "disarm_below": self.disarm_below,
                "disarm_above": self.disarm_above,
                "min_hold_s": self.min_hold_s,
                "window_s": self.window_s,
                "state": self.state, "firings": self.firings,
                "value": (round(self.value, 6)
                          if self.value is not None else None)}


class TimeSeriesRing:
    """Bounded ring of periodic registry snapshots + signal evaluation.

    ``source`` is anything with ``snapshot_state(prefix=...)`` — the
    process :data:`~nnstreamer_tpu_torch.obs.metrics.REGISTRY` by
    default, or any collector with that method.

    ``capture(now=...)`` is the injectable-clock tick (tests drive it
    directly; production uses :class:`RingSampler`).  Capacity is
    ``retention_s / interval_s`` samples; windows larger than retention
    degrade to "data so far" exactly like the SLO evaluator's warm-up.
    """

    def __init__(self, source: Any = None, interval_s: float = 1.0,
                 retention_s: float = 120.0, prefix: str = "nns_",
                 registry=None) -> None:
        self.source = source if source is not None else REGISTRY
        self.interval_s = max(1e-3, float(interval_s))
        self.retention_s = max(self.interval_s, float(retention_s))
        self.prefix = prefix
        capacity = int(self.retention_s / self.interval_s) + 2
        self._lock = make_lock("obs.timeseries")
        #: [mono_s, wall_us, snapshot_state, flat-or-None] samples,
        #: oldest first; slot 3 memoizes flatten_state per capture (a
        #: capture is immutable, and re-flattening the whole retention
        #: window per dashboard refresh is O(retention × metrics))
        self._samples: "deque[list]" = deque(maxlen=max(8, capacity))
        self.captures = 0
        self.bus = SignalBus()
        self._signals: List[SustainedSignal] = []
        #: lazy gauges exporting each signal's state (registered on the
        #: metrics registry so scrapes/federation carry signal states);
        #: None source registries (collector facades) skip the export
        self._signal_gauges: List[Any] = []
        self._registry = registry if registry is not None else (
            self.source if hasattr(self.source, "gauge") else None)

    # -- signals -------------------------------------------------------------
    def add_signal(self, signal: SustainedSignal) -> SustainedSignal:
        with self._lock:
            self._signals.append(signal)
        reg = self._registry
        if reg is not None:
            g = reg.gauge(
                "nns_signal_state",
                fn=lambda s=signal: _SIGNAL_STATE_NUM[s.state],
                signal=signal.name)
            self._signal_gauges.append(g)
        return signal

    def signals(self) -> List[SustainedSignal]:
        with self._lock:
            return list(self._signals)

    def signal_report(self) -> Dict[str, Any]:
        """Verdict-ready signal summary."""
        sigs = self.signals()
        return {"signals": [s.report() for s in sigs],
                "firings": sum(s.firings for s in sigs),
                "fired": sorted(s.name for s in sigs if s.firings),
                "events": list(self.bus.events)}

    # -- capture -------------------------------------------------------------
    def capture(self, now: Optional[float] = None,
                state: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """Take one snapshot (``now`` injectable for tests), evaluate
        every signal against it, publish transitions, return the
        snapshot."""
        if now is None:
            now = mono_ns() / 1e9
        if state is None:
            # snapshot OUTSIDE the ring lock: gauge providers may take
            # element locks and must not nest under obs.timeseries
            state = self.source.snapshot_state(prefix=self.prefix)
        with self._lock:
            prev = self._samples[-1][2] if self._samples else None
            self._samples.append([now, wall_us(), state, None])
            self.captures += 1
            signals = list(self._signals)
        events: List[Dict[str, Any]] = []
        if signals:
            # adjacent-sample reset detection: a restart is only
            # visible across the boundary it happened at — a windowed
            # base-to-newest diff can net out positive right across it
            reset_keys = frozenset()
            if prev is not None:
                step = state_delta(state, prev)
                reset_keys = frozenset(
                    k for k, st in step.items() if st.get("reset"))
            deltas: Dict[float, Tuple[float, Dict[str, Any]]] = {}
            for sig in signals:
                # one windowed diff per DISTINCT window, not per
                # signal: a standard watch list shares one
                # window, and a federated snapshot is thousands of keys
                if sig.window_s not in deltas:
                    deltas[sig.window_s] = self.window(sig.window_s,
                                                      now=now)
                span_s, delta = deltas[sig.window_s]
                events.extend(sig.evaluate(now, state, delta, span_s,
                                           reset_keys=reset_keys))
        for event in events:
            self.bus.publish(event)
        return state

    # -- windows -------------------------------------------------------------
    def _base_at_locked(self, now: float, window_s: float
                        ) -> Tuple[float, Dict[str, Any]]:
        cutoff = now - window_s
        base = self._samples[0]
        for sample in self._samples:
            if sample[0] <= cutoff:
                base = sample
            else:
                break
        return base[0], base[2]

    def window(self, window_s: float, now: Optional[float] = None
               ) -> Tuple[float, Dict[str, Any]]:
        """``(span_s, state_delta)`` between the newest sample and the
        newest sample at-or-before ``now - window_s`` (falls back to
        the oldest stored — warm-up covers "data so far")."""
        with self._lock:
            if not self._samples:
                return 0.0, {}
            t_new, newest = self._samples[-1][0], self._samples[-1][2]
            if now is None:
                now = t_new
            t_base, base = self._base_at_locked(now, window_s)
        if t_base >= t_new:
            return 0.0, state_delta(newest, newest)
        return t_new - t_base, state_delta(newest, base)

    def rate(self, family: str, window_s: float,
             match: Optional[str] = None) -> float:
        """Summed matching counter deltas / window span (events/s)."""
        span_s, delta = self.window(window_s)
        if span_s <= 0:
            return 0.0
        total = sum(st["value"] for key, st in delta.items()
                    if st.get("kind") == "counter"
                    and _key_match(key, family, match))
        return total / span_s

    def quantile(self, family: str, q: float, window_s: float,
                 match: Optional[str] = None) -> float:
        """Windowed histogram quantile (summed matching buckets)."""
        _span, delta = self.window(window_s)
        counts: Optional[List[int]] = None
        for key, st in delta.items():
            if st.get("kind") != "histogram" \
                    or not _key_match(key, family, match):
                continue
            if counts is None:
                counts = list(st["counts"])
            else:
                for i, c in enumerate(st["counts"]):
                    counts[i] += c
        if counts is None:
            return 0.0
        return quantile_from_counts(counts, q)

    def latest(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._samples[-1][2] if self._samples else None

    def series(self, key: str, window_s: Optional[float] = None
               ) -> List[Tuple[float, float]]:
        """``(t, value)`` points for ONE exact key: gauge/counter values
        per capture (counters stay cumulative — diff adjacent points
        for rates), histogram counts.  The dashboard's sparkline feed."""
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return []
        cutoff = samples[-1][0] - window_s if window_s else None
        out: List[Tuple[float, float]] = []
        for sample in samples:
            t, snap = sample[0], sample[2]
            if cutoff is not None and t < cutoff:
                continue
            st = snap.get(key)
            if st is None:
                continue
            val = st.get("count") if st.get("kind") == "histogram" \
                else st.get("value")
            if val is not None:
                out.append((t, float(val)))
        return out

    def flat_samples(self, window_s: Optional[float] = None
                     ) -> List[Tuple[float, Dict[str, float]]]:
        """Per-capture flattened ``{key: float}`` maps — counters and
        gauges as values, histograms as ``_count`` plus rendered
        ``quantile`` keys (the same shape a /metrics scrape parses to,
        so the dashboard consumes rings and scrapes identically).
        Flattening is memoized per capture (slot 3 of the sample):
        only NEW captures pay the histogram-quantile work on a
        refresh, not the whole retention window."""
        with self._lock:
            samples = list(self._samples)
        if not samples:
            return []
        cutoff = samples[-1][0] - window_s if window_s else None
        out: List[Tuple[float, Dict[str, float]]] = []
        for sample in samples:
            t = sample[0]
            if cutoff is not None and t < cutoff:
                continue
            if sample[3] is None:
                sample[3] = flatten_state(sample[2])
            out.append((t, sample[3]))
        return out

    def close(self) -> None:
        reg = self._registry
        if reg is not None:
            for g in self._signal_gauges:
                reg.unregister(g)
        self._signal_gauges = []


def flatten_state(state: Dict[str, Any]) -> Dict[str, float]:
    """One snapshot_state map flattened to ``{key: float}`` in the
    shape a Prometheus scrape parses to: counters/gauges keep their
    key, a histogram ``name{l}`` yields ``name_count{l}``,
    ``name_sum{l}`` and ``name{l,quantile="0.5|0.95|0.99"}`` keys
    (quantiles from the cumulative bucket vector)."""
    out: Dict[str, float] = {}
    for key, st in state.items():
        kind = st.get("kind")
        if kind == "histogram":
            name, brace, labels = key.partition("{")
            inner = labels[:-1] if brace else ""
            sep = "," if inner else ""
            out[f"{name}_count{{{inner}}}" if brace
                else f"{name}_count"] = float(st["count"])
            out[f"{name}_sum{{{inner}}}" if brace
                else f"{name}_sum"] = float(st["total"])
            for q in (0.5, 0.95, 0.99):
                qkey = (f"{name}{{{inner}{sep}quantile=\"{q}\"}}"
                        if brace else f"{name}{{quantile=\"{q}\"}}")
                out[qkey] = (quantile_from_counts(st["counts"], q)
                             if st["count"] else 0.0)
        else:
            try:
                out[key] = float(st["value"])
            except (TypeError, ValueError):
                continue
    return out


class DeadlineLoop:
    """Generic absolute-deadline background loop: ``Event.wait`` pacing
    (drift-free; an overrunning pass realigns rather than bunching —
    the SLOMonitor discipline), every registered fn called per pass, a
    raising fn logged once and survived (a dead maintenance loop would
    read as a clean pass).  The engine of :class:`RingSampler`."""

    def __init__(self, fns, interval_s: float,
                 name: str = "nns-loop") -> None:
        self.fns = list(fns)
        self.interval_s = max(1e-3, float(interval_s))
        self.name = name
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "DeadlineLoop":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name=self.name)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)

    def _loop(self) -> None:
        logged = False
        deadline = mono_ns() / 1e9 + self.interval_s
        while not self._stop.is_set():
            wait = deadline - mono_ns() / 1e9
            if wait > 0 and self._stop.wait(wait):
                return
            for fn in list(self.fns):
                try:
                    fn()
                except Exception:   # noqa: BLE001 — one bad pass
                    # (torn-down source, poisoned federated state)
                    # must not silently kill the loop for the rest of
                    # the run
                    if not logged:
                        logged = True
                        from ..utils.log import ml_logw

                        ml_logw("%s: pass failed (continuing)",
                                self.name, exc_info=True)
            now = mono_ns() / 1e9
            deadline += self.interval_s
            if deadline < now:      # overran: realign, don't bunch
                deadline = now + self.interval_s


class RingSampler(DeadlineLoop):
    """Background capture loop for a :class:`TimeSeriesRing` (one
    :class:`DeadlineLoop` pass = one ``ring.capture()``)."""

    def __init__(self, ring: TimeSeriesRing,
                 interval_s: Optional[float] = None) -> None:
        self.ring = ring
        super().__init__([ring.capture],
                         interval_s if interval_s is not None
                         else ring.interval_s,
                         name="nns-ts-sampler")

    def start(self) -> "RingSampler":
        super().start()
        return self

    def stop(self, final_capture: bool = True) -> None:
        super().stop()
        if final_capture:
            self.ring.capture()
