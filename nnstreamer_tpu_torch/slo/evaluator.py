"""SLO evaluator: multi-window burn-rate gating over the metrics registry.

The evaluator owns NO instrumentation of its own — it periodically
snapshots the process metrics registry (``MetricsRegistry.
snapshot_state``, the counters/histograms the loadgen and query
clients already write) and keeps a bounded time-indexed store of those
snapshots.  Every evaluation diffs the newest snapshot against the one
closest to ``now - window`` (``state_delta``), which yields exact
windowed request/error counts and a windowed latency distribution with
no per-request timestamping and no interference with the live metrics.

Breach logic is the standard multi-window burn-rate alert: an objective
breaches only when its error budget burns faster than
``spec.burn_threshold`` in BOTH the fast and the slow window.  The fast
window bounds detection latency; the slow window provides the evidence
that the condition is sustained — a single recovered disconnect spikes
the fast window but never the slow one, so it does not page (the
"zero SLO false-positives" gate of the soak smoke).  Early in a run
both windows necessarily cover the same "data so far", so alerts stay
UNARMED until the slow window genuinely outspans the fast one (3x,
capped at the full slow window) — otherwise a startup blip would
breach on the very first tick with no suppression in play.

:class:`SLOMonitor` runs the evaluator on its own thread with
absolute-deadline pacing (``Event.wait`` against a monotonic schedule —
no ``time.sleep`` polling) and fires
``on_breach`` exactly at breach ONSET per objective, which is the
flight recorder's dump trigger (slo/flightrec.py).
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis.sanitizer import make_lock
from ..obs.clock import mono_ns
from ..obs.metrics import (REGISTRY, MetricsRegistry,
                           count_over_threshold, quantile_from_counts,
                           state_delta)
from .spec import (ERRORS_TOTAL, HIST_FAMILY, HIST_KINDS,
                   REQUESTS_TOTAL, Objective, SLOSpec)


def _family(key: str) -> str:
    return key.partition("{")[0]


def _key_match(key: str, obj: Objective) -> bool:
    if obj.request_class and f'class="{obj.request_class}"' not in key:
        return False
    return not obj.match or obj.match in key


def _sum_counters(delta: Dict[str, Any], family: str,
                  obj: Objective) -> int:
    total = 0
    for key, st in delta.items():
        if st.get("kind") == "counter" and _family(key) == family \
                and _key_match(key, obj):
            total += int(st["value"])
    return total


def _sum_hist(delta: Dict[str, Any], family: str, obj: Objective
              ) -> Tuple[int, Optional[Tuple[int, ...]]]:
    """Summed (count, bucket vector) across matching histogram labels;
    (0, None) when the family has no data."""
    count = 0
    counts: Optional[List[int]] = None
    for key, st in delta.items():
        if st.get("kind") != "histogram" or _family(key) != family \
                or not _key_match(key, obj):
            continue
        count += int(st["count"])
        if counts is None:
            counts = list(st["counts"])
        else:
            for i, c in enumerate(st["counts"]):
                counts[i] += c
    return count, tuple(counts) if counts is not None else None


class Evaluator:
    """Windowed burn-rate evaluation of one :class:`SLOSpec`.

    ``tick(now)`` snapshots the registry, evaluates every objective
    over the fast and slow windows, records breach ONSETS, and returns
    the evaluation dict.  ``now`` defaults to the monotonic clock;
    tests inject a fake clock for deterministic window math.

    ``on_breach(breach_event, evaluation)`` fires outside the
    evaluator's lock, once per objective breach onset (re-arming only
    after the objective recovers) — the flight-recorder trigger.
    """

    def __init__(self, spec: SLOSpec,
                 registry: MetricsRegistry = REGISTRY,
                 on_breach: Optional[Callable[[Dict[str, Any],
                                               Dict[str, Any]],
                                              None]] = None) -> None:
        self.spec = spec
        self.registry = registry
        self.on_breach = on_breach
        #: per-tick observer (flight recorder's snapshot feed): called
        #: with every evaluation dict, outside the evaluator lock
        self.on_tick: Optional[Callable[[Dict[str, Any]], None]] = None
        self._lock = make_lock("slo")
        #: (t, snapshot) store, pruned to slow_window (+ one older
        #: entry so a full slow-window diff always has a base)
        self._snaps: "deque[Tuple[float, Dict[str, Any]]]" = deque()
        self._t0: Optional[float] = None
        self._ticks = 0
        self._breaches: List[Dict[str, Any]] = []
        self._breached_now: Dict[str, bool] = {}
        self._worst_burn: Dict[str, float] = {}
        self._last_eval: Optional[Dict[str, Any]] = None

    # -- windows -------------------------------------------------------------
    def _base_at_locked(self, now: float, window_s: float
                        ) -> Tuple[float, Dict[str, Any]]:
        """Newest stored snapshot at-or-before ``now - window_s``
        (falls back to the oldest stored — early in a run the "window"
        is the data so far, standard burn-rate warm-up behavior)."""
        cutoff = now - window_s
        base = self._snaps[0]
        for t, snap in self._snaps:
            if t <= cutoff:
                base = (t, snap)
            else:
                break
        return base

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.spec.window_slow_s
        while len(self._snaps) > 1 and self._snaps[1][0] <= horizon:
            self._snaps.popleft()

    # -- evaluation ----------------------------------------------------------
    def _objective_window(self, obj: Objective, delta: Dict[str, Any],
                          span_s: float) -> Dict[str, Any]:
        if obj.kind in HIST_KINDS:
            # latency / ttft / itl share the histogram-threshold
            # accounting; only the default family differs (the token
            # kinds read the loadgen's schedule-anchored families
            # unless ``metric`` points at the server-side ones)
            total, counts = _sum_hist(delta,
                                      obj.metric
                                      or HIST_FAMILY[obj.kind], obj)
            bad = (count_over_threshold(counts, obj.threshold_us)
                   if counts else 0)
            p99 = (quantile_from_counts(counts, 0.99)
                   if counts and total else 0.0)
        else:   # error_rate / availability: counter accounting
            total = _sum_counters(delta, REQUESTS_TOTAL, obj)
            bad = _sum_counters(delta, ERRORS_TOTAL, obj)
            p99 = None
        frac = (bad / total) if total else 0.0
        out = {"window_s": round(span_s, 3), "total": total, "bad": bad,
               "bad_fraction": round(frac, 6),
               "burn_rate": round(frac / obj.budget, 4)}
        if p99 is not None:
            out["p99_us"] = round(p99, 1)
        return out

    def _evaluate(self, now: float, snap: Dict[str, Any]
                  ) -> Dict[str, Any]:
        with self._lock:
            t_fast, base_fast = self._base_at_locked(
                now, self.spec.window_fast_s)
            t_slow, base_slow = self._base_at_locked(
                now, self.spec.window_slow_s)
        d_fast = state_delta(snap, base_fast)
        d_slow = state_delta(snap, base_slow)
        fast_span = max(now - t_fast, 1e-9)
        slow_span = max(now - t_slow, 1e-9)
        # arming: early in a run both windows cover the same
        # "data so far" and the multi-window suppression does not exist
        # yet — a startup blip (64 clients dialing at once) would
        # breach on the first tick.  Alerts arm only once the slow
        # window genuinely outspans the fast one (3x, capped at the
        # full slow window so short specs still arm).
        armed = (slow_span + 1e-6
                 >= min(3.0 * fast_span, self.spec.window_slow_s))
        objectives = []
        for obj in self.spec.objectives:
            fast = self._objective_window(obj, d_fast, fast_span)
            slow = self._objective_window(obj, d_slow, slow_span)
            breached = (armed
                        and fast["total"] > 0 and slow["total"] > 0
                        and fast["burn_rate"] > self.spec.burn_threshold
                        and slow["burn_rate"] > self.spec.burn_threshold)
            objectives.append({**obj.to_dict(),
                               "budget": round(obj.budget, 6),
                               "fast": fast, "slow": slow,
                               "breached": breached})
        return {"t": round(now, 3),
                "burn_threshold": self.spec.burn_threshold,
                "armed": armed,
                "objectives": objectives,
                "breached": any(o["breached"] for o in objectives)}

    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation step; returns the evaluation dict and fires
        ``on_breach`` for objectives whose breach starts this tick."""
        if now is None:
            now = mono_ns() / 1e9
        # "nns_" covers the loadgen families AND metric-override
        # targets (per-element histograms, query server counters)
        snap = self.registry.snapshot_state(prefix="nns_")
        with self._lock:
            if self._t0 is None:
                self._t0 = now
            self._snaps.append((now, snap))
            self._prune_locked(now)
            self._ticks += 1
        evaluation = self._evaluate(now, snap)
        onsets: List[Dict[str, Any]] = []
        with self._lock:
            for o in evaluation["objectives"]:
                worst = max(o["fast"]["burn_rate"],
                            o["slow"]["burn_rate"])
                if worst > self._worst_burn.get(o["name"], 0.0):
                    self._worst_burn[o["name"]] = worst
                was = self._breached_now.get(o["name"], False)
                self._breached_now[o["name"]] = o["breached"]
                if o["breached"] and not was:
                    event = {"t": evaluation["t"],
                             "tick": self._ticks,
                             "objective": o["name"],
                             "kind": o["kind"],
                             "evidence": {"fast": o["fast"],
                                          "slow": o["slow"],
                                          "burn_threshold":
                                              self.spec.burn_threshold}}
                    self._breaches.append(event)
                    onsets.append(event)
            self._last_eval = evaluation
        if self.on_tick is not None:
            self.on_tick(evaluation)
        if self.on_breach is not None:
            for event in onsets:
                self.on_breach(event, evaluation)
        return evaluation

    # -- verdict -------------------------------------------------------------
    def verdict(self) -> Dict[str, Any]:
        """Machine-readable PASS/FAIL: the soak's exit artifact.  FAIL
        iff any objective ever breached (breaches latch — a soak that
        breached and recovered still failed its SLO)."""
        with self._lock:
            last = self._last_eval
            breaches = list(self._breaches)
            ticks = self._ticks
            duration = ((self._snaps[-1][0] - self._t0)
                        if self._snaps and self._t0 is not None else 0.0)
            worst = dict(self._worst_burn)
        objectives = []
        for obj in self.spec.objectives:
            row = {**obj.to_dict(),
                   "worst_burn_rate": round(worst.get(obj.name, 0.0), 4),
                   "breaches": sum(1 for b in breaches
                                   if b["objective"] == obj.name)}
            if last is not None:
                final = next((o for o in last["objectives"]
                              if o["name"] == obj.name), None)
                if final is not None:
                    row["final"] = {"fast": final["fast"],
                                    "slow": final["slow"]}
            objectives.append(row)
        ok = not breaches
        return {"slo": self.spec.name,
                "verdict": "PASS" if ok else "FAIL",
                "pass": ok,
                "burn_threshold": self.spec.burn_threshold,
                "windows": {"fast_s": self.spec.window_fast_s,
                            "slow_s": self.spec.window_slow_s},
                "ticks": ticks,
                "duration_s": round(duration, 3),
                "objectives": objectives,
                "breaches": breaches}


class SLOMonitor:
    """Background evaluation loop: ticks an :class:`Evaluator` every
    ``spec.tick_s`` on an absolute-deadline schedule (drift-free; an
    overrunning tick skips forward rather than bunching)."""

    def __init__(self, evaluator: Evaluator,
                 tick_s: Optional[float] = None) -> None:
        self.evaluator = evaluator
        self.tick_s = float(tick_s if tick_s is not None
                            else evaluator.spec.tick_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "SLOMonitor":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="slo-monitor")
            self._thread.start()
        return self

    def stop(self, final_tick: bool = True) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)
        if final_tick:
            # close the books: the verdict must include requests that
            # landed after the last scheduled tick
            self.evaluator.tick()

    def _loop(self) -> None:
        deadline = mono_ns() / 1e9 + self.tick_s
        while not self._stop.is_set():
            wait = deadline - mono_ns() / 1e9
            if wait > 0 and self._stop.wait(wait):
                return
            self.evaluator.tick()
            now = mono_ns() / 1e9
            deadline += self.tick_s
            if deadline < now:      # overran: realign, don't bunch
                deadline = now + self.tick_s
