"""Metrics registry: counters, gauges, log-bucket latency histograms.

The pull model is the design constraint: the dataflow hot path must not
pay for metrics it is not producing.  So:

- **Gauges are lazy**: register a callable (queue depth, pool
  occupancy, filter inflight) and it is evaluated at *scrape* time —
  zero instructions per buffer.
- **Histograms are push** but only written by code that is already
  observing (a :class:`~nnstreamer_tpu_torch.pipeline.tracing.Tracer` with
  its per-element clock reads); no tracer, no writes.
- **Counters** wrap the same monotonic-int contract as
  ``query/resilience.py`` STATS (which the registry bridges at render
  time rather than duplicating).

Histogram buckets are fixed log-spaced: ``factor = 2**(1/4)`` (~19 %
relative width), so quantiles interpolated at the geometric bucket
midpoint land within ~9 % of the true value — tight enough for p50/p95/
p99 latency reporting with a 128-slot fixed footprint and O(1) observe.

``render_prometheus()`` emits Prometheus text exposition (counters and
gauges as-is, histograms as summaries with quantile labels), what the
``NNS_METRICS_PORT`` endpoint (obs/httpd.py) serves.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis.sanitizer import make_lock

#: buckets per factor-of-2 (quarter-octave): bucket i covers
#: [2**(i/4), 2**((i+1)/4))
_SUB = 4
_LOG2_SUB = _SUB / math.log(2.0)
_NBUCKETS = 128            # covers [1, 2**32) — 1 µs .. ~71 min in µs


def _bucket_of(value: float) -> int:
    if value <= 1.0:
        return 0
    i = int(math.log(value) * _LOG2_SUB)
    return i if i < _NBUCKETS else _NBUCKETS - 1


def _bucket_mid(i: int) -> float:
    """Geometric midpoint of bucket ``i`` (the quantile interpolant)."""
    return 2.0 ** ((i + 0.5) / _SUB)


def _bucket_lo(i: int) -> float:
    """Lower edge of bucket ``i`` — the reported value for mass in the
    OVERFLOW bucket, whose upper edge is unbounded (a midpoint of an
    open interval would be an invention, not an interpolation)."""
    return 2.0 ** (i / _SUB)


def _escape_label_value(value: str) -> str:
    """Prometheus exposition label-value escaping: backslash, double
    quote and newline are the three characters the text format reserves
    (escaped as ``\\\\``, ``\\"`` and ``\\n`` — in that order, backslash
    first, or the other escapes would double-escape)."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class Counter:
    """Monotonic counter."""

    def __init__(self, name: str, labels: Dict[str, str]) -> None:
        self.name = name
        self.labels = labels
        self._value = 0
        self._lock = make_lock("obs.metrics")

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Point-in-time value: either explicitly ``set()`` or backed by a
    callable evaluated at scrape time (the zero-hot-path-cost form).

    Teardown contract: a lazy provider belonging to a stopping element
    can be called by a concurrent scrape AFTER the element tore its
    state down.  A provider that raises (or returns something
    non-numeric) is a DEAD provider: :meth:`sample` answers ``None``
    and every renderer drops the sample — the scrape never 500s, never
    leaks an exception into the httpd thread, and never emits a bogus
    value for a metric that no longer exists."""

    def __init__(self, name: str, labels: Dict[str, str],
                 fn: Optional[Callable[[], float]] = None) -> None:
        self.name = name
        self.labels = labels
        self.fn = fn
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def sample(self) -> Optional[float]:
        """The scrape read: the provider's value, or ``None`` when the
        provider is dead (raised / non-numeric) — a dropped sample,
        not an error."""
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:   # noqa: BLE001 — dead provider (element
                return None     # stopped under the scrape): drop
        return self._value

    @property
    def value(self) -> float:
        """Back-compat numeric read; dead providers read as NaN (use
        :meth:`sample` to distinguish dead from NaN-valued)."""
        v = self.sample()
        return float("nan") if v is None else v


class Histogram:
    """Fixed log-bucket histogram with quantile estimation.

    ``observe`` is O(1): one log, one increment.  128 quarter-octave
    buckets cover 1 µs .. ~71 min when observations are microseconds
    (the unit every caller in this package uses).
    """

    __slots__ = ("name", "labels", "counts", "count", "total", "vmin",
                 "vmax", "_lock")

    def __init__(self, name: str, labels: Dict[str, str]) -> None:
        self.name = name
        self.labels = labels
        self.counts = [0] * _NBUCKETS
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = 0.0
        self._lock = make_lock("obs.metrics")

    def observe(self, value: float) -> None:
        i = _bucket_of(value)
        with self._lock:
            self.counts[i] += 1
            self.count += 1
            self.total += value
            if value < self.vmin:
                self.vmin = value
            if value > self.vmax:
                self.vmax = value

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (geometric bucket-midpoint
        interpolation); 0.0 when empty."""
        with self._lock:
            n = self.count
            if n == 0:
                return 0.0
            target = q * n
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= target:
                    mid = _bucket_mid(i)
                    # clamp to observed range: the edge buckets would
                    # otherwise report midpoints outside the data
                    return min(max(mid, self.vmin), self.vmax)
            return self.vmax

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            n = self.count
            if n == 0:
                return {"count": 0}
            mean = self.total / n
        return {"count": n, "mean": round(mean, 2),
                "min": round(self.vmin, 2), "max": round(self.vmax, 2),
                "p50": round(self.quantile(0.50), 2),
                "p95": round(self.quantile(0.95), 2),
                "p99": round(self.quantile(0.99), 2)}

    def state(self) -> Tuple[int, float, Tuple[int, ...]]:
        """Point-in-time ``(count, total, bucket counts)`` — the
        window-diff primitive: two states subtracted bucket-wise give a
        windowed distribution (``quantile_from_counts``) without
        resetting the live histogram."""
        with self._lock:
            return (self.count, self.total, tuple(self.counts))


def quantile_from_counts(counts, q: float) -> float:
    """``q``-quantile of a (possibly diff'd) bucket-count vector, using
    the same geometric-midpoint interpolation as
    :meth:`Histogram.quantile`.  This is how a WINDOWED p99 is computed
    from two :meth:`Histogram.state` snapshots without any
    per-observation timestamping.

    Documented edge behavior (pinned by property tests against numpy
    quantiles in tests/test_attrib.py):

    - **empty window** (all-zero vector, or empty vector): ``0.0`` —
      "no observations" reads as zero latency, never as an
      interpolated fiction;
    - **single-bucket mass**: every quantile answers that bucket's
      geometric midpoint (the only value the histogram can still
      distinguish — within the ~9 % bucket-resolution error);
    - **mass in the overflow bucket** (observations at/beyond the last
      bucket edge, ~71 min in µs): the overflow bucket's LOWER edge is
      returned, never a midpoint interpolated off the end of the range
      — the answer is a documented underestimate ("at least this"),
      not an invented point in an unbounded interval.
    """
    n = sum(counts)
    if n <= 0:
        return 0.0
    last = len(counts) - 1
    target = q * n
    seen = 0
    for i, c in enumerate(counts):
        seen += c
        if seen >= target:
            return _bucket_lo(i) if i == last else _bucket_mid(i)
    return _bucket_lo(last)


def count_over_threshold(counts, threshold: float) -> int:
    """Observations in a bucket-count vector whose bucket lies entirely
    at-or-above ``threshold``.  Bucket boundaries are log-spaced, so the
    answer is exact up to the bucket containing the threshold (that
    bucket is counted as over iff its geometric midpoint is over) —
    within the histogram's documented ~9 % quantile error.

    Documented edge behavior: ``threshold <= 1`` counts everything
    (bucket 0's lower edge is 1); an empty vector counts 0; a
    threshold at or beyond the overflow bucket's midpoint counts 0 —
    the histogram cannot distinguish values inside its open-ended last
    bucket, so it makes no claim rather than a wrong one."""
    if threshold <= 1.0:
        return sum(counts)
    lo = _bucket_of(threshold)
    if _bucket_mid(lo) < threshold:
        lo += 1
    return sum(counts[lo:])


class MetricsRegistry:
    """Process-wide metric table.

    Metrics are identified by (name, labels); re-registering returns
    the existing instance so call sites need no get-or-create dance.
    ``unregister_matching`` lets elements drop their gauges at stop.
    """

    def __init__(self) -> None:
        self._metrics: Dict[Tuple[str, Tuple[Tuple[str, str], ...]],
                            Any] = {}
        self._lock = make_lock("obs.metrics")

    def _key(self, name: str, labels: Dict[str, str]):
        return (name, tuple(sorted(labels.items())))

    def counter(self, name: str, **labels: str) -> Counter:
        return self._get_or_make(Counter, name, labels)

    def gauge(self, name: str, fn: Optional[Callable[[], float]] = None,
              **labels: str) -> Gauge:
        g = self._get_or_make(Gauge, name, labels, fn=fn)
        if fn is not None:
            g.fn = fn           # re-registration rebinds the provider
        return g

    def histogram(self, name: str, **labels: str) -> Histogram:
        return self._get_or_make(Histogram, name, labels)

    def _get_or_make(self, cls, name: str, labels: Dict[str, str],
                     **kw) -> Any:
        key = self._key(name, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None or m.__class__ is not cls:
                m = self._metrics[key] = cls(name, dict(labels), **kw)
            return m

    def register(self, metric: Any) -> Any:
        """Install (or REPLACE) a caller-constructed metric under its
        (name, labels) key.  Replacement is the point: a freshly
        attached tracer's per-element histograms must supersede a prior
        run's instances so the endpoint serves the live distributions,
        not an accumulation across runs."""
        key = self._key(metric.name, metric.labels)
        with self._lock:
            self._metrics[key] = metric
        return metric

    def unregister(self, metric: Any) -> bool:
        """Remove ``metric`` ONLY if it is still the registered instance
        for its key.  The identity check is what makes element teardown
        safe when names collide: if a later pipeline re-registered the
        same (name, labels) key, stopping the earlier element must not
        delete the live provider."""
        key = self._key(metric.name, metric.labels)
        with self._lock:
            if self._metrics.get(key) is metric:
                del self._metrics[key]
                return True
            return False

    def unregister_matching(self, name: str, **labels: str) -> int:
        """Drop every metric with this name whose labels are a superset
        of ``labels``; returns how many were removed."""
        want = set(labels.items())
        with self._lock:
            victims = [k for k, m in self._metrics.items()
                       if m.name == name and want <= set(k[1])]
            for k in victims:
                del self._metrics[k]
            return len(victims)

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def _snapshot(self) -> List[Any]:
        with self._lock:
            return list(self._metrics.values())

    # -- state snapshot / diff (the SLO evaluator's substrate) ---------------
    def snapshot_state(self, prefix: str = "") -> Dict[str, Any]:
        """Numeric state of every metric (optionally name-filtered by
        ``prefix``), keyed like :meth:`report`.  Counters/gauges carry
        their value, histograms their full ``(count, total, buckets)``
        state — so two snapshots taken at different times diff into
        exact windowed rates and windowed quantiles
        (:func:`state_delta`).  Taken under the registry lock only for
        the metric list; per-metric state reads take each metric's own
        lock, gauges evaluate their provider (scrape semantics)."""
        out: Dict[str, Any] = {}
        for m in self._snapshot():
            if prefix and not m.name.startswith(prefix):
                continue
            key = m.name + _label_str(m.labels)
            if isinstance(m, Histogram):
                count, total, counts = m.state()
                out[key] = {"kind": "histogram", "count": count,
                            "total": total, "counts": counts}
            elif isinstance(m, Counter):
                out[key] = {"kind": "counter", "value": m.value}
            else:
                v = m.sample() if isinstance(m, Gauge) else m.value
                if v is None:
                    continue   # dead provider: dropped sample
                out[key] = {"kind": "gauge", "value": v}
        return out

    # -- rendering -----------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        """JSON-friendly snapshot (embedded in ``launch.py --trace``
        reports next to the tracer's per-element table)."""
        out: Dict[str, Any] = {}
        for m in self._snapshot():
            key = m.name + _label_str(m.labels)
            if isinstance(m, Histogram):
                out[key] = m.snapshot()
            else:
                v = m.sample() if isinstance(m, Gauge) else m.value
                if v is None:
                    continue   # dead provider: dropped sample
                out[key] = round(v, 4) if isinstance(v, float) else v
        for name, value in _resilience_items():
            out.setdefault(name, value)
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format, v0.0.4."""
        lines: List[str] = []
        seen_families = set()

        def family(name: str, kind: str, help_: str) -> None:
            if name not in seen_families:
                seen_families.add(name)
                lines.append(f"# HELP {name} {help_}")
                lines.append(f"# TYPE {name} {kind}")

        for m in self._snapshot():
            if isinstance(m, Counter):
                family(m.name, "counter", "nnstreamer_tpu counter")
                lines.append(f"{m.name}{_label_str(m.labels)} {m.value}")
            elif isinstance(m, Gauge):
                v = m.sample()
                if v is None:
                    continue   # dead provider (element stopped under
                    #            the scrape): dropped sample, not a 500
                family(m.name, "gauge", "nnstreamer_tpu gauge")
                val = "NaN" if v != v else repr(round(v, 6))
                lines.append(f"{m.name}{_label_str(m.labels)} {val}")
            elif isinstance(m, Histogram):
                family(m.name, "summary", "nnstreamer_tpu latency summary")
                base = dict(m.labels)
                for q in (0.5, 0.95, 0.99):
                    lbl = _label_str({**base, "quantile": str(q)})
                    lines.append(f"{m.name}{lbl} "
                                 f"{round(m.quantile(q), 3)}")
                ls = _label_str(base)
                lines.append(f"{m.name}_sum{ls} {round(m.total, 3)}")
                lines.append(f"{m.name}_count{ls} {m.count}")
        for name, value in _resilience_items():
            family(name, "counter", "query resilience counter")
            lines.append(f"{name} {value}")
        return "\n".join(lines) + "\n"


def state_delta(new: Dict[str, Any], old: Dict[str, Any]
                ) -> Dict[str, Any]:
    """Window diff of two :meth:`MetricsRegistry.snapshot_state` maps:
    counters/histograms subtract (monotonic — a metric absent from
    ``old`` counts from zero, covering mid-window registration),
    gauges keep the NEW point-in-time value.  Histogram deltas carry
    the diff'd bucket vector, ready for :func:`quantile_from_counts` /
    :func:`count_over_threshold` — windowed rates and quantiles with no
    per-observation timestamping.

    Counter-reset hardening: a monotonic count going BACKWARDS between
    the two snapshots is a restart (a federated worker process died and
    came back under the same origin, or a same-key metric was
    re-registered) — the naive subtraction would yield a negative
    windowed rate that poisons burn rates and sustained-signal
    detection.  The delta clamps to zero AND carries ``reset: True`` so
    consumers that must not act on a restart artifact (the
    ``SustainedSignal`` detector, obs/timeseries.py) can skip the
    sample entirely instead of reading "zero traffic" as recovery."""
    out: Dict[str, Any] = {}
    for key, cur in new.items():
        kind = cur.get("kind")
        prev = old.get(key)
        if prev is not None and prev.get("kind") != kind:
            prev = None         # re-registered as a different type
        if kind == "counter":
            base = prev["value"] if prev else 0
            row = {"kind": "counter",
                   "value": max(0, cur["value"] - base)}
            if cur["value"] < base:
                row["reset"] = True
            out[key] = row
        elif kind == "histogram":
            reset = False
            if prev:
                # per-bucket clamp: a same-key histogram re-registered
                # mid-window (register() REPLACES — tracer re-attach)
                # resets counts below the base; a negative bucket would
                # poison windowed quantiles and burn rates
                counts = tuple(max(0, c - p) for c, p in
                               zip(cur["counts"], prev["counts"]))
                count = cur["count"] - prev["count"]
                total = cur["total"] - prev["total"]
                reset = cur["count"] < prev["count"]
            else:
                counts, count, total = (cur["counts"], cur["count"],
                                        cur["total"])
            row = {"kind": "histogram", "count": max(0, count),
                   "total": max(0.0, total), "counts": counts}
            if reset:
                row["reset"] = True
            out[key] = row
        else:
            out[key] = dict(cur)
    return out


def _resilience_items() -> List[Tuple[str, int]]:
    """The query resilience counters (process-wide STATS), bridged into
    the exposition under ``nns_resilience_*`` — the registry does not
    duplicate their accounting, it renders their live snapshot."""
    from ..query.resilience import STATS

    out = []
    for key, value in sorted(STATS.snapshot().items()):
        name = "nns_resilience_" + key.replace(".", "_").replace("-", "_")
        out.append((name, value))
    return out


#: process-wide registry (the endpoint serves this; elements register
#: their gauges here)
REGISTRY = MetricsRegistry()
