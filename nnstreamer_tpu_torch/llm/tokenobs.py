"""Token-level serving observability: per-session lifecycle records,
TTFT/ITL histograms, and decode-plane head-of-line blame.

The PyTorch counterpart of ``nnstreamer_tpu/llm/tokenobs.py``, pure host
code with the JAX package's metric families.  Spans and phase
attribution see FRAMES, but a token stream's health lives between
frames — "time to first token for gold clients", "which prefill chunk
stalled whose tokens".  Three surfaces, all on the metrics registry:

- **Latency histograms** — ``nns_llm_ttft_us{class=}`` (admit → first
  emitted token, chunk interleave INCLUDED: TTFT is what the client
  waited, not what the prefill executable cost) and
  ``nns_llm_itl_us{class=}`` (inter-token gap between consecutive
  emitted tokens).  Shed / rejected / evicted streams never observe —
  a fast refusal must not flatter p50 and a reaped zombie must not
  poison p99; they land in the terminal-cause counters instead.
- **Terminal-cause counters** —
  ``nns_llm_session_terminal_total{cause=}`` with the closed cause set
  :data:`TERMINAL_CAUSES`: every stream ends exactly once, with a name.
- **Head-of-line blame** — each inter-token gap is attributed by
  diffing the engine's :class:`~nnstreamer_tpu_torch.llm.engine.
  PhaseClock` integer totals at consecutive tokens and folding phases
  through :data:`PHASE_BLAME` (decode-compute | prefill-chunk-steal |
  compile | admission | egress | idle).  Because the snapshots
  partition the decode thread's wall time EXACTLY, a session's
  accumulated blame sums to its admit→terminal window by identity.

Completed records land in a bounded ring exported as per-session
timeline lanes (:meth:`TokenObs.chrome_events`, on the tracer's mono-ns
timebase).  The element only constructs a :class:`TokenObs` when its
``token-obs`` property is on; every hot-path hook site gates on one
attribute test.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

from ..analysis.sanitizer import make_lock
from ..obs.metrics import REGISTRY, MetricsRegistry

#: token-latency histogram families (class-labeled by QoS)
TTFT_US = "nns_llm_ttft_us"
ITL_US = "nns_llm_itl_us"
#: every stream ends exactly once, with a cause
TERMINAL_TOTAL = "nns_llm_session_terminal_total"
#: aggregate blame, monotone ns per cause — federates like any counter
BLAME_NS_TOTAL = "nns_llm_blame_ns_total"
#: paged-cache churn counter the element mirrors from pool stats
PAGES_RECLAIMED_TOTAL = "nns_llm_pages_reclaimed_total"

#: the closed terminal-cause set: stop-token, granted length exhausted,
#: deadline eviction, client vanished, admission shed, deterministic
#: refusal (malformed / over-length).  ``shed``/``reject`` streams were
#: never admitted — counted here, NEVER observed in the histograms.
TERMINAL_CAUSES = ("stop", "max_new", "evict", "disconnect", "shed",
                   "reject")

#: head-of-line blame causes, and the PhaseClock phase → cause fold.
#: ``prefill`` and ``llm-prefill-chunk`` both fold to
#: ``prefill-chunk-steal``: from a WAITING session's point of view any
#: prefill occupying the single decode thread is stolen time (its own
#: pre-first-token prefill included — TTFT's cost, named).
BLAME_CAUSES = ("decode-compute", "prefill-chunk-steal", "compile",
                "admission", "egress", "idle")
PHASE_BLAME = {
    "decode": "decode-compute",
    "prefill": "prefill-chunk-steal",
    "llm-prefill-chunk": "prefill-chunk-steal",
    "compile": "compile",
    "admit": "admission",
    "egress": "egress",
    "idle": "idle",
}


class SessionRecord:
    """One session's lifecycle: admit → (chunks) → first token →
    steady decode → terminal, with integer blame accumulation."""

    __slots__ = ("key", "qos", "trace_id", "admit_ns", "first_ns",
                 "end_ns", "last_tok_ns", "tokens", "chunks", "cause",
                 "mark", "blame_ns", "itl_count", "itl_sum_us",
                 "itl_max_us")

    def __init__(self, key, qos: str, trace_id: int = 0) -> None:
        self.key = key
        self.qos = qos
        self.trace_id = trace_id
        self.admit_ns = 0
        self.first_ns = 0
        self.end_ns = 0
        self.last_tok_ns = 0
        self.tokens = 0
        self.chunks = 0
        self.cause = ""
        self.mark: Optional[Dict[str, int]] = None
        self.blame_ns: Dict[str, int] = {}
        self.itl_count = 0
        self.itl_sum_us = 0.0
        self.itl_max_us = 0.0

    def _absorb(self, totals: Dict[str, int]) -> None:
        """Fold the phase-total delta since the last mark into the
        blame accumulator.  Two marks partition the thread's wall time
        exactly, so over the record's life ``sum(blame_ns)`` equals the
        admit→terminal totals delta by integer identity."""
        mark = self.mark
        blame = self.blame_ns
        for phase, total in totals.items():
            d = total - (mark.get(phase, 0) if mark else 0)
            if d:
                cause = PHASE_BLAME.get(phase, phase)
                blame[cause] = blame.get(cause, 0) + d
        self.mark = totals

    def to_dict(self) -> Dict[str, Any]:
        wall_ns = max(0, self.end_ns - self.admit_ns)
        blame_sum = sum(self.blame_ns.values())
        out = {
            "key": str(self.key),
            "class": self.qos,
            "cause": self.cause,
            "tokens": self.tokens,
            "chunks": self.chunks,
            "admit_ns": self.admit_ns,
            "first_ns": self.first_ns,
            "end_ns": self.end_ns,
            "wall_ms": round(wall_ns / 1e6, 3),
            "blame_ns": dict(self.blame_ns),
            # conservation evidence: accumulated blame vs the session's
            # own admit→terminal window.  The snapshots are an exact
            # partition; the only slack is the independent clock reads
            # that stamp admit/end (sub-microsecond)
            "blame_conserved_pct": round(
                100.0 * blame_sum / wall_ns, 3) if wall_ns else 100.0,
        }
        if self.first_ns:
            out["ttft_us"] = round((self.first_ns - self.admit_ns)
                                   / 1e3, 1)
        if self.itl_count:
            out["itl_mean_us"] = round(self.itl_sum_us
                                       / self.itl_count, 1)
            out["itl_max_us"] = round(self.itl_max_us, 1)
        if self.trace_id:
            out["trace_id"] = f"{self.trace_id:x}"
        return out


class TokenObs:
    """The element's token-level recorder: one per ``tensor_llm``
    element, mutated only on the decode thread (the single-pusher
    contract); the bounded completed-record ring is the only
    cross-thread surface, under its own leaf lock."""

    def __init__(self, phases, clock_ns=None,
                 registry: MetricsRegistry = REGISTRY,
                 labels: Optional[Dict[str, str]] = None,
                 capacity: int = 256) -> None:
        from ..obs.clock import mono_ns

        self._phases = phases
        self._clock_ns = clock_ns if clock_ns is not None else mono_ns
        self._registry = registry
        self._labels = dict(labels or {})
        self._lock = make_lock("leaf")
        self._ring: "deque[SessionRecord]" = deque(maxlen=max(
            1, int(capacity)))
        self._hists: Dict[Any, Any] = {}
        self._ctrs: Dict[Any, Any] = {}
        #: published-so-far marks for the monotone blame counters
        self._blame_pub: Dict[str, int] = {}

    # -- metric plumbing -------------------------------------------------
    def _hist(self, family: str, qos: str):
        h = self._hists.get((family, qos))
        if h is None:
            h = self._registry.histogram(family, **{**self._labels,
                                                    "class": qos})
            self._hists[(family, qos)] = h
        return h

    def _ctr(self, family: str, **extra: str):
        key = (family, tuple(sorted(extra.items())))
        c = self._ctrs.get(key)
        if c is None:
            c = self._registry.counter(family, **{**self._labels,
                                                  **extra})
            self._ctrs[key] = c
        return c

    # -- lifecycle hooks (decode thread only) ----------------------------
    def on_admit(self, sess) -> None:
        ctx = sess.extra.get("nns_trace") if sess.extra else None
        rec = SessionRecord(sess.key, sess.qos or "silver",
                            trace_id=getattr(ctx, "trace_id", 0) or 0)
        rec.admit_ns = self._clock_ns()
        rec.mark = self._phases.totals_ns()
        sess.obs = rec

    def on_chunk(self, sess) -> None:
        rec = sess.obs
        if rec is not None:
            rec.chunks += 1

    def on_token(self, sess) -> None:
        """One emitted token: blame the gap, observe TTFT on the
        first, ITL on every later one.  Called AFTER the token frame's
        push, so first-token latency includes its egress — TTFT is what
        the wire saw, not what the executable cost."""
        rec = sess.obs
        if rec is None:
            return
        now = self._clock_ns()
        rec._absorb(self._phases.totals_ns())
        rec.tokens += 1
        if rec.first_ns == 0:
            rec.first_ns = now
            self._hist(TTFT_US, rec.qos).observe(
                max(0.0, (now - rec.admit_ns) / 1e3))
        else:
            itl = max(0.0, (now - rec.last_tok_ns) / 1e3)
            rec.itl_count += 1
            rec.itl_sum_us += itl
            if itl > rec.itl_max_us:
                rec.itl_max_us = itl
            self._hist(ITL_US, rec.qos).observe(itl)
        rec.last_tok_ns = now

    def on_terminal(self, sess, cause: str) -> None:
        """Close the stream's record under ``cause`` and count it.
        Only counting happens for latency purposes: an evicted /
        disconnected stream's terminal marker frame is NOT a token and
        must not observe ITL."""
        self._ctr(TERMINAL_TOTAL, cause=cause,
                  **{"class": sess.qos or "silver"}).inc()
        rec = sess.obs
        if rec is None:
            return
        sess.obs = None
        rec.end_ns = self._clock_ns()
        rec._absorb(self._phases.totals_ns())
        rec.mark = None
        rec.cause = cause
        with self._lock:
            self._ring.append(rec)

    def on_refused(self, qos: str, cause: str) -> None:
        """A stream that never got a slot (``shed``) or could never
        succeed (``reject``): terminal-cause accounting only — by
        construction these cannot reach the latency histograms."""
        self._ctr(TERMINAL_TOTAL, cause=cause,
                  **{"class": qos or "silver"}).inc()

    # -- aggregates ------------------------------------------------------
    def sync_blame_counters(self) -> None:
        """Mirror the PhaseClock's per-cause totals into the monotone
        ``nns_llm_blame_ns_total{cause=}`` counters (the federable
        aggregate: per-phase totals only grow, so the deltas are
        always >= 0).  The deltas are claimed under the leaf lock: the
        decode thread syncs periodically and a snapshotting reader may
        force one — an unlocked race would double-publish a delta.  They
        are published after it (the registry's lock ranks below leaf)."""
        causes: Dict[str, int] = {}
        for phase, ns in self._phases.totals_ns().items():
            cause = PHASE_BLAME.get(phase, phase)
            causes[cause] = causes.get(cause, 0) + ns
        deltas = []
        with self._lock:
            for cause, ns in causes.items():
                prev = self._blame_pub.get(cause, 0)
                if ns > prev:
                    deltas.append((cause, ns - prev))
                    self._blame_pub[cause] = ns
        for cause, delta in deltas:
            self._ctr(BLAME_NS_TOTAL, cause=cause).inc(delta)

    def blame_report(self) -> Dict[str, Any]:
        """Decode-thread wall-time blame shares.  These fold the
        PhaseClock partition, so the shares sum to 100 % of thread wall
        time by the same identity the phase report carries."""
        causes: Dict[str, int] = {}
        for phase, ns in self._phases.totals_ns().items():
            cause = PHASE_BLAME.get(phase, phase)
            causes[cause] = causes.get(cause, 0) + ns
        total = max(1, sum(causes.values()))
        return {"causes_ns": causes,
                "shares_pct": {c: round(100.0 * v / total, 3)
                               for c, v in sorted(causes.items())},
                "conserved_pct": 100.0}

    def records(self) -> List[Dict[str, Any]]:
        """Completed per-session records, oldest first (bounded ring —
        the session-timeline feed)."""
        with self._lock:
            recs = list(self._ring)
        return [r.to_dict() for r in recs]

    # -- timeline export -------------------------------------------------
    def chrome_events(self, pid: int = 9, offset_ns: int = 0
                      ) -> List[Dict[str, Any]]:
        """Chrome ``trace_event`` session lanes: one tid per completed
        session, a ``ttft`` span admit→first-token and a ``decode``
        span first→terminal carrying cause/tokens/blame.  Timestamps
        are the tracer's mono-ns base / 1000, so these merge into the
        client/server export with the SAME ``offset_ns`` re-basing the
        span ring uses."""
        with self._lock:
            recs = list(self._ring)
        events: List[Dict[str, Any]] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "llm-sessions"},
        }]
        for tid, rec in enumerate(recs, start=1):
            events.append({"name": "thread_name", "ph": "M",
                           "pid": pid, "tid": tid,
                           "args": {"name": f"session {rec.key}"}})
            first = rec.first_ns or rec.end_ns
            if first > rec.admit_ns:
                events.append({
                    "name": "ttft", "cat": "llm-session", "ph": "X",
                    "pid": pid, "tid": tid,
                    "ts": (rec.admit_ns + offset_ns) / 1000.0,
                    "dur": (first - rec.admit_ns) / 1000.0,
                    "args": {"class": rec.qos, "chunks": rec.chunks},
                })
            if rec.first_ns and rec.end_ns > rec.first_ns:
                events.append({
                    "name": "decode", "cat": "llm-session", "ph": "X",
                    "pid": pid, "tid": tid,
                    "ts": (rec.first_ns + offset_ns) / 1000.0,
                    "dur": (rec.end_ns - rec.first_ns) / 1000.0,
                    "args": {"class": rec.qos, "cause": rec.cause,
                             "tokens": rec.tokens,
                             "blame_ns": dict(rec.blame_ns)},
                })
        events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
        return events


def default_llm_signals(pages: int = 0,
                        ttft_p99_us: float = 2_000_000.0,
                        reclaim_rate: float = 50.0,
                        min_hold_s: float = 5.0) -> List[Any]:
    """The LLM tier's default :class:`~nnstreamer_tpu_torch.obs.timeseries.
    SustainedSignal` sources: free-page exhaustion (an *idle-style*
    below-threshold condition on the gauge), paged-reclaim churn (rate
    over the mirror counter — sustained churn means the arena is
    thrashing its prefix cache), and sustained TTFT p99 over budget.
    ``pages=0`` (dense pool) drops the paged signals."""
    from ..obs.timeseries import SustainedSignal

    out: List[Any] = [
        SustainedSignal("llm-ttft-p99-high", TTFT_US,
                        threshold=ttft_p99_us, min_hold_s=min_hold_s,
                        kind="p99"),
    ]
    if pages > 0:
        out.append(SustainedSignal(
            "llm-free-pages-low", "nns_llm_free_pages",
            threshold=max(1.0, pages / 10.0), min_hold_s=min_hold_s,
            direction="below", kind="gauge",
            disarm_above=max(2.0, pages / 4.0)))
        out.append(SustainedSignal(
            "llm-reclaim-churn", PAGES_RECLAIMED_TOTAL,
            threshold=reclaim_rate, min_hold_s=min_hold_s,
            kind="rate"))
    return out
