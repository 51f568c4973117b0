"""Pipeline tracing: per-element proctime / framerate / queue levels,
per-buffer timeline spans, latency distributions, interlatency.

The reference's profiling story is external GStreamer tracers — GstShark's
``proctime`` (time inside each element's chain), ``framerate`` (buffers/s
per pad) and ``interlatency`` hooks (tools/tracing/README.md:33-43,
tools/profiling/README.md:5-17).  Here tracing is built into the pipeline
substrate: attach a :class:`Tracer` and every ``chain()`` is timed with
one clock read on each side — nanosecond counters, no sampling, zero cost
when no tracer is attached (a single ``is None`` test per buffer).

Usage::

    p = parse_launch("videotestsrc num-buffers=64 ! … ! tensor_sink")
    tracer = p.enable_tracing()            # counters + histograms
    tracer = p.enable_tracing(spans=True)  # + per-buffer timeline spans
    p.run(timeout=60)
    print(json.dumps(tracer.report(), indent=2))
    tracer.export_chrome("timeline.json")  # Perfetto / chrome://tracing

``python -m nnstreamer_tpu_torch.launch --trace`` prints the same report
after the pipeline ends; ``--trace-out FILE`` writes it as JSON.

The port of ``nnstreamer_tpu/pipeline/tracing.py`` (the interpret tier:
``Element._chain_entry`` calls :meth:`Tracer.enter` / :meth:`Tracer.exit`
around every ``chain()``).

Report fields per element: ``buffers``, ``proctime_ms`` (total time inside
chain), ``proctime_avg_us``, ``fps`` (buffers/sec over the element's
active window), ``proctime_us`` p50/p95/p99 (obs/metrics.py log-bucket
histograms) and — when the pipeline's sources stamped buffers —
``interlatency_us``: the GstShark interlatency role, source→element
transit measured per buffer at each element's exit, so the sink row reads
as end-to-end pipeline latency.

**Spans** (opt-in per tracer): each traced ``chain()`` additionally
appends ``(element, thread, start ns, duration ns, buffer seq, trace
id)`` to a bounded ring (obs/span.py), exported as Chrome ``trace_event``
JSON.  Remote spans harvested over the query wire (T_TRACE piggyback,
query/client.py) merge into the same export under extra pids, re-based
via the clock-offset estimate — one timeline for a client→server→client
round trip.

Dataflow-copy observability (the zero-copy hot path's regression gate):
serialize/convert code reports every payload byte it MATERIALIZES into a
new host buffer via :func:`record_copy`, and pool acquires report
hits/misses via :func:`record_pool`.  Both attribute to the element whose
``chain()`` is on the current thread's trace stack, surfacing as
``bytes_copied`` / ``pool_hits`` / ``pool_misses`` in the report — so a
re-introduced full-frame copy shows up per element instead of hiding in
wall time.  With no tracer attached both calls are a single dict lookup.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Tuple


class _ElementStats:
    __slots__ = ("buffers", "frames", "proc_ns", "first_ts", "last_ts",
                 "bytes_copied", "pool_hits", "pool_misses",
                 "inter_ns", "inter_n")

    def __init__(self) -> None:
        self.buffers = 0
        #: frame-weighted count: a cross-stream batch buffer of N
        #: frames (query/server.py bucket) counts N here and 1 in
        #: ``buffers`` — per-frame rates must not undercount buckets
        self.frames = 0
        self.proc_ns = 0
        self.first_ts: Optional[float] = None
        self.last_ts: Optional[float] = None
        self.bytes_copied = 0
        self.pool_hits = 0
        self.pool_misses = 0
        self.inter_ns = 0
        self.inter_n = 0


#: process-wide per-thread trace frame stack.  Each entry is one live
#: ``chain()``: [tracer, start_ns, child_ns, bytes_copied, pool_hits,
#: pool_misses, buf, element_name].  Module-level (not per-Tracer) so
#: record_copy / record_pool reach the active frame
#: without any registry lookups.
_TLS = threading.local()


def _stack():
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def record_copy(nbytes: int) -> None:
    """Report ``nbytes`` of payload materialized into a fresh host buffer
    (``tobytes``/``ascontiguousarray``/adapter compaction...).  Attributes
    to the element currently in ``chain()`` on this thread; no-op (one
    getattr) when no tracer is active."""
    stack = getattr(_TLS, "stack", None)
    if stack:
        stack[-1][3] += nbytes


def record_pool(hit: bool) -> None:
    """Report one pool acquire (hit = served from the free list)."""
    stack = getattr(_TLS, "stack", None)
    if stack:
        stack[-1][4 if hit else 5] += 1


def annotation_active() -> bool:
    """True when a span-recording tracer owns this thread's innermost
    live ``chain()`` — the pre-gate for state annotations, so untraced
    hot paths never pay the clock reads an :func:`annotate` call would
    need (one getattr + one truthiness test when off)."""
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return False
    tracer = stack[-1][0]
    return tracer is not None and tracer.ring is not None


def annotate(state: str, start_ns: int, end_ns: int) -> None:
    """Record a wait-state annotation span (``state:<state>``,
    obs/attrib.py closed set) against the buffer currently in
    ``chain()`` on this thread.  Callers pre-gate with
    :func:`annotation_active` so the two clock reads bracketing the
    annotated region cost nothing when tracing is off.  Used by the
    wire framing path (``serialize``) and the host materialization of a
    device tensor (``device-invoke``)."""
    stack = getattr(_TLS, "stack", None)
    if not stack:
        return
    frame = stack[-1]
    tracer = frame[0]
    if tracer is None or tracer.ring is None:
        return
    seq = -1
    trace_id = tracer.trace_id
    buf = frame[6]
    if buf is not None:
        extra = buf.extra
        seq = extra.get("nns_seq", -1)
        ctx = extra.get("nns_trace")
        if ctx is not None and ctx.trace_id:
            trace_id = ctx.trace_id
    from ..obs.span import Span

    tracer.ring.append(Span("state:" + state, threading.get_ident(),
                            start_ns, max(0, end_ns - start_ns), seq,
                            trace_id))


class copy_probe:
    """Standalone copy/pool counter for code that isn't a pipeline
    element (microbenches, unit tests)::

        with copy_probe() as probe:
            send_tensors(...)
        assert probe.bytes_copied <= header_bytes

    Pushes a synthetic frame on this thread's trace stack, so
    record_copy / record_pool attribute to it.
    """

    def __init__(self) -> None:
        self.bytes_copied = 0
        self.pool_hits = 0
        self.pool_misses = 0

    def __enter__(self) -> "copy_probe":
        _stack().append([None, 0, 0, 0, 0, 0, None, None])
        return self

    def __exit__(self, *exc) -> None:
        frame = _stack().pop()
        self.bytes_copied += frame[3]
        self.pool_hits += frame[4]
        self.pool_misses += frame[5]


class Tracer:
    """Collects per-element dataflow statistics (thread-safe: elements
    chain from multiple streaming threads).

    Dataflow is synchronous within a streaming thread — an element's
    ``chain()`` pushes downstream before returning — so SELF time is
    wall time minus the nested downstream chains' time.  A per-thread
    frame stack does that subtraction, matching GstShark's proctime
    semantics (time inside ONE element).

    ``spans=True`` additionally records every traced chain as a
    timeline span into a bounded ring (obs/span.py) for Chrome-trace
    export; off by default — span recording is per-buffer work the
    counters-only mode does not pay."""

    def __init__(self, spans: bool = False,
                 ring_capacity: int = 65536) -> None:
        from ..analysis.sanitizer import make_lock
        from ..obs.clock import mono_ns, wall_us
        from ..obs.span import SpanRing, new_trace_id

        self._stats: Dict[str, _ElementStats] = {}
        self._lock = make_lock("tracer")
        #: one process-local trace id; buffers without a propagated wire
        #: context record under it, so a single-process run still groups
        self.trace_id = new_trace_id()
        self.spans = bool(spans)
        self.ring = SpanRing(ring_capacity) if self.spans else None
        #: local mono↔wall anchor pair: lets this process's mono-ns spans
        #: be published on (and merged from) the shared wall clock
        self.anchor_mono_ns = mono_ns()
        self.anchor_wall_us = wall_us()
        #: remote spans merged in via add_remote_spans:
        #: process label -> list of re-based Span
        self._remote: Dict[str, List[Any]] = {}
        #: per-element (proctime, interlatency) histograms; registered
        #: into the global metrics registry so the live endpoint serves
        #: the same distributions the report prints
        self._hists: Dict[str, Tuple[Any, Any]] = {}
        # resilience counters (query/resilience.py STATS) are process-wide
        # and monotonic; snapshot at attach so the report shows only THIS
        # run's retries/failures/breaker transitions.  Lazy import: the
        # query package is a consumer of the pipeline package.
        from ..query.resilience import STATS

        self._resilience = STATS
        self._resilience_base = STATS.snapshot()

    # called from Element._chain_entry — keep it lean
    def enter(self, name: Optional[str] = None, buf=None) -> None:
        _stack().append([self, time.monotonic_ns(), 0, 0, 0, 0, buf,
                         name])

    def exit(self, element_name: Optional[str] = None) -> None:
        stack = _TLS.stack
        frame = stack.pop()
        end = time.monotonic_ns()
        total = end - frame[1]
        if stack:                    # attribute our total to the parent
            stack[-1][2] += total
        name = element_name if element_name is not None else frame[7]
        buf = frame[6]
        inter_ns = -1
        seq = -1
        weight = 1
        trace_id = self.trace_id
        if buf is not None:
            extra = buf.extra
            src_ns = extra.get("nns_src_ns")
            if src_ns is not None:
                inter_ns = end - src_ns
            seq = extra.get("nns_seq", -1)
            ctx = extra.get("nns_trace")
            if ctx is not None and ctx.trace_id:
                trace_id = ctx.trace_id
            xbm = extra.get("nns_xbatch")
            if xbm is not None:
                # a cross-stream bucket is ONE dispatch serving N
                # client frames: count them, or per-frame rates read
                # a batching server as 1/N of its real throughput
                weight = len(xbm.extras) or 1
        if self.ring is not None:
            from ..obs.span import Span

            self.ring.append(Span(name, threading.get_ident(),
                                  frame[1], total, seq, trace_id))
        self._record(name, total - frame[2], frame[3], frame[4],
                     frame[5], inter_ns, weight)

    def annotate_span(self, state: str, start_ns: int, end_ns: int,
                      seq: int = -1, trace_id: int = 0) -> None:
        """Ring-append a ``state:*`` annotation from a thread with no
        live trace frame (queue drain, worker pusher, serversrc create).
        No-op without span recording; callers gate on
        ``tracer.ring is not None`` before reading any clock."""
        if self.ring is None:
            return
        from ..obs.span import Span

        self.ring.append(Span("state:" + state, threading.get_ident(),
                              start_ns, max(0, end_ns - start_ns), seq,
                              trace_id or self.trace_id))

    def _element_hists(self, name: str):
        hists = self._hists.get(name)
        if hists is None:
            from ..obs.metrics import REGISTRY, Histogram

            with self._lock:          # two streaming threads, first buffer
                hists = self._hists.get(name)
                if hists is None:
                    proc = Histogram("nns_element_proctime_us",
                                     {"element": name})
                    inter = Histogram("nns_element_interlatency_us",
                                      {"element": name})
                    hists = self._hists[name] = (proc, inter)
            REGISTRY.register(hists[0])
            REGISTRY.register(hists[1])
        return hists

    def _record(self, element_name: str, proc_ns: int, copied: int,
                hits: int, misses: int, inter_ns: int = -1,
                frames: int = 1) -> None:
        now = time.monotonic()
        with self._lock:
            st = self._stats.get(element_name)
            if st is None:
                st = self._stats[element_name] = _ElementStats()
                st.first_ts = now
            st.buffers += 1
            st.frames += frames
            st.proc_ns += proc_ns
            st.last_ts = now
            st.bytes_copied += copied
            st.pool_hits += hits
            st.pool_misses += misses
            if inter_ns >= 0:
                st.inter_ns += inter_ns
                st.inter_n += 1
        proc_h, inter_h = self._element_hists(element_name)
        proc_h.observe(proc_ns / 1e3)
        if inter_ns >= 0:
            inter_h.observe(inter_ns / 1e3)

    def report(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            items = [(name, st, self._hists.get(name))
                     for name, st in self._stats.items()]
        out: Dict[str, Dict[str, float]] = {}
        for name, st, hists in items:
            window = ((st.last_ts - st.first_ts)
                      if st.buffers > 1 else 0.0)
            row = out[name] = {
                "buffers": st.buffers,
                "proctime_ms": round(st.proc_ns / 1e6, 3),
                "proctime_avg_us": round(
                    st.proc_ns / 1e3 / max(st.buffers, 1), 2),
                "fps": round((st.buffers - 1) / window, 2)
                if window > 0 else 0.0,
                "window_s": round(window, 4),
                "bytes_copied": st.bytes_copied,
            }
            if st.frames != st.buffers:
                # cross-stream buckets: per-frame truth next to the
                # per-dispatch count (fps above stays per-dispatch)
                row["frames"] = st.frames
                if window > 0:
                    row["frames_per_s"] = round(st.frames / window, 2)
            if st.pool_hits or st.pool_misses:
                row["pool_hits"] = st.pool_hits
                row["pool_misses"] = st.pool_misses
            if hists is not None:
                proc_h, inter_h = hists
                snap = proc_h.snapshot()
                for q in ("p50", "p95", "p99"):
                    if q in snap:
                        row[f"proctime_{q}_us"] = snap[q]
            if st.inter_n:
                row["interlatency_avg_us"] = round(
                    st.inter_ns / 1e3 / st.inter_n, 2)
                if hists is not None:
                    snap = hists[1].snapshot()
                    for q in ("p50", "p95", "p99"):
                        if q in snap:
                            row[f"interlatency_{q}_us"] = snap[q]
        return out

    def resilience_report(self) -> Dict[str, int]:
        """Retry / failure / breaker-transition / heartbeat counters
        accumulated since this tracer attached (delta over the
        process-wide :data:`~nnstreamer_tpu_torch.query.resilience.STATS`) —
        the dataflow-health half of the report, next to proctime.
        Empty when the run touched no remote endpoint."""
        return self._resilience.delta(self._resilience_base)

    # -- timeline export / merge ---------------------------------------------
    def publish_spans(self, since: int = 0,
                      trace_id: Optional[int] = None
                      ) -> Tuple[Dict[str, Any], int]:
        """Span batch for wire piggyback (T_TRACE): spans appended at
        ring index >= ``since`` (optionally filtered to one trace id),
        plus this process's mono↔wall anchor so the receiver can re-base
        them.  Returns ``(payload_dict, next_cursor)``."""
        if self.ring is None:
            return ({"anchor_mono_ns": self.anchor_mono_ns,
                     "anchor_wall_us": self.anchor_wall_us,
                     "spans": []}, since)
        spans, cursor = self.ring.snapshot_since(since)
        if trace_id is not None:
            spans = [s for s in spans if s.trace_id == trace_id]
        return ({"anchor_mono_ns": self.anchor_mono_ns,
                 "anchor_wall_us": self.anchor_wall_us,
                 "spans": [list(s) for s in spans]}, cursor)

    def add_remote_spans(self, payload: Dict[str, Any],
                         offset_us: int = 0,
                         process: str = "remote") -> int:
        """Merge a peer's ``publish_spans`` payload into this timeline.

        ``offset_us`` is the peer-minus-local wall-clock offset
        (obs/clock.py OffsetEstimator).  Each remote span's mono start is
        re-based: peer mono → peer wall (via the peer anchor) → local
        wall (offset) → local mono (via our anchor), so the merged
        Chrome export shows both processes on one consistent axis."""
        from ..obs.span import Span

        r_mono = int(payload.get("anchor_mono_ns", 0))
        r_wall = int(payload.get("anchor_wall_us", 0))
        merged = self._remote.setdefault(process, [])
        n = 0
        for raw in payload.get("spans", ()):
            name, tid, start_ns, dur_ns, seq, trace_id = raw
            peer_wall_us = r_wall + (int(start_ns) - r_mono) // 1000
            local_wall_us = peer_wall_us - offset_us
            local_mono_ns = (self.anchor_mono_ns
                             + (local_wall_us - self.anchor_wall_us)
                             * 1000)
            merged.append(Span(str(name), int(tid), local_mono_ns,
                               int(dur_ns), int(seq), int(trace_id)))
            n += 1
        return n

    def chrome_trace(self, process_name: str = "pipeline"
                     ) -> Dict[str, Any]:
        """Chrome ``trace_event`` document: local spans as pid 1, each
        merged remote process as its own pid."""
        from ..obs.span import chrome_trace_events

        events: List[Dict[str, Any]] = []
        local = self.ring.snapshot() if self.ring is not None else []
        events.extend(chrome_trace_events(local, pid=1,
                                          process_name=process_name))
        for i, (proc, spans) in enumerate(sorted(self._remote.items())):
            events.extend(chrome_trace_events(spans, pid=2 + i,
                                              process_name=proc))
        # per-process groups are each sorted; re-sort the MERGED stream
        # so a multi-process export is globally time-monotonic too
        events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
        meta: Dict[str, Any] = {"trace_id": f"{self.trace_id:x}"}
        if self.ring is not None and self.ring.dropped:
            meta["dropped_spans"] = self.ring.dropped
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "metadata": meta}

    def export_chrome(self, path: str,
                      process_name: str = "pipeline") -> None:
        import json

        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.chrome_trace(process_name), fh)
