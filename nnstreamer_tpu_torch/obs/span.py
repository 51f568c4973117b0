"""Per-buffer timeline spans, wire trace-context, Chrome trace export.

A **span** is one element's processing of one buffer: ``(element,
thread id, start mono-ns, duration ns, buffer seq, trace id)``.  Spans
land in a bounded :class:`SpanRing` (overwrite-oldest, so a long run
keeps the tail instead of OOMing) and export as Chrome ``trace_event``
JSON — ``chrome://tracing`` / Perfetto render streaming threads, queue
handoffs and filter-worker overlap directly.

The **trace context** is the compact distributed-tracing triple that
rides the query wire header (query/protocol.py): ``trace_id`` names the
whole distributed trace, ``span_id`` the sender-side parent span,
``origin_us`` the source stamp (sender wall clock µs) that makes
cross-process interlatency computable after clock-offset estimation
(obs/clock.py).

The port of ``nnstreamer_tpu/obs/span.py``; the shm and MQTT trace
trailers wait for those transports.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, NamedTuple, Optional


def new_trace_id() -> int:
    """Random nonzero 63-bit trace id (0 = "no trace" on the wire)."""
    while True:
        tid = int.from_bytes(os.urandom(8), "little") & 0x7FFFFFFFFFFFFFFF
        if tid:
            return tid


class TraceContext(NamedTuple):
    """Compact wire trace-context (all zeros = absent)."""

    trace_id: int = 0
    span_id: int = 0
    #: source stamp: sender wall clock µs when the buffer was born
    origin_us: int = 0

    def __bool__(self) -> bool:
        return self.trace_id != 0


class Span(NamedTuple):
    name: str
    tid: int           # thread ident (or remote pseudo-tid)
    start_ns: int      # mono_ns in THIS process's timeline
    dur_ns: int
    seq: int           # buffer sequence number (-1 = unknown)
    trace_id: int


class SpanRing:
    """Bounded per-buffer span store (overwrite-oldest).

    Appends come from every streaming thread; a plain lock per append
    is acceptable because span recording is opt-in (``Tracer(spans=
    True)``) — the untraced and metrics-only modes never construct one.
    """

    def __init__(self, capacity: int = 65536) -> None:
        from ..analysis.sanitizer import make_lock

        self.capacity = max(16, int(capacity))
        self._buf: List[Optional[Span]] = [None] * self.capacity
        self._next = 0          # total appends (mod capacity = slot)
        self._lock = make_lock("obs.ring")

    def append(self, span: Span) -> None:
        with self._lock:
            self._buf[self._next % self.capacity] = span
            self._next += 1

    @property
    def dropped(self) -> int:
        """Spans overwritten because the ring wrapped."""
        return max(0, self._next - self.capacity)

    def snapshot(self) -> List[Span]:
        """Spans in append order (oldest surviving first)."""
        return self.snapshot_since(0)[0]

    def snapshot_since(self, start: int) -> "tuple[List[Span], int]":
        """Spans with append index >= ``start`` (clamped to what the
        ring still holds), plus the next cursor — the incremental-drain
        primitive for the T_TRACE wire piggyback."""
        with self._lock:
            n = self._next
            lo = max(int(start), n - self.capacity, 0)
            out = []
            for i in range(lo, n):
                s = self._buf[i % self.capacity]
                if s is not None:
                    out.append(s)
            return out, n


def chrome_trace_events(spans: Iterable[Span], pid: int = 1,
                        process_name: str = "pipeline",
                        offset_ns: int = 0) -> List[Dict[str, Any]]:
    """Chrome ``trace_event`` dicts ("X" complete events + process/thread
    metadata) for one process's spans.  ``offset_ns`` shifts remote
    timelines onto the local one after clock-offset estimation."""
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    tids = set()
    for s in spans:
        tids.add(s.tid)
        events.append({
            "name": s.name, "cat": "element", "ph": "X", "pid": pid,
            "tid": s.tid, "ts": (s.start_ns + offset_ns) / 1000.0,
            "dur": s.dur_ns / 1000.0,
            "args": {"seq": s.seq, "trace_id": f"{s.trace_id:x}"},
        })
    for tid in sorted(tids):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": f"thread-{tid}"}})
    # Perfetto tolerates any order, but a monotone stream makes the
    # export diff-able and lets tests assert ordering cheaply
    events.sort(key=lambda e: (e["ph"] != "M", e.get("ts", 0.0)))
    return events
