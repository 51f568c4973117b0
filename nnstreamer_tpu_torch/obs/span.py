"""Per-buffer timeline spans, wire trace-context, Chrome trace export.

A **span** is one element's processing of one buffer: ``(element,
thread id, start mono-ns, duration ns, buffer seq, trace id)``.  Spans
land in a bounded :class:`SpanRing` (overwrite-oldest, so a long run
keeps the tail instead of OOMing) and export as Chrome ``trace_event``
JSON — ``chrome://tracing`` / Perfetto render streaming threads, queue
handoffs and filter-worker overlap directly.

**Program spans** belong to no buffer: a training step's phases and the
one-off set-up work, in the one process-wide ring :data:`PROCESS_SPANS`
(:func:`record`).  ``seq`` is the training step's number (-1 for set-up;
a ``kernels.build`` span's is the libraries it compiled), and a span
contained in another of the same thread is its child:

- ``trainer.step`` (``elements/trainer.py``), a step on a host batch,
  with three children in order: ``trainer.stage`` (``_cuda.GraphedStep``:
  the batch made a tensor, the wait for the previous staging copy, the
  copy into pinned staging and the copy to the card enqueued),
  ``trainer.replay`` (the graph's replay; the eager step where the step
  runs eagerly) or ``trainer.capture`` (a signature's first call: the
  eager warm-up step and the capture), and ``trainer.loss_read`` (the
  ``float(loss)`` that syncs);
- ``trainer.build``: the trainer building its model and step at the
  first ``finish()``; ``trainer.capture`` also outside a recorded step;
  ``kernels.build`` (``_cuda.build``): ``nvcc`` compiling kernel
  libraries.

Step spans are recorded only while a span-recording tracer is attached
to the trainer's pipeline or ``torch.profiler`` runs; set-up spans
always.  ``obs.clock.profiler_ns`` puts their stamps on the profiler's
clock.

The **trace context** is the compact distributed-tracing triple that
rides the query wire header (query/protocol.py): ``trace_id`` names the
whole distributed trace, ``span_id`` the sender-side parent span,
``origin_us`` the source stamp (sender wall clock µs) that makes
cross-process interlatency computable after clock-offset estimation
(obs/clock.py).  The same triple rides the MQTT header's pad region and
a magic'd trailer on the shm-ring payload (:func:`pack_ctx_trailer`).

The port of ``nnstreamer_tpu/obs/span.py``: the same trailer bytes, so
either package's shm and MQTT peers read the other's context.
"""

from __future__ import annotations

import os
import struct
import threading
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
    seq: int           # buffer sequence number or training step (-1 = unknown)
    trace_id: int


#: shm/mqtt trace trailer: magic + trace_id + span_id + origin_us
_TRAILER = struct.Struct("<4sQQq")
_TRAILER_MAGIC = b"TRCE"
TRAILER_SIZE = _TRAILER.size


def pack_ctx_trailer(ctx: TraceContext) -> bytes:
    """Trace context as a self-identifying 28-byte blob, appended after
    the tensor payload on transports whose framing has no header room
    (shm ring slots) or spare pad (the MQTT 1024-byte header).
    ``decode_tensors`` reads exactly the declared tensors, so a trailer
    after them is invisible to context-unaware consumers."""
    return _TRAILER.pack(_TRAILER_MAGIC, ctx.trace_id, ctx.span_id,
                         ctx.origin_us)


def unpack_ctx_trailer(payload, end: Optional[int] = None
                       ) -> Optional[TraceContext]:
    """Trace context from the trailing bytes of ``payload`` (bytes or
    memoryview), or None when no trailer is present."""
    n = len(payload) if end is None else end
    if n < TRAILER_SIZE:
        return None
    raw = bytes(payload[n - TRAILER_SIZE:n])
    if raw[:4] != _TRAILER_MAGIC:
        return None
    _, trace_id, span_id, origin_us = _TRAILER.unpack(raw)
    return TraceContext(trace_id, span_id, origin_us)


class SpanRing:
    """Bounded per-buffer span store (overwrite-oldest).

    Appends come from every streaming thread; a plain lock per append
    is acceptable because span recording is opt-in (``Tracer(spans=
    True)``; program spans of a step only while traced or profiled) —
    the untraced and metrics-only modes append nothing a buffer.
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


#: the process's program spans (module doc)
PROCESS_SPANS = SpanRing()


def record(name: str, start_ns: int, end_ns: int, seq: int = -1) -> None:
    """Append program span ``name`` of this thread, from ``start_ns`` to
    ``end_ns`` (``mono_ns()``), to :data:`PROCESS_SPANS`."""
    PROCESS_SPANS.append(Span(name, threading.get_ident(), start_ns,
                              end_ns - start_ns, seq, 0))


def chrome_trace_events(spans: Iterable[Span], pid: int = 1,
                        process_name: str = "pipeline",
                        offset_ns: int = 0,
                        program: Iterable[Span] = ()
                        ) -> List[Dict[str, Any]]:
    """Chrome ``trace_event`` dicts ("X" complete events + process/thread
    metadata) for one process's spans, and its ``program`` spans under
    category ``program``.  ``offset_ns`` shifts remote timelines onto the
    local one after clock-offset estimation."""
    events: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    tids = set()
    for cat, group in (("element", spans), ("program", program)):
        for s in group:
            tids.add(s.tid)
            events.append({
                "name": s.name, "cat": cat, "ph": "X", "pid": pid,
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
