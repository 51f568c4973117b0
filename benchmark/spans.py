"""The arithmetic of the ``program_span`` readers: the program's own spans
(``nnstreamer_tpu_torch.obs.span.PROCESS_SPANS``, one ring a process,
read in the run's process after the run) against a traced window.

A span's stamps are put on the profiler's clock by the program's
``obs.clock.profiler_ns`` and by nothing else.  A program without that
ring or that function (one older than its spans) gives no spans, and
every reader then reads nothing.

The traced window's bounds are not in the window the readers get, only
its length, ``window_s``, and its device operations.  It ends just
after the last traced step's loss read and the end of its last device
operation, so its end is taken as the later of those two, and its start
``window_s`` before that: off by the few microseconds of the
benchmark's own code between that loss read and the window's close.
"""

from __future__ import annotations

import collections
from typing import Dict, List, NamedTuple, Optional, Tuple

from .trace import _union_ns

STEP = "trainer.step"


class Spanned(NamedTuple):
    """A program span on the profiler's clock."""

    name: str
    start: int
    end: int
    seq: int
    tid: int


def program_spans() -> Optional[List[Spanned]]:
    """Every span the process's program recorded, on the profiler's
    clock; None where the program records none."""
    try:
        from nnstreamer_tpu_torch.obs import clock, span
    except ImportError:
        return None
    ring = getattr(span, "PROCESS_SPANS", None)
    to_profiler = getattr(clock, "profiler_ns", None)
    if ring is None or to_profiler is None:
        return None
    out = []
    for s in ring.snapshot():
        start = to_profiler(s.start_ns)
        out.append(Spanned(s.name, start, start + s.dur_ns, s.seq, s.tid))
    return out


def window_bounds(window, spans) -> Optional[Tuple[int, int, List[Spanned]]]:
    """``(t0, t1, steps)``: the traced window on the profiler's clock (the
    module doc) and the ``trainer.step`` spans that lie inside it."""
    kernels = window.get("kernels")
    if not kernels or not spans or window["window_s"] <= 0:
        return None
    lo = min(s for _, s, _ in kernels)
    hi = max(s + d for _, s, d in kernels)
    steps = [s for s in spans
             if s.name == STEP and s.start < hi and s.end > lo]
    if not steps:
        return None
    t1 = max(hi, max(s.end for s in steps))
    t0 = t1 - round(window["window_s"] * 1e9)
    return t0, t1, [s for s in steps if s.start >= t0]


def _innermost(spans: List[Spanned], t0: int, t1: int
               ) -> List[Tuple[int, int, Optional[str]]]:
    """``[t0, t1]`` cut into pieces, each with the name of the innermost
    span open over it (the latest to open; None: no span open)."""
    inside = sorted((s for s in spans if s.start < t1 and s.end > t0),
                    key=lambda s: s.start)
    bounds = sorted({t0, t1, *(min(max(x, t0), t1) for s in inside
                               for x in (s.start, s.end))})
    pieces, active, j = [], [], 0
    for a, b in zip(bounds, bounds[1:]):
        while j < len(inside) and inside[j].start <= a:
            active.append(inside[j])
            j += 1
        active = [s for s in active if s.end > a]
        inner = max(active, key=lambda s: (s.start, -s.end), default=None)
        pieces.append((a, b, inner.name if inner else None))
    return pieces


def idle_by_span(window, spans: List[Spanned], t0: int, t1: int
                 ) -> Dict[Optional[str], int]:
    """Nanoseconds of ``[t0, t1]`` in which no device operation ran, by
    the innermost program span open over them (None: no span open)."""
    busy = [(max(s, t0), min(s + d, t1)) for _, s, d in window["kernels"]]
    busy = [(s, e) for s, e in busy if e > s]
    idle = [(t0, t1)]
    if busy:
        _, gaps = _union_ns(busy)
        idle = ([(t0, min(s for s, _ in busy))] + gaps
                + [(max(e for _, e in busy), t1)])
    pieces = _innermost(spans, t0, t1)
    out: Dict[Optional[str], int] = collections.Counter()
    i = k = 0
    while i < len(idle) and k < len(pieces):
        s = max(idle[i][0], pieces[k][0])
        e = min(idle[i][1], pieces[k][1])
        if e > s:
            out[pieces[k][2]] += e - s
        if idle[i][1] < pieces[k][1]:
            i += 1
        else:
            k += 1
    return out


def idle_pct(window, name: Optional[str],
             spans: Optional[List[Spanned]] = None) -> Optional[float]:
    """Share of the traced window in which no device operation ran while
    ``name`` was the innermost open program span (None: while none was
    open), in percent of ``window_s``."""
    spans = program_spans() if spans is None else spans
    bounds = window_bounds(window, spans)
    if bounds is None:
        return None
    t0, t1, _ = bounds
    return 100.0 * idle_by_span(window, spans, t0, t1)[name] / (t1 - t0)


def phase_ms_per_step(window, name: str,
                      spans: Optional[List[Spanned]] = None
                      ) -> Optional[float]:
    """Mean host milliseconds of the ``name`` spans inside the traced
    window's steps."""
    spans = program_spans() if spans is None else spans
    bounds = window_bounds(window, spans)
    if bounds is None:
        return None
    steps = bounds[2]
    phases = [s for s in spans if s.name == name and any(
        s.tid == p.tid and p.start <= s.start and s.end <= p.end
        for p in steps if p.seq == s.seq)]
    if not phases:
        return None
    return sum(s.end - s.start for s in phases) / len(phases) / 1e6


def setup_s(name: str, less: Optional[str] = None,
            spans: Optional[List[Spanned]] = None) -> Optional[float]:
    """Seconds of every ``name`` span the process recorded, less the time
    spans named ``less`` (of any thread) overlap them."""
    spans = program_spans() if spans is None else spans
    mine = [s for s in spans or () if s.name == name]
    if not mine:
        return None
    cut = [(s.start, s.end) for s in spans if s.name == less]
    total = 0
    for s in mine:
        inside = [(max(a, s.start), min(b, s.end)) for a, b in cut]
        inside = [(a, b) for a, b in inside if b > a]
        total += s.end - s.start - (_union_ns(inside)[0] if inside else 0)
    return total / 1e9
