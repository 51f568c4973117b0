"""Observability clock helpers: the one place chain-path code reads time.

The port of ``nnstreamer_tpu/obs/clock.py``.  Two clocks matter to the
tracing layer and they must not be mixed:

- ``mono_ns()``: monotonic nanoseconds, the span and proctime clock.
  Never jumps, meaningless across processes.
- ``wall_us()``: unix-epoch microseconds.  Comparable across hosts once
  the peer offset is estimated; used only to anchor a process's
  monotonic timeline onto the shared wall clock and to stamp the query
  wire.

:func:`profiler_ns` places a span's ``mono_ns()`` stamps on the clock
of ``torch.profiler``'s events, so program spans and the device trace
share one axis.

:class:`OffsetEstimator` is the cross-process half: feed it
``(t_send_us, t_recv_us, peer_wall_us)`` request samples (the SNTP
midpoint method applied to the query wire) and it keeps the estimate
from the minimum-RTT sample, which bounds the error by that sample's
asymmetry (at most rtt/2).
"""

from __future__ import annotations

import time
from typing import Optional


def mono_ns() -> int:
    """Monotonic nanoseconds — the span clock."""
    return time.monotonic_ns()


def wall_us() -> int:
    """Unix-epoch microseconds from the local clock (cheap enough for
    per-reply stamping)."""
    return time.time_ns() // 1000


_PROFILER_OFFSET_NS: Optional[int] = None


def profiler_ns(mono: int) -> int:
    """The ``mono_ns()`` stamp ``mono`` on ``torch.profiler``'s event
    clock: Kineto's ``start_ns()`` of host and device events, which is
    the host's wall clock in unix-epoch nanoseconds (``time.time_ns()``'s
    base).

    One offset, wall minus monotonic, is read once a process, from the
    tightest of a few ``monotonic, wall, monotonic`` triples: it is off
    by at most half that triple's width (well under a microsecond).  The
    two clocks share their rate (both follow NTP's slewing), so the offset
    holds until the wall clock is stepped (``settimeofday``, a leap
    second), which moves every later stamp by the step.  Kineto itself
    places its events on the wall clock through a linear fit of the CPU's
    cycle counter, good to a few microseconds."""
    global _PROFILER_OFFSET_NS
    if _PROFILER_OFFSET_NS is None:
        best = None
        for _ in range(8):
            m0 = time.monotonic_ns()
            w = time.time_ns()
            m1 = time.monotonic_ns()
            if best is None or m1 - m0 < best[0]:
                best = (m1 - m0, w - (m0 + m1) // 2)
        _PROFILER_OFFSET_NS = best[1]
    return mono + _PROFILER_OFFSET_NS


class OffsetEstimator:
    """Peer wall-clock offset from request/reply stamps.

    One sample per query round trip: the client stamps ``t_send`` and
    ``t_recv`` (local wall µs) and the peer's reply carries its wall
    clock ``peer_wall_us`` at send time.  Assuming symmetric paths the
    peer clock read happened at the local midpoint, so::

        offset = peer_wall - (t_send + t_recv) / 2

    with error bounded by rtt/2.  The estimator keeps the sample with
    the smallest RTT seen (the classic NTP filter: congestion inflates
    RTT and asymmetry together, the fastest sample is the most
    symmetric one).
    """

    __slots__ = ("_offset_us", "_rtt_us", "samples")

    def __init__(self) -> None:
        self._offset_us: Optional[int] = None
        self._rtt_us: Optional[int] = None
        self.samples = 0

    def add_sample(self, t_send_us: int, t_recv_us: int,
                   peer_wall_us: int) -> None:
        if not peer_wall_us or t_recv_us < t_send_us:
            return
        rtt = t_recv_us - t_send_us
        if self._rtt_us is not None and rtt >= self._rtt_us:
            self.samples += 1
            return
        self._rtt_us = rtt
        self._offset_us = peer_wall_us - (t_send_us + t_recv_us) // 2
        self.samples += 1

    @property
    def offset_us(self) -> Optional[int]:
        """Peer wall clock minus local wall clock (µs); None until the
        first sample."""
        return self._offset_us

    @property
    def rtt_us(self) -> Optional[int]:
        return self._rtt_us

    def to_local_us(self, peer_wall_us: int) -> int:
        """Re-base a peer wall-clock stamp onto the local wall clock."""
        return peer_wall_us - (self._offset_us or 0)
