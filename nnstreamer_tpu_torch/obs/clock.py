"""Observability clock: the one place chain-path code reads time.

The port of ``mono_ns`` from ``nnstreamer_tpu/obs/clock.py`` — monotonic
nanoseconds, the span and phase-attribution clock.  The wall clock and
the peer-offset estimator wait for the query plane (ROADMAP A9).
"""

from __future__ import annotations

import time


def mono_ns() -> int:
    """Monotonic nanoseconds — the span clock."""
    return time.monotonic_ns()
