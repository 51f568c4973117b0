"""Lock factories.

The JAX package's factories (``nnstreamer_tpu/analysis/sanitizer.py``)
wrap each lock for the lock-order and buffer-aliasing sanitizer when it
is enabled, and return plain ``threading`` primitives otherwise.  The
port keeps the factory names, so call sites read the same, and returns
the plain primitives: the sanitizer itself is not ported yet.
"""

from __future__ import annotations

import threading


def make_lock(name: str):
    return threading.Lock()


def make_rlock(name: str):
    return threading.RLock()


def make_condition(name: str):
    return threading.Condition(threading.Lock())
