"""Runtime concurrency sanitizer: lock-order + buffer-aliasing checking.

Off by default and ZERO-COST when off: the lock factories below return
plain ``threading`` primitives and the hot-path hooks are a single
module-global test.  On (``NNS_DEBUG=1`` in the environment, or
:func:`enable` from tests) every lock created through
:func:`make_lock` / :func:`make_rlock` / :func:`make_condition` is
wrapped so the sanitizer sees each acquisition:

- **Acquisition graph**: per-thread held-lock stacks feed a global
  directed graph over lock CLASSES (names from
  :mod:`~nnstreamer_tpu_torch.analysis.lockorder`).  The first time an edge
  closes a cycle, the sanitizer reports the potential deadlock with the
  acquisition stacks of BOTH directions — the two code paths that can
  interleave into a hang.
- **Hierarchy check**: every nested acquisition is checked against the
  declared hierarchy (:func:`lockorder.check_order`); inversions are
  reported with the acquiring stack even before a full cycle exists.
- **Aliasing checker**: :class:`~nnstreamer_tpu_torch.tensor.buffer.
  BufferLease` registers the read-only numpy views decoded over its
  slab (via :func:`note_views`, called when a ``TensorBuffer`` carrying
  a lease is built).  A writable grant of the slab
  (``BufferLease.memory()``) or a pool re-issue while any registered
  view is still alive is the zero-copy contract violation that
  silently corrupts frames — reported with the view's creation stack.

``strict`` mode (the default under :func:`enable`; tests use it) raises
:class:`LockOrderError` / :class:`AliasingError` at the violation site;
non-strict (the ``NNS_DEBUG=1`` default) records findings for
:func:`report` so a live pipeline keeps streaming while evidence
accumulates.

Locks are instrumented at CREATION: enabling the sanitizer affects
objects constructed afterwards (pipelines built inside a test, a
process started with ``NNS_DEBUG=1``), never retroactively.

The port of ``nnstreamer_tpu/analysis/sanitizer.py``: the same checks,
findings and switches.  Device tensors are never slab views (a pooled
slab is host memory), so the aliasing half sees the numpy views the
transports decode, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import traceback
import weakref
from typing import Any, Dict, List, Tuple

from . import lockorder

__all__ = [
    "enable", "disable", "enabled", "report", "reset", "findings",
    "make_lock", "make_rlock", "make_condition",
    "note_views", "check_writable_grant", "check_slab_reissue",
    "guard_readonly", "LockOrderError", "AliasingError", "Finding",
]


class LockOrderError(RuntimeError):
    """A lock acquisition broke the declared hierarchy or closed a
    potential-deadlock cycle (strict mode only)."""


class AliasingError(RuntimeError):
    """A pooled slab was written (or re-issued for writing) while
    read-only zero-copy views over it were still alive — or a consumer
    attempted to write through such a view (see :func:`guard_readonly`)."""


@dataclasses.dataclass
class Finding:
    kind: str            # "lock-cycle" | "lock-hierarchy" | "aliasing"
    message: str
    #: formatted stacks giving both sides of the conflict where known
    stacks: List[str] = dataclasses.field(default_factory=list)

    def __str__(self) -> str:
        body = f"[{self.kind}] {self.message}"
        for s in self.stacks:
            body += "\n" + s
        return body


# --------------------------------------------------------------------------
# global state
# --------------------------------------------------------------------------

#: fast hot-path gate, read by buffer.py / protocol.py per frame
_ENABLED = False
_STRICT = False
_STATE_LOCK = threading.Lock()   # guards the structures below
_FINDINGS: List[Finding] = []
#: lock-class edge graph: name -> {successor names}
_EDGES: Dict[str, set] = {}
#: (a, b) -> formatted stack of the first observed a-held-acquiring-b
_EDGE_STACKS: Dict[Tuple[str, str], str] = {}
#: id(slab) -> list of (weakref-to-view, creation stack summary)
_SLAB_VIEWS: Dict[int, List[Tuple[Any, str]]] = {}

_TLS = threading.local()


def _held() -> list:
    stack = getattr(_TLS, "held", None)
    if stack is None:
        stack = _TLS.held = []
    return stack


def _fmt_stack(skip: int = 3, limit: int = 14) -> str:
    frames = traceback.format_stack()[:-skip]
    return "".join(frames[-limit:]).rstrip()


def enabled() -> bool:
    return _ENABLED


def enable(strict: bool = True) -> None:
    """Turn the sanitizer on (affects locks/buffers created from now
    on).  ``strict`` raises at the violation site; else findings are
    only recorded for :func:`report`."""
    global _ENABLED, _STRICT
    _ENABLED = True
    _STRICT = bool(strict)


def disable() -> None:
    global _ENABLED
    _ENABLED = False


def reset() -> None:
    """Drop all recorded findings, edges and view registrations."""
    with _STATE_LOCK:
        _FINDINGS.clear()
        _EDGES.clear()
        _EDGE_STACKS.clear()
        _SLAB_VIEWS.clear()


def findings() -> List[Finding]:
    with _STATE_LOCK:
        return list(_FINDINGS)


def report() -> str:
    """Human-readable report of everything recorded so far."""
    out = findings()
    if not out:
        return "sanitizer: no findings"
    return "\n\n".join(str(f) for f in out)


def _record(finding: Finding, error_cls) -> None:
    with _STATE_LOCK:
        _FINDINGS.append(finding)
    if _STRICT:
        raise error_cls(str(finding))


# NNS_DEBUG=1 arms the sanitizer for the whole process (non-strict: a
# live pipeline should keep streaming while evidence accumulates)
if os.environ.get("NNS_DEBUG", "") == "1":
    enable(strict=False)


# --------------------------------------------------------------------------
# lock instrumentation
# --------------------------------------------------------------------------

def _reaches(src: str, dst: str) -> bool:
    """DFS: does the edge graph already have a path src -> dst?"""
    seen = set()
    stack = [src]
    while stack:
        node = stack.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        stack.extend(_EDGES.get(node, ()))
    return False


def _note_acquired(lock: "_Tracked") -> None:
    held = _held()
    acq_stack = None
    for h in held:
        if h is lock:
            continue
        violation = lockorder.check_order(h.name, lock.name)
        if violation is not None:
            if acq_stack is None:
                acq_stack = _fmt_stack()
            _record(Finding(
                "lock-hierarchy",
                f"{violation} (thread {threading.current_thread().name})",
                [f"--- acquiring {lock.name!r}:\n{acq_stack}"],
            ), LockOrderError)
        if h.name != lock.name:
            with _STATE_LOCK:
                edge = (h.name, lock.name)
                new_edge = lock.name not in _EDGES.get(h.name, ())
                if new_edge:
                    if acq_stack is None:
                        acq_stack = _fmt_stack()
                    _EDGES.setdefault(h.name, set()).add(lock.name)
                    _EDGE_STACKS[edge] = acq_stack
                    cycle = _reaches(lock.name, h.name)
                    back = _EDGE_STACKS.get((lock.name, h.name))
                else:
                    cycle = False
                    back = None
            if cycle:
                stacks = [f"--- {h.name!r} -> {lock.name!r} "
                          f"(thread {threading.current_thread().name}):\n"
                          f"{acq_stack}"]
                if back is not None:
                    stacks.append(
                        f"--- {lock.name!r} -> {h.name!r} (earlier):\n"
                        f"{back}")
                _record(Finding(
                    "lock-cycle",
                    f"potential deadlock: acquisition order cycle "
                    f"{h.name!r} -> {lock.name!r} -> ... -> {h.name!r}",
                    stacks), LockOrderError)
    held.append(lock)


def _note_released(lock: "_Tracked") -> None:
    held = _held()
    # release order may not be LIFO (lock handoffs); remove last match
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lock:
            del held[i]
            return


class _Tracked:
    """Instrumented Lock/RLock: every successful acquire/release is
    mirrored into the per-thread held stack."""

    __slots__ = ("_inner", "name", "_reentrant", "_counts")

    def __init__(self, inner, name: str, reentrant: bool) -> None:
        self._inner = inner
        self.name = name
        self._reentrant = reentrant
        # per-thread recursion depth so an RLock re-acquire is not a
        # second held-stack entry (thread-keyed; tiny, debug-only)
        self._counts: Dict[int, int] = {}

    def acquire(self, blocking: bool = True, timeout: float = -1):
        # Lock.acquire forbids a timeout with blocking=False (the pool's
        # __del__-safe reclaim path uses exactly that): forward the
        # timeout only when one was given
        if timeout == -1:
            got = self._inner.acquire(blocking)
        else:
            got = self._inner.acquire(blocking, timeout)
        if got:
            tid = threading.get_ident()
            depth = self._counts.get(tid, 0)
            if not self._reentrant or depth == 0:
                _note_acquired(self)
            self._counts[tid] = depth + 1
        return got

    def release(self) -> None:
        tid = threading.get_ident()
        depth = self._counts.get(tid, 1) - 1
        if depth <= 0:
            self._counts.pop(tid, None)
            _note_released(self)
        else:
            self._counts[tid] = depth
        self._inner.release()

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # threading.Condition(lock=...) support: delegate the internal
    # save/restore protocol to the wrapped primitive while keeping the
    # held-stack in sync across the wait window
    def _release_save(self):
        tid = threading.get_ident()
        depth = self._counts.pop(tid, 1)
        _note_released(self)
        if hasattr(self._inner, "_release_save"):
            return (self._inner._release_save(), depth)
        self._inner.release()
        return (None, depth)

    def _acquire_restore(self, state) -> None:
        saved, depth = state
        if hasattr(self._inner, "_acquire_restore"):
            self._inner._acquire_restore(saved)
        else:
            self._inner.acquire()
        _note_acquired(self)
        self._counts[threading.get_ident()] = depth

    def _is_owned(self) -> bool:
        if hasattr(self._inner, "_is_owned"):
            return self._inner._is_owned()
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True


def make_lock(name: str):
    """A ``threading.Lock`` belonging to lock class ``name`` (see
    :mod:`~nnstreamer_tpu_torch.analysis.lockorder`); instrumented when the
    sanitizer is enabled, a plain lock otherwise."""
    if not _ENABLED:
        return threading.Lock()
    return _Tracked(threading.Lock(), name, reentrant=False)


def make_rlock(name: str):
    if not _ENABLED:
        return threading.RLock()
    return _Tracked(threading.RLock(), name, reentrant=True)


def make_condition(name: str):
    """A ``threading.Condition`` whose underlying lock participates in
    lock-order tracking (over a plain ``Lock``, as when it is off)."""
    if not _ENABLED:
        return threading.Condition(threading.Lock())
    return threading.Condition(lock=_Tracked(threading.Lock(), name,
                                             reentrant=False))


# --------------------------------------------------------------------------
# BufferLease aliasing checker
# --------------------------------------------------------------------------

def note_views(slab, tensors) -> None:
    """Register the live zero-copy views decoded over ``slab`` (called
    from ``TensorBuffer`` construction when a lease rides the buffer).
    Only weakref-able ndarray payloads are tracked."""
    if not _ENABLED or slab is None:
        return
    key = id(slab)
    stack = _fmt_stack()
    with _STATE_LOCK:
        entries = _SLAB_VIEWS.setdefault(key, [])
        for t in tensors:
            try:
                entries.append((weakref.ref(t), stack))
            except TypeError:
                continue   # not weakref-able: not a slab view


def _live_views(slab) -> List[str]:
    """Creation stacks of still-alive registered views over ``slab``
    (pruning dead entries as a side effect)."""
    with _STATE_LOCK:
        entries = _SLAB_VIEWS.get(id(slab))
        if not entries:
            return []
        alive = [(r, s) for (r, s) in entries if r() is not None]
        if alive:
            _SLAB_VIEWS[id(slab)] = alive
        else:
            del _SLAB_VIEWS[id(slab)]
        return [s for _, s in alive]


def check_writable_grant(slab, origin: str) -> None:
    """A writable view of ``slab`` is about to be handed out
    (``BufferLease.memory()``): writes through it would corrupt every
    live shared view."""
    if not _ENABLED or slab is None:
        return
    stacks = _live_views(slab)
    if stacks:
        _record(Finding(
            "aliasing",
            f"{origin}: writable grant of a pooled slab with "
            f"{len(stacks)} live zero-copy view(s) — writing would "
            "corrupt frames already handed downstream",
            [f"--- view decoded at:\n{stacks[0]}",
             f"--- writable grant at:\n{_fmt_stack()}"],
        ), AliasingError)


def check_slab_reissue(slab) -> None:
    """A recycled slab is about to be re-issued by the pool: by the
    no-alias invariant nothing may still see it."""
    if not _ENABLED or slab is None:
        return
    stacks = _live_views(slab)
    if stacks:
        _record(Finding(
            "aliasing",
            "pool re-issued a slab that still has live zero-copy "
            "view(s) — the refcount reclaim invariant is broken",
            [f"--- view decoded at:\n{stacks[0]}",
             f"--- re-issue at:\n{_fmt_stack()}"],
        ), AliasingError)


# --------------------------------------------------------------------------
# read-only view guard (clear error instead of numpy's)
# --------------------------------------------------------------------------

def guard_readonly(arr):
    """Wrap a read-only zero-copy tensor view so a write attempt raises
    a CLEAR :class:`AliasingError` naming the contract, instead of
    numpy's bare ``assignment destination is read-only``.  No-op (and
    no subclass) when the sanitizer is off — the view stays a plain
    read-only ndarray."""
    if not _ENABLED:
        return arr
    guarded = arr.view(_ReadOnlyTensorView)
    guarded.flags.writeable = False
    return guarded


def _readonly_write_error():
    return AliasingError(
        "write attempt on a read-only zero-copy tensor view: this array "
        "aliases a shared transport payload (pooled slab / tee fan-out "
        "contract, see tensor/buffer.py BufferLease); copy it first "
        "(np.array(x)) if you need to mutate")


try:
    import numpy as _np

    class _ReadOnlyTensorView(_np.ndarray):
        """ndarray subclass for sanitized zero-copy views: mutation of a
        read-only instance raises :class:`AliasingError` with the
        contract spelled out.  Derived WRITABLE arrays (copies, op
        results) behave exactly like ndarray."""

        def __setitem__(self, key, value):
            if not self.flags.writeable:
                raise _readonly_write_error()
            _np.ndarray.__setitem__(self, key, value)

        def fill(self, value):
            if not self.flags.writeable:
                raise _readonly_write_error()
            _np.ndarray.fill(self, value)

        def sort(self, *a, **k):
            if not self.flags.writeable:
                raise _readonly_write_error()
            _np.ndarray.sort(self, *a, **k)

except Exception:  # pragma: no cover - numpy is a hard dep in practice
    _ReadOnlyTensorView = None  # type: ignore[assignment]
