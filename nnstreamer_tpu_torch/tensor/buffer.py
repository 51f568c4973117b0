"""Stream buffer: one timestamped frame of N tensors.

The PyTorch counterpart of ``nnstreamer_tpu/tensor/buffer.py`` (the
``GstBuffer`` of N ``GstMemory`` chunks, reference hot path
tensor_filter.c:631-894).

- A tensor payload is an *array handle*: a numpy ndarray (host) or a
  ``torch.Tensor`` (a CUDA tensor is the device handle that ``jax.Array``
  is in the JAX package).  Elements pass handles zero-copy; nothing forces
  a device→host sync until a consumer calls :meth:`TensorBuffer.np`, the
  one sync point, which keeps the filter hot loop asynchronous.
- PTS/DTS/duration are integer nanoseconds like GStreamer clock-time.
- Transports receive wire payloads into pooled slabs
  (:class:`TensorBufferPool`, :class:`BufferLease`) and decode zero-copy
  numpy views over them; the buffer carrying the views holds the lease.
"""

from __future__ import annotations

import collections
import dataclasses
import sys
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..analysis import sanitizer as _san
from ..analysis.sanitizer import make_lock

#: Sentinel for "no timestamp" (GStreamer GST_CLOCK_TIME_NONE analogue).
CLOCK_TIME_NONE: Optional[int] = None


# ---------------------------------------------------------------------------
# pool refcount baselines, calibrated at import.  The no-alias guarantee
# rides on sys.getrefcount: a slab is recycled only when nothing outside
# the pool machinery can reach it.  How many references the machinery
# itself holds at the check sites depends on the interpreter, so the
# exact call shapes are measured instead of hardcoded.
# ---------------------------------------------------------------------------

def _probe_refcount(x) -> int:
    return sys.getrefcount(x)


def _calibrate_reclaim() -> int:
    # shape of _reclaim/__del__: caller local -> callee param -> getrefcount
    local = bytearray(1)
    return _probe_refcount(local)


def _calibrate_sweep() -> int:
    # shape of _sweep_pending_locked: list entry -> loop var -> getrefcount
    lst = [bytearray(1)]
    for slab in lst:
        return sys.getrefcount(slab)
    return 3


#: refcount a slab shows inside ``_reclaim`` when ONLY the caller holds
#: it; anything above means external views are alive
_RECLAIM_BASELINE = _calibrate_reclaim()
#: same for the pending-list sweep
_SWEEP_BASELINE = _calibrate_sweep()


class BufferLease:
    """One leased slab of a :class:`TensorBufferPool`.

    The lease is the ownership handle for a pooled payload: transports
    receive wire bytes into :meth:`memory` and decode zero-copy numpy
    views over it; the slab returns to the pool's free list when the
    last reference lets go (explicit :meth:`release`, or the lease being
    dropped: CPython refcounting makes the drop path prompt).

    A slab is only reused when nothing else can still see it: at reclaim
    time the pool checks the slab's external reference count (any live
    numpy view or memoryview over the slab keeps a reference chain to
    it), and a slab with outstanding views is parked on a pending list
    instead of the free list (re-checked on later acquires), so a writer
    can never scribble over bytes an old view still aliases.
    """

    __slots__ = ("_pool", "_slab", "size", "_refs", "_lock")

    def __init__(self, pool: "TensorBufferPool", slab: bytearray,
                 size: int) -> None:
        self._pool = pool
        self._slab = slab
        self.size = size
        self._refs = 1
        self._lock = make_lock("lease")

    @property
    def nbytes(self) -> int:
        return self.size

    def memory(self) -> memoryview:
        """Writable memoryview of exactly ``size`` bytes."""
        slab = self._slab
        if slab is None:
            raise RuntimeError("BufferLease used after release")
        if _san._ENABLED:
            # writable grant while decoded views are alive = the
            # aliasing bug the pool exists to prevent (sanitizer)
            _san.check_writable_grant(slab, "BufferLease.memory")
        return memoryview(slab)[:self.size]

    def view(self, dtype, shape, offset: int = 0) -> np.ndarray:
        """Zero-copy ndarray over the payload (read-only: pooled payloads
        are shared)."""
        count = 1
        for d in shape:
            count *= int(d)
        arr = np.frombuffer(self.memory(), dtype=dtype, count=count,
                            offset=offset).reshape(shape)
        arr.flags.writeable = False
        return arr

    def retain(self) -> "BufferLease":
        with self._lock:
            if self._slab is None:
                raise RuntimeError("BufferLease retained after release")
            self._refs += 1
        return self

    def release(self) -> None:
        with self._lock:
            self._refs -= 1
            if self._refs > 0:
                return
            slab, self._slab = self._slab, None
        if slab is not None:
            self._pool._reclaim(slab)

    def __del__(self):
        # an unreleased lease dying returns its slab (the common pipeline
        # flow never calls release explicitly: the buffer wrapper dropping
        # at the sink is the release)
        slab = getattr(self, "_slab", None)
        if slab is not None:
            self._slab = None
            self._pool._reclaim(slab)


class TensorBufferPool:
    """Recycled payload slabs for the transports' receive path (the role
    of GStreamer's GstBufferPool): ``acquire(n)`` hands out a
    :class:`BufferLease` over a ``bytearray`` slab, exact-size free lists
    make same-shaped streams hit the pool every frame, and ``stats``
    exposes ``hits``/``misses`` (surfaced per element as ``pool_hits`` by
    :mod:`~nnstreamer_tpu_torch.pipeline.tracing`)."""

    def __init__(self, max_per_bucket: int = 16,
                 max_free_bytes: int = 128 << 20) -> None:
        self.max_per_bucket = max_per_bucket
        #: cap on TOTAL retained free bytes across all size buckets: a
        #: variable-size stream would otherwise grow one bucket per
        #: distinct payload size without bound.  At the cap, reclaim
        #: evicts the largest free bucket before retaining.
        self.max_free_bytes = max_free_bytes
        self._free: Dict[int, List[bytearray]] = {}
        self._free_bytes = 0
        self._pending: List[bytearray] = []   # slabs with live views
        self._lock = make_lock("pool")
        # slabs whose reclaim found the lock held (see _reclaim); deque
        # append/popleft are atomic under the GIL, so __del__ can park
        # here without taking any lock
        self._deferred: "collections.deque" = collections.deque()
        self.hits = 0
        self.misses = 0

    def acquire(self, nbytes: int) -> BufferLease:
        nbytes = int(nbytes)
        with self._lock:
            self._drain_deferred_locked()
            self._sweep_pending_locked()
            bucket = self._free.get(nbytes)
            if bucket:
                slab = bucket.pop()
                if not bucket:
                    # an emptied bucket goes: variable-size streams must
                    # not accrete one entry per distinct payload size
                    del self._free[nbytes]
                self._free_bytes -= nbytes
                self.hits += 1
                hit = True
            else:
                slab = None
                self.misses += 1
                hit = False
        if slab is None:
            slab = bytearray(nbytes)
        elif _san._ENABLED:
            # a recycled slab must have NO live views (sanitizer cross-
            # checks the refcount reclaim invariant independently)
            _san.check_slab_reissue(slab)
        from ..pipeline import tracing

        tracing.record_pool(hit)
        return BufferLease(self, slab, nbytes)

    def _sweep_pending_locked(self) -> None:
        """Move parked slabs whose last external view died back to the
        free lists."""
        if not self._pending:
            return
        still = []
        for slab in self._pending:
            if sys.getrefcount(slab) <= _SWEEP_BASELINE:
                self._retain_free_locked(slab)
            else:
                still.append(slab)
        self._pending = still

    def _retain_free_locked(self, slab: bytearray) -> None:
        """Add a quiescent slab to the free lists, respecting both the
        per-bucket cap and the pool-wide byte cap (evicting the largest
        other bucket once before giving up)."""
        n = len(slab)
        # look up WITHOUT creating: a cap-rejected retention of a new size
        # must not leave a permanently empty bucket behind
        bucket = self._free.get(n)
        if bucket is not None and len(bucket) >= self.max_per_bucket:
            return
        if self._free_bytes + n > self.max_free_bytes:
            victim = max(self._free, key=lambda s: s * len(self._free[s]),
                         default=None)
            if victim is None or victim == n:
                return
            self._free_bytes -= victim * len(self._free.pop(victim))
            if self._free_bytes + n > self.max_free_bytes:
                return
        if bucket is None:
            bucket = self._free.setdefault(n, [])
        bucket.append(slab)
        self._free_bytes += n

    def _reclaim(self, slab: bytearray) -> None:
        # non-blocking acquire: _reclaim is reachable from
        # BufferLease.__del__, and the cyclic garbage collector can fire
        # that __del__ on a thread already INSIDE a locked pool section
        # (the lock is not reentrant).  When the lock is unavailable the
        # slab parks on the lock-free deferred queue; the next locked
        # section routes it through _pending.
        if not self._lock.acquire(blocking=False):
            self._deferred.append(slab)
            return
        try:
            # body stays inline: _RECLAIM_BASELINE is calibrated for
            # exactly this caller-local -> param -> getrefcount shape
            if sys.getrefcount(slab) > _RECLAIM_BASELINE:
                if len(self._pending) < 4 * self.max_per_bucket:
                    self._pending.append(slab)
                return
            self._retain_free_locked(slab)
        finally:
            self._lock.release()

    def _drain_deferred_locked(self) -> None:
        """Move lock-contended reclaims into the pending list (the sweep
        that follows applies its own view-aliasing check)."""
        while True:
            try:
                slab = self._deferred.popleft()
            except IndexError:
                return
            if len(self._pending) < 4 * self.max_per_bucket:
                self._pending.append(slab)

    @property
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "free": sum(len(b) for b in self._free.values()),
                    "free_bytes": self._free_bytes,
                    "pending": len(self._pending)}


_DEFAULT_POOL: Optional[TensorBufferPool] = None
_DEFAULT_POOL_LOCK = make_lock("leaf")


def default_pool() -> TensorBufferPool:
    """Process-wide pool shared by the query transports."""
    global _DEFAULT_POOL
    if _DEFAULT_POOL is None:
        made = None
        with _DEFAULT_POOL_LOCK:
            if _DEFAULT_POOL is None:
                _DEFAULT_POOL = made = TensorBufferPool()
        if made is not None:
            # outside the leaf lock: the registry's lock ranks below it
            _register_pool_gauges(made)
    return _DEFAULT_POOL


def _register_pool_gauges(pool: TensorBufferPool) -> None:
    """Occupancy and hit-rate gauges of the shared pool: lazy callables,
    evaluated only when the registry is read."""
    from ..obs.metrics import REGISTRY

    REGISTRY.gauge("nns_pool_free_bytes",
                   fn=lambda: pool._free_bytes, pool="default")
    REGISTRY.gauge("nns_pool_free_slabs",
                   fn=lambda: sum(len(b) for b in pool._free.values()),
                   pool="default")
    REGISTRY.gauge("nns_pool_pending_slabs",
                   fn=lambda: len(pool._pending), pool="default")
    REGISTRY.gauge(
        "nns_pool_hit_rate",
        fn=lambda: pool.hits / max(1, pool.hits + pool.misses),
        pool="default")


def is_device_array(x: Any) -> bool:
    """True when ``x`` is a tensor resident on a CUDA device, or a
    :class:`BatchView` (a row of a batched filter's output, which stays
    where that filter ran)."""
    return isinstance(x, BatchView) or (isinstance(x, torch.Tensor)
                                        and x.is_cuda)


def to_host(x: Any) -> np.ndarray:
    """Materialize a payload handle as a numpy array (syncs a CUDA
    tensor: the copy waits for the work that produces it)."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            # numpy has no bfloat16: hand over the bits as ml_dtypes'
            # bfloat16, the type the JAX package's host arrays have
            import ml_dtypes

            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


class BatchView:
    """Zero-copy per-frame view into a batched output tensor.

    The counterpart of the JAX package's ``BatchView``: a batched
    ``tensor_filter`` invoke produces ONE tensor of shape ``(bucket,
    *frame_shape)`` per output.  With ``output-device=true`` the filter
    emits one view per frame instead of copying the batch to the host,
    and:

    - a DOWNSTREAM batched filter recognizes contiguous views over the
      same underlying tensor and feeds the batch on to its own forward
      (one device copy into its graph's static input, no per-frame ops);
    - a host consumer (decoder, sink, numpy code) triggers ``__array__``,
      which copies the WHOLE underlying batch to the host once (cached
      and shared by all sibling views) and returns its row.

    Views are immutable handles; ``shape``/``dtype`` describe the single
    frame, not the batch.
    """

    __slots__ = ("batch", "index", "_cache")

    def __init__(self, batch: torch.Tensor, index: int, cache: dict) -> None:
        self.batch = batch      # shape (bucket, *frame_shape)
        self.index = int(index)
        self._cache = cache     # shared per underlying tensor: {"host": np}

    @property
    def shape(self):
        return tuple(self.batch.shape[1:])

    @property
    def dtype(self):
        return self.batch.dtype

    def device_slice(self) -> torch.Tensor:
        """This frame as its own tensor (a view of the batch: the slow
        path; batch-aware consumers use ``batch`` directly)."""
        return self.batch[self.index]

    def _host_batch(self) -> np.ndarray:
        host = self._cache.get("host")
        if host is None:
            host = self._cache["host"] = to_host(self.batch)
        return host

    def __array__(self, dtype=None, copy=None):
        row = self._host_batch()[self.index]
        if dtype is not None and row.dtype != np.dtype(dtype):
            return row.astype(dtype)
        # an independent row: the host batch is SHARED by sibling views,
        # and consumers may mutate what they np.asarray'd
        return row.copy()

    def __repr__(self) -> str:
        return (f"BatchView(row {self.index} of "
                f"{tuple(self.batch.shape)} {self.batch.dtype})")


class XBatchMeta:
    """Descriptor of a cross-stream batch buffer (rides
    ``buf.extra["nns_xbatch"]``), the JAX package's ``XBatchMeta``.

    A serving plane that coalesces admitted frames from MANY client
    connections stacks them into ONE :class:`TensorBuffer` along a new
    leading axis (``(n, *frame_shape)`` per tensor index), so the whole
    bucket traverses the pipeline as a single dispatch.  This meta
    carries what the split point needs to hand each row back, in bucket
    order:

    - ``extras[i]``: row *i*'s original per-frame ``buf.extra`` dict;
    - ``pts[i]``: row *i*'s presentation timestamp;
    - ``capacity``: the bucket size the batcher collects toward, the pad
      target of partial-bucket invokes (``TorchExecMixin.invoke_stacked``),
      so a bounded set of graphs serves every fill.

    ``n`` (the live row count) is ``len(extras)``; stacked tensors may
    carry MORE than ``n`` rows after a padded invoke — rows past ``n``
    are padding and must never be replied.
    """

    __slots__ = ("extras", "pts", "capacity")

    def __init__(self, extras, pts, capacity: int) -> None:
        self.extras = list(extras)
        self.pts = list(pts)
        self.capacity = int(capacity)

    @property
    def n(self) -> int:
        return len(self.extras)

    def __repr__(self) -> str:
        return f"XBatchMeta(n={self.n}, capacity={self.capacity})"


@dataclasses.dataclass
class TensorBuffer:
    """One frame of a tensor stream: N tensor payloads + timestamps.

    ``tensors`` entries are numpy arrays or torch tensors.  ``metas``
    carries an optional per-tensor
    :class:`~nnstreamer_tpu_torch.tensor.meta.TensorMetaInfo` for
    flexible/sparse streams (None for static streams).
    """

    tensors: List[Any] = dataclasses.field(default_factory=list)
    pts: Optional[int] = CLOCK_TIME_NONE
    duration: Optional[int] = CLOCK_TIME_NONE
    metas: Optional[List[Any]] = None
    #: free-form per-buffer metadata (e.g. the decoder's label/index, the
    #: query client id)
    extra: dict = dataclasses.field(default_factory=dict)
    #: pool ownership handle when ``tensors`` are zero-copy views into a
    #: :class:`BufferLease` slab (the slab recycles when the last holder
    #: of the frame drops it)
    lease: Any = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        # sanitizer hook (one branch per buffer when off): a leased
        # buffer's ndarray payloads are zero-copy views over the pooled
        # slab — register them so writable grants / pool re-issues with
        # live views are caught (analysis/sanitizer.py aliasing checker)
        if _san._ENABLED and self.lease is not None:
            _san.note_views(getattr(self.lease, "_slab", None),
                            self.tensors)

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def np(self, i: int = 0) -> np.ndarray:
        """Materialize tensor ``i`` on host (device sync happens HERE and
        only here).  Under a span-recording tracer the wait on a device
        tensor records as a ``device-invoke`` state span."""
        t = self.tensors[i]
        if isinstance(t, np.ndarray):
            return t
        from ..pipeline import tracing

        if tracing.annotation_active():
            import time as _time

            t0 = _time.monotonic_ns()
            out = to_host(t)
            tracing.annotate("device-invoke", t0, _time.monotonic_ns())
            return out
        return to_host(t)

    def nbytes(self) -> int:
        total = 0
        for t in self.tensors:
            total += t.nbytes if hasattr(t, "nbytes") else len(t)
        return total

    def with_tensors(self, tensors: Sequence[Any]) -> "TensorBuffer":
        """New buffer with same timestamps/extra but different payloads."""
        return TensorBuffer(tensors=list(tensors), pts=self.pts,
                            duration=self.duration, extra=dict(self.extra))

    def copy(self) -> "TensorBuffer":
        """Shallow copy: a new wrapper with independent ``extra``/``metas``
        containers but the SAME tensor payload handles (a pooled lease is
        shared by reference)."""
        return TensorBuffer(tensors=list(self.tensors), pts=self.pts,
                            duration=self.duration,
                            metas=list(self.metas) if self.metas else None,
                            extra=dict(self.extra), lease=self.lease)

    def __repr__(self) -> str:
        shapes = ",".join(str(tuple(getattr(t, "shape", ()))) for t in self.tensors)
        return f"TensorBuffer(n={self.num_tensors} shapes=[{shapes}] pts={self.pts})"


SECOND = 1_000_000_000


def frames_to_ns(frame_index: int, rate_num: int, rate_den: int) -> int:
    """PTS of frame N at a given framerate, in ns."""
    if rate_num == 0:
        return 0
    return frame_index * SECOND * rate_den // rate_num
