"""Shared-memory ring transport: host-local single-copy tensor streams.

The reference's inter-pipeline transports are all socket wires — TCP
query (`gst/nnstreamer/tensor_query/`), MQTT, gRPC — so two pipelines
on ONE host still pay the kernel socket path per buffer.  On a host
feeding a card thousands of frames a second that's the wrong transport;
this module gives
co-located pipelines a lock-free SPSC ring through POSIX shared memory:

    producer: … ! tensor_shm_sink path=frames
    consumer: tensor_shm_src path=frames ! …

Record payloads use the same tensor framing as the TCP wire
(`protocol.encode_tensors`), so static and flexible streams both ride
the ring.  Caps negotiate through the ring header (producer writes the
caps string; consumer's ``negotiate`` reads it) — the role of the TCP
HELLO exchange.

Two interoperable implementations of one region layout (documented in
native/tensorwire/shmring.cc): the C++ ring via ctypes when the native
lib is available, else a pure-Python mmap fallback (adequate for tests
and toolchain-less hosts; the native path is the fast one).

The port of ``nnstreamer_tpu/query/shm.py``.  The port's library
(``native.py``) compiles ``shmring.cc`` beside the CRC, so a ring written
by either package is read by the other, native or fallback.  On the card
``tensor_parts`` brings each output tensor to the host (one sync a
tensor) and the slot write stays the transport's one copy.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import struct
import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np

from ..analysis.sanitizer import make_condition, make_lock
from ..pipeline.caps import Caps
from ..pipeline.element import Element, EOSEvent, FlowReturn
from ..pipeline.graph import Source
from ..pipeline.registry import register_element
from ..pipeline.tracing import record_copy
from ..tensor.buffer import (BufferLease, TensorBuffer, TensorBufferPool,
                             default_pool)
from ..tensor.caps_util import tensors_template_caps
from .protocol import decode_tensors, tensor_parts

# region layout constants — must match native/tensorwire/shmring.cc
_MAGIC = 0x4E545352  # 'NTSR'
_VERSION = 1
_CAPS_MAX = 4096
_OFF_CAPS = 24
_OFF_HEAD = 4160
_OFF_TAIL = 4224
_OFF_EOS = 4288
_OFF_SLOTS = 4352
_SLOT_HDR = 16  # u64 len + s64 pts

DEFAULT_SLOT_BYTES = 1 << 20
DEFAULT_SLOTS = 16

# -- process-local ring wakeups (pure-Python fallback) ----------------------
# A blocked pure-Python endpoint cannot be notified by a REMOTE process
# (no futex without the native lib), but the common test/bench topology
# runs both pipelines in ONE process.  Rings share a per-name condition:
# push/pop/eos notify it, so a same-process peer wakes immediately
# (event-driven, zero idle wakeups) while a cross-process peer degrades
# to the bounded timed re-check of the wait loop — never a busy spin.
_WAKEUPS: Dict[str, "tuple[threading.Condition, int]"] = {}
_WAKEUPS_LOCK = make_lock("leaf")


def _wakeup_acquire(name: str) -> threading.Condition:
    with _WAKEUPS_LOCK:
        cond, refs = _WAKEUPS.get(name, (None, 0))
        if cond is None:
            cond = make_condition("shm.ring")
        _WAKEUPS[name] = (cond, refs + 1)
        return cond


def _wakeup_release(name: str) -> None:
    with _WAKEUPS_LOCK:
        cond, refs = _WAKEUPS.get(name, (None, 0))
        if cond is None:
            return
        if refs <= 1:
            del _WAKEUPS[name]
        else:
            _WAKEUPS[name] = (cond, refs - 1)


def _native_lib():
    from .. import native

    lib = native._load()
    if lib is None or not hasattr(lib, "tw_shm_create"):
        return None
    if not getattr(lib, "_shm_bound", False):
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.tw_shm_create.restype = ctypes.c_void_p
        lib.tw_shm_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                      ctypes.c_uint32, ctypes.c_char_p]
        lib.tw_shm_open.restype = ctypes.c_void_p
        lib.tw_shm_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.tw_shm_caps.restype = ctypes.c_uint32
        lib.tw_shm_caps.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                    ctypes.c_uint32]
        lib.tw_shm_push.restype = ctypes.c_int
        lib.tw_shm_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64,
                                    ctypes.c_int64, ctypes.c_uint32]
        if hasattr(lib, "tw_shm_push2"):
            lib.tw_shm_push2.restype = ctypes.c_int
            lib.tw_shm_push2.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
                ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32,
                ctypes.c_int64, ctypes.c_uint32]
        lib.tw_shm_pop.restype = ctypes.c_int64
        lib.tw_shm_pop.argtypes = [ctypes.c_void_p, u8p, ctypes.c_uint64,
                                   ctypes.POINTER(ctypes.c_int64),
                                   ctypes.c_uint32]
        lib.tw_shm_eos.argtypes = [ctypes.c_void_p]
        lib.tw_shm_slot_size.restype = ctypes.c_uint64
        lib.tw_shm_slot_size.argtypes = [ctypes.c_void_p]
        lib.tw_shm_close.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib._shm_bound = True
    return lib


class ShmRing:
    """One endpoint of the ring; ``create=True`` = producer side."""

    def __init__(self, name: str, create: bool,
                 slot_bytes: int = DEFAULT_SLOT_BYTES,
                 n_slots: int = DEFAULT_SLOTS, caps: str = "",
                 timeout: float = 10.0):
        if not name.startswith("/"):
            name = "/" + name
        self.name = name
        if create and len(caps.encode()) > _CAPS_MAX:
            # uniform, descriptive reject on BOTH paths (the native
            # tw_shm_create would return nullptr -> opaque ConnectionError)
            raise ValueError(
                f"shm ring {name!r}: caps string {len(caps.encode())} B "
                f"exceeds {_CAPS_MAX} B header slot")
        self._lib = _native_lib()
        self._h = None
        self._mm: Optional[mmap.mmap] = None
        self._wake: Optional[threading.Condition] = None
        self._owner = create
        if self._lib is not None:
            if create:
                self._h = self._lib.tw_shm_create(
                    name.encode(), slot_bytes, n_slots, caps.encode())
            else:
                self._h = self._lib.tw_shm_open(
                    name.encode(), int(timeout * 1000))
            if not self._h:
                raise ConnectionError(f"shm ring {name!r}: "
                                      f"{'create' if create else 'open'} "
                                      "failed")
            self.slot_bytes = int(self._lib.tw_shm_slot_size(self._h))
        else:
            self._py_init(create, slot_bytes, n_slots, caps, timeout)

    # -- pure-Python fallback (same layout).  SAFETY: cross-process
    # correctness relies on x86-64 TSO (stores retire in order) and on
    # aligned 8-byte mmap writes being single stores — CPython emits no
    # fences.  On other ISAs (aarch64) a consumer could observe the head
    # advance before the payload lands; warn loudly there and prefer the
    # native ring (its C++11 atomics are correct everywhere). ------------
    def _py_init(self, create, slot_bytes, n_slots, caps, timeout):
        import platform

        if platform.machine() not in ("x86_64", "AMD64"):
            from ..utils.log import logger

            logger.warning(
                "shm ring %s: pure-Python fallback has no memory barriers "
                "— cross-process use on %s may tear records; build the "
                "native lib (make -C native)", self.name,
                platform.machine())
        path = "/dev/shm" + self.name
        if create:
            caps_b = caps.encode()  # <= _CAPS_MAX, checked in __init__
            total = _OFF_SLOTS + n_slots * (_SLOT_HDR + slot_bytes)
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "wb") as f:
                f.truncate(total)
            os.replace(tmp, path)
            self._fd = os.open(path, os.O_RDWR)
            self._mm = mmap.mmap(self._fd, total)
            self._mm[8:16] = struct.pack("<Q", slot_bytes)
            self._mm[16:24] = struct.pack("<II", n_slots, len(caps_b))
            self._mm[_OFF_CAPS:_OFF_CAPS + len(caps_b)] = caps_b
            # magic last (consumer spins on it)
            self._mm[0:8] = struct.pack("<II", _MAGIC, _VERSION)
        else:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    self._fd = os.open(path, os.O_RDWR)
                    st = os.fstat(self._fd)
                    if st.st_size >= _OFF_SLOTS:
                        self._mm = mmap.mmap(self._fd, st.st_size)
                        magic, ver = struct.unpack("<II", self._mm[0:8])
                        if magic == _MAGIC and ver == _VERSION:
                            break
                        self._mm.close()
                        self._mm = None
                        if magic == _MAGIC:  # right ring, wrong layout
                            os.close(self._fd)
                            raise ConnectionError(
                                f"shm ring {self.name!r}: version {ver} "
                                f"!= {_VERSION}")
                    os.close(self._fd)
                except FileNotFoundError:
                    # only "not created yet" retries; anything else —
                    # including the version-mismatch ConnectionError
                    # (an OSError subclass!) — must escape, not spin
                    # into a misleading "open timed out"
                    pass
                if time.monotonic() > deadline:
                    raise ConnectionError(f"shm ring {self.name!r}: "
                                          "open timed out")
                # cross-PROCESS file-appearance wait: no local producer
                # exists yet to signal, so a timed re-check is the only
                # pure-Python option  # nnslint: allow(sleep-poll)
                time.sleep(0.002)
        self.slot_bytes = struct.unpack("<Q", self._mm[8:16])[0]
        self._n_slots = struct.unpack("<I", self._mm[16:20])[0]
        self._wake = _wakeup_acquire(self.name)

    def _py_u64(self, off: int) -> int:
        return struct.unpack("<Q", self._mm[off:off + 8])[0]

    # Blocked-side waiting (pure-Python fallback): condition-driven.
    # ``_wait_change`` blocks on the ring's process-local condition, so a
    # same-process peer's push/pop/eos wakes it IMMEDIATELY; the timeout
    # only bounds the re-check for cross-process peers (which cannot
    # notify) — exponential 50 µs → 2 ms, the pacing of shmring.cc's
    # native backoff.  This replaces the time.sleep backoff loop (and
    # before that a flat 100 µs spin), so a local stall costs zero
    # wakeups instead of 500+/s.
    def _wait_change(self, blocked, deadline: float, delay: float,
                     stalled: str) -> float:
        """One bounded wait while ``blocked()`` holds; raises
        TimeoutError(``stalled``) past ``deadline``.  Returns the next
        re-check delay.  The blocked-state re-check happens UNDER the
        condition, so a local peer's notify between check and wait is
        never lost."""
        with self._wake:
            if not blocked():
                return delay
            if time.monotonic() > deadline:
                raise TimeoutError(stalled)
            self._wake.wait(delay)
        return delay * 2 if delay < 0.002 else delay

    def _notify(self) -> None:
        """Ring state changed (slot filled/freed, EOS): wake any
        same-process peer blocked in ``_wait_change``."""
        wake = self._wake
        if wake is not None:
            with wake:
                wake.notify_all()

    # -- API -------------------------------------------------------------
    def caps(self) -> str:
        if self._lib is not None:
            out = ctypes.create_string_buffer(_CAPS_MAX)
            n = self._lib.tw_shm_caps(self._h, out, _CAPS_MAX)
            return out.raw[:n].decode()
        n = struct.unpack("<I", self._mm[20:24])[0]
        return bytes(self._mm[_OFF_CAPS:_OFF_CAPS + n]).decode()

    def push(self, payload: bytes, pts: int, timeout: float = 10.0) -> None:
        self.push_parts([payload], pts, timeout)

    def push_parts(self, parts, pts: int, timeout: float = 10.0) -> None:
        """Scatter-gather push: writes the iovec straight into the slot
        — ONE copy from the tensor views to shared memory, no staging
        blob (the old ``push(encode_tensors(buf))`` paid two)."""
        arrs = [np.frombuffer(p, np.uint8) for p in parts]
        total = sum(a.nbytes for a in arrs)
        record_copy(total)   # the slot write is the transport's one copy
        if self._lib is not None and hasattr(self._lib, "tw_shm_push2"):
            n = len(arrs)
            ptrs = (ctypes.c_void_p * n)(
                *(a.ctypes.data for a in arrs))
            lens = (ctypes.c_uint64 * n)(*(a.nbytes for a in arrs))
            rc = self._lib.tw_shm_push2(self._h, ptrs, lens, n, pts,
                                        int(timeout * 1000))
            if rc == -2:
                raise ValueError(f"record {total} B exceeds slot "
                                 f"size {self.slot_bytes}")
            if rc != 0:
                raise TimeoutError("shm ring full (consumer stalled?)")
            return
        if self._lib is not None:
            # old .so without the scatter entry: push a single part
            # zero-copy (the pre-scatter behavior); stage only when
            # there is genuinely more than one part to gather
            if len(arrs) == 1:
                flat, blob_len = arrs[0], arrs[0].nbytes
                buf = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
            else:
                blob = b"".join(a.tobytes() for a in arrs)
                blob_len = len(blob)
                buf = ctypes.cast(ctypes.c_char_p(blob),
                                  ctypes.POINTER(ctypes.c_uint8))
            rc = self._lib.tw_shm_push(self._h, buf, blob_len, pts,
                                       int(timeout * 1000))
            if rc == -2:
                raise ValueError(f"record {total} B exceeds slot "
                                 f"size {self.slot_bytes}")
            if rc != 0:
                raise TimeoutError("shm ring full (consumer stalled?)")
            return
        if total > self.slot_bytes:
            raise ValueError(f"record {total} B exceeds slot "
                             f"size {self.slot_bytes}")
        deadline = time.monotonic() + timeout
        delay = 5e-5

        def _full() -> bool:
            return (self._py_u64(_OFF_HEAD) - self._py_u64(_OFF_TAIL)
                    >= self._n_slots)

        while _full():
            delay = self._wait_change(
                _full, deadline, delay,
                "shm ring full (consumer stalled?)")
        head = self._py_u64(_OFF_HEAD)
        off = _OFF_SLOTS + (head % self._n_slots) * (_SLOT_HDR
                                                    + self.slot_bytes)
        self._mm[off:off + 16] = struct.pack("<Qq", total, pts)
        pos = off + 16
        for a in arrs:
            self._mm[pos:pos + a.nbytes] = a.data
            pos += a.nbytes
        self._mm[_OFF_HEAD:_OFF_HEAD + 8] = struct.pack("<Q", head + 1)
        self._notify()   # slot filled: wake a same-process consumer

    def pop(self, timeout: float = 10.0
            ) -> Optional[Tuple[bytes, int]]:
        """(payload, pts) — or None on EOS-and-drained."""
        got = self.pop_into(None, timeout)
        if got is None:
            return None
        lease, n, pts = got
        payload = bytes(lease.memory()[:n])
        lease.release()
        return payload, pts

    def pop_into(self, pool: Optional[TensorBufferPool],
                 timeout: float = 10.0
                 ) -> Optional[Tuple[BufferLease, int, int]]:
        """Pop the next record into a pooled slab: ``(lease, nbytes,
        pts)`` — or None on EOS-and-drained.  ONE copy out of the ring;
        the consumer decodes zero-copy views over the lease."""
        if pool is None:
            pool = default_pool()
        if self._lib is not None:
            # full-slot-capacity lease (record length unknown until the
            # native pop); exact-size bucketing still recycles it
            lease = pool.acquire(self.slot_bytes)
            dst = np.frombuffer(lease.memory(), np.uint8)
            pts = ctypes.c_int64()
            n = self._lib.tw_shm_pop(
                self._h, dst.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)),
                self.slot_bytes, ctypes.byref(pts), int(timeout * 1000))
            del dst
            if n == -3:
                lease.release()
                return None
            if n < 0:
                lease.release()
                raise TimeoutError("shm ring empty (producer stalled?)")
            return lease, int(n), pts.value
        deadline = time.monotonic() + timeout
        delay = 5e-5

        def _empty() -> bool:
            return self._py_u64(_OFF_HEAD) == self._py_u64(_OFF_TAIL)

        while _empty():
            if struct.unpack("<I", self._mm[_OFF_EOS:_OFF_EOS + 4])[0]:
                return None
            delay = self._wait_change(
                _empty, deadline, delay,
                "shm ring empty (producer stalled?)")
        tail = self._py_u64(_OFF_TAIL)
        off = _OFF_SLOTS + (tail % self._n_slots) * (_SLOT_HDR
                                                     + self.slot_bytes)
        ln, pts = struct.unpack("<Qq", self._mm[off:off + 16])
        lease = pool.acquire(ln)
        lease.memory()[:] = self._mm[off + 16:off + 16 + ln]
        self._mm[_OFF_TAIL:_OFF_TAIL + 8] = struct.pack("<Q", tail + 1)
        self._notify()   # slot freed: wake a same-process producer
        return lease, ln, pts

    def eos(self) -> None:
        if self._lib is not None:
            self._lib.tw_shm_eos(self._h)
        else:
            self._mm[_OFF_EOS:_OFF_EOS + 4] = struct.pack("<I", 1)
            self._notify()   # consumers blocked on empty re-check EOS

    def close(self, unlink: Optional[bool] = None) -> None:
        """Unmap; unlink the shm name when ``unlink`` (default: consumer
        side).  The producer must NOT unlink at close — a consumer that
        attaches late still needs to drain the ring; ``create`` replaces
        any stale ring left behind, bounding the leak to one name."""
        if unlink is None:
            unlink = not self._owner
        if self._lib is not None:
            if self._h:
                self._lib.tw_shm_close(self._h, 1 if unlink else 0)
                self._h = None
            return
        if self._mm is not None:
            self._mm.close()
            self._mm = None
            os.close(self._fd)
            if self._wake is not None:
                self._notify()   # peers re-check state one last time
                _wakeup_release(self.name)
                self._wake = None
            if unlink:
                try:
                    os.unlink("/dev/shm" + self.name)
                except OSError:
                    pass

    @property
    def is_native(self) -> bool:
        return self._lib is not None


@register_element
class ShmSink(Element):
    """Publish the stream into a shared-memory ring (host-local
    single-copy transport; see module docstring)."""

    FACTORY = "tensor_shm_sink"
    PROPERTIES = {
        "path": ("nns-shm", "shm ring name (under /dev/shm)"),
        "slot-bytes": (DEFAULT_SLOT_BYTES, "max record size"),
        "slots": (DEFAULT_SLOTS, "ring capacity in records"),
        "timeout": (10.0, "push timeout (s) when the ring is full"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")

    def start(self):
        self._ring: Optional[ShmRing] = None

    def stop(self):
        if self._ring is not None:
            self._ring.eos()
            self._ring.close()
            self._ring = None

    def set_caps(self, pad, caps):
        # ring is created at caps time so the consumer's negotiate() can
        # read them from the header (the TCP path's HELLO role)
        if self._ring is None:
            self._ring = ShmRing(str(self.path), create=True,
                                 slot_bytes=int(self.slot_bytes),
                                 n_slots=int(self.slots), caps=str(caps))
            self._ring_caps = str(caps)
        elif str(caps) != self._ring_caps:
            # the header caps are the consumer's negotiation source; a
            # silent mid-stream change would let differently-shaped
            # records flow under stale caps
            raise RuntimeError(
                f"{self.name}: caps renegotiation after ring creation is "
                f"not supported (ring header holds {self._ring_caps!r}); "
                "stop/start the sink to change caps")

    def chain(self, pad, buf):
        if self._ring is None:
            # caps always precede data in this framework (set_caps creates
            # the ring); a buffer without caps is a bug upstream — fail
            # loudly rather than publish an un-negotiable capsless ring
            raise RuntimeError(f"{self.name}: buffer before caps")
        # scatter-gather: tensor views land in the slot directly (one
        # copy into shared memory, no staging blob)
        parts = tensor_parts(buf)
        ctx = buf.extra.get("nns_trace")
        if ctx is not None and ctx.trace_id:
            # trace context rides a self-identifying trailer AFTER the
            # tensors (obs/span.py): the fixed 16-byte slot header is
            # shared with the native ring and cannot grow, and
            # decode_tensors never reads past the declared tensors, so
            # context-unaware consumers are unaffected.  A frame sized
            # right up to slot-bytes ships WITHOUT the trailer instead
            # of erroring: attaching a tracer must never turn a working
            # pipeline into a failing one.
            from ..obs.span import TRAILER_SIZE, pack_ctx_trailer

            total = sum(len(p) if isinstance(p, bytes) else p.nbytes
                        for p in parts)
            if total + TRAILER_SIZE <= self._ring.slot_bytes:
                parts.append(pack_ctx_trailer(ctx))
        self._ring.push_parts(parts, buf.pts or 0,
                              float(self.timeout))
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            if self._ring is not None:
                self._ring.eos()
            self.post_eos_reached()


@register_element
class ShmSrc(Source):
    """Consume a shared-memory ring published by ``tensor_shm_sink``."""

    FACTORY = "tensor_shm_src"
    PROPERTIES = {
        "path": ("nns-shm", "shm ring name (under /dev/shm)"),
        "caps": (None, "override caps (else the ring header's)"),
        "timeout": (10.0, "open/pop timeout (s)"),
        "num-buffers": (-1, "stop after N buffers, -1 unlimited"),
        "prefetch": (0, "drain the ring from a reader thread into an "
                        "unbounded local fifo (1 = on).  Decouples the "
                        "producer from this pipeline's processing rate "
                        "— the same structure edge_src/tensor_query use "
                        "— at the cost of unbounded consumer-side "
                        "memory.  0 (default) pops on demand, keeping "
                        "the ring's bounded-backpressure contract"),
    }

    #: in-band wake marker for the blocking prefetch-fifo get in
    #: create() (AppSrc._WAKE treatment: teardown enqueues it instead of
    #: the reader polling with a timeout)
    _WAKE = object()

    def _make_pads(self):
        self.add_src_pad(tensors_template_caps(), "src")

    def start(self):
        self._ring: Optional[ShmRing] = None
        self._count = 0
        self._pool = default_pool()
        self._fifo = None
        self._reader = None

    def unblock(self):
        if self._fifo is not None:
            self._fifo.put(self._WAKE)

    def _halt(self) -> None:
        # flag before marker, AppSrc-style: a create() that consumes the
        # marker must observe halted and exit
        self._halted.set()
        if self._fifo is not None:
            self._fifo.put(self._WAKE)
        super()._halt()

    def stop(self):
        self._halt()
        if self._reader is not None:
            self._reader.join(timeout=10)
            self._reader = None
        if self._ring is not None:
            self._ring.close()   # consumer side unlinks
            self._ring = None

    def negotiate(self) -> Caps:
        # the blocking ring-open happens HERE, on the streaming thread —
        # start() runs synchronously inside Pipeline.play(), and a
        # not-yet-up producer must not stall the whole pipeline's startup
        self._ring = ShmRing(str(self.path), create=False,
                             timeout=float(self.timeout))
        if int(self.prefetch or 0):
            import queue as _queue
            import threading

            # bounded upstream by the ring's fixed slot count: the
            # prefetch reader can only get ahead by n_slots frames
            # nnslint: allow(unbounded-queue)
            self._fifo = _queue.Queue()
            self._reader = threading.Thread(
                target=self._drain_loop, daemon=True,
                name=f"shm-src:{self.name}")
            self._reader.start()
        if self.caps:
            c = self.caps
            return Caps.from_string(c) if isinstance(c, str) else c
        caps = self._ring.caps()
        if not caps:
            raise ValueError(f"{self.name}: ring {self.path!r} carries no "
                             "caps; set the caps property")
        return Caps.from_string(caps)

    def _drain_loop(self) -> None:
        """prefetch=1 reader: pop the ring as fast as the producer fills
        it, park records in the local fifo.  The producer never blocks
        on THIS pipeline's processing rate (the decoupling edge_src gets
        from its broker-reader thread)."""
        deadline = time.monotonic() + float(self.timeout)
        while not self._halted.is_set():
            try:
                got = self._ring.pop_into(self._pool, timeout=0.1)
            except TimeoutError:
                if time.monotonic() > deadline:
                    self._fifo.put(TimeoutError(
                        f"{self.name}: no data on ring {self.path!r} "
                        f"for {self.timeout}s and no EOS "
                        "(producer gone?)"))
                    return
                continue
            except Exception as exc:  # noqa: BLE001 — any reader death
                # must surface on the streaming thread, not strand
                # create() polling an empty fifo forever (the on-demand
                # branch propagates the same exception directly)
                self._fifo.put(exc)
                return
            deadline = time.monotonic() + float(self.timeout)
            self._fifo.put(got)
            if got is None:      # EOS and drained
                return

    def create(self) -> Optional[TensorBuffer]:
        n = int(self.num_buffers)
        if n >= 0 and self._count >= n:
            return None
        deadline = time.monotonic() + float(self.timeout)
        while not self._halted.is_set():
            if self._fifo is not None:
                # blocking get, no timeout: the reader thread (or the
                # _halt/unblock wake marker) is the only wake source
                got = self._fifo.get()
                if got is self._WAKE:
                    continue   # teardown marker: re-check halted
                if isinstance(got, BaseException):
                    raise got
            else:
                try:
                    got = self._ring.pop_into(self._pool, timeout=0.1)
                except TimeoutError:
                    # honor the documented bound: a producer that
                    # vanished without EOS must not hang the pipeline
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{self.name}: no data on ring "
                            f"{self.path!r} for {self.timeout}s and no "
                            "EOS (producer gone?)")
                    continue
            if got is None:
                return None
            lease, n, pts = got
            self._count += 1
            # zero-copy decode over the pooled slab; the lease rides the
            # buffer so the slab outlives every downstream view
            payload = lease.memory()[:n]
            out = TensorBuffer(tensors=decode_tensors(payload), pts=pts,
                               lease=lease)
            from ..obs.span import unpack_ctx_trailer

            ctx = unpack_ctx_trailer(payload)
            if ctx is not None:
                out.extra["nns_trace"] = ctx
            return out
        return None
