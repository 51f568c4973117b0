"""N-pad time synchronization for combining elements (mux/merge).

Parity with the reference's collectpads sync engine
(gst_tensor_time_sync_*, nnstreamer_plugin_api_impl.c:34-450; policy doc
Documentation/synchronization-policies-at-mux-merge.md): policies decide
which per-pad buffers form one output frame and what PTS it carries.

- ``nosync``: pair buffers by arrival order (FIFO zip).
- ``slowest``: output PTS = max of head PTS; pads ahead of that PTS wait,
  pads behind drop forward until within range.
- ``basepad``: pad0 drives; option ``N:duration`` — other pads pick their
  newest buffer not newer than pad0's PTS + duration.
- ``refresh``: emit whenever pad0 produces, reusing the latest buffer seen
  on other pads.

The counterpart of ``nnstreamer_tpu/pipeline/clock.py``, unchanged: the
sync policies only read PTS, so where a payload lives does not matter.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional

from ..analysis.sanitizer import make_lock
from ..tensor.buffer import TensorBuffer


class SyncMode(enum.Enum):
    NOSYNC = "nosync"
    SLOWEST = "slowest"
    BASEPAD = "basepad"
    REFRESH = "refresh"

    @classmethod
    def from_string(cls, s: Optional[str]) -> "SyncMode":
        if not s:
            return cls.NOSYNC
        return cls(str(s).strip().lower())


def parse_sync_option(sync_option) -> "tuple[Optional[int], int]":
    """Parse the mux/merge ``sync-option`` string into
    ``(duration_ns, base_pad)``: ``'<basepad>:<duration_ns>'`` or a
    bare ``'<duration_ns>'``.  Reference ssat spellings include
    trailing junk (``sync-option=0:0.``) which g_ascii_strtoull
    ignores — numbers here parse the leading digits and drop the rest
    the same way (no digits at all parses as 0, as strtoull does)."""
    import re

    dur: Optional[int] = None
    base_pad = 0
    if sync_option not in (None, ""):
        def num(s):
            digits = re.match(r"\s*\+?(\d*)", str(s)).group(1)
            return int(digits) if digits else 0
        parts = str(sync_option).split(":")
        if len(parts) >= 2:
            base_pad, dur = num(parts[0]), num(parts[1])
        else:
            dur = num(parts[0])
    return dur, base_pad


class CollectPads:
    """Per-pad FIFOs + a sync policy; thread-safe (each upstream branch may
    chain from its own streaming thread, as with GStreamer collectpads)."""

    def __init__(self, num_pads: int, mode: SyncMode = SyncMode.NOSYNC,
                 base_duration_ns: Optional[int] = None, base_pad: int = 0):
        self.num_pads = num_pads
        self.mode = mode
        self.base_duration_ns = base_duration_ns
        self.base_pad = base_pad
        self._fifos: Dict[int, List[TensorBuffer]] = {
            i: [] for i in range(num_pads)}
        self._latest: Dict[int, Optional[TensorBuffer]] = {
            i: None for i in range(num_pads)}
        self._eos: Dict[int, bool] = {i: False for i in range(num_pads)}
        self._lock = make_lock("collectpads")

    def add_pad(self) -> int:
        with self._lock:
            i = self.num_pads
            self.num_pads += 1
            self._fifos[i] = []
            self._latest[i] = None
            self._eos[i] = False
            return i

    def push(self, pad_index: int, buf: TensorBuffer
             ) -> Optional[List[TensorBuffer]]:
        """Queue a buffer; return one synchronized frame set if ready."""
        with self._lock:
            self._fifos[pad_index].append(buf)
            self._latest[pad_index] = buf
            return self._collect_locked()

    def set_eos(self, pad_index: int) -> bool:
        """Mark a pad EOS; returns True when collection is exhausted.

        Reference semantics (gst_tensor_time_sync_buffer_from_collectpad
        sets is_eos, nnstreamer_plugin_api_impl.c): the mux ends as soon
        as ANY pad is EOS with nothing queued — no complete set can ever
        form again.  (All-pads-EOS would deadlock recurrent topologies:
        the tensor_reposrc state branch only ends AFTER the mux ends,
        tests/nnstreamer_repo_rnn.)"""
        with self._lock:
            self._eos[pad_index] = True
            return self._exhausted_locked()

    def exhausted(self) -> bool:
        """True when an EOS pad's FIFO has drained — re-checked after each
        collect so the mux ends once the tail is flushed."""
        with self._lock:
            return self._exhausted_locked()

    def _exhausted_locked(self) -> bool:
        # a pad blocks collection forever iff it is EOS with nothing
        # queued AND the sync mode cannot substitute for it: NOSYNC/
        # SLOWEST need every pad's queue; BASEPAD/REFRESH reuse
        # ``_latest`` for non-base pads (so those only block when no
        # buffer was EVER seen)
        for i in range(self.num_pads):
            if not (self._eos[i] and not self._fifos[i]):
                continue
            if self.mode in (SyncMode.NOSYNC, SyncMode.SLOWEST):
                return True
            if i == self.base_pad or self._latest[i] is None:
                return True
        return False

    def _collect_locked(self) -> Optional[List[TensorBuffer]]:
        mode = self.mode
        if mode is SyncMode.NOSYNC:
            if all(self._fifos[i] for i in range(self.num_pads)):
                return [self._fifos[i].pop(0) for i in range(self.num_pads)]
            return None
        if mode is SyncMode.SLOWEST:
            if not all(self._fifos[i] for i in range(self.num_pads)):
                return None
            target = max(self._fifos[i][0].pts or 0
                         for i in range(self.num_pads))
            out = []
            for i in range(self.num_pads):
                fifo = self._fifos[i]
                # drop stale buffers: keep newest with pts <= target
                while len(fifo) > 1 and (fifo[1].pts or 0) <= target:
                    fifo.pop(0)
                out.append(fifo.pop(0))
            return out
        if mode is SyncMode.BASEPAD:
            bp = self.base_pad
            if not self._fifos[bp]:
                return None
            base = self._fifos[bp][0]
            limit = (base.pts or 0) + (self.base_duration_ns or 0)
            out: List[Optional[TensorBuffer]] = [None] * self.num_pads
            for i in range(self.num_pads):
                if i == bp:
                    continue
                fifo = self._fifos[i]
                if not fifo:
                    if self._latest[i] is None:
                        return None
                    out[i] = self._latest[i]
                    continue
                while len(fifo) > 1 and (fifo[1].pts or 0) <= limit:
                    fifo.pop(0)
                out[i] = fifo.pop(0) if fifo else self._latest[i]
            out[bp] = self._fifos[bp].pop(0)
            return out
        if mode is SyncMode.REFRESH:
            bp = self.base_pad
            if not self._fifos[bp]:
                return None
            if any(self._latest[i] is None for i in range(self.num_pads)):
                return None
            out = []
            for i in range(self.num_pads):
                if i == bp:
                    out.append(self._fifos[bp].pop(0))
                    continue
                fifo = self._fifos[i]
                out.append(fifo.pop(0) if fifo else self._latest[i])
            return out
        raise AssertionError(mode)

    def finalize(self) -> Optional[List[List[TensorBuffer]]]:
        """Once EVERY pad is EOS, drain whatever frame-sets the sync policy
        can still form (BASEPAD/REFRESH keep emitting a base backlog from
        ``_latest``) and return them; ``None`` while any pad is still live.
        Collection is push-driven, so without this a base-pad backlog at
        all-EOS would strand the mux with no EOS ever sent."""
        with self._lock:
            if not all(self._eos.values()):
                return None
            frames = []
            while True:
                fs = self._collect_locked()
                if fs is None:
                    return frames
                frames.append(fs)
