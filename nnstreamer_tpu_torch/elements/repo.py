"""tensor_reposink / tensor_reposrc: in-process circular stream repository.

Parity with gst/nnstreamer/elements/gsttensor_repo.c (+reposink/reposrc):
a process-global slot table keyed by ``slot-index`` lets a pipeline feed
its own upstream (recurrent topologies) without a direct element link.
The counterpart of ``nnstreamer_tpu/elements/repo.py``; the port's slot
table is its own.
"""

from __future__ import annotations

import queue as _queue
import time
from typing import Dict, Optional

from ..analysis.sanitizer import make_condition
from ..pipeline.caps import Caps
from ..pipeline.element import Element, EOSEvent, FlowReturn
from ..pipeline.graph import Source
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..tensor.caps_util import tensors_template_caps


class _Repo:
    """Process-global slot table (reference gsttensor_repo.c table).

    Caps registration is condition-driven: a reposrc waiting for the
    writer's caps blocks on the table condition and wakes the moment
    ``set_caps`` lands (the 0.02 s poll this replaces burned 50 wakeups
    per second of startup skew for a median wait of one)."""

    def __init__(self) -> None:
        self._slots: Dict[int, _queue.Queue] = {}
        self._caps: Dict[int, Caps] = {}
        self._cv = make_condition("repo")

    def slot(self, index: int) -> _queue.Queue:
        with self._cv:
            if index not in self._slots:
                self._slots[index] = _queue.Queue(maxsize=32)
            return self._slots[index]

    def set_caps(self, index: int, caps: Caps) -> None:
        with self._cv:
            self._caps[index] = caps
            self._cv.notify_all()

    def get_caps(self, index: int) -> Optional[Caps]:
        with self._cv:
            return self._caps.get(index)

    def wait_caps(self, index: int, timeout: float,
                  cancelled=lambda: False) -> Optional[Caps]:
        """Block until slot ``index`` has caps (the writer's set_caps
        wakes us), the deadline passes, or ``cancelled()`` turns true
        (re-checked on each wakeup; :func:`wake` forces one)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while True:
                caps = self._caps.get(index)
                if caps is not None or cancelled():
                    return caps
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._cv.wait(remaining)

    def wake(self) -> None:
        """Interrupt waiters so they re-check their cancel condition
        (element teardown)."""
        with self._cv:
            self._cv.notify_all()

    def clear(self) -> None:
        with self._cv:
            self._slots.clear()
            self._caps.clear()
            self._cv.notify_all()


repo = _Repo()


@register_element
class TensorRepoSink(Element):
    FACTORY = "tensor_reposink"
    PROPERTIES = {
        "slot-index": (0, "repository slot"),
        "signal-rate": (0, "reference reposink property (emission rate "
                           "limiter there; accepted for launch-line "
                           "parity — this sink emits no signals)"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")

    def set_caps(self, pad, caps):
        repo.set_caps(int(self.slot_index), caps)

    def chain(self, pad, buf):
        repo.slot(int(self.slot_index)).put(buf)
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            repo.slot(int(self.slot_index)).put(None)
            self.post_eos_reached()


@register_element
class TensorRepoSrc(Source):
    FACTORY = "tensor_reposrc"
    PROPERTIES = {"slot-index": (0, "repository slot"),
                  "caps": (None, "caps to announce (else slot caps)")}

    def start(self):
        # first create() emits a zero dummy buffer (reference
        # gsttensor_reposrc.c:287-337): a recurrent cycle's state source
        # must produce frame 0 before the loop has written anything
        self._ini = False

    def _make_pads(self):
        self.add_src_pad(tensors_template_caps(), "src")

    #: in-band wake marker for the blocking slot-queue get in create()
    #: (same treatment as AppSrc._WAKE: teardown enqueues it so the
    #: reader never needs a timeout poll)
    _WAKE = object()

    def negotiate(self) -> Caps:
        if self.caps is not None:
            c = self.caps
            caps = Caps.from_string(c) if isinstance(c, str) else c
            self._neg_caps = caps
            return caps
        # wait (event-driven) for the writer to register caps; _halt()
        # wakes the condition so teardown never rides out the deadline
        c = repo.wait_caps(int(self.slot_index), timeout=2.0,
                           cancelled=self._halted.is_set)
        if c is not None:
            self._neg_caps = c
            return c
        raise RuntimeError(f"{self.name}: no caps in slot {self.slot_index}")

    def _dummy_buffer(self) -> Optional[TensorBuffer]:
        from ..tensor.caps_util import config_from_caps

        try:
            import numpy as np

            cfg = config_from_caps(self._neg_caps)
            zeros = [np.zeros(i.np_shape, i.np_dtype) for i in cfg.info]
            return TensorBuffer(tensors=zeros, pts=0)
        except Exception:
            return None  # flexible/unparseable caps: wait for real data

    def _halt(self) -> None:
        # flag first, then wake both wait sites: the caps condition (a
        # negotiate still waiting re-checks cancelled) and the slot
        # queue (create's blocking get consumes the marker and exits)
        self._halted.set()
        repo.wake()
        try:
            repo.slot(int(self.slot_index)).put_nowait(self._WAKE)
        except _queue.Full:
            pass   # reader isn't blocked on an empty queue: no wake needed
        super()._halt()

    def create(self) -> Optional[TensorBuffer]:
        q = repo.slot(int(self.slot_index))
        if not getattr(self, "_ini", True):
            self._ini = True
            dummy = self._dummy_buffer()
            if dummy is not None:
                return dummy
        # blocking get with NO timeout: event-driven (the 0.1 s poll this
        # replaces woke 10x/s for the whole stream); _halt()'s in-band
        # _WAKE marker interrupts it at teardown
        while not self._halted.is_set():
            item = q.get()
            if item is self._WAKE:
                continue   # teardown (or stale) marker: re-check halted
            return item    # None = EOS sentinel from reposink
        return None
