"""Sink elements: tensor_sink (signal emitter), fakesink, filesink and
multifilesink.

Parity with gst/nnstreamer/elements/gsttensor_sink.c: an appsink-like
element emitting a ``new-data`` callback per buffer, which is how
applications and all the reference's sink unit tests consume pipeline
output (tests/nnstreamer_sink/unittest_sink.cc).  The file sinks write a
device tensor's bytes after one read to the host (:meth:`TensorBuffer.np`),
as the JAX package's do.
"""

from __future__ import annotations

import threading
import time
from fractions import Fraction
from typing import Callable, List, Optional

import numpy as np

from ..pipeline.caps import Caps
from ..pipeline.element import Element, EOSEvent, FlowReturn, QoSEvent
from ..pipeline.registry import register_element
from ..tensor.buffer import SECOND, TensorBuffer


@register_element
class TensorSink(Element):
    FACTORY = "tensor_sink"
    PROPERTIES = {
        "emit-signal": (True, "invoke new-data callbacks"),
        "sync": (False, "render buffers at their PTS against the "
                        "pipeline clock (real-time playback pacing)"),
        "collect": (True, "keep buffers in .results"),
        "max-results": (0, "cap on retained buffers, 0 = unlimited"),
        "qos": (False, "emit upstream QoS events when consuming slower "
                       "than the stream's frame duration"),
    }

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._callbacks: List[Callable[[TensorBuffer], None]] = []
        self.results: List[TensorBuffer] = []
        self._caps: Optional[Caps] = None
        self._eos = threading.Event()
        self._qos_late = False
        self._unblock = threading.Event()   # stop() aborts a sync wait

    def start(self):
        self._unblock.clear()

    def unblock(self):
        self._unblock.set()

    def stop(self):
        self._unblock.set()

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")

    def connect(self, signal: str, cb: Callable[[TensorBuffer], None]) -> None:
        """GObject-signal-style registration: connect("new-data", fn)."""
        if signal != "new-data":
            raise ValueError(f"unknown signal {signal!r}")
        self._callbacks.append(cb)

    def set_caps(self, pad, caps):
        self._caps = caps

    @property
    def caps(self) -> Optional[Caps]:
        return self._caps

    def _frame_duration_ns(self, buf) -> int:
        if buf.duration:
            return int(buf.duration)
        if self._caps is not None:
            rate = self._caps.first().get("framerate")
            if isinstance(rate, Fraction) and rate > 0:
                return SECOND * rate.denominator // rate.numerator
        return 0

    def chain(self, pad, buf):
        if self.sync and buf.pts is not None and self.pipeline is not None:
            # render at PTS: wait until base_time + pts on the pipeline
            # clock (GStreamer sink sync semantics); stop() unblocks
            base = getattr(self.pipeline, "base_time_ns", None)
            if base is not None:
                target = base + int(buf.pts)
                while not self._unblock.is_set():
                    delta = (target - time.monotonic_ns()) / 1e9
                    if delta <= 0:
                        break
                    self._unblock.wait(delta)   # set() wakes immediately
        t0 = time.monotonic_ns() if self.qos else 0
        if self.collect:
            self.results.append(buf)
            cap = int(self.max_results)
            if cap > 0 and len(self.results) > cap:
                self.results.pop(0)
        if self.emit_signal:
            for cb in self._callbacks:
                cb(buf)
        if self.qos:
            # QoS feedback loop (reference wires real-time sinks' QoS events
            # to tensor_filter throttling, tensor_filter.c:1454-1485): when
            # consuming this buffer took longer than one frame duration,
            # tell upstream how far behind we are.  When a previously-slow
            # consumer catches up, send ONE catch-up event (jitter <= 0) so
            # upstream throttles can clear — without it a single transient
            # stall would throttle the stream forever.
            proc = time.monotonic_ns() - t0
            dur = self._frame_duration_ns(buf)
            if dur and proc > dur:
                self._qos_late = True
                pad.push_upstream_event(QoSEvent(
                    timestamp=buf.pts, jitter_ns=proc - dur,
                    proportion=proc / dur))
            elif dur and self._qos_late:
                self._qos_late = False
                pad.push_upstream_event(QoSEvent(
                    timestamp=buf.pts, jitter_ns=proc - dur,
                    proportion=max(proc / dur, 1e-3)))
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            self._eos.set()
            self.post_eos_reached()

    def wait_eos(self, timeout: Optional[float] = None) -> bool:
        return self._eos.wait(timeout)


@register_element
class FakeSink(Element):
    """Discards buffers (GStreamer fakesink role)."""

    FACTORY = "fakesink"

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")

    def set_caps(self, pad, caps):
        pass

    def chain(self, pad, buf):
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            self.post_eos_reached()


@register_element
class FileSink(Element):
    """Appends raw tensor bytes to a file (multifilesink/filesink role used
    by the reference golden tests to byte-compare outputs)."""

    FACTORY = "filesink"
    PROPERTIES = {"location": (None, "output path")}

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")

    def start(self):
        if not self.location:
            raise ValueError(f"{self.name}: location required")
        self._f = open(str(self.location), "wb")

    def stop(self):
        f = getattr(self, "_f", None)
        if f is not None and not f.closed:
            f.close()

    def set_caps(self, pad, caps):
        pass

    def chain(self, pad, buf):
        for i in range(buf.num_tensors):
            self._f.write(np.ascontiguousarray(buf.np(i)).tobytes())
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            self._f.flush()
            self.post_eos_reached()


@register_element
class MultiFileSink(Element):
    """One file PER BUFFER at ``location % index`` (GStreamer
    multifilesink role — the ssat harness tees processed streams into
    indexed files and byte-compares them against goldens, e.g.
    ``multifilesink location=result_%1d.log``)."""

    FACTORY = "multifilesink"
    PROPERTIES = {
        "location": (None, "printf pattern, e.g. result_%1d.log"),
        "index": (0, "first file index"),
    }

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")

    def start(self):
        from .src import _indexed_path

        if not self.location:
            raise ValueError(f"{self.name}: location required")
        self._idx = int(self.index)
        self._indexed_path = _indexed_path
        self._indexed_path(self.location, self._idx, self.name)

    def set_caps(self, pad, caps):
        pass

    def chain(self, pad, buf):
        path = self._indexed_path(self.location, self._idx, self.name)
        with open(path, "wb") as fh:
            for i in range(buf.num_tensors):
                fh.write(np.ascontiguousarray(buf.np(i)).tobytes())
        self._idx += 1
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            self.post_eos_reached()
