"""Misc elements: identity and tensor_debug.

The counterparts of ``identity`` and ``tensor_debug`` in
``nnstreamer_tpu/elements/misc.py``: pass-through elements the segment
compiler fuses (the unit of per-element dispatch overhead), each with the
reference's fused-dispatch and lowering hooks.  The JAX module's ``join``,
``tensor_crop`` and ``datareposrc`` are not ported yet.
"""

from __future__ import annotations

from typing import List

from ..pipeline.caps import Caps
from ..pipeline.element import CapsEvent, Element, LoweredStep
from ..pipeline.registry import register_element


def _identity(ts):
    return ts


@register_element
class Identity(Element):
    """Pass-through element (GStreamer ``identity`` role): forwards every
    buffer untouched.  ``sleep-us`` emulates a fixed per-buffer host cost
    (the gst identity ``sleep-time`` analogue)."""

    FACTORY = "identity"
    PROPERTIES = {"sleep-us": (0, "sleep per buffer, microseconds")}

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")
        self.add_src_pad(Caps.any(), "src")

    def _forward(self, buf):
        if self.sleep_us:
            import time as _time

            _time.sleep(int(self.sleep_us) / 1e6)
        return buf

    def chain(self, pad, buf):
        return self.push(self._forward(buf))

    def plan_step(self):
        return self._forward

    def lower_reason(self):
        if int(self.sleep_us or 0):
            return "identity sleep-us emulates host work (untraceable)"
        return None

    def lower_step(self):
        if self.lower_reason() is not None:
            return None
        return LoweredStep(_identity, batched=_identity)


@register_element
class TensorDebug(Element):
    """Logs caps/buffer meta in-band (console-output parity with
    gsttensor_debug.c)."""

    FACTORY = "tensor_debug"
    PROPERTIES = {"output": ("console", "console|silent"),
                  "capture": (False, "keep a record in .log")}

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self.log: List[str] = []

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")
        self.add_src_pad(Caps.any(), "src")

    def set_caps(self, pad, caps):
        self._note(f"caps: {caps}")
        self.src_pad.push_event(CapsEvent(caps))

    def _observe(self, buf):
        shapes = [tuple(getattr(t, "shape", ())) for t in buf.tensors]
        self._note(f"buffer pts={buf.pts} n={buf.num_tensors} shapes={shapes}")
        return buf

    def chain(self, pad, buf):
        return self.push(self._observe(buf))

    def plan_step(self):
        return self._observe

    def lower_reason(self):
        if str(self.output) == "console" or bool(self.capture):
            return ("tensor_debug output=console/capture has per-buffer "
                    "side effects (set output=silent to lower)")
        return None

    def lower_step(self):
        if self.lower_reason() is not None:
            return None
        return LoweredStep(_identity, batched=_identity)

    def _note(self, msg: str) -> None:
        if bool(self.capture):
            self.log.append(msg)
        if str(self.output) == "console":
            print(f"[{self.name}] {msg}")
