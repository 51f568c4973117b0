"""tensor_rate: framerate control + throttling for tensor streams.

Parity with gst/nnstreamer/elements/gsttensor_rate.c: drop/duplicate frames
to hit a target ``framerate``; ``throttle`` mode simply drops to an upper
bound (the QoS role the reference wires to tensor_filter throttling).
The counterpart of ``nnstreamer_tpu/elements/rate.py``.
"""

from __future__ import annotations

from fractions import Fraction

from ..pipeline.element import Element, FlowReturn, QoSEvent
from ..pipeline.registry import register_element
from ..tensor.buffer import SECOND
from ..tensor.caps_util import caps_from_config, config_from_caps, \
    tensors_template_caps


@register_element
class TensorRate(Element):
    FACTORY = "tensor_rate"
    PROPERTIES = {
        "framerate": (None, "target rate 'N/D'"),
        "throttle": (True, "drop-only (no duplication)"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")
        self.add_src_pad(tensors_template_caps(), "src")

    def start(self):
        if self.framerate in (None, ""):
            raise ValueError(f"{self.name}: framerate required")
        self._target = Fraction(str(self.framerate))
        self._qos_proportion = 1.0     # downstream slowdown (QoS feedback)
        self._next_pts = 0
        self.dropped = 0
        self.duplicated = 0

    def on_upstream_event(self, pad, event):
        """Close the QoS loop: a downstream slowdown report lowers the
        EFFECTIVE output rate (open-loop target ÷ proportion); a catch-up
        report (jitter <= 0) restores the configured rate.  The event still
        propagates upstream so producers can throttle too."""
        if isinstance(event, QoSEvent):
            self._qos_proportion = (1.0 if event.jitter_ns <= 0
                                    else max(1.0, event.proportion))
            super().on_upstream_event(pad, event)
            return True
        return super().on_upstream_event(pad, event)

    @property
    def effective_rate(self) -> Fraction:
        """QoS-adapted output rate: target / proportion.  The proportion
        is quantized to millesimals for an exact Fraction — reports in
        (1.0, 1.001) round DOWN to no-op, which is below any actionable
        slowdown (the reference's integer-ns throttling interval
        quantizes harder)."""
        p = self._qos_proportion
        quant = Fraction(int(p * 1000), 1000)
        return self._target if p <= 1.0 or quant <= 1 \
            else self._target / quant

    def set_caps(self, pad, caps):
        cfg = config_from_caps(caps)
        cfg.rate = self._target
        self.announce_src_caps(caps_from_config(cfg))

    def chain(self, pad, buf):
        eff = self.effective_rate
        interval = SECOND * eff.denominator // eff.numerator
        pts = buf.pts or 0
        if pts + (buf.duration or 0) < self._next_pts:
            self.dropped += 1
            return FlowReturn.DROPPED
        ret = FlowReturn.OK
        while pts + (buf.duration or interval) >= self._next_pts:
            out = buf.copy()
            out.pts = self._next_pts
            out.duration = interval
            ret = self.push(out)
            self._next_pts += interval
            if bool(self.throttle):
                break
            if ret is not FlowReturn.OK:
                break
        return ret
