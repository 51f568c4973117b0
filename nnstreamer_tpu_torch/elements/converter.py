"""tensor_converter: video frames → other/tensors.

Parity with gst/nnstreamer/elements/gsttensor_converter.c (chain at
:1015-1300) for the video path, as in ``nnstreamer_tpu/elements/
converter.py``: an ``(h, w, c)`` frame IS the tensor layout, so a frame
passes through untouched — a device-resident frame (``videotestsrc
device-cache``) is never synced to host here — and ``frames-per-tensor``
N>1 stacks N frames into one ``(N, h, w, c)`` tensor, on the device when
the frames are there.  At ``frames-per-tensor=1`` the element fuses
(``plan_step``) and lowers (``lower_step``: the payload passthrough).

The JAX package's audio, text, octet-stream and flexible-tensor paths and
its converter subplugins are not ported yet.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np

from ..pipeline.element import Element, FlowReturn, LoweredStep
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer, is_device_array, to_host
from ..tensor.caps_util import caps_from_config, tensors_template_caps
from ..tensor.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensor.types import TensorType
from .src import _CHANNELS, video_template_caps


@register_element
class TensorConverter(Element):
    FACTORY = "tensor_converter"
    PROPERTIES = {
        "frames-per-tensor": (1, "frames batched into one tensor"),
    }

    def _make_pads(self):
        self.add_sink_pad(video_template_caps(), "sink")
        self.add_src_pad(tensors_template_caps(), "src")

    def start(self):
        self._pending: List = []
        self._pending_pts: Optional[int] = None

    # -- negotiation ---------------------------------------------------------
    def set_caps(self, pad, caps):
        st = caps.first()
        if st.name != "video/x-raw":
            raise ValueError(f"unsupported media type {st.name}")
        fpt = int(self.frames_per_tensor)
        rate = st.get("framerate")
        if isinstance(rate, Fraction) and fpt > 1:
            rate = rate / fpt
        w, h = int(st.get("width")), int(st.get("height"))
        ch = _CHANNELS[str(st.get("format"))]
        dims = (ch, w, h) if fpt == 1 else (ch, w, h, fpt)
        cfg = TensorsConfig(
            info=TensorsInfo([TensorInfo(TensorType.UINT8, dims)]),
            rate=rate if isinstance(rate, Fraction) else Fraction(30, 1))
        self.announce_src_caps(caps_from_config(cfg))

    # -- dataflow ------------------------------------------------------------
    def _video_frame(self, buf: TensorBuffer) -> TensorBuffer:
        t = buf.tensors[0]
        return buf.with_tensors([t if is_device_array(t) else buf.np(0)])

    def chain(self, pad, buf: TensorBuffer) -> FlowReturn:
        fpt = int(self.frames_per_tensor)
        if fpt == 1:
            return self.push(self._video_frame(buf))
        frame = buf.tensors[0] if is_device_array(buf.tensors[0]) \
            else buf.np(0)
        self._pending.append(frame)
        if self._pending_pts is None:
            self._pending_pts = buf.pts
        if len(self._pending) < fpt:
            return FlowReturn.OK
        if all(is_device_array(f) for f in self._pending):
            import torch

            stacked = torch.stack(self._pending, dim=0)   # (fpt,h,w,c)
        else:
            stacked = np.stack([to_host(f) for f in self._pending], axis=0)
        self._pending = []
        out = TensorBuffer(tensors=[stacked], pts=self._pending_pts,
                           duration=(buf.duration or 0) * fpt)
        self._pending_pts = None
        return self.push(out)

    def plan_step(self):
        # fused dispatch covers the stateless 1:1 conversion; the
        # accumulating path (frames-per-tensor>1) keeps interpreted
        # dispatch
        if int(self.frames_per_tensor) == 1:
            return self._video_frame
        return None

    def lower_reason(self):
        if int(self.frames_per_tensor) != 1:
            return "frames-per-tensor>1 accumulates state across buffers"
        return None

    def lower_step(self):
        # video at frames-per-tensor=1 is a pure payload passthrough
        if self.lower_reason() is not None:
            return None
        return LoweredStep(_first_tensor, batched=_first_tensor)


def _first_tensor(ts):
    return [ts[0]]

