"""Misc elements: identity, tensor_debug, join, tensor_crop, datareposrc.

The counterpart of ``nnstreamer_tpu/elements/misc.py``:

- identity / tensor_debug: pass-through elements the segment compiler
  fuses (the unit of per-element dispatch overhead), each with the
  reference's fused-dispatch and lowering hooks.
- join: N→1 first-come forwarding without sync (gst/join/gstjoin.c).
- tensor_crop: crop a raw tensor stream using crop-info from a second
  flexible stream (gsttensor_crop.c: in-band dynamic shapes; output is
  flexible).  As in the JAX element, the frame and the regions are read
  on the host (:meth:`TensorBuffer.np`) and the crops are host arrays.
- datareposrc: file-based training-data source
  (gst/datarepo/gstdatareposrc.c: replayable datasets, e.g. MNIST .dat),
  on the port's native reader (:class:`~nnstreamer_tpu_torch.native.RepoReader`).
"""

from __future__ import annotations

import os
from fractions import Fraction
from typing import List, Optional

import numpy as np

from ..pipeline.caps import Caps
from ..pipeline.element import (CapsEvent, Element, EOSEvent, FlowReturn,
                                LoweredStep, Pad)
from ..pipeline.graph import Source
from ..pipeline.registry import register_element
from ..tensor.buffer import SECOND, TensorBuffer
from ..tensor.caps_util import (caps_from_config, config_from_caps,
                                flexible_tensors_caps, static_tensors_caps,
                                tensors_template_caps)
from ..tensor.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensor.meta import TensorMetaInfo
from ..tensor.types import TensorFormat, TensorType, dim_parse


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


@register_element
class Join(Element):
    """First-come N→1 forwarding, no sync (gst/join/gstjoin.c)."""

    FACTORY = "join"

    def _make_pads(self):
        self.add_src_pad(Caps.any(), "src")

    def request_sink_pad(self) -> Pad:
        return self.add_sink_pad(Caps.any())

    def start(self):
        self._caps_sent = False
        self._eos_count = 0

    def set_caps(self, pad, caps):
        if not self._caps_sent:
            self._caps_sent = True
            self.src_pad.push_event(CapsEvent(caps))

    def chain(self, pad, buf):
        return self.push(buf)

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            self._eos_count += 1
            if self._eos_count >= len(self.sink_pads):
                self.src_pad.push_event(EOSEvent())
            return
        super().on_event(pad, event)


@register_element
class TensorCrop(Element):
    """Crop raw tensors with crop-info from a second (flexible) stream.

    sink_0 = raw stream, sink_1 = crop info: each crop-info buffer holds a
    tensor of int32 [[x, y, w, h], ...] regions (reference flex-tensor crop
    info, gsttensor_crop.c:494-649).  Output: flexible stream, one cropped
    tensor per region.
    """

    FACTORY = "tensor_crop"
    PROPERTIES = {
        "lateness": (-1, "reference crop-info sync tolerance in ms "
                         "(accepted for launch-line parity; this crop "
                         "pairs raw/info buffers exactly by arrival "
                         "order)"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "raw")
        self.add_sink_pad(tensors_template_caps(), "info")
        self.add_src_pad(flexible_tensors_caps(), "src")

    def start(self):
        self._raw: List[TensorBuffer] = []
        self._info: List[TensorBuffer] = []
        self._announced = False
        self._eos = 0

    def set_caps(self, pad, caps):
        if not self._announced:
            self._announced = True
            rate = config_from_caps(caps).rate or Fraction(0, 1)
            self.announce_src_caps(caps_from_config(
                TensorsConfig(format=TensorFormat.FLEXIBLE, rate=rate)))

    def chain(self, pad, buf):
        (self._raw if pad.name == "raw" else self._info).append(buf)
        while self._raw and self._info:
            raw = self._raw.pop(0)
            info = self._info.pop(0)
            out = self._crop(raw, info)
            ret = self.push(out)
            if ret is FlowReturn.ERROR:
                return ret
        return FlowReturn.OK

    def _crop(self, raw: TensorBuffer, info: TensorBuffer) -> TensorBuffer:
        frame = raw.np(0)  # (H, W, C) video-like or (W,) 1-D
        regions = np.asarray(info.np(0)).reshape(-1, 4)
        tensors, metas = [], []
        for x, y, w, h in regions.astype(int):
            if frame.ndim >= 2:
                crop = frame[y:y + h, x:x + w]
            else:
                crop = frame[x:x + w]
            crop = np.ascontiguousarray(crop)
            tensors.append(crop)
            metas.append(TensorMetaInfo.from_info(TensorInfo.from_np(crop)))
        out = raw.with_tensors(tensors)
        out.metas = metas
        return out

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            self._eos += 1
            if self._eos >= 2:
                self.src_pad.push_event(EOSEvent())
            return
        if pad.name == "raw":
            super().on_event(pad, event)


@register_element
class DataRepoSrc(Source):
    """Replayable file dataset source (gstdatareposrc.c role): reads fixed-
    size frames from a binary file, announcing caps from input-dim/type."""

    FACTORY = "datareposrc"
    PROPERTIES = {
        "location": (None, "data file path"),
        "input-dim": (None, "frame dims, e.g. 1:1:784:1"),
        "input-type": (None, "frame dtype"),
        "epochs": (1, "number of passes over the file"),
        "framerate": ("0/1", "announced rate"),
    }

    def _make_pads(self):
        self.add_src_pad(static_tensors_caps(), "src")

    def start(self):
        if not self.location or not os.path.exists(str(self.location)):
            raise ValueError(f"{self.name}: bad location {self.location!r}")
        dims = [dim_parse(d) for d in str(self.input_dim).split(",")]
        types = [TensorType.from_string(t)
                 for t in str(self.input_type).split(",")]
        self._infos = TensorsInfo(
            [TensorInfo(t, d) for t, d in zip(types, dims)])
        self._frame_bytes = self._infos.total_size()
        # native prefetching reader (tensorwire reader.cc): file IO
        # overlaps pipeline compute with bounded memory; Python mmap
        # fallback without the .so
        from ..native import RepoReader

        try:
            self._reader = RepoReader(str(self.location),
                                      self._frame_bytes, capacity=8,
                                      wrap=True)
        except ValueError as e:
            raise ValueError(f"{self.name}: {e}") from e
        self._num_frames = self._reader.num_frames

    def stop(self):
        if getattr(self, "_reader", None) is not None:
            self._reader.close()
            self._reader = None
        super().stop()

    def negotiate(self) -> Caps:
        cfg = TensorsConfig(info=self._infos,
                            rate=Fraction(str(self.framerate)))
        return caps_from_config(cfg)

    def create(self) -> Optional[TensorBuffer]:
        reader = self._reader     # local ref: stop() may null the attr
        if reader is None:
            return None
        total = int(self.epochs) * self._num_frames
        got = reader.next_frame()
        if got is None or got[0] >= total:
            return None
        index, chunk = got
        tensors = []
        pos = 0
        for info in self._infos:
            raw = np.frombuffer(chunk, np.uint8, count=info.size, offset=pos)
            tensors.append(raw.view(info.np_dtype).reshape(info.np_shape))
            pos += info.size
        return TensorBuffer(tensors=tensors, pts=index * SECOND // 30)
