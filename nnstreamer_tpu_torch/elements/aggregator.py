"""tensor_aggregator: temporal batching/windowing of tensor streams.

Parity with gst/nnstreamer/elements/gsttensor_aggregator.c (fields at
gsttensor_aggregator.h:60-63): collect ``frames-in`` incoming frames,
emit windows of ``frames-out`` with hop ``frames-flush`` (0 = tumbling),
concatenated along ``frames-dim`` — e.g. 300:300 @30fps with frames-out=2
→ 300:300:2 @15fps.

This is also the framework's long-context streaming primitive: windows feed
sequence models, and with large ``frames-out`` a window is one batched
tensor for the model behind it.

The counterpart of ``nnstreamer_tpu/elements/aggregator.py``: windows are
built on the host through :meth:`TensorBuffer.np`, as in the JAX element.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..pipeline.element import Element, FlowReturn
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..tensor.caps_util import (caps_from_config, config_from_caps,
                                static_tensors_caps)
from ..tensor.info import TensorInfo, TensorsConfig, TensorsInfo


@register_element
class TensorAggregator(Element):
    FACTORY = "tensor_aggregator"
    PROPERTIES = {
        "frames-in": (1, "frames per incoming buffer along frames-dim"),
        "frames-out": (1, "frames per outgoing window"),
        "frames-flush": (0, "hop size in frames; 0 = frames-out (tumbling)"),
        "frames-dim": (None, "reference dim index to stack along; default "
                             "appends a new outermost dim"),
        "concat": (True, "concatenate (True) vs emit list of frames"),
    }

    def _make_pads(self):
        self.add_sink_pad(static_tensors_caps(), "sink")
        self.add_src_pad(static_tensors_caps(), "src")

    def start(self):
        self._window: List[np.ndarray] = []
        self._pts: List[int] = []
        fin, fout = int(self.frames_in), int(self.frames_out)
        if fin > 1 and self.frames_dim is None:
            raise ValueError(
                f"{self.name}: frames-in > 1 requires frames-dim")
        if fout % fin:
            raise ValueError(
                f"{self.name}: frames-out={fout} not a multiple of "
                f"frames-in={fin}")
        hop_frames = int(self.frames_flush) or fout
        if hop_frames % fin:
            raise ValueError(
                f"{self.name}: frames-flush={hop_frames} not a multiple of "
                f"frames-in={fin}")
        # buffer counts: each incoming buffer carries frames-in frames
        self._need_bufs = fout // fin
        self._hop_bufs = hop_frames // fin

    def set_caps(self, pad, caps):
        cfg = config_from_caps(caps)
        info = cfg.info[0]
        fin, fout = int(self.frames_in), int(self.frames_out)
        dims = list(info.dims)
        if self.frames_dim is None:
            dims = dims + [fout]
            self._axis_new = True
            self._dim = len(dims) - 1
        else:
            self._dim = int(self.frames_dim)
            self._axis_new = False
            if self._dim >= len(dims):
                # reference dims are 1-padded to the rank limit, so any
                # frames-dim up to rank 8 is addressable
                dims = dims + [1] * (self._dim + 1 - len(dims))
            per_buf = dims[self._dim]
            dims[self._dim] = per_buf * fout // max(fin, 1)
        rate = cfg.rate
        if rate and fout:
            hop = int(self.frames_flush) or fout
            rate = rate / hop
        out = TensorsConfig(
            info=TensorsInfo([TensorInfo(info.dtype, tuple(dims))]),
            rate=rate)
        self.announce_src_caps(caps_from_config(out))

    def chain(self, pad, buf):
        self._window.append(buf.np(0))
        self._pts.append(buf.pts or 0)
        need = self._need_bufs
        if len(self._window) < need:
            return FlowReturn.OK
        if self._axis_new:
            merged = np.stack(self._window[:need], axis=0)
        else:
            frames = [f.reshape((1,) * (self._dim + 1 - f.ndim) + f.shape)
                      if f.ndim <= self._dim else f
                      for f in self._window[:need]]
            axis = frames[0].ndim - 1 - self._dim
            merged = np.concatenate(frames, axis=axis)
        out = TensorBuffer(tensors=[merged], pts=self._pts[0],
                           duration=buf.duration)
        self._window = self._window[self._hop_bufs:]
        self._pts = self._pts[self._hop_bufs:]
        return self.push(out)
