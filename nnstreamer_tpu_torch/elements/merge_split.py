"""tensor_merge / tensor_split: dimension-wise concatenation and slicing.

Parity with gst/nnstreamer/elements/gsttensor_merge.c (N single-tensor
streams → one tensor concatenated along a dimension, PTS-synced) and
gsttensor_split.c (one tensor → N streams sliced by ``tensorseg``).

The counterpart of ``nnstreamer_tpu/elements/merge_split.py``: both
elements compute on the host through :meth:`TensorBuffer.np`, as the JAX
elements do (a device tensor from a filter is read back once).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List

import numpy as np

from ..pipeline.clock import CollectPads, SyncMode, parse_sync_option
from ..pipeline.element import CapsEvent, Element, EOSEvent, FlowReturn, Pad
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..tensor.caps_util import (caps_from_config, config_from_caps,
                                static_tensors_caps)
from ..tensor.info import TensorInfo, TensorsConfig, TensorsInfo


@register_element
class TensorMerge(Element):
    """mode=linear option=<dim> concatenates along the reference dim index
    (innermost-first), i.e. numpy axis ``ndim-1-dim``."""

    FACTORY = "tensor_merge"
    PROPERTIES = {
        "mode": ("linear", "only 'linear' (like the reference's main mode)"),
        "option": (0, "reference dim index to concat along"),
        "sync-mode": ("slowest", "nosync|slowest|basepad|refresh"),
        "sync-option": (None, "basepad: '<pad>:<duration_ns>'"),
    }

    def _make_pads(self):
        self.add_src_pad(static_tensors_caps(), "src")

    def request_sink_pad(self) -> Pad:
        return self.add_sink_pad(static_tensors_caps())

    def start(self):
        import threading

        if str(self.mode) != "linear":
            raise ValueError(f"{self.name}: unsupported mode {self.mode}")
        self._dim = int(self.option)
        dur, base_pad = parse_sync_option(self.sync_option)
        self._collect = CollectPads(len(self.sink_pads),
                                    SyncMode.from_string(self.sync_mode),
                                    dur, base_pad=base_pad)
        self._pad_index = {p.name: i for i, p in enumerate(self.sink_pads)}
        self._pad_configs: Dict[int, TensorsConfig] = {}
        self._announced = False
        self._sent_eos = False
        self._eos_lock = threading.Lock()

    def set_caps(self, pad, caps):
        idx = self._pad_index[pad.name]
        cfg = config_from_caps(caps)
        if cfg.info.num_tensors != 1:
            raise ValueError(f"{self.name}: merge needs single-tensor pads")
        self._pad_configs[idx] = cfg
        if len(self._pad_configs) == len(self.sink_pads) and not self._announced:
            base = self._pad_configs[0].info[0]
            total = 0
            for i in range(len(self.sink_pads)):
                info = self._pad_configs[i].info[0]
                dims = list(info.dims) + [1] * (len(base.dims) - len(info.dims))
                total += dims[self._dim] if self._dim < len(dims) else 1
            out_dims = list(base.dims)
            while len(out_dims) <= self._dim:
                out_dims.append(1)
            out_dims[self._dim] = total
            cfg_out = TensorsConfig(
                info=TensorsInfo([TensorInfo(base.dtype, tuple(out_dims))]),
                rate=self._pad_configs[0].rate or Fraction(0, 1))
            self._announced = True
            self.announce_src_caps(caps_from_config(cfg_out))

    def chain(self, pad, buf):
        idx = self._pad_index[pad.name]
        if self._sent_eos:
            return FlowReturn.EOS
        frame_set = self._collect.push(idx, buf)
        if frame_set is None:
            return FlowReturn.OK
        ret = self.push(self._combine(frame_set))
        if self._collect.exhausted():
            self._send_eos_once()
            return FlowReturn.EOS
        return ret

    def _send_eos_once(self) -> None:
        with self._eos_lock:
            if self._sent_eos:
                return
            self._sent_eos = True
        self.src_pad.push_event(EOSEvent())

    def _combine(self, frame_set: List[TensorBuffer]) -> TensorBuffer:
        arrays = [b.np(0) for b in frame_set]
        # the concat dim may address a padded NNS dim beyond the true
        # rank (reference 'option=2' on rank-1 tensors; set_caps pads
        # the announced dims the same way) — NNS trailing dims are
        # LEADING numpy axes, so pad with leading 1-axes to cover it
        nd = max(arrays[0].ndim, self._dim + 1)
        arrays = [a.reshape((1,) * (nd - a.ndim) + a.shape)
                  for a in arrays]
        axis = nd - 1 - self._dim
        merged = np.concatenate(arrays, axis=axis)
        pts = max((b.pts or 0) for b in frame_set)
        return TensorBuffer(tensors=[merged], pts=pts,
                            duration=frame_set[0].duration)

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            if self._collect.set_eos(self._pad_index[pad.name]):
                self._send_eos_once()
            else:
                leftover = self._collect.finalize()
                if leftover is not None:
                    for fs in leftover:
                        self.push(self._combine(fs))
                    self._send_eos_once()
            return
        if self._pad_index[pad.name] == 0:
            super().on_event(pad, event)


@register_element
class TensorSplit(Element):
    """tensorseg=a,b,c slices the innermost-first dim 0... reference uses
    ``tensorseg`` as dim-sized chunks along a dimension (gsttensor_split.c);
    here ``option`` gives the reference dim and ``tensorseg`` the chunk
    sizes."""

    FACTORY = "tensor_split"
    PROPERTIES = {
        "tensorseg": (None, "comma list of slice sizes"),
        "option": (0, "reference dim index to slice along"),
    }

    def _make_pads(self):
        self.add_sink_pad(static_tensors_caps(), "sink")

    def request_src_pad(self) -> Pad:
        return self.add_src_pad(static_tensors_caps())

    def start(self):
        if self.tensorseg in (None, ""):
            raise ValueError(f"{self.name}: tensorseg required")
        self._segs = [int(x) for x in str(self.tensorseg).split(",")]
        self._dim = int(self.option)

    def set_caps(self, pad, caps):
        cfg = config_from_caps(caps)
        info = cfg.info[0]
        if sum(self._segs) != info.dims[self._dim]:
            raise ValueError(
                f"{self.name}: tensorseg sums to {sum(self._segs)}, dim is "
                f"{info.dims[self._dim]}")
        if len(self.src_pads) != len(self._segs):
            raise ValueError(
                f"{self.name}: {len(self.src_pads)} pads vs "
                f"{len(self._segs)} segments")
        for sp, seg in zip(self.src_pads, self._segs):
            dims = list(info.dims)
            dims[self._dim] = seg
            out = TensorsConfig(
                info=TensorsInfo([TensorInfo(info.dtype, tuple(dims))]),
                rate=cfg.rate)
            sp.push_event(CapsEvent(caps_from_config(out)))

    def chain(self, pad, buf):
        arr = buf.np(0)
        axis = arr.ndim - 1 - self._dim
        off = 0
        for sp, seg in zip(self.src_pads, self._segs):
            sl = [slice(None)] * arr.ndim
            sl[axis] = slice(off, off + seg)
            ret = sp.push(buf.with_tensors([np.ascontiguousarray(arr[tuple(sl)])]))
            if ret is FlowReturn.ERROR:
                return ret
            off += seg
        return FlowReturn.OK
