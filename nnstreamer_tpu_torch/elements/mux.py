"""tensor_mux / tensor_demux: frame composition and decomposition.

Parity with gst/nnstreamer/elements/gsttensor_mux.c (N streams → one
multi-tensor frame, PTS-synced via the policies of
:mod:`nnstreamer_tpu_torch.pipeline.clock`) and gsttensor_demux.c (one
frame → N streams, with ``tensorpick`` selection).  The counterpart of
``nnstreamer_tpu/elements/mux.py``: the demux regroups payload handles,
so a device tensor from a filter passes through without a copy.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Optional

from ..pipeline.clock import CollectPads, SyncMode, parse_sync_option
from ..pipeline.element import CapsEvent, Element, EOSEvent, FlowReturn, Pad
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..tensor.caps_util import (caps_from_config, config_from_caps,
                                static_tensors_caps, tensors_template_caps)
from ..tensor.info import TensorsConfig, TensorsInfo


@register_element
class TensorMux(Element):
    FACTORY = "tensor_mux"
    PROPERTIES = {
        "sync-mode": ("slowest", "nosync|slowest|basepad|refresh"),
        "sync-option": (None, "basepad: '<pad>:<duration_ns>'"),
    }

    def _make_pads(self):
        self.add_src_pad(static_tensors_caps(), "src")

    def request_sink_pad(self) -> Pad:
        return self.add_sink_pad(static_tensors_caps())

    def start(self):
        import threading

        dur, base_pad = parse_sync_option(self.sync_option)
        self._collect = CollectPads(len(self.sink_pads),
                                    SyncMode.from_string(self.sync_mode), dur,
                                    base_pad=base_pad)
        self._pad_index = {p.name: i for i, p in enumerate(self.sink_pads)}
        self._pad_configs: Dict[int, TensorsConfig] = {}
        self._announced = False
        self._sent_eos = False
        self._eos_lock = threading.Lock()

    # -- negotiation: src caps = concatenation of all sink infos -------------
    def set_caps(self, pad, caps):
        idx = self._pad_index[pad.name]
        self._pad_configs[idx] = config_from_caps(caps)
        if len(self._pad_configs) == len(self.sink_pads) and not self._announced:
            infos: List = []
            for i in range(len(self.sink_pads)):
                infos.extend(self._pad_configs[i].info)
            rate = self._pad_configs[0].rate or Fraction(0, 1)
            cfg = TensorsConfig(info=TensorsInfo(list(infos)), rate=rate)
            self._announced = True
            self.announce_src_caps(caps_from_config(cfg))

    def chain(self, pad, buf):
        idx = self._pad_index[pad.name]
        if self._sent_eos:
            return FlowReturn.EOS
        frame_set = self._collect.push(idx, buf)
        if frame_set is None:
            return FlowReturn.OK
        ret = self.push(self._combine(frame_set))
        # an EOS'd pad may just have drained: the stream ends now
        # (reference is_eos re-check per collect, gsttensor_mux.c:505-513)
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
        tensors = []
        for b in frame_set:
            tensors.extend(b.tensors)
        pts = max((b.pts or 0) for b in frame_set)
        return TensorBuffer(tensors=tensors, pts=pts,
                            duration=frame_set[0].duration)

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            idx = self._pad_index[pad.name]
            if self._collect.set_eos(idx):
                self._send_eos_once()
            else:
                # all pads EOS but not exhausted (basepad/refresh base
                # backlog): drain what the policy can still form, then end
                leftover = self._collect.finalize()
                if leftover is not None:
                    for fs in leftover:
                        self.push(self._combine(fs))
                    self._send_eos_once()
            return
        # forward non-EOS events once (from pad 0 only, to avoid duplicates)
        if self._pad_index[pad.name] == 0:
            super().on_event(pad, event)


@register_element
class TensorDemux(Element):
    FACTORY = "tensor_demux"
    PROPERTIES = {
        "tensorpick": (None, "comma list: which tensors to expose, in order; "
                             "supports 'i' or 'i:j:k' groups per src pad"),
    }

    def _make_pads(self):
        self.add_sink_pad(static_tensors_caps(), "sink")

    def request_src_pad(self) -> Pad:
        return self.add_src_pad(static_tensors_caps())

    def _parse_picks(self) -> Optional[List[List[int]]]:
        """One parser for start() AND static_check(): the verifier must
        judge exactly the syntax the runtime accepts."""
        if self.tensorpick in (None, ""):
            return None
        return [[int(x) for x in grp.split(":")]
                for grp in str(self.tensorpick).split(",")]

    def start(self):
        self._picks = self._parse_picks()

    def static_check(self):
        """Verifier hook: a tensorpick that declares fewer groups than
        this demux has linked src pads is the exact mismatch set_caps
        rejects at negotiation — catch it pre-play."""
        try:
            picks = self._parse_picks()
        except ValueError:
            return [("error", f"{self.name}: unparsable tensorpick "
                              f"{self.tensorpick!r}")]
        if picks is not None and len(picks) < len(self.src_pads):
            return [("error",
                     f"{self.name}: {len(self.src_pads)} src pads but "
                     f"tensorpick declares only {len(picks)} tensor "
                     "groups — negotiation would fail")]
        return []

    def _groups(self, num_tensors: int) -> List[List[int]]:
        if self._picks is not None:
            return self._picks
        return [[i] for i in range(num_tensors)]

    def set_caps(self, pad, caps):
        cfg = config_from_caps(caps)
        groups = self._groups(cfg.info.num_tensors)
        if len(groups) < len(self.src_pads):
            raise ValueError(
                f"{self.name}: {len(self.src_pads)} src pads but only "
                f"{len(groups)} tensor groups")
        for sp, grp in zip(self.src_pads, groups):
            infos = TensorsInfo([cfg.info[i].copy() for i in grp])
            out = TensorsConfig(info=infos, rate=cfg.rate)
            sp.push_event(CapsEvent(caps_from_config(out)))

    def chain(self, pad, buf):
        groups = self._groups(buf.num_tensors)
        for sp, grp in zip(self.src_pads, groups):
            out = buf.with_tensors([buf.tensors[i] for i in grp])
            ret = sp.push(out)
            if ret is FlowReturn.ERROR:
                return ret
        return FlowReturn.OK
