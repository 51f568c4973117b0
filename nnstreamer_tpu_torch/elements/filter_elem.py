"""tensor_filter: THE inference element.

The counterpart of ``nnstreamer_tpu/elements/filter_elem.py``, with its
parity to gst/nnstreamer/tensor_filter/tensor_filter.c (+ the shared
property/lifecycle logic of tensor_filter_common.c):

- properties: framework (incl. ``auto``), model, forced input/output
  dims/types, accelerator string, custom properties, input-combination /
  output-combination, latency/throughput readouts, shared key, is-updatable
  (reference property table tensor_filter_common.c)
- start() opens the backend (reference :1492-1504 → open_fw :2420)
- caps: sink accepts static tensors; src caps derived from model output info
  (reference transform_caps/configure :902-1280), with per-buffer
  validation in the hot loop (:557-626)
- hot loop (reference transform :631-894): validate → input-combination →
  invoke → output-combination/wrap → push, keeping device tensors unsynced
- model-update custom event (``tensor_filter_update_model``) triggers
  backend reload (reference :1413-1446)

The port runs one frame per invoke.  The JAX package's micro-batching
(``batch>1``, ``batch-timeout-ms``, ``inflight``), its cross-stream
batcher, the ``workers`` invoke pool and ``output-device`` cascades are
not ported yet: ``batch>1`` raises a :class:`FilterError` at start.
"""

from __future__ import annotations

from typing import List, Optional

from ..filter.framework import (Accelerator, FilterError, FilterProperties,
                                close_backend, open_backend)
from ..pipeline.element import CustomEvent, Element, FlowReturn, QoSEvent
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..tensor.caps_util import (caps_from_config, config_from_caps,
                                static_tensors_caps)
from ..tensor.info import TensorsConfig, TensorsInfo


def _parse_combination(s) -> Optional[List[int]]:
    if s in (None, ""):
        return None
    return [int(x) for x in str(s).split(",")]


@register_element
class TensorFilter(Element):
    FACTORY = "tensor_filter"
    PROPERTIES = {
        "framework": ("auto", "backend name or auto"),
        "model": (None, "model name/path/object"),
        "input-dim": (None, "forced input dims"),
        "input-type": (None, "forced input types"),
        "output-dim": (None, "forced output dims"),
        "output-type": (None, "forced output types"),
        "accelerator": (None, "e.g. true:gpu, or true:cpu for the CPU"),
        "custom": (None, "key:value,... custom properties"),
        "inputname": (None, "graph input tensor name(s) (reference "
                            "property; merged into custom props)"),
        "outputname": (None, "graph output tensor name(s)"),
        "inputlayout": (None, "reference per-tensor layout hints "
                              "(NHWC/NCHW/ANY/NONE) — accepted and "
                              "forwarded to the backend custom props"),
        "outputlayout": (None, "see inputlayout"),
        "inputranks": (None, "reference READABLE property: rank per "
                             "input tensor of the opened model"),
        "outputranks": (None, "reference READABLE property: rank per "
                              "output tensor"),
        "sub-plugins": (None, "reference READABLE property: registered "
                              "filter backends"),
        # "latency"/"throughput" (reference READABLE stats) are python
        # properties on this class — get_property reaches them via
        # getattr, so they must NOT appear here (the defaults loop
        # would try to assign the read-only descriptors)
        "input-combination": (None, "indices of input tensors to feed"),
        "output-combination": (None, "i0,i1/o0,o1 passthrough+output mix"),
        "shared-tensor-filter-key": (None, "share backend across instances"),
        "is-updatable": (False, "allow model-update events"),
        "latency-report": (False, "report invoke latency"),
        "batch": (1, "frames per device invoke; only 1 is ported"),
    }

    #: the reference's own property names for the same settings
    #: (gsttensor_filter_common: "input"/"inputtype"/"output"/
    #: "outputtype" set forced dims/types)
    REFERENCE_PROP_ALIASES = {
        "input": "input-dim", "inputtype": "input-type",
        "output": "output-dim", "outputtype": "output-type",
    }

    #: reference G_PARAM_READABLE-only properties (enforced by
    #: Element.set_property)
    READONLY_PROPERTIES = ("sub-plugins", "inputranks", "outputranks",
                           "latency", "throughput")

    def set_property(self, key, value):
        super().set_property(self.REFERENCE_PROP_ALIASES.get(key, key),
                             value)

    def get_property(self, key):
        key = self.REFERENCE_PROP_ALIASES.get(key, key)
        if key in ("sub-plugins", "sub_plugins"):
            from ..filter.framework import list_filters

            return ",".join(list_filters())   # registry is sorted
        if key in ("inputranks", "outputranks"):
            fw = getattr(self, "fw", None)
            if fw is None:
                return ""
            in_info, out_info = fw.get_model_info()
            info = in_info if key == "inputranks" else out_info
            return ",".join(str(len(t.dims)) for t in info)
        return super().get_property(key)

    def _make_pads(self):
        self.add_sink_pad(static_tensors_caps(), "sink")
        self.add_src_pad(static_tensors_caps(), "src")

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        batch = int(self.batch or 1)
        if batch > 1:
            raise FilterError(
                f"{self.name}: batch={batch}: micro-batching is not yet "
                "ported to the PyTorch package (run batch=1)")
        in_info = out_info = None
        if self.input_dim and self.input_type:
            in_info = TensorsInfo.from_strings(str(self.input_dim),
                                               str(self.input_type))
        if self.output_dim and self.output_type:
            out_info = TensorsInfo.from_strings(str(self.output_dim),
                                                str(self.output_type))
        custom = FilterProperties.parse_custom(self.custom)
        # "inputname=data" / "outputname=prob" (and the layout hints)
        # are first-class reference properties; backends read them from
        # the custom map
        for key in ("inputname", "outputname", "inputlayout",
                    "outputlayout"):
            val = getattr(self, key, None)
            if val not in (None, "") and key not in custom:
                custom[key] = str(val)
        props = FilterProperties(
            framework=str(self.framework or "auto"), model=self.model,
            input_info=in_info, output_info=out_info,
            accelerators=Accelerator.parse(self.accelerator),
            custom_properties=custom,
            shared_key=self.shared_tensor_filter_key)
        self.fw = open_backend(props)
        self._props = props
        self.stats = getattr(self.fw, "stats", None)
        self._in_comb = _parse_combination(self.input_combination)
        self._throttle_ns = 0          # QoS-driven drop interval
        self._last_kept_pts: Optional[int] = None
        self.dropped = 0               # frames throttle-dropped
        self._out_comb = None
        if self.output_combination not in (None, ""):
            ins, _, outs = str(self.output_combination).partition("/")
            self._out_comb = (_parse_combination(ins) or [],
                              _parse_combination(outs) or [])
        self._pushdown = None           # fn of a fused device reduction

    def stop(self):
        close_backend(getattr(self, "fw", None), self._props)
        self.fw = None

    # -- negotiation ---------------------------------------------------------
    def set_caps(self, pad, caps):
        in_cfg = config_from_caps(caps)
        model_in, model_out = self.fw.get_model_info()
        if self._in_comb is not None:
            expect_sel = TensorsInfo([in_cfg.info[i] for i in self._in_comb])
            if not expect_sel.is_equal(model_in):
                raise ValueError(
                    f"{self.name}: input-combination {self._in_comb} gives "
                    f"{expect_sel}, model wants {model_in}")
        elif not in_cfg.info.is_equal(model_in):
            # try dynamic renegotiation (reference SET_INPUT_INFO path)
            try:
                _, model_out = self.fw.set_input_info(in_cfg.info)
            except FilterError:
                raise ValueError(
                    f"{self.name}: incoming {in_cfg.info} != model "
                    f"input {model_in}") from None
        self._in_config = in_cfg
        out_infos = model_out
        if self._out_comb is not None:
            ins, outs = self._out_comb
            combined = [in_cfg.info[i] for i in ins] + \
                       [model_out[i] for i in outs]
            out_infos = TensorsInfo(combined)
        self._out_config = TensorsConfig(info=out_infos, rate=in_cfg.rate)
        self.announce_src_caps(caps_from_config(self._out_config))

    # -- hot loop ------------------------------------------------------------
    def _preprocess(self, buf: TensorBuffer):
        """QoS throttle-drop + per-buffer validation + input-combination.
        Returns the selected input tensor list, or ``FlowReturn.DROPPED``."""
        # QoS throttle-drop (reference :609): after a downstream QoS event,
        # drop frames arriving faster than the reported consumption rate
        if self._throttle_ns and buf.pts is not None:
            last = self._last_kept_pts
            if last is not None and buf.pts - last < self._throttle_ns:
                self.dropped += 1
                return FlowReturn.DROPPED
            self._last_kept_pts = buf.pts
        elif buf.pts is not None:
            self._last_kept_pts = buf.pts
        # per-buffer validation against negotiated meta (reference :557-626)
        in_info = self._in_config.info
        if buf.num_tensors != in_info.num_tensors:
            raise ValueError(
                f"{self.name}: buffer has {buf.num_tensors} tensors, "
                f"negotiated {in_info.num_tensors}")
        tensors = buf.tensors
        if self._in_comb is not None:
            tensors = [tensors[i] for i in self._in_comb]
        return tensors

    def chain(self, pad, buf: TensorBuffer) -> FlowReturn:
        fw = self.fw
        if fw is None or not fw.opened:
            raise RuntimeError(f"{self.name}: not started")
        tensors = self._preprocess(buf)
        if tensors.__class__ is FlowReturn:
            return tensors
        outs = fw.invoke(list(tensors))
        return self.push(self._compose_output(buf, list(outs)))

    def _compose_output(self, buf: TensorBuffer, outs) -> TensorBuffer:
        out_tensors = outs
        if self._out_comb is not None:
            ins, sel = self._out_comb
            out_tensors = [buf.tensors[i] for i in ins] + \
                          [outs[i] for i in sel]
        return buf.with_tensors(out_tensors)

    # -- events --------------------------------------------------------------
    def on_upstream_event(self, pad, event):
        if isinstance(event, QoSEvent):
            # Reference src_event QOS handling (:1454-1485): derive a
            # throttling interval from the reported slowdown and the
            # stream's frame cadence; a catch-up report (jitter <= 0)
            # clears it.  Also auto-enables latency accounting.
            if event.jitter_ns <= 0:
                self._throttle_ns = 0
            else:
                rate = getattr(self, "_in_config", None)
                rate = rate.rate if rate is not None else None
                if rate and rate > 0:
                    frame_ns = (1_000_000_000 * rate.denominator
                                // rate.numerator)
                elif event.proportion > 1.0:
                    # jitter = dur·(proportion-1) at the reporter, so the
                    # frame duration is recoverable even without caps rate
                    frame_ns = max(
                        int(event.jitter_ns / (event.proportion - 1.0)), 1)
                else:
                    frame_ns = max(event.jitter_ns, 1)
                self._throttle_ns = int(frame_ns * max(1.0,
                                                       event.proportion))
                self.latency_report = True
            # keep propagating so upstream sources can throttle too — the
            # filter is a participant, not the owner
            super().on_upstream_event(pad, event)
            return True
        if isinstance(event, CustomEvent) and \
                event.name == "nns/device-reduce":
            # Reduction pushdown from a downstream decoder: compose its
            # device reduction into the backend's forward and re-announce
            # the (smaller) output caps.  The new caps travel in-band, and
            # decoders dispatch on actual tensor shapes.
            if self._out_comb is not None:
                # output-combination re-indexes/mixes the model outputs
                # AFTER invoke; a reduction computed against the combined
                # view cannot be fused onto the raw outputs
                return False
            fn = event.data["fn"]
            if not self._fuse(fn):
                return False
            # remember the fusion: a model reload rebuilds the backend
            # (close+open), which would silently drop the device-fused
            # tail back to host decode — the update handler re-applies it
            self._pushdown = fn
            self._out_config = TensorsConfig(info=event.data["out_info"],
                                             rate=self._in_config.rate)
            self.announce_src_caps(caps_from_config(self._out_config))
            return True
        return super().on_upstream_event(pad, event)

    def on_event(self, pad, event):
        if isinstance(event, CustomEvent) and \
                event.name == "tensor_filter_update_model":
            if not self.is_updatable:
                raise RuntimeError(f"{self.name}: not is-updatable")
            try:
                self.fw.handle_event("reload_model", event.data)
            except Exception as exc:  # noqa: BLE001
                # a rejected reload keeps the old model serving — log and
                # keep streaming instead of erroring the pipeline (unless
                # the backend could not be restored at all)
                from ..utils.log import ml_logw

                if not self.fw.opened:
                    raise
                ml_logw("%s: model reload rejected, keeping old model: %s",
                        self.name, exc)
            self._reapply_pushdown()
            return  # consumed, like the reference custom-event sink
        super().on_event(pad, event)

    def _fuse(self, fn) -> bool:
        """Compose a decoder's reduction into the backend's forward and
        compile the fused forward now (on the card: capture its graph),
        so that the next frame, the stream's first, finds it warm."""
        if not self.fw.set_postprocess(fn):
            return False
        warmup = getattr(self.fw, "warmup", None)
        if warmup is not None:
            warmup()
        return True

    def _reapply_pushdown(self) -> None:
        """Restore a device-fused decoder reduction after a model reload:
        a close+open swap rebuilt the backend WITHOUT the fused tail.  The
        reload interface check guarantees the model's tensor io is
        unchanged, so the stored reduction still applies.  If the fresh
        backend refuses the fusion, fall back loudly to the full output
        caps (decoders dispatch on actual shapes, so correctness holds
        either way)."""
        if self._pushdown is None or not getattr(self.fw, "opened", False):
            return
        if self.fw.has_postprocess():
            # the backend kept its fusion: re-fusing would compose the
            # reduction over the already-reduced outputs
            return
        if self._fuse(self._pushdown):
            return
        from ..utils.log import ml_logw

        ml_logw("%s: device-reduce fusion could not be re-applied after "
                "reload; serving full outputs (host decode)", self.name)
        self._pushdown = None
        _, model_out = self.fw.get_model_info()
        self._out_config = TensorsConfig(info=model_out,
                                         rate=self._in_config.rate)
        self.announce_src_caps(caps_from_config(self._out_config))

    def report_latency(self) -> int:
        """LATENCY-query contribution: rolling average invoke latency in ns
        when latency-report is on (reference tensor_filter.c:1313-1377)."""
        if not self.latency_report:
            return 0
        lat_us = self.latency
        return lat_us * 1000 if lat_us > 0 else 0

    # -- stats readout (reference readable props :2163-2171) -----------------
    @property
    def latency(self) -> int:
        stats = getattr(self, "stats", None)
        return stats.latency_us if stats else -1

    @property
    def throughput(self) -> float:
        stats = getattr(self, "stats", None)
        return stats.throughput if stats else 0.0
