"""tensor_if: data-dependent stream routing.

Parity with gst/nnstreamer/elements/gsttensor_if.c (enums at
gsttensor_if.h:42-141): a compared value (per-tensor value / tensor
average / custom callback) tested with an operator against supplied
operand(s) routes each buffer to the ``then`` or ``else`` behavior:
passthrough, skip, fill-zero, or tensorpick on two src pads (src_0 = then,
src_1 = else when both linked).

The counterpart of ``nnstreamer_tpu/elements/tensor_if.py``: the compared
value and ``fill-zero`` read the host through :meth:`TensorBuffer.np`, as
in the JAX element; ``passthrough`` and ``tensorpick`` hand the payload
handles on (a device tensor stays on the device).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from ..pipeline.element import Element, FlowReturn, Pad
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..tensor.caps_util import static_tensors_caps

_OPS = {
    "eq": lambda v, a, b: v == a,
    "ne": lambda v, a, b: v != a,
    "gt": lambda v, a, b: v > a,
    "ge": lambda v, a, b: v >= a,
    "lt": lambda v, a, b: v < a,
    "le": lambda v, a, b: v <= a,
    "range-inclusive": lambda v, a, b: a <= v <= b,
    "range-exclusive": lambda v, a, b: a < v < b,
    "not-in-range-inclusive": lambda v, a, b: not (a <= v <= b),
    "not-in-range-exclusive": lambda v, a, b: not (a < v < b),
}

_CUSTOM_CONDS: dict = {}


def _norm(value, aliases: Optional[dict] = None) -> str:
    """Reference launch lines spell tensor_if enum values in
    UPPER_SNAKE (compared-value=A_VALUE operator=RANGE_INCLUSIVE
    then=PASSTHROUGH — every ssat script does); normalize to this
    module's lower-hyphen names so verbatim lines run."""
    k = str(value).strip().lower().replace("_", "-")
    return (aliases or {}).get(k, k)


#: reference nick → this module's name, post-normalization
_CV_ALIASES = {"tensor-average-value": "tensor-average"}
_BEHAVIOR_ALIASES = {"fill-with-zero": "fill-zero"}


def register_if_custom(name: str, fn: Callable[[TensorBuffer], bool]) -> None:
    """Custom condition callback (reference tensor_if.h custom API)."""
    _CUSTOM_CONDS[name] = fn


@register_element
class TensorIf(Element):
    FACTORY = "tensor_if"
    PROPERTIES = {
        "compared-value": ("a-value", "a-value|tensor-average|custom"),
        "compared-value-option": (None, "e.g. '0:0:0:0,0' index or tensor idx"),
        "supplied-value": (None, "operand(s), comma separated"),
        "operator": ("gt", "|".join(_OPS)),
        "then": ("passthrough", "passthrough|skip|fill-zero|tensorpick"),
        "then-option": (None, "tensorpick indices"),
        "else": ("skip", "passthrough|skip|fill-zero|tensorpick"),
        "else-option": (None, "tensorpick indices"),
    }

    def _make_pads(self):
        self.add_sink_pad(static_tensors_caps(), "sink")
        self.add_src_pad(static_tensors_caps(), "src_0")

    def request_src_pad(self) -> Pad:
        if len(self.src_pads) >= 2:
            raise ValueError("tensor_if has at most 2 src pads")
        return self.add_src_pad(static_tensors_caps(), "src_1")

    def start(self):
        # enum spellings resolve ONCE here (the chain() hot path must
        # not re-normalize per buffer), and bad spellings fail the
        # pipeline at start, not mid-stream
        op = _norm(self.operator)
        if op not in _OPS:
            raise ValueError(f"unknown operator {self.operator}")
        self._op = _OPS[op]
        self._cv = _norm(self.compared_value, _CV_ALIASES)
        if self._cv not in ("a-value", "tensor-average", "custom"):
            raise ValueError(
                f"unknown compared-value {self.compared_value!r}")
        self._then = _norm(self.then, _BEHAVIOR_ALIASES)
        self._else = _norm(getattr(self, "else"), _BEHAVIOR_ALIASES)
        for raw, b in ((self.then, self._then),
                       (getattr(self, "else"), self._else)):
            if b not in ("passthrough", "skip", "fill-zero",
                         "tensorpick"):
                raise ValueError(f"unknown behavior {raw!r}")
        sup = str(self.supplied_value or "0")
        vals = [float(x) for x in sup.split(",")]
        self._a = vals[0]
        self._b = vals[1] if len(vals) > 1 else vals[0]

    def set_property(self, key, value):
        super().set_property(key, value)
        # properties stay runtime-mutable (GObject semantics): a set
        # on a PLAYING element re-resolves the enum snapshot start()
        # froze for the hot path
        if hasattr(self, "_op") and key in (
                "operator", "compared-value", "then", "else",
                "supplied-value"):
            self.start()

    def _compared_value(self, buf: TensorBuffer) -> float:
        cv = self._cv
        opt = self.compared_value_option
        if cv == "custom":
            fn = _CUSTOM_CONDS.get(str(opt))
            if fn is None:
                raise ValueError(f"custom condition {opt!r} not registered")
            return fn(buf)
        if cv == "tensor-average":
            idx = int(opt) if opt not in (None, "") else 0
            return float(np.mean(buf.np(idx)))
        # a-value: "i0:i1:...,tensor_idx" picks one element
        if opt in (None, ""):
            return float(np.ravel(buf.np(0))[0])
        coord_s, _, tidx = str(opt).partition(",")
        tensor = buf.np(int(tidx) if tidx else 0)
        coords = tuple(int(x) for x in coord_s.split(":"))
        # reference coords are innermost-first; numpy index is reversed
        np_idx = tuple(reversed(coords))[-tensor.ndim:]
        return float(tensor[np_idx])

    def _apply_behavior(self, behavior: str, option, buf: TensorBuffer
                        ) -> Optional[TensorBuffer]:
        if behavior == "passthrough":
            return buf
        if behavior == "skip":
            return None
        if behavior == "fill-zero":
            return buf.with_tensors(
                [np.zeros_like(buf.np(i)) for i in range(buf.num_tensors)])
        if behavior == "tensorpick":
            picks = [int(x) for x in str(option).split(",")]
            return buf.with_tensors([buf.tensors[i] for i in picks])
        raise ValueError(f"unknown behavior {behavior!r}")

    def chain(self, pad, buf):
        v = self._compared_value(buf)
        cond = bool(self._op(v, self._a, self._b))
        if cond:
            out = self._apply_behavior(self._then, self.then_option, buf)
            target = self.src_pads[0]
        else:
            out = self._apply_behavior(self._else, self.else_option, buf)
            target = (self.src_pads[1] if len(self.src_pads) > 1
                      else self.src_pads[0])
        if out is None:
            return FlowReturn.DROPPED
        return target.push(out)

    def set_caps(self, pad, caps):
        from ..pipeline.element import CapsEvent
        from ..tensor.caps_util import caps_from_config, config_from_caps
        from ..tensor.info import TensorsConfig, TensorsInfo

        cfg = config_from_caps(caps)
        behaviors = [(self._then, self.then_option),
                     (self._else, self.else_option)]
        for sp, (behavior, option) in zip(self.src_pads, behaviors):
            if behavior == "tensorpick" and cfg.info.num_tensors:
                picks = [int(x) for x in str(option).split(",")]
                out = TensorsConfig(
                    info=TensorsInfo([cfg.info[i].copy() for i in picks]),
                    rate=cfg.rate)
                sp.push_event(CapsEvent(caps_from_config(out)))
            else:
                sp.push_event(CapsEvent(caps))
