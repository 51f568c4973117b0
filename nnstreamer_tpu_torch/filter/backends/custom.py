"""Custom filter backends: user-supplied Python callables/classes.

The port of ``nnstreamer_tpu/filter/backends/custom.py``: host backends,
their payloads numpy (a CUDA tensor input is copied to the host first).

Parity with the reference's custom filter family (SURVEY.md §2.2):

- ``custom``: a user *class* with get_input/output info + invoke, the
  analogue of the dlopen'd ``NNStreamer_custom_class``
  (gst/nnstreamer/include/tensor_filter_custom.h) — here any Python object
  with the right methods, passed as ``model``.
- ``custom-easy``: in-process registration of a plain function + fixed
  in/out infos (gst/nnstreamer/include/tensor_filter_custom_easy.h
  NNS_custom_easy_register), looked up by name.
- ``dummy``: hardware-free fixed-output backend, the test hook modeled on
  the Edge-TPU subplugin's ``device_type:dummy`` option
  (ext/nnstreamer/tensor_filter/tensor_filter_edgetpu.cc:63-84) — returns
  zeros of the configured output shape so full pipelines run without any
  model or device.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from ...tensor.buffer import to_host
from ...tensor.info import TensorsInfo
from ..framework import (Accelerator, FilterError, FilterFramework,
                         FilterProperties, FilterStatistics, register_filter)


@register_filter
class CustomFilter(FilterFramework):
    """``framework=custom``: model is a Python object implementing
    ``get_input_info() / get_output_info() / invoke(inputs)`` (optionally
    ``set_input_info``), or a bare callable used with forced in/out infos.
    """

    NAME = "custom"
    SUPPORTED_ACCELERATORS = (Accelerator.CPU,)

    def __init__(self) -> None:
        super().__init__()
        self._obj = None
        self.stats = FilterStatistics()

    def open(self, props: FilterProperties) -> None:
        obj = props.model
        if callable(obj) and not hasattr(obj, "invoke"):
            if props.input_info is None or props.output_info is None:
                raise FilterError(
                    "custom: bare callable requires input/output info")
            obj = _EasySpec(obj, props.input_info, props.output_info)
        if not hasattr(obj, "invoke"):
            raise FilterError(f"custom: model {obj!r} has no invoke()")
        self._obj = obj
        super().open(props)

    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        return self._obj.get_input_info(), self._obj.get_output_info()

    def set_input_info(self, in_info: TensorsInfo):
        if hasattr(self._obj, "set_input_info"):
            return self._obj.set_input_info(in_info)
        return super().set_input_info(in_info)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        t0 = time.monotonic_ns()
        outs = self._obj.invoke([to_host(t) for t in inputs])
        self.stats.record(time.monotonic_ns() - t0)
        return list(outs)

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        return callable(model) or hasattr(model, "invoke")


class _EasySpec:
    def __init__(self, fn: Callable, in_info: TensorsInfo,
                 out_info: TensorsInfo):
        self.fn = fn
        self.in_info = in_info
        self.out_info = out_info

    def get_input_info(self) -> TensorsInfo:
        return self.in_info

    def get_output_info(self) -> TensorsInfo:
        return self.out_info

    def invoke(self, inputs: List[np.ndarray]) -> List[np.ndarray]:
        outs = self.fn(inputs)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        return list(outs)


# -- custom-easy registration table -----------------------------------------

_EASY: Dict[str, _EasySpec] = {}


def register_custom_easy(name: str, fn: Callable, in_info: TensorsInfo,
                         out_info: TensorsInfo) -> None:
    """Reference: NNS_custom_easy_register
    (tensor_filter/tensor_filter_custom_easy.c)."""
    if name in _EASY:
        raise ValueError(f"custom-easy {name!r} already registered")
    _EASY[name] = _EasySpec(fn, in_info, out_info)


def unregister_custom_easy(name: str) -> None:
    _EASY.pop(name, None)


@register_filter
class CustomEasyFilter(CustomFilter):
    """``framework=custom-easy``: model names an entry registered via
    :func:`register_custom_easy`."""

    NAME = "custom-easy"

    def open(self, props: FilterProperties) -> None:
        name = str(props.model)
        if name not in _EASY:
            raise FilterError(f"custom-easy model {name!r} not registered")
        self._obj = _EASY[name]
        FilterFramework.open(self, props)

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        return isinstance(model, str) and model in _EASY


@register_filter
class DummyFilter(FilterFramework):
    """``framework=dummy``: zeros of the configured output shape; the
    hardware-free CI backend (edgetpu dummy pattern)."""

    NAME = "dummy"
    SUPPORTED_ACCELERATORS = (Accelerator.CPU, Accelerator.GPU)
    THREADSAFE_INVOKE = True   # stateless zeros + locked stats counter

    def __init__(self) -> None:
        super().__init__()
        self.stats = FilterStatistics()
        self.invoke_count = 0

    def open(self, props: FilterProperties) -> None:
        if props.input_info is None or props.output_info is None:
            raise FilterError("dummy: requires forced input/output info "
                              "(input-dim/input-type/output-dim/output-type)")
        super().open(props)

    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        return self.props.input_info, self.props.output_info

    def set_input_info(self, in_info: TensorsInfo):
        return in_info, self.props.output_info

    def invoke(self, inputs: List[Any]) -> List[Any]:
        t0 = time.monotonic_ns()
        outs = [np.zeros(i.np_shape, i.np_dtype)
                for i in self.props.output_info]
        self.invoke_count += 1
        self.stats.record(time.monotonic_ns() - t0)
        return outs
