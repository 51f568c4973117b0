"""Pipeline-less single-shot inference ("Single API" side door).

Parity with ``GTensorFilterSingle``
(gst/nnstreamer/tensor_filter/tensor_filter_single.c:101-108,321: a plain
object exposing start/stop/invoke without any pipeline, reusing the common
filter logic) — the entry point an application uses for one-shot inference.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import numpy as np

from ..tensor.buffer import to_host
from ..tensor.info import TensorsInfo
from .framework import (Accelerator, FilterError, FilterFramework,
                        FilterProperties, close_backend, open_backend)


class FilterSingle:
    """One-shot invoke wrapper around any filter framework.

    Usage::

        single = FilterSingle(framework="xla", model="mobilenet_v2")
        # runs on cuda:0; accelerator="true:cpu" asks for the CPU
        single.start()
        out, = single.invoke([frame])      # frame: np.uint8 (224,224,3)
        single.stop()
    """

    def __init__(self, framework: str = "auto", model: Any = None,
                 input_info: Optional[TensorsInfo] = None,
                 output_info: Optional[TensorsInfo] = None,
                 accelerator: Optional[str] = None,
                 custom: Optional[str] = None,
                 shared_key: Optional[str] = None):
        self.props = FilterProperties(
            framework=framework, model=model, input_info=input_info,
            output_info=output_info,
            accelerators=Accelerator.parse(accelerator),
            custom_properties=FilterProperties.parse_custom(custom),
            shared_key=shared_key)
        self.fw: Optional[FilterFramework] = None

    def start(self) -> None:
        self.fw = open_backend(self.props)

    def stop(self) -> None:
        close_backend(self.fw, self.props)
        self.fw = None

    @property
    def input_info(self) -> TensorsInfo:
        return self.fw.get_model_info()[0]

    @property
    def output_info(self) -> TensorsInfo:
        return self.fw.get_model_info()[1]

    def input_configured(self) -> bool:
        """Reference ``input_configured`` check: a started backend with
        valid input info."""
        return self.fw is not None and self.input_info.is_valid()

    def output_configured(self) -> bool:
        return self.fw is not None and self.output_info.is_valid()

    def set_input_info(self, info: TensorsInfo) -> TensorsInfo:
        """Reference ``set_input_info`` (dynamic input reshape,
        tensor_filter_single.c:77,106): reconfigure the opened model's
        input and return the RE-DERIVED output info.  Backends that
        can't reshape raise a named FilterError."""
        if self.fw is None:
            raise FilterError("not started")
        self.fw.set_input_info(info)
        return self.output_info

    def invoke(self, inputs: Sequence[Any]) -> List[np.ndarray]:
        """Validate against model info, invoke, materialize on host (the
        one sync)."""
        if self.fw is None:
            raise FilterError("not started")
        in_info, _ = self.fw.get_model_info()
        if len(inputs) != in_info.num_tensors:
            raise FilterError(
                f"expected {in_info.num_tensors} inputs, got {len(inputs)}")
        for arr, info in zip(inputs, in_info):
            shape = tuple(getattr(arr, "shape", ()))
            if shape != info.np_shape:
                raise FilterError(
                    f"input shape {shape} != negotiated {info.np_shape}")
        outs = self.fw.invoke(list(inputs))
        return [to_host(o) for o in outs]

    def __enter__(self) -> "FilterSingle":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
