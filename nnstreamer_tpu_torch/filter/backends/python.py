"""Python-script filter backend: a .py file as the model.

The port of ``nnstreamer_tpu/filter/backends/python.py``, over the port's
``utils/nns_python_compat.py``; script payloads stay numpy.

Parity with the reference python3 subplugin
(ext/nnstreamer/tensor_filter/tensor_filter_python3.cc + helper: embeds
CPython, loads a user script defining a class with getInputDim/getOutputDim/
invoke).  Here the host language *is* Python, so this backend reduces to
importing the script and adapting its class — same script contract as the
reference fixtures (tests/test_models/models/passthrough.py).

Script contract: define ``class CustomFilter`` (or a module-level
``filter_instance``) with methods:

- ``getInputDim() -> TensorsInfo`` (or list of (dims, dtype-name) pairs)
- ``getOutputDim() -> TensorsInfo``
- ``invoke(inputs: list[np.ndarray]) -> list[np.ndarray]``
- optionally ``setInputDim(in_info) -> (in_info, out_info)``
"""

from __future__ import annotations

import time
from typing import Any, List, Optional, Tuple

from ...tensor.buffer import to_host
from ...tensor.info import TensorInfo, TensorsInfo
from ...tensor.types import TensorType
from ..framework import (Accelerator, FilterError, FilterFramework,
                         FilterProperties, FilterStatistics, register_filter)


def _coerce_info(value) -> TensorsInfo:
    if isinstance(value, TensorsInfo):
        return value
    value = list(value)
    # reference-API scripts return list[nns.TensorShape]
    if value and hasattr(value[0], "getDims"):
        from ...utils import nns_python_compat

        return nns_python_compat.to_tensors_info(value)
    # list of (dims, dtype) pairs, dims innermost-first like the reference
    infos = []
    for dims, dtype in value:
        infos.append(TensorInfo(TensorType.from_string(str(dtype)),
                                tuple(dims)))
    return TensorsInfo(infos)


@register_filter
class PythonFilter(FilterFramework):
    """``framework=python``: model is a path to a .py script."""

    NAME = "python"
    SUPPORTED_ACCELERATORS = (Accelerator.CPU,)

    def __init__(self) -> None:
        super().__init__()
        self._obj = None
        self.stats = FilterStatistics()

    def open(self, props: FilterProperties) -> None:
        path = str(props.model)
        from ...utils.nns_python_compat import load_user_script

        try:
            got, self._ref_style = load_user_script(
                path, "_nns_pyfilter", "CustomFilter", "filter_instance")
        except (FileNotFoundError, AttributeError) as exc:
            raise FilterError(f"python: {exc}") from exc
        if isinstance(got, type):
            if self._ref_style:
                # reference contract: the whole custom string is ONE
                # constructor argument (tensor_filter_python3.cc passes
                # it verbatim, e.g. custom=640x480)
                custom = ",".join(
                    k if not v else f"{k}:{v}"
                    for k, v in props.custom_properties.items())
                self._obj = got(custom) if custom else got()
            else:
                self._obj = got()
        else:
            self._obj = got
        super().open(props)
        self._negotiated: Optional[Tuple[TensorsInfo, TensorsInfo]] = None
        if not hasattr(self._obj, "getInputDim"):
            # setInputDim-only script (reference scaler.py shape): its
            # meta comes from negotiation; with a forced input-dim
            # (Single API / input-dim prop) negotiate once at open
            if props.input_info is None:
                raise FilterError(
                    "python: script has no getInputDim — set input-dim/"
                    "input-type (or input_info) so setInputDim can run")
            self._negotiated = self.set_input_info(props.input_info)

    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        if self._negotiated is not None:
            return self._negotiated
        return (_coerce_info(self._obj.getInputDim()),
                _coerce_info(self._obj.getOutputDim()))

    def set_input_info(self, in_info: TensorsInfo):
        if hasattr(self._obj, "setInputDim"):
            if self._ref_style:
                # reference contract: setInputDim(list[TensorShape]) ->
                # output TensorShape list (input accepted as-is)
                from ...utils import nns_python_compat

                got = self._obj.setInputDim(
                    nns_python_compat.from_tensors_info(in_info))
                if got is None:
                    raise FilterError("python: setInputDim rejected the "
                                      f"input meta {in_info}")
                return in_info, _coerce_info(got)
            # native contract: setInputDim(TensorsInfo) -> (in, out)
            new_in, new_out = self._obj.setInputDim(in_info)
            return _coerce_info(new_in), _coerce_info(new_out)
        return super().set_input_info(in_info)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        t0 = time.monotonic_ns()
        outs = self._obj.invoke([to_host(t) for t in inputs])
        self.stats.record(time.monotonic_ns() - t0)
        return list(outs)

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        return isinstance(model, str) and model.endswith(".py")
