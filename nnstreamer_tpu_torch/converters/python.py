"""Python-script converter: the reference python3 converter contract.

Parity with ext/nnstreamer/tensor_converter/tensor_converter_python3.cc:
``tensor_converter mode=custom-script:<file.py>`` loads a script whose
``class CustomConverter`` implements
``convert(input_array) -> (list[nns.TensorShape], list[np.ndarray(u8)],
rate_n, rate_d)`` — the reference's own fixture
(tests/test_models/models/custom_converter.py) runs unmodified through
the `nnstreamer_python` shim (utils/nns_python_compat.py).
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..pipeline.caps import Caps
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig
from . import Converter, register_converter


@register_converter
class PythonScriptConverter(Converter):
    NAME = "python3"

    def __init__(self, path: str = "") -> None:
        self._obj = None
        if path:
            self.load(path)

    def load(self, path: str) -> None:
        from ..utils.nns_python_compat import load_user_script

        try:
            got, _ = load_user_script(path, "_nns_pyconv",
                                      "CustomConverter",
                                      "converter_instance")
        except (FileNotFoundError, AttributeError) as exc:
            raise ValueError(f"python3 converter: {exc}") from exc
        self._obj = got() if isinstance(got, type) else got

    def query_caps(self) -> Caps:
        return Caps.any()   # the script decides what bytes it accepts

    def get_out_config(self, in_caps: Caps) -> TensorsConfig:
        rate = in_caps.first().get("framerate")
        return TensorsConfig(rate=rate if isinstance(rate, Fraction)
                             else Fraction(0, 1))

    def convert(self, buf: TensorBuffer) -> TensorBuffer:
        if self._obj is None:
            raise ValueError("python3 converter: no script loaded "
                             "(mode=custom-script:<file.py>)")
        arrays = [np.asarray(buf.np(i)) for i in range(buf.num_tensors)]
        shapes, raw, rate_n, rate_d = self._obj.convert(arrays)
        from ..utils.nns_python_compat import to_tensors_info

        info = to_tensors_info(shapes)
        tensors = []
        for ti, blob in zip(info, raw):
            flat = np.asarray(blob).reshape(-1).view(ti.np_dtype)
            tensors.append(flat.reshape(ti.np_shape))
        out = buf.with_tensors(tensors)
        return out
