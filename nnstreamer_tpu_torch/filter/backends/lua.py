"""Lua script filter backend.

The port of ``nnstreamer_tpu/filter/backends/lua.py``, over the port's
own copy of ``utils/minilua.py``.

Parity with the reference lua subplugin
(ext/nnstreamer/tensor_filter/tensor_filter_lua.cc, 591 LoC): a ``.lua``
script declares ``inputTensorsInfo`` / ``outputTensorsInfo`` tables and an
``nnstreamer_invoke()`` function that reads ``input_tensor(i)`` and writes
``output_tensor(i)`` with 1-based flat indexing.  The image ships no
liblua, so the script runs on the in-tree interpreter
(``utils/minilua.py``); the reference's own fixture scripts
(tests/test_models/models/passthrough.lua, scaler.lua) are the goldens.

Host-CPU backend (script filters are host work in the reference too);
tensor payloads stay numpy, exposed to the script through 1-based proxies.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Tuple

import numpy as np

from ...tensor.buffer import to_host
from ...tensor.info import TensorInfo, TensorsInfo
from ...tensor.types import TensorType
from ...utils.minilua import LuaState, LuaTable
from ..framework import (Accelerator, FilterError, FilterFramework,
                         FilterProperties, FilterStatistics, register_filter)


class _TensorProxy:
    """1-based flat element access over a numpy array (the reference's
    lua tensor userdata contract)."""

    __slots__ = ("arr",)

    def __init__(self, arr: np.ndarray):
        self.arr = arr

    def __getitem__(self, i):
        return float(self.arr[int(i) - 1])

    def __setitem__(self, i, v):
        self.arr[int(i) - 1] = v

    def __len__(self):
        return self.arr.size


def _info_from_table(table: Any, which: str) -> TensorsInfo:
    if not isinstance(table, LuaTable):
        raise FilterError(f"lua: script must define {which} as a table")
    num = table.get("num")
    dims = table.get("dim")
    types = table.get("type")
    if not isinstance(num, (int, float)) or not isinstance(dims, LuaTable) \
            or not isinstance(types, LuaTable):
        raise FilterError(f"lua: {which} needs num/dim/type fields")
    infos: List[TensorInfo] = []
    for i in range(1, int(num) + 1):
        d = dims.get(i)
        t = types.get(i)
        if not isinstance(d, LuaTable) or not isinstance(t, str):
            raise FilterError(f"lua: {which}.dim/type[{i}] malformed")
        dim = tuple(int(d.get(j)) for j in range(1, d.length() + 1))
        infos.append(TensorInfo(TensorType.from_string(t), dim))
    return TensorsInfo(infos)


@register_filter
class LuaFilter(FilterFramework):
    """``framework=lua``: model is a path to a .lua script."""

    NAME = "lua"
    SUPPORTED_ACCELERATORS = (Accelerator.CPU,)

    def __init__(self) -> None:
        super().__init__()
        self._state: Optional[LuaState] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self.stats = FilterStatistics()

    def open(self, props: FilterProperties) -> None:
        path = str(props.model)
        if os.path.isfile(path):
            with open(path) as f:
                source = f.read()
        elif "\n" in path or (" " in path and "nnstreamer_invoke" in path):
            # inline script-as-model: the reference's lua filter accepts
            # the script TEXT in the model property (its own unit tests
            # drive it that way, unittest_filter_lua.cc:36-65).  A
            # single-line script qualifies via the space+invoke check;
            # a typo'd PATH (no whitespace) still reports 'not found'
            source = path
        else:
            raise FilterError(f"lua: script not found: {path}")
        try:
            state = LuaState(source)
        except FilterError:
            raise
        except Exception as exc:  # noqa: BLE001 - scripts can raise raw
            # python errors too (TypeError from bad operands, ...)
            raise FilterError(f"lua: script error: {exc}") from exc
        try:
            self._in_info = _info_from_table(state.get("inputTensorsInfo"),
                                             "inputTensorsInfo")
            self._out_info = _info_from_table(
                state.get("outputTensorsInfo"), "outputTensorsInfo")
        except FilterError:
            raise
        except Exception as exc:  # noqa: BLE001
            raise FilterError(f"lua: bad tensors info: {exc}") from exc
        if state.get("nnstreamer_invoke") is None:
            raise FilterError("lua: script defines no nnstreamer_invoke()")
        self._state = state
        super().open(props)

    def close(self) -> None:
        self._state = None
        super().close()

    def invoke(self, inputs: List[Any]) -> List[Any]:
        import time

        if self._state is None:
            raise FilterError("lua: not opened")
        ins = [np.ascontiguousarray(to_host(x)).reshape(-1)
               for x in inputs]
        outs = [np.zeros(i.np_shape, i.np_dtype) for i in self._out_info]
        flat_outs = [o.reshape(-1) for o in outs]
        self._state.set("input_tensor",
                        lambda i: _TensorProxy(ins[int(i) - 1]))
        self._state.set("output_tensor",
                        lambda i: _TensorProxy(flat_outs[int(i) - 1]))
        t0 = time.monotonic_ns()
        try:
            self._state.call("nnstreamer_invoke")
        except Exception as exc:  # noqa: BLE001 - script faults surface as
            # python exceptions too (IndexError from bad tensor indices,
            # TypeError from mixed comparisons) — all become FilterError
            raise FilterError(f"lua: invoke error: {exc}") from exc
        finally:
            # do not keep a frame of tensors alive through the closures
            self._state.set("input_tensor", None)
            self._state.set("output_tensor", None)
        self.stats.record(time.monotonic_ns() - t0)
        return outs

    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        if self._state is None:
            raise FilterError("lua: not opened")
        return self._in_info, self._out_info

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        return isinstance(model, str) and model.endswith(".lua")
