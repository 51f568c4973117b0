"""`nnstreamer_python` compatibility shim for reference user scripts.

The reference embeds CPython and exposes a small `nnstreamer_python`
module to user filter/converter/decoder scripts
(ext/nnstreamer/extra/nnstreamer_python_helper.py: `TensorShape`,
dims innermost-first, numpy dtypes).  Scripts written against it open
with ``import nnstreamer_python as nns`` — so a reference user's
existing .py filters (e.g. the fixtures
tests/test_models/models/passthrough.py / scaler.py) must run here
unmodified.  ``install()`` registers this module under that name
before a user script executes.

Behavior contract (not code) mirrored from the reference helper:
`TensorShape(dims, type)` holds a MUTABLE dims list (scripts mutate the
list returned by ``getDims`` in place — scaler.py does) and a numpy
dtype; rank ≤ 8, innermost-first, missing dims padded with 1.

The port of ``nnstreamer_tpu/utils/nns_python_compat.py``, unchanged.  A
process that loads both packages registers whichever shim ``install()``
finds first; the two are interchangeable.
"""

from __future__ import annotations

import os
import sys
from typing import List, Sequence

import numpy as np

_RANK_LIMIT = 8


class TensorShape:
    """One tensor's dims (innermost-first, ≤8, mutable) + numpy dtype."""

    def __init__(self, dims: Sequence[int], ttype=np.uint8):
        dims = [int(d) for d in list(dims)[:_RANK_LIMIT]]
        if not dims:
            dims = [1]
        self._dims: List[int] = dims
        self._type = np.dtype(ttype)

    def getDims(self) -> List[int]:
        # the LIVE list: reference scripts mutate it in place
        return self._dims

    def getType(self) -> np.dtype:
        return self._type

    def setDims(self, dims: Sequence[int]) -> None:
        self._dims = [int(d) for d in list(dims)[:_RANK_LIMIT]]

    def setType(self, ttype) -> None:
        self._type = np.dtype(ttype)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TensorShape({self._dims}, {self._type.name})"


def install() -> None:
    """Make ``import nnstreamer_python`` resolve to this shim (no-op if
    a real module of that name is importable first)."""
    sys.modules.setdefault("nnstreamer_python", sys.modules[__name__])


def load_user_script(path: str, prefix: str, class_attr: str,
                     instance_attr: str):
    """Load a user script and return ``(cls_or_instance, ref_style)``.

    One loader for the three script subplugins (filter / converter /
    decoder): installs the shim, imports the file under a
    collision-safe module name, and reports whether the script is
    REFERENCE-style (it imported ``nnstreamer_python``) — callers gate
    the reference API contract on that, so scripts written against this
    framework's native contracts keep their behavior.  Returns the
    ``instance_attr`` attribute when the module defines it, else the
    ``class_attr`` CLASS (callers construct it — the filter passes the
    custom string through).  A failed exec leaves no half-registered
    module behind.
    """
    import importlib.util

    if not os.path.exists(path):
        raise FileNotFoundError(f"script not found: {path}")
    install()
    name = f"{prefix}_{abs(hash(os.path.abspath(path))) & 0xffffffff:x}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        sys.modules.pop(name, None)
        raise
    shim = sys.modules.get("nnstreamer_python")
    # reference-style detection must also catch `from nnstreamer_python
    # import TensorShape`: any script global that IS a shim-defined API
    # member (by identity) marks the script, not just the bound module
    # object.  Only members DEFINED here count — matching re-exported
    # imports (np, os) would misclassify native scripts that import
    # numpy themselves.
    shim_api_ids = {id(v) for k, v in vars(shim).items()
                    if not k.startswith("_")
                    and getattr(v, "__module__", None) == shim.__name__
                    } if shim else set()
    ref_style = any(v is shim or id(v) in shim_api_ids
                    for v in vars(mod).values())
    if hasattr(mod, instance_attr):
        return getattr(mod, instance_attr), ref_style
    if hasattr(mod, class_attr):
        return getattr(mod, class_attr), ref_style
    raise AttributeError(
        f"{path} defines neither {class_attr} nor {instance_attr}")


def to_tensors_info(shapes):
    """list[TensorShape] -> framework TensorsInfo (trailing 1-dims
    trimmed: the reference pads to rank 8 for the wire, the framework
    keeps natural rank)."""
    from ..tensor.info import TensorInfo, TensorsInfo
    from ..tensor.types import TensorType

    infos = []
    for s in shapes:
        dims = list(s.getDims())
        while len(dims) > 1 and dims[-1] == 1:
            dims.pop()
        infos.append(TensorInfo(TensorType.from_string(s.getType().name),
                                tuple(dims)))
    return TensorsInfo(infos)


def from_tensors_info(info) -> List[TensorShape]:
    """Framework TensorsInfo -> list[TensorShape] (padded to rank 8,
    the shape reference scripts index into)."""
    shapes = []
    for ti in info:
        dims = list(ti.dims)
        dims += [1] * (_RANK_LIMIT - len(dims))
        shapes.append(TensorShape(dims, ti.np_dtype))
    return shapes
