"""Converter subplugins: custom media → tensors converters.

Parity with the reference converter subplugin ABI
(gst/nnstreamer/include/nnstreamer_plugin_api_converter.h: name /
convert / get_out_config / query_caps) used by flatbuf/flexbuf/protobuf/
python converters (SURVEY.md §2.6).  The counterpart of
``nnstreamer_tpu/converters/``: the port's registry is its own.
"""

from __future__ import annotations

from typing import Dict, Type

from ..pipeline.caps import Caps
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig


class Converter:
    """Converter subplugin ABI."""

    NAME: str = ""

    def query_caps(self) -> Caps:
        """Sink caps this converter accepts."""
        return Caps.any()

    def get_out_config(self, in_caps: Caps) -> TensorsConfig:
        raise NotImplementedError

    def convert(self, buf: TensorBuffer) -> TensorBuffer:
        raise NotImplementedError


_CONVERTERS: Dict[str, Type[Converter]] = {}


def register_converter(cls: Type[Converter]) -> Type[Converter]:
    if not cls.NAME:
        raise ValueError(f"{cls.__name__} has no NAME")
    _CONVERTERS[cls.NAME] = cls
    return cls


def find_converter(name: str):
    _ensure_loaded()
    if name not in _CONVERTERS:
        raise KeyError(f"unknown converter {name!r}; known: "
                       f"{sorted(_CONVERTERS)}")
    return _CONVERTERS[name]()


def list_converters():
    _ensure_loaded()
    return sorted(_CONVERTERS)


def _ensure_loaded() -> None:
    from . import flatbuf, flexbuf, protobuf, python  # noqa: F401
