"""Decoder subplugins: other/tensors → media/labels/boxes/segments/poses.

Parity with the reference decoder subplugin family (SURVEY.md §2.5,
ABI: gst/nnstreamer/include/nnstreamer_plugin_api_decoder.h): each decoder
registers a mode name, takes up to 9 option strings, announces out caps from
the incoming tensor config, and decodes per buffer.
"""

from __future__ import annotations

from typing import Dict, Type

from ..pipeline.caps import Caps
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig


class Decoder:
    """Decoder subplugin ABI (reference GstTensorDecoderDef,
    nnstreamer_plugin_api_decoder.h: modename/setOption/getOutCaps/decode)."""

    MODE: str = ""

    def set_option(self, index: int, value: str) -> None:
        """option{index} property (1-based, ≤9 like the reference)."""

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        raise NotImplementedError

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        raise NotImplementedError

    def device_reduce_spec(self, config: TensorsConfig):
        """Optional reduction pushdown (net-new, TPU-native — no reference
        counterpart): return ``(fn, reduced_info)`` where ``fn(outputs)``
        is a torch function shrinking the upstream filter's outputs on
        device, and ``reduced_info`` is the resulting TensorsInfo, or None.
        ``decode`` must accept BOTH the raw and the reduced form (detected
        by shape/count), because buffers in flight when the pushdown lands
        still carry the raw layout."""
        return None


_DECODERS: Dict[str, Type[Decoder]] = {}


def register_decoder(cls: Type[Decoder]) -> Type[Decoder]:
    if not cls.MODE:
        raise ValueError(f"{cls.__name__} has no MODE")
    _DECODERS[cls.MODE] = cls
    return cls


def find_decoder(mode: str) -> Type[Decoder]:
    _ensure_loaded()
    if mode not in _DECODERS:
        raise KeyError(f"unknown decoder mode {mode!r}; "
                       f"known: {sorted(_DECODERS)}")
    return _DECODERS[mode]


def list_decoders():
    _ensure_loaded()
    return sorted(_DECODERS)


def _ensure_loaded() -> None:
    from . import imagelabel  # noqa: F401 - the slice's one decoder

