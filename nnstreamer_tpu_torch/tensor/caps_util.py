"""Tensor caps ↔ config conversion.

Equivalent of gst_tensor_caps_from_config / gst_tensors_config_from_structure
(reference: nnstreamer_plugin_api_impl.c:1110-1393) and the caps macros in
tensor_typedef.h:93-128.  The ``other/tensors`` media type covers all three
formats; ``format`` selects static/flexible/sparse.
"""

from __future__ import annotations

from fractions import Fraction

from ..pipeline.caps import ANY_FRAMERATE, Caps, Structure
from .info import TensorsConfig, TensorsInfo
from .types import TensorFormat

TENSORS_MIME = "other/tensors"


def caps_from_config(config: TensorsConfig) -> Caps:
    """Build (possibly non-fixed) caps from a tensors config."""
    fields = {}
    fields["format"] = str(config.format)
    if config.format is TensorFormat.STATIC and config.info.num_tensors > 0:
        fields["num_tensors"] = config.info.num_tensors
        fields["dimensions"] = config.info.dims_string(sep=".")
        fields["types"] = config.info.types_string(sep=".")
    fields["framerate"] = (config.rate if config.rate is not None
                           else ANY_FRAMERATE)
    return Caps([Structure(TENSORS_MIME, fields)])


def config_from_structure(struct: Structure) -> TensorsConfig:
    """Parse a fixed ``other/tensors`` structure into a config."""
    if struct.name != TENSORS_MIME:
        raise ValueError(f"not a tensors structure: {struct.name}")
    fmt = TensorFormat.from_string(str(struct.get("format", "static")))
    info = TensorsInfo()
    dims = struct.get("dimensions")
    types = struct.get("types")
    if dims is not None and types is not None:
        info = TensorsInfo.from_strings(str(dims), str(types))
        num = struct.get("num_tensors")
        if num is not None and int(num) != info.num_tensors:
            raise ValueError(
                f"num_tensors={num} but {info.num_tensors} dims given")
    rate = struct.get("framerate")
    if not isinstance(rate, Fraction):
        rate = None
    return TensorsConfig(info=info, rate=rate, format=fmt)


def config_from_caps(caps: Caps) -> TensorsConfig:
    return config_from_structure(caps.first())


def tensors_template_caps() -> Caps:
    """Pad-template caps accepting any tensor stream."""
    return Caps([
        Structure(TENSORS_MIME, {"format": [str(f) for f in TensorFormat],
                                 "framerate": ANY_FRAMERATE}),
    ])


def static_tensors_caps() -> Caps:
    return Caps([Structure(TENSORS_MIME, {"format": "static",
                                          "framerate": ANY_FRAMERATE})])


def flexible_tensors_caps() -> Caps:
    return Caps([Structure(TENSORS_MIME, {"format": "flexible",
                                          "framerate": ANY_FRAMERATE})])
