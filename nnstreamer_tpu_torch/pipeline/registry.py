"""Element factory registry.

Equivalent of the reference's plugin registerer
(gst/nnstreamer/registerer/nnstreamer.c:91-133 registering 22+ elements) —
but in-process: element classes register by factory name and launch-string
parsing resolves them here.
"""

from __future__ import annotations

from typing import Dict, Type

from .element import Element

_FACTORIES: Dict[str, Type[Element]] = {}


def register_element(cls: Type[Element]) -> Type[Element]:
    """Class decorator: register by ``cls.FACTORY``."""
    if not cls.FACTORY:
        raise ValueError(f"{cls.__name__} has no FACTORY name")
    _FACTORIES[cls.FACTORY] = cls
    return cls


def element_factory(name: str) -> Type[Element]:
    # Import-on-demand keeps `import nnstreamer_tpu_torch` light: the
    # port's element library (the slice's elements only) registers itself
    # when first needed.
    if name not in _FACTORIES:
        from .. import elements as _  # noqa: F401 - triggers registration
    if name not in _FACTORIES:
        raise KeyError(f"no such element factory {name!r}; "
                       f"known: {sorted(_FACTORIES)}")
    return _FACTORIES[name]


def register_element_alias(alias: str, cls: Type[Element]) -> None:
    """Second factory name for the same class (the reference registers
    ``edgesink``/``edgesrc`` without the underscore our canonical
    names use — verbatim reference launch lines need both)."""
    _FACTORIES[alias] = cls


def make_element(name: str, element_name=None, **props) -> Element:
    return element_factory(name)(element_name, **props)


def list_factories():
    from .. import elements as _  # noqa: F401

    return sorted(_FACTORIES)
