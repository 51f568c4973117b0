"""Model registry: named models the ``xla`` filter backend serves.

The PyTorch counterpart of ``nnstreamer_tpu/models/registry.py``: a model
is an ``nn.Module`` whose ``forward`` takes one frame per input and
returns a tuple of outputs, plus its forward over a leading batch axis
(the micro-batched filter's), built on an explicit device.  The JAX
package's ``host_init`` and orbax checkpoint restore have no counterpart
here yet; weights are random from ``custom=seed:N``.

A model whose builder has a training form (f32 parameters with the
compute dtype applied per call, the JAX package's trained variables) is
registered with ``trainable=True`` and built with ``get_model(...,
trainable=True)``; the trainers ask for it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set

import torch
from torch import nn

from ..device import DeviceLike
from ..tensor.info import TensorsInfo


@dataclasses.dataclass
class Model:
    """A ready-to-serve model.

    ``module(*inputs) -> tuple(outputs)`` operates on numpy-shaped
    tensors of one stream frame on ``device``.  ``batched(*inputs)`` is
    the same forward on ``(B, *frame_shape)`` inputs, returning ``(B,
    *output_shape)`` outputs: the JAX package's ``jax.vmap`` of the
    forward, written out.  ``None`` serves the batch through
    ``torch.func.vmap`` of ``module``, which no CUDA kernel wrapper of
    the port supports: a model whose forward reaches one supplies its
    own.  A fused segment (``fuse=xla``) composes both, eagerly, into
    its own CUDA graph (``TorchExecMixin.segment_forward``).
    ``in_info``/``out_info`` use reference dim order (innermost
    first)."""

    name: str
    module: nn.Module
    device: torch.device
    in_info: TensorsInfo
    out_info: TensorsInfo
    batched: Optional[Callable] = None


#: name -> build(custom_props: dict, device) -> Model
_MODELS: Dict[str, Callable[..., Model]] = {}
#: names whose builders take ``trainable=True``
_TRAINABLE: Set[str] = set()


def register_model(name: str, trainable: bool = False):
    def deco(build: Callable[..., Model]):
        _MODELS[name] = build
        if trainable:
            _TRAINABLE.add(name)
        return build
    return deco


def _ensure_loaded() -> None:
    from . import (deeplab_v3, mlp, mobilenet_v2, posenet,  # noqa: F401
                   ssd, streamformer_lm, vit)


def get_model(name: str, custom_props: Optional[Dict[str, str]] = None,
              device: DeviceLike = None, trainable: bool = False) -> Model:
    """Build model ``name`` on ``device`` (``None``: the card);
    ``trainable``: its training form."""
    _ensure_loaded()
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_MODELS)}")
    if not trainable:
        return _MODELS[name](custom_props or {}, device)
    if name not in _TRAINABLE:
        raise ValueError(f"model {name!r} has no training form in the "
                         f"port yet; trainable: {sorted(_TRAINABLE)}")
    return _MODELS[name](custom_props or {}, device, trainable=True)


def has_model(name: str) -> bool:
    _ensure_loaded()
    return name in _MODELS


def list_models() -> List[str]:
    _ensure_loaded()
    return sorted(_MODELS)
