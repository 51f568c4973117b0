"""Model registry: named models the ``xla`` filter backend serves.

The PyTorch counterpart of ``nnstreamer_tpu/models/registry.py``: a model
is an ``nn.Module`` whose ``forward`` takes one frame per input and
returns a tuple of outputs, plus its forward over a leading batch axis
(the micro-batched filter's), built on an explicit device.  Weights are
random from ``custom=seed:N``; :func:`save_checkpoint` and
:func:`restore_params` are the JAX package's pair over the port's own
format (the JAX package writes orbax, which the port cannot read):
``torch.save`` of a flat name → tensor mapping, every tensor the model
computes with (BatchNorm's running statistics too, the JAX tree's
``batch_stats``).  The JAX package's ``host_init`` has no counterpart:
models are built on their device directly.

A model whose builder has a training form (f32 parameters with the
compute dtype applied per call, the JAX package's trained variables) is
registered with ``trainable=True`` and built with ``get_model(...,
trainable=True)``; the trainers ask for it.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Mapping, Optional, Set

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
#: name -> why the model has no training form
_UNTRAINABLE: Dict[str, str] = {}


def register_model(name: str, trainable: bool = False,
                   untrainable: Optional[str] = None):
    """``trainable``: the builder takes ``trainable=True``; ``untrainable``:
    why it cannot (said by ``get_model(..., trainable=True)``)."""
    def deco(build: Callable[..., Model]):
        _MODELS[name] = build
        if trainable:
            _TRAINABLE.add(name)
        if untrainable:
            _UNTRAINABLE[name] = untrainable
        return build
    return deco


def loss_misfit(first_output: str) -> str:
    """Why a vision model has no training form: the ``mesh-vision`` step's
    loss reads ``log_softmax`` of the model's first output at one label a
    frame, which fits a ``(B, classes)`` output only; the JAX package's
    step (``parallel/vision_train.py``) raises on any other."""
    return (f"the vision train step's loss needs a (classes,) first output "
            f"a frame, and {first_output}; the JAX package's step raises "
            "on it too (take_along_axis: indices and arr differ in rank)")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _flat_tree(tree: Any, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{dotted path: tensor}`` of a tree of dicts and lists (the LM's
    ``layers.<i>.<name>``)."""
    if isinstance(tree, torch.Tensor):
        return {prefix[:-1]: tree}
    items = (tree.items() if isinstance(tree, Mapping)
             else enumerate(tree))
    out: Dict[str, torch.Tensor] = {}
    for k, v in items:
        out.update(_flat_tree(v, f"{prefix}{k}."))
    return out


def named_tensors(obj: Any) -> Dict[str, torch.Tensor]:
    """Every tensor ``obj`` computes with, by checkpoint name: a
    :class:`Model` or ``nn.Module`` gives its ``checkpoint_tensors()``
    when it has one (a module whose weights are a plain tree), else its
    ``state_dict``; a tree of dicts and lists gives its dotted paths.
    The tensors are the live ones."""
    if isinstance(obj, Model):
        obj = obj.module
    if isinstance(obj, nn.Module):
        own = getattr(obj, "checkpoint_tensors", None)
        return dict(own()) if callable(own) else dict(obj.state_dict())
    return _flat_tree(obj)


def save_checkpoint(model: Any, path: str) -> None:
    """Write ``model``'s tensors (a :class:`Model`, an ``nn.Module`` or a
    parameter tree; :func:`named_tensors`) to ``path``: ``torch.save`` of
    ``{name: CPU tensor}``, through a temporary file and a rename, so a
    reader never sees half a checkpoint."""
    flat = {n: t.detach().to("cpu", copy=True).contiguous()
            for n, t in named_tensors(model).items()}
    path = os.path.abspath(path)
    tmp = f"{path}.tmp{os.getpid()}"
    torch.save(flat, tmp)
    os.replace(tmp, path)


def restore_params(template: Any, path: str) -> Any:
    """Read the checkpoint at ``path`` into ``template``'s structure.

    Names and shapes must match the template's (:func:`named_tensors`):
    otherwise it raises, naming the first mismatch, as orbax's restore
    against a target does.  Each tensor takes the template's dtype and
    device (a training form's f32 checkpoint loads into its serving
    form's bf16).  A :class:`Model` or ``nn.Module`` template is loaded
    in place and returned; a tree template gives a new tree."""
    want = named_tensors(template)
    device = next(iter(want.values())).device if want else "cpu"
    got = torch.load(os.path.abspath(path), weights_only=True,
                     map_location=device)
    if not isinstance(got, Mapping):
        raise ValueError(f"{path}: not a checkpoint of named tensors")
    for name in sorted(set(want) | set(got)):
        if name not in got:
            raise ValueError(f"{path}: the checkpoint lacks {name!r}")
        if name not in want:
            raise ValueError(f"{path}: {name!r} is not a tensor of the "
                             "template")
        if tuple(got[name].shape) != tuple(want[name].shape):
            raise ValueError(f"{path}: {name!r} has shape "
                             f"{tuple(got[name].shape)}, the template "
                             f"{tuple(want[name].shape)}")
    cast = {n: got[n].to(device=t.device, dtype=t.dtype)
            for n, t in want.items()}
    if isinstance(template, (Model, nn.Module)):
        with torch.no_grad():
            for n, t in want.items():
                t.copy_(cast[n])
        return template
    return _rebuild(template, cast)


def _rebuild(tree: Any, flat: Dict[str, torch.Tensor], prefix: str = ""):
    if isinstance(tree, torch.Tensor):
        return flat[prefix[:-1]]
    if isinstance(tree, Mapping):
        return {k: _rebuild(v, flat, f"{prefix}{k}.")
                for k, v in tree.items()}
    return type(tree)(_rebuild(v, flat, f"{prefix}{i}.")
                      for i, v in enumerate(tree))


def _ensure_loaded() -> None:
    from . import (deeplab_v3, mlp, mobilenet_v2, posenet,  # noqa: F401
                   ssd, streamformer_lm, swin_v2, vit)


def get_model(name: str, custom_props: Optional[Dict[str, str]] = None,
              device: DeviceLike = None, trainable: bool = False) -> Model:
    """Build model ``name`` on ``device`` (``None``: the card);
    ``trainable``: its training form."""
    _ensure_loaded()
    if name not in _MODELS:
        raise KeyError(f"unknown model {name!r}; known: {sorted(_MODELS)}")
    if not trainable:
        return _MODELS[name](custom_props or {}, device)
    if name in _UNTRAINABLE:
        raise ValueError(f"model {name!r} has no training form: "
                         f"{_UNTRAINABLE[name]}")
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
