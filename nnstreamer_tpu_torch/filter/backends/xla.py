"""Registry-model filter backend, registered as ``framework=xla``.

The counterpart of ``nnstreamer_tpu/filter/backends/xla.py``.  It keeps the
name ``xla`` so a launch string written for the JAX package
(``tensor_filter framework=xla model=mobilenet_v2``) runs unchanged on the
port; what runs is a model from the port's registry, in PyTorch, on
``cuda:0`` (or on the CPU with ``accelerator=true:cpu``).

It serves micro-batches (``tensor_filter batch=N``) through the model's
batched forward (``Model.batched``) as one CUDA graph per pad shape.

``custom=checkpoint:<path>`` serves the weights of a checkpoint in the
port's format (``models.registry.save_checkpoint``, what ``tensor_trainer
model-save-path`` writes): at open, and on ``RELOAD_MODEL`` with a new
``checkpoint`` (or other custom props) for the same model.  A reload
builds and restores the new weights while the old ones keep serving,
then copies them into the served model's own tensors, which every CUDA
graph of the filter (and of a fused segment around it) reads: no graph
replays the old weights after the swap, and none is captured anew.

``custom=mesh:dp=N`` (``TorchExecMixin._resolve_mesh``): N > 1 builds a
replica of the model on each further device of the mesh with the served
weights copied in, and a batched dispatch splits over them.  A reload
copies the new weights into every replica.  The JAX package's persistent
compilation cache is not ported (each capture is built at open).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ...tensor.info import TensorsInfo
from ..framework import (Accelerator, FilterError, FilterFramework,
                         FilterProperties, FilterStatistics, register_filter)
from ._torchexec import TorchExecMixin


@register_filter
class XLAFilter(TorchExecMixin, FilterFramework):
    """``framework=xla``: serve a registry model on the card."""

    NAME = "xla"
    SUPPORTED_ACCELERATORS = (Accelerator.GPU, Accelerator.CPU)

    def __init__(self) -> None:
        super().__init__()
        self._model = None
        self._replicas = []
        self._forward_fn = None
        self._device = None
        self.stats = FilterStatistics()

    # -- lifecycle -----------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        from ...models.registry import has_model, list_models

        model_name = str(props.model)
        custom = dict(props.custom_properties)
        if not has_model(model_name):
            raise FilterError(f"xla: unknown model {model_name!r}; "
                              f"known: {list_models()}")
        device = self._pick_device(props.accelerators)
        mesh = self._resolve_mesh(props, device)
        self._model = self._build(model_name, custom, device)
        self._replicas = [self._build(model_name, custom, dev)
                          for dev in (mesh or [])[1:]]
        for replica in self._replicas:
            self._copy_weights(self._model, replica)
        zeros = [np.zeros(i.np_shape, i.np_dtype)
                 for i in self._model.in_info]
        # the warm-up invoke captures the open signature's graph
        self._setup_exec(
            self._model.module, device, warmup_inputs=zeros,
            batched_fn=self._model.batched,
            mesh=None if mesh is None else [
                (m.device, m.batched or torch.func.vmap(m.module))
                for m in [self._model] + self._replicas])
        super().open(props)

    def close(self) -> None:
        self._model = None
        self._replicas = []
        self._teardown_exec()         # frees the graphs
        super().close()

    @staticmethod
    def _build(model_name: str, custom: Dict[str, str], device):
        """The registry model, with ``custom``'s checkpoint restored
        (the role of loading the reference's .tflite/.pb weights)."""
        from ...models.registry import get_model, restore_params

        model = get_model(model_name, custom, device)
        ckpt = custom.get("checkpoint")
        if ckpt:
            try:
                restore_params(model, str(ckpt))
            except (OSError, RuntimeError, ValueError) as exc:
                raise FilterError(f"xla: checkpoint {ckpt}: {exc}") from exc
        return model

    # -- events --------------------------------------------------------------
    def handle_event(self, name: str,
                     data: Optional[Dict[str, Any]] = None) -> None:
        if name != "reload_model" or (
                data and "model" in data
                and str(data["model"]) != str(self.props.model)):
            # a DIFFERENT model name changes the forward, not just the
            # weights: the generic close+open swap (interface check +
            # rollback)
            return super().handle_event(name, data)
        # hot reload: build the new weights (a new checkpoint path in
        # data) while the old ones keep serving, then swap them in
        # (reference RELOAD_MODEL holds the old model,
        # nnstreamer_plugin_api_filter.h:377-383)
        props = self.props
        if data:
            merged = dict(props.custom_properties)
            merged.update({k: str(v) for k, v in data.items()})
            props = dataclasses.replace(props, custom_properties=merged)
        new_model = self._build(str(props.model), props.custom_properties,
                                self._device)
        self._swap_weights(new_model)
        self.props = props

    def _swap_weights(self, new_model) -> None:
        """Copy ``new_model``'s tensors into the served model's, which
        every graph reads in place.  The device finishes the frames
        dispatched before the swap first (they answer with the old
        weights) and the copy before the next dispatch."""
        with self._exec_lock:
            for served in [self._model] + self._replicas:
                self._copy_weights(new_model, served)

    @staticmethod
    def _copy_weights(src, dst) -> None:
        """Copy ``src``'s tensors into ``dst``'s (the same model), after
        the work queued on ``dst``'s device and before the next."""
        from ...models.registry import named_tensors

        old, new = named_tensors(dst), named_tensors(src)
        for n in sorted(set(old) | set(new)):
            if n not in old or n not in new or \
                    old[n].shape != new[n].shape or \
                    old[n].dtype != new[n].dtype:
                raise FilterError(f"xla: reload changes the model's tensor "
                                  f"{n!r}: only weights of the same model "
                                  "can be swapped in")
        device = next(iter(old.values())).device if old else None
        cuda = device is not None and device.type == "cuda"
        with torch.no_grad():
            if cuda:
                torch.cuda.synchronize(device)
            for n, t in old.items():
                t.copy_(new[n])
            if cuda:
                torch.cuda.synchronize(device)

    # -- model meta ----------------------------------------------------------
    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        if self._model is None:
            raise FilterError("xla: not opened")
        return self._model.in_info, self._model.out_info

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        if not isinstance(model, str):
            return False
        from ...models.registry import has_model

        return has_model(model)
