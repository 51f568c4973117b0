"""Registry-model filter backend, registered as ``framework=xla``.

The counterpart of ``nnstreamer_tpu/filter/backends/xla.py``.  It keeps the
name ``xla`` so a launch string written for the JAX package
(``tensor_filter framework=xla model=mobilenet_v2``) runs unchanged on the
port; what runs is a model from the port's registry, in PyTorch, on
``cuda:0`` (or on the CPU with ``accelerator=true:cpu``).

It serves micro-batches (``tensor_filter batch=N``) through the model's
batched forward (``Model.batched``) as one CUDA graph per pad shape.
The JAX package's persistent compilation cache, ``custom=mesh:dp=N``
sharding and ``checkpoint`` restore are not ported yet.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np

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
        self._forward_fn = None
        self._device = None
        self.stats = FilterStatistics()

    # -- lifecycle -----------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        from ...models.registry import get_model, has_model, list_models

        model_name = str(props.model)
        custom = dict(props.custom_properties)
        for key in ("checkpoint", "mesh"):
            if custom.get(key):
                raise FilterError(f"xla: custom={key}:... is not yet ported "
                                  "to the PyTorch package")
        if not has_model(model_name):
            raise FilterError(f"xla: unknown model {model_name!r}; "
                              f"known: {list_models()}")
        device = self._pick_device(props.accelerators)
        self._model = get_model(model_name, custom, device)
        zeros = [np.zeros(i.np_shape, i.np_dtype)
                 for i in self._model.in_info]
        # the warm-up invoke captures the open signature's graph
        self._setup_exec(self._model.module, device, warmup_inputs=zeros,
                         batched_fn=self._model.batched)
        super().open(props)

    def close(self) -> None:
        self._model = None
        self._teardown_exec()         # frees the graphs
        super().close()

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
