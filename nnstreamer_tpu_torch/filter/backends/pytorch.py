"""PyTorch (TorchScript) filter backend, run natively on the card.

The port of ``nnstreamer_tpu/filter/backends/pytorch.py`` (reference:
ext/nnstreamer/tensor_filter/tensor_filter_pytorch.cc).  A TorchScript
``.pt`` carries no input meta, so the caller supplies ``input_info`` (the
element's ``input``/``inputtype`` properties); output meta comes from a
zero probe at open (the open's warm-up invoke), as in the reference's
``getModelInfo`` path, and ``set_input_info`` probes again.  A declared
``output_info`` that disagrees with the probe raises.

Where the JAX package lowers the graph to XLA, the port loads it with
``torch.jit.load``, moves its parameters and buffers to the device (the
code's 0-dim constants stay host scalars), freezes the eval module
(``torch.jit.freeze``) and serves it through
:class:`~._torchexec.TorchExecMixin`: one CUDA graph per input signature
on the card, batching (``torch.func.vmap`` of the module) and pushdown
included.  The module computes in its own dtype (f32 for the usual
``.pt``), as the JAX backend does.  There is no fallback: a graph that
cannot be captured raises :class:`FilterError`, and a graph with a
constant pinned to another device than the filter's (a trace taken on
the CPU can hard-code ``device=cpu`` in a tensor constructor) is refused
at open with the node, so no part of a card run happens on the CPU
unseen.

``custom=executor:torch`` runs the module through the TorchScript
interpreter without capture, on the filter's device (never a hidden CPU
run).  ``executor`` says which ran (``torchexec`` or ``torch``);
``fallback_reason`` stays empty.
"""

from __future__ import annotations

import os
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ...tensor.info import TensorInfo, TensorsInfo
from ..framework import (Accelerator, FilterError, FilterFramework,
                         FilterProperties, FilterStatistics, register_filter)
from ..torchscript import UnsupportedTorchOp
from ._torchexec import TorchExecMixin


def pinned_elsewhere(value, device: torch.device):
    """The other device a graph constant ``value`` pins work to, or None:
    a tensor or a ``torch.device`` of another type than ``device``'s.  A
    0-dim host tensor is a scalar, which every device's ops take (a CPU
    trace records its shape arithmetic so); it pins nothing."""
    if isinstance(value, torch.Tensor):
        if value.dim() == 0 and value.device.type == "cpu":
            return None
        where = value.device
    elif isinstance(value, torch.device):
        where = value
    else:
        return None
    return where if where.type != device.type else None


def check_device(graph, device: torch.device) -> None:
    """Raise :class:`UnsupportedTorchOp` at the first node of ``graph``
    (blocks included) whose constant :func:`pinned_elsewhere`."""
    todo = [graph]
    while todo:
        g = todo.pop()
        for node in g.nodes():
            todo.extend(node.blocks())
            if node.kind() != "prim::Constant":
                continue
            out = node.output()
            typ = out.type()
            if not (isinstance(typ, torch._C.TensorType)
                    or typ.kind() == "DeviceObjType"):
                continue
            try:
                value = out.toIValue()
            except RuntimeError:
                continue
            where = pinned_elsewhere(value, device)
            if where is not None:
                raise UnsupportedTorchOp(
                    f"node {str(node).strip()} pins {where} but the filter "
                    f"runs on {device}")


@register_filter
class PyTorchFilter(TorchExecMixin, FilterFramework):
    """``framework=pytorch``: a TorchScript model on the card."""

    NAME = "pytorch"
    SUPPORTED_ACCELERATORS = (Accelerator.GPU, Accelerator.CPU)

    def __init__(self) -> None:
        super().__init__()
        self._module = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        #: "torchexec" (captured on the card, eager on the CPU) or
        #: "torch" (custom=executor:torch: uncaptured, filter's device)
        self.executor: str = ""
        #: kept for tensor_filter's introspection; the port has no
        #: fallback, so it stays empty
        self.fallback_reason: str = ""
        self.stats = FilterStatistics()

    # -- lifecycle -----------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        path = str(props.model)
        if not os.path.isfile(path):
            raise FilterError(f"pytorch: model file not found: {path}")
        if props.input_info is None or not props.input_info.is_valid():
            raise FilterError(
                "pytorch: input_info required (TorchScript files carry no "
                "input meta; set the input/inputtype properties — reference "
                "tensor_filter_pytorch.cc contract)")
        device = self._pick_device(props.accelerators)
        try:
            # parameters and buffers move to the device; the code's own
            # constants stay where the file put them: a CPU trace's 0-dim
            # constants are the host scalars of its shape arithmetic,
            # which must not become device reads inside a capture
            module = torch.jit.load(path, map_location="cpu").to(device)
        except (RuntimeError, ValueError, OSError) as e:
            raise FilterError(f"pytorch: cannot load {path}: {e}")
        module.eval()
        try:
            module = torch.jit.freeze(module)
        except RuntimeError as e:
            raise FilterError(f"pytorch: cannot freeze {path}: {e}")
        try:
            check_device(module.graph, device)
        except UnsupportedTorchOp as e:
            raise FilterError(f"pytorch: {path}: {e}")
        self._module = module
        self._in_info = props.input_info.copy()
        eager = props.custom_properties.get("executor") == "torch"
        self.executor = "torch" if eager else "torchexec"
        self.fallback_reason = ""
        if eager:
            # shadows the class attribute: this instance never captures
            self._eager = True
        zeros = [np.zeros(i.np_shape, i.np_dtype) for i in self._in_info]
        # the warm-up outputs double as the output-meta probe
        outs = self._setup_exec(self._forward, device, warmup_inputs=zeros)
        self._check_declared_output(props, self._probe(outs))
        super().open(props)

    def _forward(self, *xs):
        # the interpreter runs the frozen graph as it is: the profiling
        # executor would otherwise specialise and compile fusions on a
        # later call, which a CUDA graph capture refuses
        with torch.jit.optimized_execution(False):
            out = self._module(*xs)
        return tuple(out) if isinstance(out, (tuple, list)) else (out,)

    @staticmethod
    def _probe(outs) -> TensorsInfo:
        return TensorsInfo([TensorInfo.from_np(np.zeros(
            tuple(o.shape), torch.empty((), dtype=o.dtype).numpy().dtype))
            for o in outs])

    def _check_declared_output(self, props: FilterProperties,
                               probed: TensorsInfo) -> None:
        if props.output_info is not None and props.output_info.is_valid():
            if not props.output_info.is_equal(probed):
                raise FilterError(
                    f"pytorch: declared output {props.output_info} != "
                    f"model output {probed}")
            self._out_info = props.output_info.copy()
        else:
            self._out_info = probed

    def close(self) -> None:
        self._module = None
        self._teardown_exec()
        super().close()

    # -- model meta ----------------------------------------------------------
    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        if self._module is None:
            raise FilterError("pytorch: not opened")
        return self._in_info, self._out_info

    def set_input_info(self, in_info: TensorsInfo
                       ) -> Tuple[TensorsInfo, TensorsInfo]:
        """Re-probe with new input shapes (reference SET_INPUT_INFO)."""
        self._in_info = in_info.copy()
        zeros = [np.zeros(i.np_shape, i.np_dtype) for i in in_info]
        self._out_info = self._probe(self.invoke(zeros))
        return self._in_info, self._out_info

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        return isinstance(model, str) and model.endswith((".pt", ".pth"))
