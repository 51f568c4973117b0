"""Shared torch execution engine for device backends.

The counterpart of ``nnstreamer_tpu/filter/backends/_jitexec.py``: any
backend whose model is an ``nn.Module`` taking one unbatched frame per
input gets the same hot-path discipline —

- the model lives on its device from open onward (weights move once);
- one executable per input signature (the ``(shape, dtype)`` of each
  input, the key of the JAX package's ``_ledger_note``): on the card a
  ``torch.cuda.CUDAGraph`` (:class:`~nnstreamer_tpu_torch._cuda.
  CapturedGraph`) with static input buffers, captured after one eager
  run of the forward on a side stream; ``invoke`` copies the frame into
  the static inputs on the current stream and replays.  A capture or
  replay that fails raises :class:`FilterError`; nothing falls back to
  eager execution.  On the CPU (``accelerator=true:cpu``) the forward
  runs eagerly;
- each new signature is a compile: it is recorded in the compile ledger
  (site ``filter.jitexec.invoke``) on either device;
- a warm-up invoke at open, so frame 1 is steady state (the open
  signature is captured then, cuDNN picks its algorithms and the CUDA
  kernels are built);
- ``invoke`` enqueues the work and returns device tensors WITHOUT a host
  sync; :meth:`TensorBuffer.np` downstream is the one sync point.  A
  replay's outputs are cloned before they are handed on: a sink may hold
  device tensors, and the next replay overwrites the graph's own (a
  clone is one device copy an output, and right whatever a consumer
  keeps, where a ring of graphs would be right only while it holds fewer
  frames than the ring has slots);
- :meth:`set_postprocess` composes a decoder-pushed reduction into the
  forward, so only the reduced (small) outputs cross to the host; it
  drops the graphs, and :meth:`warmup` captures the fused forward.

The :meth:`TorchExecMixin.pad_rows` quantizer is ported (the LLM decode
engine pads its lanes with it); micro-batched invoke
(``invoke_batched``/``invoke_stacked``), the mesh and the compute-dtype
wrapper are not ported yet.
"""

from __future__ import annotations

import time
from typing import Any, List

import numpy as np
import torch

from ... import _cuda
from ...analysis import compileledger
from ...device import resolve_device
from ..framework import Accelerator, FilterError


def _signature(inputs) -> tuple:
    """The executable key of a dispatch: ``(shape, dtype name)`` of each
    input, with ``uint8`` for ``torch.uint8`` and ``np.dtype('uint8')``
    alike (the name ``str`` gives a JAX array's dtype)."""
    return tuple((tuple(x.shape), str(x.dtype).rpartition(".")[2])
                 for x in inputs)


class TorchExecMixin:
    """Execution engine over ``self._forward_fn`` / ``self._device``
    (set by :meth:`_setup_exec`)."""

    #: private: run the forward eagerly on the card as well, for a
    #: reference run to hold the graphs to (set on the class or an
    #: instance by tests and chip_smoke.py; not a launch property)
    _eager = False

    def _setup_exec(self, forward_fn, device: torch.device,
                    warmup_inputs=None):
        """Stage the forward and run the optional warm-up invoke, which
        captures the open signature on the card.  Returns the warm-up
        outputs."""
        self._device = device
        self._forward_fn = forward_fn
        self._postprocess_fn = None
        self._drop_execs()
        if warmup_inputs is None:
            return None
        outs = self._invoke_device(warmup_inputs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return outs

    def _teardown_exec(self) -> None:
        self._forward_fn = None
        self._postprocess_fn = None
        self._drop_execs()

    def _drop_execs(self) -> None:
        """Forget every executable: the next dispatch of each signature
        is a compile again."""
        #: signature -> its CapturedGraph (None where the forward runs
        #: eagerly: the CPU, or ``_eager``)
        self._execs = {}
        self._graph_memory = None

    @staticmethod
    def _pick_device(accelerators) -> torch.device:
        """``accelerator=true:cpu`` runs on the CPU; anything else runs on
        ``cuda:0`` and raises when this host has no CUDA device."""
        want = accelerators[0] if accelerators else Accelerator.AUTO
        if want is Accelerator.CPU:
            return torch.device("cpu")
        if want is Accelerator.NONE:
            raise FilterError("accelerator=false: this backend runs on a "
                              "device; ask for the CPU with "
                              "accelerator=true:cpu")
        try:
            return resolve_device(None)
        except RuntimeError as exc:
            raise FilterError(str(exc)) from exc

    @staticmethod
    def pad_rows(n: int, capacity: int = 0) -> int:
        """Quantized pad target for an ``n``-row partial bucket: next
        power of two up to 8, then multiples of 8, capped at
        ``capacity`` — waste <= 7 rows above 8 and a bounded set of
        shapes (``4 + capacity/8``) over every fill."""
        cap = max(int(capacity), n, 1)
        if n <= 8:
            bucket = 1
            while bucket < n:
                bucket <<= 1
        else:
            bucket = (n + 7) & ~7
        return min(bucket, cap)

    # -- hot path ------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x if x.device == self._device else \
                x.to(self._device, non_blocking=True)
        return _cuda.host_tensor(x).to(self._device, non_blocking=True)

    def _graphed(self) -> bool:
        return self._device.type == "cuda" and not self._eager

    def _invoke_device(self, inputs: List[Any]):
        key = _signature(inputs)
        with torch.inference_mode():
            if key not in self._execs:
                outs = self._compile(key, inputs)
                if outs is not None:
                    return outs
            graph = self._execs[key]
            if graph is not None:
                return self._replay(graph, inputs)
            return self._forward_fn(*[self._to_device(x) for x in inputs])

    def _compile(self, key, inputs: List[Any]):
        """A new signature: record it in the compile ledger and, on the
        card, capture the forward.  Returns the outputs of the eager run
        that precedes the capture (this dispatch's result), or None where
        the forward stays eager."""
        if compileledger.ENABLED:
            compileledger.record("filter.jitexec.invoke", tuple(
                (f"arg[{i}]", k) for i, k in enumerate(key)))
        if not self._graphed():
            self._execs[key] = None
            return None
        if self._graph_memory is None:
            self._graph_memory = _cuda.graph_memory(self._device)
        statics = [self._to_device(x).clone() for x in inputs]
        try:
            graph = _cuda.CapturedGraph(self._forward_fn, statics,
                                        self._graph_memory)
        except RuntimeError as exc:
            raise FilterError(f"{self.NAME}: CUDA graph capture of the "
                              f"forward for {key} failed: {exc}") from exc
        self._execs[key] = graph
        return tuple(graph.first)

    def _replay(self, graph, inputs: List[Any]):
        try:
            for static, x in zip(graph.inputs, inputs):
                static.copy_(_cuda.host_tensor(x), non_blocking=True)
            outs = graph.replay()
        except RuntimeError as exc:
            raise FilterError(f"{self.NAME}: CUDA graph replay failed: "
                              f"{exc}") from exc
        return tuple(o.clone() for o in outs)

    def warmup(self) -> None:
        """Compile the forward for the model's input signature now, so
        the next frame is steady state: the element calls it when a
        decoder's pushdown has just dropped the graphs.  On the card that
        is a capture (with its eager run, on zeros); where the forward
        runs eagerly it is only the ledger's record."""
        in_info, _ = self.get_model_info()
        zeros = [np.zeros(i.np_shape, i.np_dtype) for i in in_info]
        key = _signature(zeros)
        if key in self._execs:
            return
        with torch.inference_mode():
            self._compile(key, zeros)
        if self._graphed():
            torch.cuda.synchronize(self._device)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        t0 = time.monotonic_ns()
        outs = self._invoke_device(inputs)
        self.stats.record(time.monotonic_ns() - t0)
        return list(outs)

    def set_postprocess(self, fn) -> bool:
        """Compose a decoder-pushed reduction into the forward: the
        reduced (small) outputs are what cross to the host."""
        base_fwd = self._forward_fn

        def fused(*xs):
            return tuple(fn(list(base_fwd(*xs))))

        self._forward_fn = fused
        self._drop_execs()        # new executables: signatures reset
        # marker for the element's post-reload re-apply: a backend that
        # still carries the fusion must NOT be fused again
        self._postprocess_fn = fn
        return True

    def has_postprocess(self) -> bool:
        return getattr(self, "_postprocess_fn", None) is not None
