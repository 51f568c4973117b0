"""Shared torch execution engine for device backends.

The counterpart of ``nnstreamer_tpu/filter/backends/_jitexec.py``: any
backend whose model is an ``nn.Module`` taking one unbatched frame per
input gets the same hot-path discipline —

- the model lives on its device from open onward (weights move once);
- a warm-up invoke at open, so frame 1 is steady state (cuDNN picks its
  algorithms and the CUDA kernels are built then);
- ``invoke`` enqueues the work and returns device tensors WITHOUT a host
  sync; :meth:`TensorBuffer.np` downstream is the one sync point;
- :meth:`set_postprocess` composes a decoder-pushed reduction into the
  forward, so only the reduced (small) outputs cross to the host.

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

from ...device import resolve_device
from ..framework import Accelerator, FilterError


class TorchExecMixin:
    """Execution engine over ``self._forward_fn`` / ``self._device``
    (set by :meth:`_setup_exec`)."""

    def _setup_exec(self, forward_fn, device: torch.device,
                    warmup_inputs=None):
        """Stage the forward and run the optional warm-up invoke.  Returns
        the warm-up outputs."""
        self._device = device
        self._forward_fn = forward_fn
        self._postprocess_fn = None
        if warmup_inputs is None:
            return None
        outs = self._invoke_device(warmup_inputs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return outs

    def _teardown_exec(self) -> None:
        self._forward_fn = None
        self._postprocess_fn = None

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
        arr = np.asarray(x)
        if not arr.flags.writeable:
            arr = arr.copy()          # torch.from_numpy needs a writable array
        return torch.from_numpy(arr).to(self._device, non_blocking=True)

    def _invoke_device(self, inputs: List[Any]):
        xs = [self._to_device(x) for x in inputs]
        with torch.inference_mode():
            return self._forward_fn(*xs)

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
        # marker for the element's post-reload re-apply: a backend that
        # still carries the fusion must NOT be fused again
        self._postprocess_fn = fn
        return True

    def has_postprocess(self) -> bool:
        return getattr(self, "_postprocess_fn", None) is not None
