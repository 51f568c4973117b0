"""Stream buffer: one timestamped frame of N tensors.

The PyTorch counterpart of ``nnstreamer_tpu/tensor/buffer.py`` (the
``GstBuffer`` of N ``GstMemory`` chunks, reference hot path
tensor_filter.c:631-894).

- A tensor payload is an *array handle*: a numpy ndarray (host) or a
  ``torch.Tensor`` (a CUDA tensor is the device handle that ``jax.Array``
  is in the JAX package).  Elements pass handles zero-copy; nothing forces
  a device→host sync until a consumer calls :meth:`TensorBuffer.np`, the
  one sync point, which keeps the filter hot loop asynchronous.
- PTS/DTS/duration are integer nanoseconds like GStreamer clock-time.

The JAX package's pooled payload slabs (``TensorBufferPool``,
``BufferLease``), ``BatchView`` and ``XBatchMeta`` serve the transports
and the micro-batching paths, which this package does not have yet.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

#: Sentinel for "no timestamp" (GStreamer GST_CLOCK_TIME_NONE analogue).
CLOCK_TIME_NONE: Optional[int] = None


def is_device_array(x: Any) -> bool:
    """True when ``x`` is a tensor resident on a CUDA device."""
    return isinstance(x, torch.Tensor) and x.is_cuda


def to_host(x: Any) -> np.ndarray:
    """Materialize a payload handle as a numpy array (syncs a CUDA
    tensor: the copy waits for the work that produces it)."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            # numpy has no bfloat16: hand over the bits as ml_dtypes'
            # bfloat16, the type the JAX package's host arrays have
            import ml_dtypes

            return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return x.numpy()
    return np.asarray(x)


@dataclasses.dataclass
class TensorBuffer:
    """One frame of a tensor stream: N tensor payloads + timestamps.

    ``tensors`` entries are numpy arrays or torch tensors.  ``metas``
    carries an optional per-tensor
    :class:`~nnstreamer_tpu_torch.tensor.meta.TensorMetaInfo` for
    flexible/sparse streams (None for static streams).
    """

    tensors: List[Any] = dataclasses.field(default_factory=list)
    pts: Optional[int] = CLOCK_TIME_NONE
    duration: Optional[int] = CLOCK_TIME_NONE
    metas: Optional[List[Any]] = None
    #: free-form per-buffer metadata (e.g. the decoder's label/index)
    extra: dict = dataclasses.field(default_factory=dict)

    @property
    def num_tensors(self) -> int:
        return len(self.tensors)

    def np(self, i: int = 0) -> np.ndarray:
        """Materialize tensor ``i`` on host (device sync happens HERE and
        only here)."""
        return to_host(self.tensors[i])

    def with_tensors(self, tensors: Sequence[Any]) -> "TensorBuffer":
        """New buffer with same timestamps/extra but different payloads."""
        return TensorBuffer(tensors=list(tensors), pts=self.pts,
                            duration=self.duration, extra=dict(self.extra))

    def __repr__(self) -> str:
        shapes = ",".join(str(tuple(getattr(t, "shape", ()))) for t in self.tensors)
        return f"TensorBuffer(n={self.num_tensors} shapes=[{shapes}] pts={self.pts})"


SECOND = 1_000_000_000


def frames_to_ns(frame_index: int, rate_num: int, rate_den: int) -> int:
    """PTS of frame N at a given framerate, in ns."""
    if rate_num == 0:
        return 0
    return frame_index * SECOND * rate_den // rate_num
