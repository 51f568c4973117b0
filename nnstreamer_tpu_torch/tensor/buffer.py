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
    """True when ``x`` is a tensor resident on a CUDA device, or a
    :class:`BatchView` (a row of a batched filter's output, which stays
    where that filter ran)."""
    return isinstance(x, BatchView) or (isinstance(x, torch.Tensor)
                                        and x.is_cuda)


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


class BatchView:
    """Zero-copy per-frame view into a batched output tensor.

    The counterpart of the JAX package's ``BatchView``: a batched
    ``tensor_filter`` invoke produces ONE tensor of shape ``(bucket,
    *frame_shape)`` per output.  With ``output-device=true`` the filter
    emits one view per frame instead of copying the batch to the host,
    and:

    - a DOWNSTREAM batched filter recognizes contiguous views over the
      same underlying tensor and feeds the batch on to its own forward
      (one device copy into its graph's static input, no per-frame ops);
    - a host consumer (decoder, sink, numpy code) triggers ``__array__``,
      which copies the WHOLE underlying batch to the host once (cached
      and shared by all sibling views) and returns its row.

    Views are immutable handles; ``shape``/``dtype`` describe the single
    frame, not the batch.
    """

    __slots__ = ("batch", "index", "_cache")

    def __init__(self, batch: torch.Tensor, index: int, cache: dict) -> None:
        self.batch = batch      # shape (bucket, *frame_shape)
        self.index = int(index)
        self._cache = cache     # shared per underlying tensor: {"host": np}

    @property
    def shape(self):
        return tuple(self.batch.shape[1:])

    @property
    def dtype(self):
        return self.batch.dtype

    def device_slice(self) -> torch.Tensor:
        """This frame as its own tensor (a view of the batch: the slow
        path; batch-aware consumers use ``batch`` directly)."""
        return self.batch[self.index]

    def _host_batch(self) -> np.ndarray:
        host = self._cache.get("host")
        if host is None:
            host = self._cache["host"] = to_host(self.batch)
        return host

    def __array__(self, dtype=None, copy=None):
        row = self._host_batch()[self.index]
        if dtype is not None and row.dtype != np.dtype(dtype):
            return row.astype(dtype)
        # an independent row: the host batch is SHARED by sibling views,
        # and consumers may mutate what they np.asarray'd
        return row.copy()

    def __repr__(self) -> str:
        return (f"BatchView(row {self.index} of "
                f"{tuple(self.batch.shape)} {self.batch.dtype})")


class XBatchMeta:
    """Descriptor of a cross-stream batch buffer (rides
    ``buf.extra["nns_xbatch"]``), the JAX package's ``XBatchMeta``.

    A serving plane that coalesces admitted frames from MANY client
    connections stacks them into ONE :class:`TensorBuffer` along a new
    leading axis (``(n, *frame_shape)`` per tensor index), so the whole
    bucket traverses the pipeline as a single dispatch.  This meta
    carries what the split point needs to hand each row back, in bucket
    order:

    - ``extras[i]``: row *i*'s original per-frame ``buf.extra`` dict;
    - ``pts[i]``: row *i*'s presentation timestamp;
    - ``capacity``: the bucket size the batcher collects toward, the pad
      target of partial-bucket invokes (``TorchExecMixin.invoke_stacked``),
      so a bounded set of graphs serves every fill.

    ``n`` (the live row count) is ``len(extras)``; stacked tensors may
    carry MORE than ``n`` rows after a padded invoke — rows past ``n``
    are padding and must never be replied.
    """

    __slots__ = ("extras", "pts", "capacity")

    def __init__(self, extras, pts, capacity: int) -> None:
        self.extras = list(extras)
        self.pts = list(pts)
        self.capacity = int(capacity)

    @property
    def n(self) -> int:
        return len(self.extras)

    def __repr__(self) -> str:
        return f"XBatchMeta(n={self.n}, capacity={self.capacity})"


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
