"""Device ops of the port: hand-written CUDA kernels and torch primitives
for the stream hot paths (the JAX package's ``nnstreamer_tpu.ops``)."""

from .classify import top1, topk_indices
from .preprocess import normalize_frame, normalize_frame_reference

__all__ = ["normalize_frame", "normalize_frame_reference", "top1",
           "topk_indices"]
