"""Token-streaming LLM serving tier: session-keyed KV-cache pool +
continuous-batching decode plane.

The PyTorch counterpart of ``nnstreamer_tpu/llm/``, dense slot pool only:

- **pool.py** — :class:`KVCachePool`: fixed ``max_seq`` cache slots,
  two preallocated tensors on the device; slot admission rides the
  :class:`~nnstreamer_tpu_torch.query.overload.AdmissionController`;
- **engine.py** — :class:`DecodeEngine`: one padded
  ``decode_step_pooled`` per step over the active lanes, prompt prefill
  through the flash-attention kernel, in-place cache updates and
  conserved :class:`PhaseClock` attribution.

The paged pool, the ``tensor_llm`` element, the client and token-level
observability are not ported yet (ROADMAP A8/A9).
"""

from .engine import DecodeEngine, PhaseClock
from .pool import KVCachePool, slot_admission_controller

__all__ = ["DecodeEngine", "KVCachePool", "PhaseClock",
           "slot_admission_controller"]
