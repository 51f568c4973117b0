"""Token-streaming LLM serving tier: session-keyed KV-cache pools, the
continuous-batching decode plane and the ``tensor_llm`` element.

The PyTorch counterpart of ``nnstreamer_tpu/llm/``, with its names:

- **pool.py** — :class:`KVCachePool`: fixed ``max_seq`` cache slots,
  two preallocated tensors on the device; slot admission rides the
  :class:`~nnstreamer_tpu_torch.query.overload.AdmissionController`;
- **paged.py** — :class:`PagedKVCachePool`: the block-paged arena
  (vLLM/PagedAttention layout) behind the same pool contract — memory
  proportional to what a session uses, content-hash prefix reuse
  (copy-on-write, refcounted), commitment-based page admission;
- **engine.py** — :class:`DecodeEngine`: one padded decode step over the
  active lanes (dense or paged), prompt prefill through the
  flash-attention kernel (dense) or in bounded chunks (paged), in-place
  cache updates, CUDA graphs on the card and conserved
  :class:`PhaseClock` attribution;
- **element.py** — ``tensor_llm``: prompt request frames in, per-token
  ``[1, 1]`` reply frames out through ``tensor_query_serversink`` in
  exact per-client order;
- **tokenobs.py** — :class:`TokenObs`: TTFT/ITL histograms, terminal
  causes and head-of-line blame;
- **client.py** — :class:`TokenStreamClient`: the client half of the
  streaming reply contract over the unchanged query wire protocol.
"""

from .client import TokenStreamClient, TokenTimeoutError
from .engine import DecodeEngine, PhaseClock
from .paged import PagedKVCachePool
from .pool import KVCachePool, slot_admission_controller
from .tokenobs import TokenObs

__all__ = ["DecodeEngine", "KVCachePool", "PagedKVCachePool",
           "PhaseClock", "TokenObs", "TokenStreamClient",
           "TokenTimeoutError", "slot_admission_controller"]
