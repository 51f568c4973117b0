"""Device-side non-maximum suppression (static shapes, graph-capturable).

The counterpart of ``nnstreamer_tpu/ops/nms.py``.  The reference decodes
SSD boxes and runs greedy NMS on the host CPU (tensordec-boundingbox.c nms
+ the per-scheme decode); here the whole detection tail — prior decode,
thresholding, top-K cap, greedy per-class NMS — runs inside the filter's
CUDA graph, so only the <= K surviving boxes cross device→host.

Everything is static-shape and free of host syncs (no ``.item()``,
``nonzero``, boolean-mask indexing or branch on a tensor value), so it is
captured in a graph and lifts over a batch axis under ``torch.func.vmap``
(the micro-batched filter maps the fused decode over its bucket):

- candidates are the top ``k`` scores by a STABLE descending sort, so
  equal scores keep the lower index first, as ``lax.top_k`` does
  (``torch.topk`` on CUDA promises no order among ties);
- the greedy scan is a Python loop over the static ``k`` that clears
  ``keep[i]`` through a one-hot mask when an earlier kept box of the same
  class overlaps box ``i`` by more than the threshold (the JAX package's
  ``lax.fori_loop`` over its keep mask).  Each step launches a handful of
  small kernels: ~100 steps of them a call.
"""

from __future__ import annotations

import torch


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """(K, 4) yxyx corners -> (K, K) IoU matrix (0 where union is 0)."""
    ymin, xmin, ymax, xmax = (boxes[:, i] for i in range(4))
    area = (ymax - ymin) * (xmax - xmin)
    iy = (torch.minimum(ymax[:, None], ymax[None, :])
          - torch.maximum(ymin[:, None], ymin[None, :]))
    ix = (torch.minimum(xmax[:, None], xmax[None, :])
          - torch.maximum(xmin[:, None], xmin[None, :]))
    inter = iy.clamp_min(0.0) * ix.clamp_min(0.0)
    union = area[:, None] + area[None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def device_nms(boxes: torch.Tensor, scores: torch.Tensor,
               classes: torch.Tensor, k: int = 100,
               iou_thresh: float = 0.5, score_thresh: float = 0.0):
    """Greedy per-class NMS over the top-``k`` candidates.

    Args:
      boxes: (N, 4) yxyx corners (already decoded to image space).
      scores: (N,) — entries below ``score_thresh`` are dropped.
      classes: (N,) int class ids.

    Returns ``(boxes (k,4) f32, classes (k,) i32, scores (k,) f32,
    num (1,) i32)``: score-descending; suppressed/invalid slots carry
    class -1 / score 0, and ``num`` counts the survivors — the output
    contract of the reference's ssd-postprocess tensors.
    """
    n = scores.shape[0]
    k = min(k, n)
    sc = torch.where(scores >= score_thresh, scores.float(),
                     torch.full_like(scores, float("-inf"),
                                     dtype=torch.float32))
    top, idx = torch.sort(sc, descending=True, stable=True)
    top, idx = top[:k], idx[:k]
    b = torch.index_select(boxes, 0, idx).float()
    c = torch.index_select(classes, 0, idx).to(torch.int32)
    valid = torch.isfinite(top)
    top = torch.where(valid, top, torch.zeros_like(top))
    same_cls = c[:, None] == c[None, :]
    order = torch.arange(k, device=scores.device)
    # conflict[i, j] for an earlier candidate j < i only: the one mask
    # each step reads
    earlier = ((pairwise_iou(b) > iou_thresh) & same_cls
               & (order[None, :] < order[:, None]))
    onehot = order[None, :] == order[:, None]
    keep = valid
    for i in range(k):
        sup = (earlier[i] & keep).any()
        keep = keep & ~(onehot[i] & sup)
    out_c = torch.where(keep, c, torch.full_like(c, -1))
    out_s = torch.where(keep, top, torch.zeros_like(top))
    return (b, out_c, out_s,
            keep.to(torch.int32).sum().to(torch.int32).reshape(1))
