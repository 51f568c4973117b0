"""Device NMS and the top-k reductions: the port against the JAX package.

The same numpy candidates (boxes, scores with exact ties, classes) go
through ``nnstreamer_tpu.ops.nms.device_nms`` and the port's
``device_nms``: classes, scores and the survivor count must be equal
exactly, boxes within 1e-6; under ``torch.func.vmap`` (the batched
filter maps the fused decode over its bucket) each row must equal the
per-row call bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.decoders.boundingbox import DetectedObject, nms
from nnstreamer_tpu.ops.classify import top1 as jax_top1
from nnstreamer_tpu.ops.classify import topk_indices as jax_topk
from nnstreamer_tpu.ops.nms import device_nms as jax_nms
from nnstreamer_tpu.ops.nms import pairwise_iou as jax_iou
from nnstreamer_tpu_torch.ops import top1, topk_indices
from nnstreamer_tpu_torch.ops.nms import device_nms, pairwise_iou


def _candidates(rng, n, classes=3, ties=8):
    """``n`` boxes with ``ties``-level quantized scores (exact ties)."""
    y0 = rng.random(n).astype(np.float32) * 0.8
    x0 = rng.random(n).astype(np.float32) * 0.8
    boxes = np.stack([y0, x0,
                      y0 + 0.05 + rng.random(n).astype(np.float32) * .3,
                      x0 + 0.05 + rng.random(n).astype(np.float32) * .3],
                     axis=1)
    scores = (np.round(rng.random(n) * ties) / ties).astype(np.float32)
    cls = rng.integers(1, 1 + classes, n).astype(np.int32)
    return boxes, scores, cls


def _both(boxes, scores, cls, **kw):
    want = [np.asarray(a) for a in jax_nms(boxes, scores, cls, **kw)]
    got = [a.numpy() for a in device_nms(torch.from_numpy(boxes),
                                         torch.from_numpy(scores),
                                         torch.from_numpy(cls), **kw)]
    return got, want


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    np.testing.assert_array_equal(got[1], want[1])     # classes
    np.testing.assert_array_equal(got[2], want[2])     # scores
    np.testing.assert_array_equal(got[3], want[3])     # num
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)


@pytest.mark.parametrize("n,k", [(64, 64), (64, 20), (200, 100), (7, 100),
                                 (1, 1), (130, 1)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_device_nms_matches_jax(n, k, seed):
    rng = np.random.default_rng(100 * seed + n)
    boxes, scores, cls = _candidates(rng, n)
    got, want = _both(boxes, scores, cls, k=k, iou_thresh=0.5,
                      score_thresh=0.3)
    _assert_same(got, want)


def test_ties_keep_the_lower_index_first():
    """All scores equal and every box the same: the stable sort keeps the
    candidates in index order, so the FIRST index survives, as with
    ``lax.top_k``; the top-k cut among ties keeps the lowest indices."""
    n = 50
    boxes = np.tile(np.array([[0.1, 0.1, 0.5, 0.5]], np.float32), (n, 1))
    scores = np.full(n, 0.75, np.float32)
    cls = np.ones(n, np.int32)
    got, want = _both(boxes, scores, cls, k=10, iou_thresh=0.5)
    _assert_same(got, want)
    assert got[3][0] == 1 and got[1][0] == 1 and (got[1][1:] == -1).all()
    # a distinct box at index 3 ranks among the top 10 of the tie
    boxes[3] = [0.6, 0.6, 0.9, 0.9]
    got, want = _both(boxes, scores, cls, k=10, iou_thresh=0.5)
    _assert_same(got, want)
    assert got[3][0] == 2


def test_nothing_passes_the_threshold():
    rng = np.random.default_rng(5)
    boxes, scores, cls = _candidates(rng, 30)
    got, want = _both(boxes, scores * 0.1, cls, k=10, score_thresh=0.5)
    _assert_same(got, want)
    assert got[3][0] == 0 and (got[1] == -1).all() and (got[2] == 0).all()


def test_device_nms_matches_host_oracle():
    """The greedy per-class semantics of the host decoder's ``nms``."""
    rng = np.random.default_rng(0)
    boxes, scores, cls = _candidates(rng, 64, ties=1000)
    b, c, s, num = (a.numpy() for a in device_nms(
        torch.from_numpy(boxes), torch.from_numpy(scores),
        torch.from_numpy(cls), k=64, iou_thresh=0.5, score_thresh=0.3))
    got = [(int(ci), round(float(si), 6), tuple(np.round(bi, 4)))
           for bi, ci, si in zip(b, c, s) if ci >= 0]
    assert len(got) == int(num[0])
    objs = [DetectedObject(int(c_), float(s_), *map(float, bx))
            for bx, c_, s_ in zip(boxes, cls, scores) if s_ >= 0.3]
    want = [(o.class_id, round(o.score, 6),
             tuple(np.round(np.float32([o.ymin, o.xmin, o.ymax, o.xmax]),
                            4)))
            for o in nms(objs)]
    assert got == want


@pytest.mark.parametrize("k", [32, 12])
def test_device_nms_under_vmap_equals_per_row(k):
    rng = np.random.default_rng(6)
    rows = [_candidates(rng, 32, classes=2, ties=4) for _ in range(4)]
    boxes, scores, cls = (torch.from_numpy(np.stack(a)) for a in zip(*rows))
    batched = torch.func.vmap(lambda b, s, c: device_nms(
        b, s, c, k=k, score_thresh=0.3))(boxes, scores, cls)
    for i, (b, s, c) in enumerate(rows):
        one = device_nms(torch.from_numpy(b), torch.from_numpy(s),
                         torch.from_numpy(c), k=k, score_thresh=0.3)
        for v, o in zip(batched, one):
            assert torch.equal(v[i], o)
        _assert_same([o.numpy() for o in one],
                     [np.asarray(a) for a in jax_nms(b, s, c, k=k,
                                                     score_thresh=0.3)])


def test_pairwise_iou_matches_jax():
    rng = np.random.default_rng(3)
    boxes, _, _ = _candidates(rng, 40)
    boxes[5] = boxes[6] = [0.2, 0.2, 0.2, 0.2]          # zero area
    np.testing.assert_allclose(pairwise_iou(torch.from_numpy(boxes)).numpy(),
                               np.asarray(jax_iou(jnp.asarray(boxes))),
                               atol=1e-7, rtol=0)


@pytest.mark.parametrize("k", [1, 5, 17])
def test_topk_indices_match_jax_with_ties(k):
    rng = np.random.default_rng(k)
    scores = (np.round(rng.random((3, 11)) * 4) / 4).astype(np.float32)
    got = topk_indices(torch.from_numpy(scores), k).numpy()
    want = np.asarray(jax_topk(jnp.asarray(scores), k))
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_top1_matches_jax_with_ties():
    scores = np.array([0.1, 0.7, 0.3, 0.7], np.float32)
    got = top1(torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_top1(scores)))
    assert got.dtype == np.int32 and got.tolist() == [1]

