"""The numbers that decide ``correct``: what the timed path produced,
held to the plain reference.

Labels: the gap by which the reference's logit of the served label lies
below the reference's best logit of that frame, in units of the standard
deviation of the frame's reference logits (so the number means the same
at any scale of the weights); the widest over every answered frame, and
the mean over them (a label served in a lower precision flips on near
ties, so the mean grows with the square of the precision's error where
the widest grows with the error).

Training: each checked step's loss, the first gradient as the optimizer
holds it after one step, and the parameters' change after the checked
steps, the last two by the worst leaf: the gap between the program's norm
of a leaf and the reference's (``grad_gap``, ``change_gap``), over the
reference's norm of that leaf or of the median leaf, whichever is larger.
A gap of norms is blind to a leaf of the right norm in the wrong
direction (a transposed or swapped gradient), so the first gradient is
also held by the norm of the difference between the two leaves over the
same scale (``grad_diff``).  The change has no such number: under Adam
its first steps move an element by about the learning rate whatever the
size of its gradient, so an element whose gradient is near nought moves
either way on rounding, and the difference of sound runs is as large as
a fault's (``change_diff`` is read, not compared).  A leaf whose
reference gradient is under a thousandth of the median leaf's moves by
round-off alone, and is left out of the change.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch

#: a leaf whose first reference gradient is below this share of the
#: median leaf's is left out of the parameters' change
STILL_LEAF = 1e-3


def label_gaps(ref_logits: torch.Tensor) -> torch.Tensor:
    """``(frames, classes)`` -> each label's gap below the frame's best,
    in units of the frame's logit standard deviation."""
    ref = ref_logits.double()
    best = ref.max(dim=-1, keepdim=True).values
    return (best - ref) / ref.std(dim=-1, keepdim=True)


def widest_label_gap(gaps: torch.Tensor,
                     answers: Iterable[Tuple[int, Optional[int]]]) -> float:
    """The widest gap over ``(frame, served label)`` answers; a label that
    is missing or out of range is infinitely wrong."""
    table = gaps.cpu()
    classes = table.shape[1]
    widest = 0.0
    seen: Dict[Tuple[int, int], float] = {}
    for frame, label in answers:
        if label is None or not 0 <= int(label) < classes:
            return float("inf")
        key = (frame, int(label))
        if key not in seen:
            seen[key] = float(table[frame, int(label)])
            widest = max(widest, seen[key])
    return widest


def mean_label_gap(gaps: torch.Tensor,
                   answers: Iterable[Tuple[int, Optional[int]]]) -> float:
    """The mean gap over ``(frame, served label)`` answers; a label that
    is missing or out of range is infinitely wrong."""
    answers = list(answers)
    if not answers:
        return 0.0
    classes = gaps.shape[1]
    if any(label is None or not 0 <= int(label) < classes
           for _, label in answers):
        return float("inf")
    frames = torch.tensor([f for f, _ in answers])
    labels = torch.tensor([int(label) for _, label in answers])
    return float(gaps.cpu()[frames, labels].mean())


def leaf_gap(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
             names: Iterable[str], difference: bool = False
             ) -> Tuple[float, str]:
    """The worst leaf's gap among ``names`` and its name: the gap of the
    two norms, or with ``difference`` the norm of the difference, over
    the larger of the reference's norm of the leaf and of the median
    leaf (module doc); a leaf missing from ``got`` reads as zeros."""
    names = list(names)
    want_n = {n: float(want[n].double().norm()) for n in names}
    floor = statistics.median(want_n.values())
    worst, leaf = 0.0, ""
    for n in names:
        w = want[n].double()
        g = got[n].double() if n in got else torch.zeros_like(w)
        off = float((g - w).norm()) if difference else abs(
            float(g.norm()) - want_n[n])
        gap = off / max(want_n[n], floor)
        if not gap <= worst:          # a NaN is the worst
            worst, leaf = gap, n
    return worst, leaf


def leaf_numbers(first: Dict[str, torch.Tensor], change: Dict[str, torch.Tensor],
                 ref_first: Dict[str, torch.Tensor],
                 ref_change: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The training cell's leaf numbers (module doc) and, for each, the
    leaf behind it."""
    moving = moving_leaves(ref_first)
    out = {"grad_gap": leaf_gap(first, ref_first, ref_first),
           "grad_diff": leaf_gap(first, ref_first, ref_first, True),
           "change_gap": leaf_gap(change, ref_change, moving),
           "change_diff": leaf_gap(change, ref_change, moving, True)}
    return ({k: v for k, (v, _) in out.items()},
            {k: leaf for k, (_, leaf) in out.items()})


def moving_leaves(first_grad: Dict[str, torch.Tensor]):
    """Leaves whose reference gradient is not nought to rounding."""
    norms = {n: float(g.double().norm()) for n, g in first_grad.items()}
    floor = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= STILL_LEAF * floor]


def loss_gap(got, want) -> float:
    """The widest relative gap between the program's losses and the
    reference's, step by step (a missing step reads infinite)."""
    if len(got) < len(want):
        return float("inf")
    return max(abs(g - w) / abs(w) for g, w in zip(got, want))


def checks(numbers: Dict[str, float], limits: Dict[str, float]) -> dict:
    """``{name: {"value", "limit"}}`` of every number the cell compares:
    those its ``limits`` name (a number that no control or fault separates
    from sound runs gets no limit, and is not compared)."""
    return {n: {"value": v, "limit": limits[n]} for n, v in numbers.items()
            if n in limits}


def passed(table: dict) -> bool:
    return all(row["value"] <= row["limit"] for row in table.values())


class exact_f32:
    """float32 products without TF32 inside the block (the reference's
    precision on the card)."""

    def __enter__(self):
        self._was = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._was
