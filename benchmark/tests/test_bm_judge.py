"""The numbers that decide ``correct``, on hand-made inputs."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import judge


def test_label_gaps_are_in_units_of_the_frames_spread():
    logits = torch.tensor([[0.0, 1.0, 3.0], [2.0, 2.0, -1.0]])
    gaps = judge.label_gaps(logits)
    std = logits.double().std(-1).tolist()
    assert gaps[0].tolist() == pytest.approx([3 / std[0], 2 / std[0], 0.0])
    assert gaps[1].tolist() == pytest.approx([0.0, 0.0, 3 / std[1]])
    served = [(0, 2), (0, 1), (1, 1)]
    assert judge.widest_label_gap(gaps, served) == pytest.approx(2 / std[0])
    assert judge.mean_label_gap(gaps, served) == pytest.approx(
        2 / std[0] / 3)
    for bad in ([(0, None)], [(1, 3)]):
        assert judge.widest_label_gap(gaps, bad) == math.inf
        assert judge.mean_label_gap(gaps, bad) == math.inf


def test_leaf_gaps_are_taken_by_the_worst_leaf():
    want = {"a": torch.full((4,), 1.0), "b": torch.full((4,), 0.001),
            "c": torch.full((4,), 2.0)}
    got = {"a": torch.full((4,), 1.1), "b": torch.full((4,), 0.002),
           "c": torch.full((4,), 2.0)}
    # b's gap is over the median leaf's norm (a's, 2), not its own
    gap, leaf = judge.leaf_gap(got, want, want)
    assert (gap, leaf) == (pytest.approx(0.1), "a")
    assert judge.leaf_gap({}, want, want)[0] == pytest.approx(1.0)


def test_a_leaf_of_the_right_norm_in_the_wrong_direction():
    """reads nought as a gap of norms and as far off as it is by the norm
    of the difference."""
    want = {"q": torch.tensor([[1.0, 2.0], [3.0, 4.0]]),
            "k": torch.tensor([1.0, 0.0]), "v": torch.tensor([0.0, 1.0])}
    norm = float(want["q"].norm())
    # the transpose, and k and v swapped: every norm as the reference's
    got = {"q": want["q"].t(), "k": want["v"], "v": want["k"]}
    assert judge.leaf_gap(got, want, want)[0] == pytest.approx(0.0)
    assert judge.leaf_gap(got, want, ["q"], True)[0] == pytest.approx(
        float((want["q"].t() - want["q"]).norm()) / norm)
    gap, leaf = judge.leaf_gap(got, want, want, True)
    assert (gap, leaf) == (pytest.approx(2 ** 0.5), "k")


def test_leaf_numbers_leave_still_leaves_out_of_the_change():
    ref_first = {"a": torch.ones(4), "still": torch.full((4,), 1e-9)}
    ref_change = {"a": torch.ones(4), "still": torch.ones(4)}
    change = {"a": torch.ones(4), "still": -torch.ones(4)}
    numbers, _ = judge.leaf_numbers(ref_first, change, ref_first,
                                    ref_change)
    assert numbers == {"grad_gap": 0.0, "grad_diff": 0.0,
                       "change_gap": 0.0, "change_diff": 0.0}


def test_losses_and_limits():
    assert judge.loss_gap([1.1, 2.0], [1.0, 2.0]) == pytest.approx(0.1)
    assert judge.loss_gap([1.0], [1.0, 2.0]) == math.inf
    table = judge.checks({"x": 0.5, "y": float("nan")}, {"x": 1.0, "y": 1.0})
    assert not judge.passed(table)
    assert judge.passed(judge.checks({"x": 1.0}, {"x": 1.0}))
    assert judge.checks({"x": 1.0, "unlimited": 9.0}, {"x": 1.0}) == {
        "x": {"value": 1.0, "limit": 1.0}}
