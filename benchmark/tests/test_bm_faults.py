"""A run's ``correct`` comes out false when the timed path is broken
underneath: each fault a cell can have, planted in the program, through
the rest of a run (the look for a card skipped; tiny cells on the CPU).
A sound run of the same cell comes out true."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run

SEED = 2 ** 31 + 101
SECONDS = 1.0


def _run(tiny, cell):
    return run.run_cell(tiny, cell, SEED, SECONDS, False, device="cpu",
                        started=time.perf_counter())


@pytest.mark.parametrize("cell", ["mnv2-tiny", "vit-tiny", "vit-tiny-train"])
def test_a_sound_run_is_correct(tiny, cell):
    out = _run(tiny, cell)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) >= {"setup_s"}


def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch):
    from nnstreamer_tpu_torch.decoders import imagelabel

    decode = imagelabel.ImageLabelDecoder.decode

    def altered(self, buf, config):
        out = decode(self, buf, config)
        out.extra["index"] = (out.extra["index"] + 1) % 1001
        return out

    monkeypatch.setattr(imagelabel.ImageLabelDecoder, "decode", altered)
    out = _run(tiny, "mnv2-tiny")
    mean = out["checks"]["label_gap_mean"]
    assert not out["correct"] and mean["value"] > mean["limit"]


def test_half_of_each_bucket_left_out(tiny, monkeypatch):
    from nnstreamer_tpu_torch.models import vit

    forward = vit.ViT.forward

    def half(self, frame):
        if frame.dim() != 4:
            return forward(self, frame)
        kept = forward(self, frame[:frame.shape[0] // 2])[0]
        return (torch.cat([kept, torch.zeros_like(kept)])[:frame.shape[0]],)

    monkeypatch.setattr(vit.ViT, "forward", half)
    out = _run(tiny, "vit-tiny")
    assert not out["correct"], out["checks"]


def test_a_step_that_leaves_its_state_unchanged(tiny, monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step",
                        lambda self, closure=None: None)
    out = _run(tiny, "vit-tiny-train")
    assert not out["correct"]
    assert out["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_of_the_loss(tiny, monkeypatch):
    from nnstreamer_tpu_torch.parallel import vision_train

    nll = vision_train._nll

    def half(logits, labels):
        n = logits.shape[0] // 2
        return nll(logits[:n], labels[:n])

    monkeypatch.setattr(vision_train, "_nll", half)
    out = _run(tiny, "vit-tiny-train")
    assert not out["correct"], out["checks"]


def test_a_gradient_of_the_right_norm_in_the_wrong_direction(tiny,
                                                              monkeypatch):
    """Each weight matrix's gradient reversed along its columns before the
    update: every norm is the reference's, so only ``grad_diff`` sees it."""
    step = torch.optim.Adam.step

    def reversed_columns(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None and p.grad.dim() == 2:
                    p.grad.copy_(p.grad.flip(1))
        return step(self, closure)

    monkeypatch.setattr(torch.optim.Adam, "step", reversed_columns)
    out = _run(tiny, "vit-tiny-train")
    checks = out["checks"]
    assert not out["correct"]
    assert checks["grad_gap"]["value"] <= checks["grad_gap"]["limit"]
    assert checks["grad_diff"]["value"] > checks["grad_diff"]["limit"]
