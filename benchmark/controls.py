"""Readings of the controls that the limits of ``correct`` are set
against: the reference put in the program's place in a lower precision,
and the faults a cell can have, planted in the reference, at the cell's
own sizes and inputs for each seed.

    python3 -m benchmark.controls --cell vit-label-b32 --seeds 1 2 3

- ``fp8``: every product's operands and the residual stream rounded to
  float8 e4m3 with a scale a tensor (its largest magnitude onto 448), the
  step below the bf16 the configurations state; in training the
  gradients flowing back through them rounded to e5m2 likewise, the
  formats fp8 training uses;
- ``bf16``: the same at bfloat16, the program's own precision, for
  comparison with the program's readings;
- ``half_batch`` (training): the reference trained on the first half of
  each batch, its mean loss over those rows.

Each prints one JSON line a seed with the numbers the cell compares.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import inputs, judge
from . import spec as bench_spec


def _round(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype``, back in ``t``'s type; to a float8 type
    with one scale a tensor (its largest magnitude onto the type's
    largest)."""
    if dtype.itemsize > 1:
        return t.to(dtype).to(t.dtype)
    scale = t.abs().amax().clamp_min(1e-30) / torch.finfo(dtype).max
    return (t / scale).to(dtype).to(t.dtype) * scale


class _Rounded(torch.autograd.Function):
    """An operand in the lower precision, and in training the gradient
    that flows back through it in the gradients' type."""

    @staticmethod
    def forward(ctx, t, dtype, grad_dtype):
        ctx.grad_dtype = grad_dtype
        return _round(t.detach(), dtype)

    @staticmethod
    def backward(ctx, grad):
        return _round(grad, ctx.grad_dtype), None, None


def rounded(dtype: torch.dtype, grad_dtype: torch.dtype = None):
    """The cast of a control: operands in ``dtype``, their gradients in
    ``grad_dtype`` (default ``dtype``)."""
    return lambda t: _Rounded.apply(t, dtype, grad_dtype or dtype)


#: fp8 as it trains (Micikevicius et al. 2022, arXiv:2209.05433): e4m3
#: operands and e5m2 gradients, one scale a tensor
CASTS = {"fp8": rounded(torch.float8_e4m3fn, torch.float8_e5m2),
         "bf16": rounded(torch.bfloat16)}


def label_readings(cell: dict, seed: int, device: str) -> dict:
    cfg, mix = cell["config"], cell["traffic"]
    ref = bench_spec.reference(cfg)
    frames = torch.from_numpy(inputs.video_frames(
        seed, int(mix["launch_args"]["cache_frames"]),
        int(cfg["image_size"]))).to(device)
    w = inputs.model_weights(cell, seed,
                             frames[:int(mix["calibration_frames"])], device,
                             inputs.dtype(cfg["serve_dtype"]))
    batch = int(mix["batch"])

    def logits(cast=lambda t: t):
        with judge.exact_f32(), torch.no_grad():
            return torch.cat([ref.forward(w, frames[i:i + batch], cfg, cast)
                              for i in range(0, len(frames), batch)])

    reference = logits()
    gaps = judge.label_gaps(reference)
    out = {"distinct_labels": len(set(reference.argmax(-1).tolist()))}
    for name, cast in CASTS.items():
        served = list(enumerate(logits(cast).argmax(-1).tolist()))
        out[name] = {"label_gap": judge.widest_label_gap(gaps, served),
                     "label_gap_mean": judge.mean_label_gap(gaps, served)}
    return out


def train_readings(cell: dict, seed: int, device: str) -> dict:
    cfg, mix = cell["config"], cell["traffic"]
    opt = cfg["train"]
    ref = bench_spec.reference(cfg)
    adam = bench_spec.load_module(f"{cfg['base']}/reference/adam.py")
    checked = int(mix["checked_steps"])
    batches = [(f.to(device), y.to(device)) for f, y in inputs.train_batches(
        seed, int(mix["distinct_batches"]), int(mix["batch"]),
        int(cfg["image_size"]), int(cfg["num_classes"]), device)[:checked]]
    w0 = inputs.model_weights(cell, seed, batches[0][0], device,
                              torch.float32)

    def train(batches, cast=lambda t: t):
        with judge.exact_f32():
            return adam.train(ref.forward, w0, cfg, batches,
                              bench_spec.trainable, float(opt["lr"]),
                              tuple(opt["betas"]), float(opt["eps"]), cast)

    split = getattr(ref, "leaves", lambda tensors: tensors)
    losses, first, after = train(batches)
    change = split({n: after[n] - w0[n] for n in after})
    first = split(first)

    def numbers(run):
        got_losses, got_first, got_after = run
        got_change = split({n: got_after[n] - w0[n] for n in got_after})
        leaves = judge.leaf_numbers(split(got_first), got_change, first,
                                    change)[0]
        return {"loss_gap": judge.loss_gap(got_losses, losses), **leaves}

    half = [(f[:f.shape[0] // 2], y[:y.shape[0] // 2]) for f, y in batches]
    return {**{name: numbers(train(batches, cast))
               for name, cast in CASTS.items()},
            "half_batch": numbers(train(half)),
            "still_leaves": len(first) - len(judge.moving_leaves(first))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.controls")
    ap.add_argument("--cell", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    bench = bench_spec.Benchmark()
    for name in args.cell:
        cell = bench.cell(name)
        readings = (train_readings if cell["traffic"]["kind"] ==
                    "train_stream" else label_readings)
        for seed in args.seeds:
            print(json.dumps({"cell": name, "seed": seed,
                              **readings(cell, seed, args.device)}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
