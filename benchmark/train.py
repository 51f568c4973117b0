"""``train_stream`` traffic: a vision model trained from a stream through
the program's own entry, ``parse_launch`` and ``Pipeline.play``:
``appsrc ! tensor_trainer framework=mesh-vision ! tensor_sink``.

Set-up makes ``distinct_batches`` host batches of ``batch`` frames with
int32 labels from the seed, pushes them into the source and ends the
stream.  The trainer buffers them and, at the end of the stream, builds
its step (forward, backward and the Adam update as one CUDA graph per
batch signature) and trains on them ``num-epochs`` times over, one step
a batch: what the element does with any stream.  ``num-epochs`` is sized
so that the steps cannot run out inside the window below
``max_steps_per_s``.

The benchmark's code wraps the trainer's call of one step (the copy of
the host batch into the step's buffers, the replay and the loss read):
before the first step it loads the seed's weights into the trainer's
parameters, after the first it reads Adam's first moment, and after
``checked_steps`` the parameters and opens the window.  The window lasts
``seconds``; a step counts when it ends inside it.  Once it has closed
the trainer's remaining steps are skipped and the stream drains.

After the window the reference trains the same weights on the same first
batches, and the program's losses, first gradient (read from Adam's first
moment after one step) and change of the parameters over the checked
steps are held to it.
"""

from __future__ import annotations

import gc
import math
import os
import time

import torch

from . import inputs, judge
from . import spec as bench_spec
from .trace import DeviceTrace

#: seconds the stream may take to reach its window's end: the first run
#: in a checkout builds the kernels, and the trainer captures its graph
STREAM_S = 1100.0


def run(cell: dict, seed: int, seconds: float, traced: bool, device: str,
        started: float) -> dict:
    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    cfg, mix = cell["config"], cell["traffic"]
    on_card = device == "cuda"
    batch, checked = int(mix["batch"]), int(mix["checked_steps"])
    batches = inputs.train_batches(seed, int(mix["distinct_batches"]), batch,
                                   int(cfg["image_size"]),
                                   int(cfg["num_classes"]), device)
    w0 = inputs.model_weights(cell, seed, batches[0][0].to(device), device,
                              torch.float32)
    phases = {"inputs": time.perf_counter() - started}
    steps = checked + math.ceil(seconds * float(mix["max_steps_per_s"]))
    custom = [cfg["program"]["custom"]] + (
        [] if on_card else ["device:cpu", "dtype:float32"])
    p = parse_launch(mix["launch"].format(
        size=int(cfg["image_size"]), batch=batch,
        epochs=math.ceil(steps / len(batches)), lr=cfg["train"]["lr"],
        model=cfg["program"]["model"], custom=",".join(custom)))
    p.play()
    trainer = p.get("trainer").trainer
    clock = _StepClock(trainer, w0, checked, seconds,
                       min(seconds, float(mix["trace_seconds"])), traced,
                       on_card, float(cfg["train"]["betas"][0]))
    del w0
    src = p.get("src")
    try:
        for i, (frames, labels) in enumerate(batches):
            src.push_buffer(TensorBuffer(
                tensors=[frames.numpy(), labels.numpy()], pts=i))
        src.end_of_stream()
        phases["pushed"] = time.perf_counter() - started
        p.wait(timeout=STREAM_S + seconds)
    finally:
        p.stop()
    if not clock.closed:
        raise RuntimeError(f"the trainer ran out of steps after "
                           f"{clock.ran} inside the window")
    phases.update(clock.phases(started))
    window = clock.trace.read() if traced else None
    memory = torch.cuda.max_memory_allocated() if on_card else 0
    losses, first, after, w0 = (trainer.losses[:checked], clock.first,
                                clock.after, clock.w0)
    del p, trainer
    clock.release()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    worst, uncompared = {}, {}
    table = _judge(cell, bench_spec.reference(cfg), w0, batches[:checked],
                   losses, first, after, clock.finite, device, worst,
                   uncompared)
    attempted = (clock.ran - checked) * batch
    out = {"attempted": attempted,
           "failed": 0 if clock.finite else attempted,
           "checks": table, "correct": judge.passed(table),
           "memory_peak_bytes": memory, "setup_phases": phases,
           "worst_leaves": worst, "uncompared": uncompared,
           "end_to_end": {"train_samples_per_s": clock.done * batch / seconds,
                          "setup_s": clock.t0 / 1e9 - started},
           "window": None}
    if window is not None:
        window.update(units=clock.traced_steps,
                      samples=clock.traced_steps * batch)
        out["window"] = window
    return out


class _StepClock:
    """Takes the place of ``trainer._run_step`` (module doc) and keeps
    what the run reads of the steps: the checked state, the window's
    steps and their trace."""

    def __init__(self, trainer, w0, checked: int, seconds: float,
                 trace_seconds: float, traced: bool, on_card: bool,
                 b1: float) -> None:
        self.trainer, self.step = trainer, trainer._run_step
        trainer._run_step = self
        self.w0, self.checked, self.on_card, self.b1 = (w0, checked,
                                                        on_card, b1)
        self.seconds, self.trace_seconds = seconds, trace_seconds
        self.trace = DeviceTrace() if traced else None
        self.tracing = False
        self.ran = self.done = self.traced_steps = 0
        self.t0 = self.end = self.t_trace = 0
        self.finite, self.closed = True, False
        self.first = self.after = None
        self.stamps = {}

    def __call__(self, *batch) -> None:
        if self.closed:
            return
        if self.ran == 0:
            self._load_weights()
        self.step(*batch)
        now = time.perf_counter_ns()
        self.ran += 1
        if self.ran == 1:
            self.stamps["first_step"] = now
            self.first = self._first_moment()
        if self.ran == self.checked:
            self.after = {n: t.to("cpu", copy=True)
                          for n, t in self._params().items()}
            self._open()
        elif self.ran > self.checked:
            self._count(now)

    def _params(self) -> dict:
        return {n[len("params."):]: t
                for n, t in self.trainer.state_tensors().items()
                if n.startswith("params.")}

    def _load_weights(self) -> None:
        live = self._params()
        if set(live) != set(self.w0):
            raise ValueError(f"the trainer's parameters "
                             f"{sorted(set(live) ^ set(self.w0))} differ "
                             "from the reference's")
        with torch.no_grad():
            for n, t in live.items():
                t.copy_(self.w0[n])
        # the benchmark's copy waits on the host, and the card's peak
        # from here on is the program's
        self.w0 = {n: t.cpu() for n, t in self.w0.items()}
        if self.on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        self.stamps["weights"] = time.perf_counter_ns()

    def _first_moment(self) -> dict:
        """The first gradient as Adam holds it after one step (zeros where
        it holds no state: the leaf never stepped)."""
        state = self.trainer.state_tensors()
        return {n: (state[f"exp_avg.{n}"].to("cpu", copy=True)
                    / (1 - self.b1)
                    if f"exp_avg.{n}" in state else
                    torch.zeros(p.shape, dtype=p.dtype))
                for n, p in self._params().items()}

    def _open(self) -> None:
        self.t0 = time.perf_counter_ns()
        self.end = self.t0 + int(self.seconds * 1e9)
        self.t_trace = self.t0 + int(self.trace_seconds * 1e9)
        if self.trace is not None:
            self.trace.start()
            self.tracing = True

    def _count(self, now: int) -> None:
        if now > self.end:
            self.closed = True
            self._stop_trace()
            return
        self.done += 1
        self.finite = self.finite and math.isfinite(self.trainer.losses[-1])
        if self.tracing and now >= self.t_trace:
            self._stop_trace()

    def _stop_trace(self) -> None:
        """Between two steps, on the thread that launches them."""
        if self.tracing:
            self.trace.close()
            self.trace.stop()
            self.traced_steps, self.tracing = self.done, False

    def release(self) -> None:
        """Let the trainer, its model and its graph go."""
        del self.trainer, self.step

    def phases(self, started: float) -> dict:
        return {k: v / 1e9 - started for k, v in self.stamps.items()}


def _judge(cell, ref, w0, batches, losses, first, after, finite, device,
           worst: dict, uncompared: dict) -> dict:
    """The checks' table; ``worst`` gets the leaf behind each leaf
    number, ``uncompared`` the numbers read that no limit holds."""
    cfg = cell["config"]
    adam = bench_spec.load_module(os.path.join(cfg["base"], "reference",
                                               "adam.py"))
    opt_cfg = cfg["train"]
    w0 = {n: t.to(device) for n, t in w0.items()}
    batches = [(f.to(device), y.to(device)) for f, y in batches]
    with judge.exact_f32():
        ref_losses, ref_first, ref_after = adam.train(
            ref.forward, w0, cfg, batches, bench_spec.trainable,
            float(opt_cfg["lr"]), tuple(opt_cfg["betas"]),
            float(opt_cfg["eps"]))
    split = getattr(ref, "leaves", lambda tensors: tensors)
    w0 = {n: t.cpu() for n, t in w0.items()}
    ref_first = split({n: g.cpu() for n, g in ref_first.items()})
    first = split(first)
    change = split({n: after[n] - w0[n] for n in after})
    ref_change = split({n: ref_after[n].cpu() - w0[n] for n in ref_after})
    leaves, worst_leaves = judge.leaf_numbers(first, change, ref_first,
                                              ref_change)
    worst.update(worst_leaves)
    numbers = {"loss_gap": judge.loss_gap(losses, ref_losses), **leaves,
               "nonfinite_losses": 0 if finite else 1}
    uncompared.update({k: v for k, v in numbers.items()
                       if k not in cell["limits"]})
    return judge.checks(numbers, cell["limits"])
