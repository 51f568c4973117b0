"""``label_stream`` traffic: a labeling pipeline driven from source to
sink through the program's own entry, ``parse_launch`` and
``Pipeline.play``.

The mix's ``launch`` string holds the pipeline with the cell's sizes
filled in.  Its source renders ``cache_frames`` distinct frames from the
run's seed and cycles them, as fast as the pipeline takes them (a closed
loop: backpressure from the queue paces it), and never runs dry.  The
benchmark's own code counts each frame where it leaves the source (around
the source's ``create``, which also checks its timestamp) and stamps its
label where it reaches the sink.  Set-up ends when ``warm_buckets``
buckets have reached the sink (every graph is captured before the first
does); the window lasts ``seconds``; then the source ends the stream, the
pipeline drains, and every frame the source made must have exactly one
label.

A configuration whose reference has ``calibrate`` (BatchNorm statistics
measured on data) gets it run on the first ``calibration_frames`` frames
before the weights are handed to the program.
"""

from __future__ import annotations

import array
import gc
import os
import tempfile
import threading
import time

import torch

from . import inputs, judge
from . import spec as bench_spec
from .trace import DeviceTrace

#: seconds the first frames may take: the first run in a checkout builds
#: the kernels and captures the graphs
FIRST_FRAMES_S = 1100.0
#: seconds the stream may take to drain after the window
DRAIN_S = 120.0


def _wait(p, until, timeout: float) -> None:
    """Wait until ``until()`` while the pipeline streams; raise the
    pipeline's error if it posted one, or if it ended early."""
    deadline = time.monotonic() + timeout
    while not until():
        if time.monotonic() > deadline:
            raise TimeoutError(f"the pipeline did not get there in "
                               f"{timeout:.0f} s")
        try:
            p.wait(timeout=0.05)
        except TimeoutError:
            continue
        if not until():
            raise RuntimeError("the pipeline reached its end before the "
                               "window closed")


def _element_totals(tracer) -> dict:
    return {name: (row["proctime_ms"], row["buffers"])
            for name, row in tracer.report().items()}


def run(cell: dict, seed: int, seconds: float, traced: bool, device: str,
        started: float) -> dict:
    from nnstreamer_tpu_torch import parse_launch

    cfg, mix = cell["config"], cell["traffic"]
    on_card = device == "cuda"
    batch, size = int(mix["batch"]), int(cfg["image_size"])
    frames = inputs.video_frames(seed, int(mix["launch_args"]["cache_frames"]),
                                 size)
    weights = inputs.model_weights(
        cell, seed, torch.from_numpy(
            frames[:int(mix["calibration_frames"])]).to(device),
        device, inputs.dtype(cfg["serve_dtype"] if on_card else "float32"))
    phases = {"inputs": time.perf_counter() - started}
    fd, ckpt = tempfile.mkstemp(prefix=f"benchmark-{cell['name']}-",
                                suffix=".pt")
    os.close(fd)
    try:
        torch.save(weights, ckpt)
        # the benchmark's copies wait on the host, and the card's peak
        # from here on is the program's
        weights = {n: t.cpu() for n, t in weights.items()}
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        custom = ",".join(filter(None, [cfg["program"]["custom"],
                                        f"checkpoint:{ckpt}"]))
        launch = mix["launch"].format(
            seed=seed, size=size, model=cfg["program"]["model"],
            custom=custom,
            batch=batch,
            accelerator="" if on_card else " accelerator=true:cpu",
            **mix["launch_args"])
        p = parse_launch(launch)
        phases["parsed"] = time.perf_counter() - started
        stream = _stream(p, mix, seconds, traced, started, phases)
    finally:
        os.unlink(ckpt)
    stream["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                   if on_card else 0)
    del p
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    return _judge(cell, frames, weights, stream, device)


def _stream(p, mix: dict, seconds: float, traced: bool, started: float,
            phases: dict) -> dict:
    """Play ``p`` through set-up and the window; a traced run's window is
    the mix's ``trace_seconds``, and its trace stops once the stream has
    drained.  The answers are kept in arrays, which the garbage collector
    does not walk, so the benchmark's bookkeeping adds nothing to the
    program's collections."""
    src, sink = p.get("src"), p.get("out")
    frame_ns = 10 ** 9 // int(mix["launch_args"]["fps"])
    made = [0]
    got = (array.array("q"), array.array("q"), array.array("q"))
    closed = threading.Event()
    create = src.create

    def stamped():
        if closed.is_set():
            return None               # the window closed: end the stream
        buf = create()
        if buf is not None:
            if buf.pts != made[0] * frame_ns:
                raise RuntimeError(f"frame {made[0]} has pts {buf.pts}")
            made[0] += 1
        return buf

    def arrived(buf):
        label = buf.extra.get("index")
        got[0].append(buf.pts // frame_ns)
        got[1].append(-1 if label is None else int(label))
        got[2].append(time.perf_counter_ns())

    src.create = stamped
    sink.connect("new-data", arrived)
    tracer = p.enable_tracing() if traced else None
    warm = int(mix["warm_buckets"]) * int(mix["batch"])
    dev = DeviceTrace() if traced else None
    p.play()
    phases["playing"] = time.perf_counter() - started
    try:
        _wait(p, lambda: len(got[2]) > 0, FIRST_FRAMES_S)
        phases["first_label"] = time.perf_counter() - started
        _wait(p, lambda: len(got[2]) >= warm, FIRST_FRAMES_S)
        t0 = time.perf_counter_ns()
        setup_s = t0 / 1e9 - started
        if traced:
            seconds = min(seconds, float(mix["trace_seconds"]))
            before = _element_totals(tracer)
            dev.start()
        end = t0 + int(seconds * 1e9)
        _wait(p, lambda: time.perf_counter_ns() >= end, seconds + 60)
        t1 = time.perf_counter_ns()
        closed.set()
        if traced:
            dev.close()
            after = _element_totals(tracer)
        _wait(p, lambda: sink.wait_eos(0), DRAIN_S)
        if traced:
            dev.stop()
    finally:
        closed.set()
        p.stop()
    frames = sum(t0 <= t <= t1 for t in got[2])
    window = None
    if traced:
        window = dev.read()
        window["frames"] = frames
        window["elements"] = {
            n: (ms - before.get(n, (0.0, 0))[0],
                bufs - before.get(n, (0.0, 0))[1])
            for n, (ms, bufs) in after.items()}
    return {"setup_s": setup_s, "window_s": (t1 - t0) / 1e9,
            "frames": frames, "made": made[0],
            "answers": list(zip(got[0], got[1])), "window": window,
            "setup_phases": phases}


def _judge(cell, frames, weights, stream, device) -> dict:
    cfg, mix = cell["config"], cell["traffic"]
    ref = bench_spec.reference(cfg)
    frames = torch.from_numpy(frames).to(device)
    batch = int(mix["batch"])
    weights = {n: t.to(device) for n, t in weights.items()}
    with judge.exact_f32(), torch.no_grad():
        logits = torch.cat([ref.forward(weights, frames[i:i + batch], cfg)
                            for i in range(0, len(frames), batch)])
    gaps = judge.label_gaps(logits)
    made = stream["made"]
    answered = {}
    for number, label in stream["answers"]:
        answered.setdefault(number, []).append(None if label < 0 else label)
    unanswered = sum(n not in answered for n in range(made))
    repeated = sum(len(v) - 1 for v in answered.values())
    stray = sum(not 0 <= n < made for n in answered)
    served = [(n % len(frames), label)
              for n, labels in answered.items() for label in labels]
    table = judge.checks({"label_gap": judge.widest_label_gap(gaps, served),
                          "label_gap_mean": judge.mean_label_gap(gaps,
                                                                 served),
                          "unanswered": unanswered + stray,
                          "repeated": repeated}, cell["limits"])
    window_s = stream["window_s"]
    out = {"attempted": made, "failed": unanswered + stray,
           "checks": table, "correct": judge.passed(table),
           "memory_peak_bytes": stream["memory_peak_bytes"],
           "setup_phases": stream["setup_phases"],
           "end_to_end": {"frames_per_s": stream["frames"] / window_s,
                          "setup_s": stream["setup_s"]},
           "window": None}
    if stream["window"] is not None:
        window = stream["window"]
        window.update(units=window["frames"],
                      buckets=window["frames"] / batch)
        out["window"] = window
    return out
