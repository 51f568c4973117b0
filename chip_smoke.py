#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                      # as the check runs it
    python3 chip_smoke.py --frames 256 --profile out/profile

Phases, each of which must pass:

1. build every CUDA kernel of the port from ``nnstreamer_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. hold each kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few others, and time both, plus the one
   PyTorch call that computes the same function where there is one;
3. drive the main path, the flagship image-labeling pipeline of the
   README at full width (MobileNetV2 1.0, 224x224, 1001 classes, bf16)
   with ``custom=use_pallas:1``, through the port's ``parse_launch``, with
   every kernel launch counter set to 0 just before and read just after;
4. check what came out: every frame has a label, the labels equal those
   of the same model run with the plain normalization, the logits are
   finite, and the card's f32 forward agrees with the CPU's.

Earlier lines are JSON objects of the phases' numbers, the card's name and
power limit as ``nvidia-smi`` gives them, and the ``kernels`` line; the
last line is ``{"ok": true, "device": {...}}`` and is printed only when
every phase passed.  The script fails without a CUDA device, and when the
package is not beside it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

LAUNCH = ("videotestsrc num-buffers={frames} pattern=random seed={seed} ! "
          "video/x-raw,format=RGB,width=224,height=224,framerate=30/1 ! "
          "tensor_converter ! "
          "tensor_filter name=f framework=xla model=mobilenet_v2 "
          "custom=seed:{seed},use_pallas:1 ! "
          "tensor_decoder mode=image_labeling ! "
          "tensor_sink name=out")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 200, warmup: int = 10, backlog: bool = True
            ) -> float:
    """Median time of one ``fn()`` call on the card, from a CUDA event
    pair around each of ``reps`` calls.

    A small kernel runs in less time than Python takes to launch it, so
    with an idle stream an event pair measures the launch.  With
    ``backlog`` each group of calls is queued behind a spin on the card
    (``torch.cuda._sleep``), so the events see the calls run back to back:
    that is the device time.  Without it, the host's cost per call."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    group = 20
    for first in range(0, reps, group):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
                 for _ in range(min(group, reps - first))]
        if backlog:
            torch.cuda._sleep(20_000_000)   # ~10 ms at the H100's clock
        for s, e in pairs:
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        times += [s.elapsed_time(e) for s, e in pairs]
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

NORMALIZE_SHAPES = [(224, 224, 3), (1,), (7, 13, 3), (1080, 1920, 3)]
MAIN_PATH_SHAPE = (224, 224, 3)


def check_normalize_frame(reps: int) -> dict:
    """normalize_frame: bit-exact against its plain version in f32 and
    bf16 (tolerance 0: both round ``x * scale + shift`` once to f32)."""
    import torch

    from nnstreamer_tpu_torch.ops.preprocess import (
        normalize_frame, normalize_frame_reference)

    scale, shift = 1.0 / 127.5, -1.0
    gen = torch.Generator().manual_seed(0)
    rows, worst = [], 0.0
    for shape in NORMALIZE_SHAPES:
        x = torch.randint(0, 256, shape, dtype=torch.uint8,
                          generator=gen).cuda()
        for dt in (torch.float32, torch.bfloat16):
            got = normalize_frame(x, scale, shift, dt)
            want = normalize_frame_reference(x, scale, shift, dt)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            worst = max(worst, err)
            n, out_bytes = x.numel(), x.numel() * got.element_size()
            bound_bytes = (n + out_bytes) / HBM_BYTES_PER_S * 1e3
            bound_ops = 2 * n / F32_FLOPS * 1e3      # one FMA per value
            rows.append({
                "shape": list(shape), "dtype": str(dt).split(".")[-1],
                "max_abs_err": err,
                "kernel_ms": time_ms(
                    lambda: normalize_frame(x, scale, shift, dt), reps),
                "kernel_call_ms": time_ms(
                    lambda: normalize_frame(x, scale, shift, dt), reps,
                    backlog=False),
                "plain_ms": time_ms(
                    lambda: normalize_frame_reference(x, scale, shift, dt),
                    reps),
                "library_ms": time_ms(
                    lambda: (x.float() * scale + shift).to(dt), reps),
                "bound_ms": max(bound_bytes, bound_ops),
                "bound_by": "bytes" if bound_bytes >= bound_ops
                            else "operations"})
    emit({"phase": "kernel", "kernel": "normalize_frame", "rows": rows})
    if worst != 0.0:
        raise AssertionError(f"normalize_frame differs from its plain "
                             f"version by {worst}")
    main = next(r for r in rows if tuple(r["shape"]) == MAIN_PATH_SHAPE
                and r["dtype"] == "bfloat16")
    return {"name": "normalize_frame", "route": "cuda",
            "source": "nnstreamer_tpu_torch/csrc/normalize_frame.cu",
            "replaces": "nnstreamer_tpu/ops/preprocess.py:57",
            "max_abs_err": worst, "ms": main["kernel_ms"],
            "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"]}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def run_main_path(frames: int, seed: int, card: str) -> dict:
    from nnstreamer_tpu_torch import _cuda, parse_launch

    stamps = []
    _cuda.reset_launches()
    p = parse_launch(LAUNCH.format(frames=frames, seed=seed))
    p.get("out").connect("new-data",
                         lambda buf: stamps.append(time.perf_counter()))
    t0 = time.perf_counter()
    p.run(timeout=600)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.launches)
    results = p.get("out").results
    labels = [b.extra.get("index") for b in results]
    if len(results) != frames or any(i is None for i in labels):
        raise AssertionError(f"{len(results)} labelled frames of {frames}")
    # one synchronous streaming thread: a frame reaches the sink before
    # the next is made, so the gap between sink arrivals is the per-frame
    # latency from source to sink
    gaps = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    row = {"phase": "main_path", "frames": frames, "launches": launches,
           "fps": (len(stamps) - 1) / (stamps[-1] - stamps[0]),
           "p50_ms": statistics.median(gaps),
           "p90_ms": gaps[int(0.9 * (len(gaps) - 1))],
           "wall_s_incl_open": wall, "card": card}
    emit(row)
    # the filter's open runs one warm-up invoke; every frame runs one
    want = frames + 1
    if launches.get("normalize_frame", 0) != want:
        raise AssertionError(f"normalize_frame launched "
                             f"{launches.get('normalize_frame', 0)} times "
                             f"on the main path, expected {want}")
    return {"labels": labels, "launches": launches}


def source_frames(frames: int, seed: int, size: int = 224):
    """The frames of ``videotestsrc pattern=random seed=<seed>``: one
    seeded numpy generator, one (h, w, 3) uint8 draw per frame."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
            for _ in range(frames)]


def check_outputs(labels, frames: int, seed: int) -> None:
    """The main path's labels against the same model run with the plain
    normalization, frame by frame; then the card's f32 forward against
    the CPU's on two frames."""
    import torch

    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.ops.preprocess import normalize_frame_reference

    model = get_model("mobilenet_v2", {"seed": str(seed),
                                       "use_pallas": "1"}).module
    imgs = source_frames(frames, seed)
    worst, plain_top1, kern_top1 = 0.0, [], []
    with torch.inference_mode():
        for img in imgs:
            x = torch.from_numpy(img).cuda()
            kern = model(x)[0]
            plain_in = normalize_frame_reference(x, dtype=model.dtype)
            plain = model.logits(plain_in.permute(2, 0, 1).unsqueeze(0))[0]
            if kern.shape != (1001,) or not torch.isfinite(kern).all():
                raise AssertionError("logits not finite or not (1001,)")
            worst = max(worst, (kern - plain).abs().max().item())
            kern_top1.append(int(kern.argmax()))
            plain_top1.append(int(plain.argmax()))
    same = sum(a == b for a, b in zip(labels, plain_top1))
    emit({"phase": "outputs", "frames": frames,
          "top1_equal_plain": same, "top1_equal_module": sum(
              a == b for a, b in zip(labels, kern_top1)),
          "logits_max_abs_diff_vs_plain": worst,
          "distinct_labels": len(set(labels))})
    if labels != plain_top1 or labels != kern_top1:
        raise AssertionError(f"top-1 differs from the plain normalization "
                             f"on {frames - same} of {frames} frames")

    # the card's convolutions against the CPU's, in full f32
    torch.backends.cudnn.allow_tf32 = False
    custom = {"seed": str(seed), "use_pallas": "1", "dtype": "float32"}
    gpu = get_model("mobilenet_v2", custom).module
    cpu = get_model("mobilenet_v2", custom, device="cpu").module
    diffs = []
    with torch.inference_mode():
        for img in imgs[:2]:
            a = gpu(torch.from_numpy(img).cuda())[0].cpu()
            b = cpu(torch.from_numpy(img))[0]
            diffs.append((a - b).abs().max().item())
            if int(a.argmax()) != int(b.argmax()):
                raise AssertionError("f32 top-1 differs between card and "
                                     "CPU")
    torch.backends.cudnn.allow_tf32 = True
    emit({"phase": "f32_card_vs_cpu", "max_abs_diff": max(diffs),
          "atol": 1e-3})
    if max(diffs) > 1e-3:
        raise AssertionError(f"f32 logits differ from the CPU by "
                             f"{max(diffs)} > 1e-3")


def profile_main_path(frames: int, seed: int, out_dir: str) -> None:
    """Trace a steady window of the main path (it opens before the trace
    starts): device time by kernel, launches per frame and the device's
    idle share.  The op table goes to ``out_dir/main_path_ops.txt``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch import parse_launch

    os.makedirs(out_dir, exist_ok=True)
    p = parse_launch(LAUNCH.format(frames=frames, seed=seed))
    p.play()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            p.wait(timeout=600)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        p.stop()
    events = prof.key_averages()
    # torch renamed the device-time fields from *_cuda_* to *_device_*
    field = ("self_device_time_total"
             if hasattr(events[0], "self_device_time_total")
             else "self_cuda_time_total")
    with open(os.path.join(out_dir, "main_path_ops.txt"), "w") as f:
        f.write(events.table(sort_by=field, row_limit=60))
    busy_us = sum(getattr(e, field) for e in events)
    # the source streams while the profiler starts: count the frames the
    # window holds by their one normalize_frame launch each
    in_window = sum(e.count for e in events
                    if "normalize_frame_kernel" in e.key)
    launches = sum(e.count for e in events
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cuLaunchKernelEx"))
    emit({"phase": "profile", "frames_in_window": in_window,
          "wall_us": wall_us, "device_busy_us": busy_us,
          "device_busy_us_per_frame": busy_us / max(in_window, 1),
          "launches_per_frame": launches / max(in_window, 1),
          "device_idle_share": 1.0 - busy_us / wall_us,
          "out": out_dir})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=200,
                    help="timed launches per kernel measurement")
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace the main path into DIR")
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("no CUDA device")
    if not os.path.isdir(os.path.join(HERE, "nnstreamer_tpu_torch")):
        return fail("nnstreamer_tpu_torch is not beside this script")
    sys.path.insert(0, HERE)
    from nnstreamer_tpu_torch import _cuda

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    emit({"phase": "build", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card,
          "build_s": time.perf_counter() - t0})
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    try:
        kernels = [check_normalize_frame(args.reps)]
        main_path = run_main_path(args.frames, args.seed, card)
        for k in kernels:
            k["launches"] = main_path["launches"].get(k["name"], 0)
            if k["launches"] == 0:
                raise AssertionError(f"{k['name']} never launched on the "
                                     "main path")
        check_outputs(main_path["labels"], args.frames, args.seed)
        if args.profile:
            profile_main_path(args.frames, args.seed, args.profile)
    except AssertionError as exc:
        return fail(str(exc))

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    emit({"kernels": [{k: kern[k] for k in keys} for kern in kernels]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
