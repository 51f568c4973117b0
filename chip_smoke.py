#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                      # as the check runs it
    python3 chip_smoke.py --frames 256 --profile out/profile

Phases, each of which must pass:

1. build every CUDA kernel of the port from ``nnstreamer_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) and report each kernel
   function's registers, shared memory, spill bytes and ptxas notes from
   ``-Xptxas -v``; a tensor-core K2/K3/K4 (f16, bf16) that spills at a
   padded head dim of 16, 32 or 64 fails;
2. hold each kernel against its plain PyTorch version on the card, at the
   paths' shapes and a few others, and time both, plus the one PyTorch
   call that computes the same function where there is one; K2's
   tensor-core versions are checked and timed against each other in
   turns at the four attention paths' shapes; K1's floor is traced inside
   CUDA graph replays: an empty kernel (the card's per-kernel floor), K1
   on a 1-element frame, on the main path's and on a 32-frame bucket
   (beside that bucket's event-timed call and its bytes bound);
3. drive each path through the port's entry points at full width, with
   every kernel launch counter set to 0 just before it and read just
   after.  The four serving paths run as CUDA graphs (the filter
   captures its forward at open and, fused with the decoder's pushdown,
   before the first frame; the engine captures its step and prefill sets
   in ``warmup()``), so a launch counts as captured launches x replays,
   plus the eager run before each capture; each stream must capture
   nothing, and each path prints its compile-ledger snapshot.  Each
   serving path runs again eagerly in the same call, and the graph run's
   labels, logits and greedy tokens must equal the eager run's bit for
   bit:

   - ``main_path``: the flagship image-labeling pipeline of the README
     (MobileNetV2 1.0, 224x224, 1001 classes, bf16, ``use_pallas:1``);
   - ``vit_path``: the same pipeline on ViT-S/16 (dim 384, depth 12,
     6 heads x 64, T = 197, bf16): 12 flash-attention launches a frame;
   - ``lm_filter``: StreamFormer LM full-sequence logits as a stream
     filter at seq 2048 (vocab 8192, dim 512, 8 heads x 64, 4 layers,
     2 experts): 4 causal flash launches a frame;
   - ``llm_serve``: the dense-slot decode engine at that LM's width,
     8 sessions prefilled through the kernel (``layers`` launches each),
     then batched and single-lane decode steps;
   - ``vit_train``: ``appsrc ! tensor_trainer framework=mesh-vision
     custom=model:vit ! tensor_sink``, ViT-S/16 in its training form
     (f32 parameters, bf16 compute), batches of 32 frames, 8 Adam steps:
     12 launches each of the flash forward (K2) and backward (K3, K4) a
     step, the batch in their grid;
   - ``lm_train``: ``tensor_trainer framework=mesh`` on that LM, (4, 2048)
     tokens, 6 steps: 4 launches each of K2, K3 and K4 a step;
   - ``mlp_train``: ``tensor_trainer framework=jax``, the MLP trainer at
     the JAX package's example size (8 features, 4 classes, batches of
     8), 16 steps;
   - ``batched_path``: the JAX package's benchmark string
     (``bench.py:208-229``: ``videotestsrc cache-frames=64 ! ... !
     tensor_filter batch=32 inflight=1 ! queue ! tensor_decoder !
     tensor_sink``) on MobileNetV2 (``flagship_batched``, one K1 launch a
     32-frame bucket), its ``device-cache=64 inflight=8`` form
     (``resident_batched``) and ViT-S/16 (``vit_batched``, 12 K2
     launches a bucket), each in graph mode (4 captures before the first
     frame reaches the sink, a replay a bucket) and eagerly, with the
     batched graph's logits held to eager bit for bit, and the same
     strings at batch=1 as the reference: labels equal where the
     per-frame top-2 margin exceeds MARGIN, f32 logits (TF32 off) within
     1e-4 relative; inflight=8's logits equal inflight=1's bit for bit;
     ``cascade``: MobileNetV2 (``output-device=true``) into an MLP at
     batch 32 equals the same cascade through the host bit for bit, and
     the hand-over (one device copy a bucket) is timed;
   - ``xbatch_bucket``: ``invoke_stacked`` at capacity 32 over fills
     1..32 on the MLP and MobileNetV2: 7 pad shapes captured by
     ``warmup_stacked``, a replay a fill, each fill bit-equal to eager;
   - ``query_serve``: the README's query pair, ``tensor_query_serversrc
     batch=32 batch-timeout-ms=5 ! tensor_filter model=mobilenet_v2 !
     tensor_query_serversink`` in this process, 32 client connections in
     threads (one warm-up frame each, then 16 seeded frames each) and one
     more client pipeline (``videotestsrc ! tensor_converter !
     tensor_query_client ! tensor_decoder ! tensor_sink``, 64 frames)
     through ``python -m nnstreamer_tpu_torch.launch`` in a child
     process; replies/s, round-trip p50/p99 and the mean bucket fill; the
     same string at batch=1 on the same frames is the reference (every
     reply within the bf16 bound, the CLI client's labels wherever the
     top-2 margin is above twice the largest reply difference, and at
     least one label so compared); every bucket of the timed run
     replayed eagerly, each of the 512 replies bit for bit; one capture
     at open and the 7 pad shapes at the first cross-stream bucket, none
     after; K1 once a bucket; zero sheds and errors;

   Each training path runs as CUDA graphs (step 1 is the capture's eager
   warm-up, every later step a replay of the one graph: launches count as
   captured x replays, one capture a path) and then eagerly, in the same
   call; then in graph mode and twice eagerly under deterministic
   algorithms, where every step's loss and the final parameters and Adam
   moments must equal the eager run's bit for bit; a training batch's
   copy into its static buffers is timed two ways in turns (through
   pinned staging, and as one pageable copy);
4. check what came out: the labels and logits of each path against the
   same model run with the kernels' plain versions (and MobileNetV2's f32
   forward against the CPU's), the LM engine's token streams against an
   engine that prefills with plain attention, and one training step of
   each model with the kernels against the same step with plain attention
   (loss and every gradient, in f32 and bf16).

With ``--profile DIR`` the seven serving paths, the three training
paths and ``query_serve`` are traced first, each in a process of its
own, in graph and
eager mode in turns (graph, eager, eager, graph): device busy time,
device kernels and host launch calls a unit (and a bucket, on the
batched paths), the idle share and the rates, one ``profile_modes`` line
a path with both modes side by side; and ``query_pace`` serves the
query pair twice more, with the clients in processes of their own and
without the wire's CRC.

Earlier lines are JSON objects of the phases' numbers, the card's name and
power limit as ``nvidia-smi`` gives them, and the ``kernels`` line; the
last line is ``{"ok": true, "device": {...}}`` and is printed only when
every phase passed.  The script fails without a CUDA device, and when the
package is not beside it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: graph captures of a labeling pipeline: the forward at open, and the
#: forward fused with the decoder's pushdown before the first frame
PUSHDOWN_CAPTURES = 2
#: frames whose filter outputs (logits) are held graph against eager
GRAPH_LOGITS_FRAMES = 8

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12        # tensor cores, bf16 and f16

LAUNCH = ("videotestsrc num-buffers={frames} pattern=random seed={seed} ! "
          "video/x-raw,format=RGB,width=224,height=224,framerate=30/1 ! "
          "tensor_converter ! "
          "tensor_filter name=f framework=xla model=mobilenet_v2 "
          "custom=seed:{seed},use_pallas:1 ! "
          "tensor_decoder mode=image_labeling ! "
          "tensor_sink name=out")


#: ViT-S/16 at 224x224, 1000 classes: the registry's defaults
VIT_SIZE = 224
VIT_CLASSES = 1000
VIT_LAUNCH = ("videotestsrc num-buffers={frames} pattern=random seed={seed} ! "
              f"video/x-raw,format=RGB,width={VIT_SIZE},height={VIT_SIZE},"
              "framerate=30/1 ! tensor_converter ! "
              "tensor_filter name=f framework=xla model=vit "
              "custom=seed:{seed} ! "
              "tensor_decoder mode=image_labeling ! "
              "tensor_sink name=out")

#: the LM shape of the JAX package's benchmark (bench.py ``lm``)
LM_CUSTOM = {"vocab": "8192", "dim": "512", "heads": "8", "head_dim": "64",
             "mlp": "2048", "layers": "4", "experts": "2"}
LM_SEQ = 2048
LM_LAUNCH = ("appsrc name=src caps=other/tensors,format=static,num_tensors=1,"
             "dimensions={seq},types=int32,framerate=0/1 ! "
             "tensor_filter name=f framework=xla model=streamformer_lm "
             "custom={custom} ! tensor_sink name=out")
#: the engine's prompt lengths: 8 sessions, 8 different prefill shapes
#: after power-of-two padding
SERVE_PROMPTS = (7, 19, 33, 64, 100, 150, 230, 300)
#: decode steps of the f32 engines that hold the token streams
F32_STEPS = 16
#: greedy choices are compared only where the reference's top-2 margin
#: exceeds this (a smaller margin can flip on bf16 rounding)
MARGIN = 0.1
#: logits |kernel run - plain run| <= LOGITS_ATOL + LOGITS_RTOL * |plain|
#: for the bf16 paths: the bound of the JAX package's tests/test_vit.py
#: for flash vs naive ViT
LOGITS_ATOL = 5e-2
LOGITS_RTOL = 5e-2
#: the same in f32 (TF32 off): kernel and plain attention differ only in
#: summation order
F32_LOGITS_ATOL = 1e-3
#: StreamFormer routes each token to ONE expert by the argmax of two gate
#: logits.  In bf16, rounding differences of ~1e-3 between two runs flip
#: the choice for the tokens whose two gate logits nearly tie (about one
#: decision in 400), and a flipped token's logits move by O(1).  So a bf16
#: LM run is held to the plain run statistically (at most this share of
#: rows beyond LOGITS_ATOL, of confident argmaxes differing), and exactly
#: in f32, where no choice flips.
BF16_LM_SHARE = 0.02


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


#: the tensor-core K2/K3/K4 specialisations, by mangled name: (kernel,
#: type, DP); K2's f32 and 256-wide kernel (flash_forward_kernel) is not one
TC_KERNEL = re.compile(r"(flash_(?:forward|bwd_d(?:q|kv))_tc_kernel)I\d+"
                       r"(__nv_bfloat16|__half)Li(\d+)E")
#: padded head dims at which a tensor-core K2/K3/K4 must not spill
NO_SPILL_WIDTHS = (16, 32, 64)
#: a name every K2 specialisation carries (the profile counts frames by it)
K2_MARKER = "flash_forward"


def demangle(names):
    """Readable kernel names (``c++filt`` where the host has it), without
    the argument list."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60,
                             check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return list(names)
    if len(out) != len(names):
        return list(names)
    return [o.replace("void ", "", 1).replace("(anonymous namespace)::", "")
            .split("(")[0] for o in out]


def build_report():
    """Registers, static shared memory and spill bytes of every kernel
    function from the build's ``-Xptxas -v`` report, and the tensor-core
    K2/K3/K4 specialisations at a width of NO_SPILL_WIDTHS that spill."""
    from nnstreamer_tpu_torch import _cuda

    rows, spills = [], []
    for lib, funcs in _cuda.ptxas_report().items():
        labels = demangle([f["function"] for f in funcs])
        for f, label in zip(funcs, labels):
            rows.append({"library": lib, "kernel": label,
                         **{k: v for k, v in f.items() if k != "function"}})
            m = TC_KERNEL.search(f["function"])
            spilled = f.get("spill_store_bytes", 0) + f.get(
                "spill_load_bytes", 0)
            if m and int(m.group(3)) in NO_SPILL_WIDTHS and spilled:
                spills.append(f"{label} spills {spilled} bytes")
    return rows, spills


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

NORMALIZE_SHAPES = [(224, 224, 3), (1,), (7, 13, 3), (1080, 1920, 3),
                    (32, 224, 224, 3)]
MAIN_PATH_SHAPE = (224, 224, 3)
#: a 32-frame bucket of the batched and served paths
BUCKET_SHAPE = (32, 224, 224, 3)


def check_normalize_frame(reps: int):
    """normalize_frame: bit-exact against its plain version in f32 and
    bf16 (tolerance 0: both round ``x * scale + shift`` once to f32).
    Returns the kernel's row of the ``kernels`` line and the bf16 event
    timings by shape."""
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
    bf16 = {tuple(r["shape"]): r for r in rows if r["dtype"] == "bfloat16"}
    main = bf16[MAIN_PATH_SHAPE]
    return ({"name": "normalize_frame", "route": "cuda",
             "source": "nnstreamer_tpu_torch/csrc/normalize_frame.cu",
             "replaces": "nnstreamer_tpu/ops/preprocess.py:57",
             "max_abs_err": worst, "ms": main["kernel_ms"],
             "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
             "bound_by": main["bound_by"], "library_ms": main["library_ms"]},
            {shape: r["kernel_ms"] for shape, r in bf16.items()})


#: K1's floor: kernels inside a CUDA graph's replay, traced — an empty
#: kernel (what any launch costs the card, independent of K1), K1 on one
#: element, on the main path's frame and on a 32-frame bucket; each graph
#: holds K1_FLOOR_CALLS launches, replayed K1_FLOOR_REPLAYS times in the
#: trace.  ``time_ms`` records an event pair around each launch, which
#: adds a few µs to a kernel that runs in a few: the traced times are the
#: device's own
K1_FLOOR_SHAPES = [(1,), MAIN_PATH_SHAPE, BUCKET_SHAPE]
K1_FLOOR_CALLS = 50
K1_FLOOR_REPLAYS = 20
#: the empty kernel (a probe of the card, not a kernel of the port)
EMPTY_KERNEL_SRC = r"""
#include <cuda_runtime.h>
extern "C" __global__ void nns_empty_kernel() {}
extern "C" int nns_empty_launch(void *stream) {
  nns_empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def empty_kernel_launcher():
    """Build the empty kernel beside the port's libraries and return a
    function that launches it once on the current stream."""
    import ctypes
    import hashlib

    import torch

    from nnstreamer_tpu_torch import _cuda

    digest = hashlib.sha256(EMPTY_KERNEL_SRC.encode()
                            + " ".join(_cuda.NVCC_FLAGS).encode())
    lib_path = os.path.join(_cuda.BUILD_DIR,
                            f"empty_kernel-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(lib_path):
        os.makedirs(_cuda.BUILD_DIR, exist_ok=True)
        src = f"{lib_path}.{os.getpid()}.cu"
        with open(src, "w") as f:
            f.write(EMPTY_KERNEL_SRC)
        tmp = f"{lib_path}.{os.getpid()}.tmp"
        try:
            subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", tmp, src],
                           check=True, capture_output=True)
        finally:
            os.remove(src)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(lib_path)
    lib.nns_empty_launch.argtypes = [ctypes.c_void_p]
    lib.nns_empty_launch.restype = ctypes.c_int

    def launch():
        code = lib.nns_empty_launch(torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"empty kernel: CUDA error {code}")

    return launch


def k1_floor(card: str, event_ms: dict) -> dict:
    """Device time a call inside a replay, traced, of an empty kernel and
    of K1 at each of K1_FLOOR_SHAPES (bf16 out, as on the main path): no
    launch or event pair is paid there, so the empty kernel's time is the
    least any kernel costs the card, and K1's bound is the larger of its
    bytes over HBM and that floor.  K1's 1-element time stands beside it
    (K1's own fixed cost).  One trace holds every graph's replays, one
    graph after the other.  The bucket's traced time stands beside its
    event-pair time (``event_ms``, from check_normalize_frame) and its
    share of its bytes bound."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.ops.preprocess import normalize_frame

    empty = empty_kernel_launcher()

    def empties(_):
        for _ in range(K1_FLOOR_CALLS):
            empty()
        return []

    def calls(frame):
        return [normalize_frame(frame, 1.0 / 127.5, -1.0, torch.bfloat16)
                for _ in range(K1_FLOOR_CALLS)]

    names = ["nns_empty_kernel"] + ["normalize_frame"] * len(K1_FLOOR_SHAPES)
    with torch.inference_mode():
        graphs = []
        for fn, shape in [(empties, (1,))] + [(calls, s)
                                              for s in K1_FLOOR_SHAPES]:
            x = torch.randint(0, 256, shape, dtype=torch.uint8,
                              device="cuda")
            graphs.append(_cuda.CapturedGraph(fn, [x],
                                              _cuda.graph_memory(x.device)))
            graphs[-1].replay()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for graph in graphs:
                for _ in range(K1_FLOOR_REPLAYS):
                    graph.replay()
                torch.cuda.synchronize()
    per_graph = K1_FLOOR_CALLS * K1_FLOOR_REPLAYS
    events = {}
    for name in set(names):
        events[name] = sorted(
            (e for e in prof.events() if name in e.name
             and e.device_type == torch.autograd.DeviceType.CUDA),
            key=lambda e: e.time_range.start)
        want = per_graph * names.count(name)
        if len(events[name]) != want:
            raise AssertionError(f"K1 floor: the trace holds "
                                 f"{len(events[name])} {name} events, "
                                 f"expected {want}")
    rows, seen = [], collections.Counter()
    for name, shape in zip(names, [(1,), *K1_FLOOR_SHAPES]):
        i = seen[name]
        seen[name] += 1
        mine = events[name][i * per_graph:(i + 1) * per_graph]
        rows.append({"kernel": name, "shape": list(shape),
                     "events": len(mine),
                     "in_graph_us": sum(e.time_range.elapsed_us()
                                        for e in mine) / len(mine)})
    def bytes_ms(shape):                        # uint8 in, bf16 out
        n = 1
        for d in shape:
            n *= d
        return 3 * n / HBM_BYTES_PER_S * 1e3

    floor_ms, k1_one_ms, main_ms, bucket_ms = (r["in_graph_us"] / 1e3
                                               for r in rows)
    bound = max(bytes_ms(MAIN_PATH_SHAPE), floor_ms)
    bucket_bound = max(bytes_ms(BUCKET_SHAPE), floor_ms)
    row = {"phase": "kernel_floor", "kernel": "normalize_frame",
           "rows": rows, "bytes_bound_ms": bytes_ms(MAIN_PATH_SHAPE),
           "empty_kernel_ms": floor_ms, "k1_one_element_ms": k1_one_ms,
           "bound_ms": bound, "main_path_ms": main_ms,
           "share_of_bound": bound / main_ms,
           "reaches_half_of_bound": main_ms <= 2 * bound,
           "bucket": {"shape": list(BUCKET_SHAPE), "in_graph_ms": bucket_ms,
                      "event_pair_ms": event_ms[BUCKET_SHAPE],
                      "bytes_bound_ms": bytes_ms(BUCKET_SHAPE),
                      "bound_ms": bucket_bound,
                      "share_of_bound": bucket_bound / bucket_ms,
                      "reaches_half_of_bound": bucket_ms <= 2 * bucket_bound},
           "card": card}
    emit(row)
    return row


#: flash attention (K2) rows: (name, batch, tq, tkv, h, d, causal, dtype,
#: q_offset, k_offset), batch None for an unbatched (T, H, D) call; the
#: first three are the serving paths' shapes, the last two the training
#: paths' (the batch in the kernel's grid)
FLASH_ROWS = [
    ("vit", None, 197, 197, 6, 64, False, "bfloat16", 0, 0),
    ("lm", None, 2048, 2048, 8, 64, True, "bfloat16", 0, 0),
    ("streamformer_default", None, 64, 64, 8, 16, True, "bfloat16", 0, 0),
    ("vit_f32", None, 197, 197, 6, 64, False, "float32", 0, 0),
    ("vit_f16", None, 197, 197, 6, 64, False, "float16", 0, 0),
    # keys start 64 positions after the queries: rows 0..63 see no key
    ("offset_lse", None, 256, 256, 8, 64, True, "bfloat16", 0, 64),
    ("vit_train", 32, 197, 197, 6, 64, False, "bfloat16", 0, 0),
    ("lm_train", 4, 2048, 2048, 8, 64, True, "bfloat16", 0, 0),
    # a vit-batched bucket: the training layer's shape, served without lse
    ("vit_batched", 32, 197, 197, 6, 64, False, "bfloat16", 0, 0),
]
#: FLASH_ROWS whose call returns no lse (its bytes leave the bound)
FLASH_NO_LSE = ("vit_batched",)
#: |kernel - plain| <= atol + rtol * |plain| on out; lse <= LSE_ATOL
FLASH_TOL = {"float32": (1e-4, 0.0), "float16": (3e-2, 1e-2),
             "bfloat16": (3e-2, 1e-2)}
LSE_ATOL = 1e-3


def visible_pairs(tq, tkv, causal, q_offset, k_offset) -> int:
    """(query, key) pairs one head of one batch item computes under this
    call's mask."""
    if not causal:
        return tq * tkv
    return sum(min(tkv, max(0, q_offset + i - k_offset + 1))
               for i in range(tq))


def bound_ms(nbytes, ops, itemsize):
    """Least time for ``nbytes`` over HBM and ``ops`` over the dtype's
    peak: (ms, bound_by)."""
    peak = F32_FLOPS if itemsize == 4 else BF16_FLOPS
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def flash_bound_ms(tq, tkv, h, d, causal, itemsize, q_offset, k_offset,
                   batch=1, lse=True):
    """Least time for one K2 call: each of q, k, v read once, out (and
    lse, where the call returns it) written once, over HBM; 4*D
    operations per visible (query, key) pair (this call's mask) over the
    dtype's peak.  Returns (ms, bound_by)."""
    nbytes = batch * ((2 * tq + 2 * tkv) * h * d * itemsize
                      + (h * tq * 4 if lse else 0))
    pairs = batch * h * visible_pairs(tq, tkv, causal, q_offset, k_offset)
    return bound_ms(nbytes, 4.0 * d * pairs, itemsize)


def flash_bwd_bound_ms(which, tq, tkv, h, d, causal, itemsize, q_offset,
                       k_offset, batch=1):
    """Least time for K3 (``which`` "dq": 6*D operations per visible pair —
    s, dO.v and ds.k — reading q, k, v, dO, lse and delta once, writing dq
    once) or K4 ("dkv": 8*D — s, dO.v, p.dO, ds.q — writing dk and dv)."""
    rows = (2 * tq + 2 * tkv) * h * d * itemsize + 2 * h * tq * 4
    out = (tq if which == "dq" else 2 * tkv) * h * d * itemsize
    pairs = batch * h * visible_pairs(tq, tkv, causal, q_offset, k_offset)
    per_pair = 6.0 if which == "dq" else 8.0
    return bound_ms(batch * (rows + out), per_pair * d * pairs, itemsize)


def check_flash_attention(reps: int) -> dict:
    """flash_attention against its plain version at FLASH_ROWS, with the
    tolerances above; rows that see no key must be exactly 0 and -inf."""
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator().manual_seed(1)
    rows, failures = [], []
    for (name, b, tq, tkv, h, d, causal, dt, qo, ko) in FLASH_ROWS:
        dtype = getattr(torch, dt)
        lead = () if b is None else (b,)
        q, k, v = (torch.randn(*lead, t, h, d, generator=gen)
                   .to("cuda", dtype) for t in (tq, tkv, tkv))
        kw = dict(causal=causal, q_offset=qo, k_offset=ko)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        want, want_lse = flash_attention_reference(q, k, v, return_lse=True,
                                                   **kw)
        torch.cuda.synchronize()
        err = (out.float() - want.float()).abs()
        atol, rtol = FLASH_TOL[dt]
        dead = torch.isinf(want_lse)
        lse_err = ((lse - want_lse)[~dead].abs().max().item()
                   if (~dead).any() else 0.0)
        ok = (bool((err <= atol + rtol * want.float().abs()).all())
              and torch.equal(torch.isinf(lse), dead)
              and lse_err <= LSE_ATOL
              and bool((out.float().transpose(-3, -2)[dead] == 0).all()))
        if not ok:
            failures.append(name)
        # the library call: SDPA on (1, H, T, D) views (a 3-D input takes
        # its slow math path); an explicit mask where the offsets move the
        # causal diagonal
        qh, kh, vh = (x.transpose(-3, -2) if b else x.transpose(0, 1)[None]
                      for x in (q, k, v))
        mask = None
        if causal and (qo or ko or tq != tkv):
            mask = ((ko + torch.arange(tkv, device="cuda"))[None, :]
                    <= (qo + torch.arange(tq, device="cuda"))[:, None])
        lib = (lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=mask,
            is_causal=causal and mask is None))
        bound, bound_by = flash_bound_ms(tq, tkv, h, d, causal,
                                         q.element_size(), qo, ko, b or 1,
                                         lse=name not in FLASH_NO_LSE)
        rows.append({
            "case": name, "q": [*lead, tq, h, d], "kv": [*lead, tkv, h, d],
            "causal": causal, "dtype": dt, "q_offset": qo, "k_offset": ko,
            "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
            "dead_rows": int(dead.sum()), "ok": ok,
            "kernel_ms": time_ms(lambda: flash_attention(q, k, v, **kw),
                                 reps),
            "kernel_call_ms": time_ms(
                lambda: flash_attention(q, k, v, **kw), reps,
                backlog=False),
            "plain_ms": time_ms(
                lambda: flash_attention_reference(q, k, v, **kw), reps),
            "library_ms": time_ms(lib, reps),
            "bound_ms": bound, "bound_by": bound_by})
    emit({"phase": "kernel", "kernel": "flash_attention", "rows": rows})
    if failures:
        raise AssertionError(f"flash_attention differs from its plain "
                             f"version beyond tolerance at {failures}")
    main = rows[0]            # the ViT layer: the first attention path
    return {"name": "flash_attention", "route": "cuda",
            "source": "nnstreamer_tpu_torch/csrc/flash_attention.cu",
            "replaces": "nnstreamer_tpu/ops/flash_attention.py:282",
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"]}


#: FLASH_ROWS whose shapes the paths give K2
K2_PATH_ROWS = ("vit", "lm", "vit_train", "lm_train")


def time_flash_versions(reps: int) -> None:
    """K2's tensor-core versions (``FORWARD_VERSIONS``) at the four path
    shapes: each held to the plain version as in check_flash_attention,
    then all timed in turns with SDPA, in one order and back."""
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.flash_attention import (
        FORWARD_VERSIONS, flash_attention_reference, flash_attention_version)

    gen = torch.Generator().manual_seed(3)
    rows, failures = [], []
    order = sorted(FORWARD_VERSIONS)
    for (name, b, tq, tkv, h, d, causal, dt, qo, ko) in FLASH_ROWS:
        if name not in K2_PATH_ROWS:
            continue
        lead = () if b is None else (b,)
        q, k, v = (torch.randn(*lead, t, h, d, generator=gen)
                   .to("cuda", getattr(torch, dt)) for t in (tq, tkv, tkv))
        want = flash_attention_reference(q, k, v, causal=causal)
        atol, rtol = FLASH_TOL[dt]
        errs = {}
        for ver in order:
            out, _ = flash_attention_version(q, k, v, ver, causal=causal)
            err = (out.float() - want.float()).abs()
            errs[ver] = err.max().item()
            if not bool((err <= atol + rtol * want.float().abs()).all()):
                failures.append(f"{name} v{ver}")
        qh, kh, vh = (x.transpose(-3, -2) if b else x.transpose(0, 1)[None]
                      for x in (q, k, v))
        times = {ver: [] for ver in order + ["sdpa"]}
        for turn in (order + ["sdpa"], ["sdpa"] + order[::-1]):
            for ver in turn:
                fn = ((lambda: F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal)) if ver == "sdpa" else
                      (lambda ver=ver: flash_attention_version(
                          q, k, v, ver, causal=causal)))
                times[ver].append(time_ms(fn, reps))
        rows.append({"case": name, "q": [*lead, tq, h, d], "causal": causal,
                     "dtype": dt, "max_abs_err": errs,
                     "ms": {str(ver): t for ver, t in times.items()}})
    emit({"phase": "kernel", "kernel": "flash_attention_versions",
          "versions": FORWARD_VERSIONS, "rows": rows})
    if failures:
        raise AssertionError(f"K2 versions differ from the plain version "
                             f"beyond tolerance at {failures}")


#: flash backward (K3 dq, K4 dk/dv) rows: (name, batch, tq, tkv, h, d,
#: causal, dtype, q_offset, k_offset, lse cotangent); the first two are the
#: training paths' shapes
BWD_ROWS = [
    ("vit_train", 32, 197, 197, 6, 64, False, "bfloat16", 0, 0, False),
    ("lm_train", 4, 2048, 2048, 8, 64, True, "bfloat16", 0, 0, False),
    ("vit_f32", None, 197, 197, 6, 64, False, "float32", 0, 0, False),
    # ragged and cross-length, keys 65 positions after the queries (rows
    # 0..64 see no key), with a nonzero lse cotangent
    ("offset_ragged_lse", 2, 100, 150, 3, 64, True, "bfloat16", 10, 75,
     True),
]
#: |kernel - plain| <= tol * max(max |plain|, 1) on dq, dk and dv: f32
#: differs in summation order; bf16 rounds each gradient once from f32
#: sums taken in another order
BWD_TOL = {"float32": 1e-4, "float16": 2e-2, "bfloat16": 2e-2}


def check_flash_backward(reps: int) -> list:
    """K3 and K4 against the plain backward at BWD_ROWS, on the same
    saved out and lse; rows that see no key must get dq exactly 0.  Times
    each kernel, the plain backward (dq, dk and dv together) and SDPA's
    backward (one call computes all three, so the same time stands in
    both kernels' rows)."""
    import torch
    import torch.nn.functional as F

    from nnstreamer_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_backward_reference,
        flash_attention_bwd_dkv, flash_attention_bwd_dq)

    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in f32
    gen = torch.Generator().manual_seed(2)
    rows, failures = [], []
    for (name, b, tq, tkv, h, d, causal, dt, qo, ko, lse_cot) in BWD_ROWS:
        dtype = getattr(torch, dt)
        lead = () if b is None else (b,)
        q, g = (torch.randn(*lead, tq, h, d, generator=gen).to("cuda", dtype)
                for _ in range(2))
        k, v = (torch.randn(*lead, tkv, h, d, generator=gen)
                .to("cuda", dtype) for _ in range(2))
        kw = dict(causal=causal, q_offset=qo, k_offset=ko)
        with torch.no_grad():
            out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        delta = (g.float() * out.float()).sum(-1).transpose(-1, -2)
        if lse_cot:
            delta = delta - torch.randn(lse.shape, generator=gen).cuda()
        args = (q, k, v, g, lse, delta)
        dq = flash_attention_bwd_dq(*args, **kw)
        dk, dv = flash_attention_bwd_dkv(*args, **kw)
        want = flash_attention_backward_reference(*args, **kw)
        torch.cuda.synchronize()
        errs, ok = {}, True
        for gname, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
            err = (got.float() - w.float()).abs().max().item()
            errs[gname] = err
            ok &= err <= BWD_TOL[dt] * max(w.float().abs().max().item(), 1.0)
        dead = torch.isinf(lse)                       # ([B,] H, Tq)
        ok &= bool((dq.float().transpose(-3, -2)[dead] == 0).all())
        if not ok:
            failures.append(name)
        # the library call: SDPA's backward on (B, H, T, D) leaves
        lib_in = [(x.transpose(-3, -2) if b else x.transpose(0, 1)[None])
                  .contiguous().requires_grad_() for x in (q, k, v)]
        g_lib = g.transpose(-3, -2) if b else g.transpose(0, 1)[None]
        mask = None
        if causal and (qo or ko or tq != tkv):
            mask = ((ko + torch.arange(tkv, device="cuda"))[None, :]
                    <= (qo + torch.arange(tq, device="cuda"))[:, None])
        lib_out = F.scaled_dot_product_attention(
            *lib_in, attn_mask=mask, is_causal=causal and mask is None)
        item = q.element_size()
        bounds = {w: flash_bwd_bound_ms(w, tq, tkv, h, d, causal, item, qo,
                                        ko, b or 1) for w in ("dq", "dkv")}
        big = (b or 1) * tq * tkv * h > 10 ** 8      # the plain backward
        rows.append({
            "case": name, "q": [*lead, tq, h, d], "kv": [*lead, tkv, h, d],
            "causal": causal, "dtype": dt, "q_offset": qo, "k_offset": ko,
            "lse_cotangent": lse_cot, "max_abs_err": errs,
            "dead_rows": int(dead.sum()), "ok": ok,
            "dq_kernel_ms": time_ms(
                lambda: flash_attention_bwd_dq(*args, **kw), reps),
            "dkv_kernel_ms": time_ms(
                lambda: flash_attention_bwd_dkv(*args, **kw), reps),
            "plain_ms": time_ms(
                lambda: flash_attention_backward_reference(*args, **kw),
                max(reps // 10, 5) if big else reps),
            "library_ms": time_ms(lambda: torch.autograd.grad(
                lib_out, lib_in, g_lib, retain_graph=True), reps),
            "dq_bound_ms": bounds["dq"][0], "dq_bound_by": bounds["dq"][1],
            "dkv_bound_ms": bounds["dkv"][0],
            "dkv_bound_by": bounds["dkv"][1]})
    emit({"phase": "kernel", "kernel": "flash_attention_bwd", "rows": rows})
    if failures:
        raise AssertionError(f"flash backward differs from its plain "
                             f"version beyond tolerance at {failures}")
    main = rows[0]            # the ViT training layer: the first path
    worst = {g: max(r["max_abs_err"][g] for r in rows)
             for g in ("dq", "dk", "dv")}
    common = {"route": "cuda",
              "source": "nnstreamer_tpu_torch/csrc/flash_attention_bwd.cu",
              "plain_ms": main["plain_ms"],
              "library_ms": main["library_ms"]}
    return [
        {"name": "flash_attention_bwd_dq",
         "replaces": "nnstreamer_tpu/ops/flash_attention.py:466",
         "max_abs_err": worst["dq"], "ms": main["dq_kernel_ms"],
         "bound_ms": main["dq_bound_ms"], "bound_by": main["dq_bound_by"],
         **common},
        {"name": "flash_attention_bwd_dkv",
         "replaces": "nnstreamer_tpu/ops/flash_attention.py:481",
         "max_abs_err": max(worst["dk"], worst["dv"]),
         "ms": main["dkv_kernel_ms"], "bound_ms": main["dkv_bound_ms"],
         "bound_by": main["dkv_bound_by"], **common}]


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def eager_filters(on: bool):
    """While ``on``, every ``tensor_filter`` backend runs its forward
    eagerly on the card, without graphs: the reference run (a private
    attribute of the backend, not a launch property)."""
    from nnstreamer_tpu_torch.filter.backends._torchexec import \
        TorchExecMixin

    was = TorchExecMixin._eager
    TorchExecMixin._eager = on
    try:
        yield
    finally:
        TorchExecMixin._eager = was


def graph_counts(eager: bool, captures: int, replays: int):
    """What ``_cuda.graphs`` must read after a run of one mode."""
    return {} if eager else {"captures": captures, "replays": replays}


def run_labeling(phase: str, launch: str, frames: int, seed: int,
                 card: str, kernel: str, per_frame: int,
                 eager: bool = False) -> dict:
    """Drive an image-labeling pipeline of ``frames`` frames.  In graph
    mode the filter captures its forward at open and again, fused with
    the decoder's pushdown, before the first frame; every frame is a
    replay.  ``kernel`` must launch ``per_frame`` times a frame and as
    often in each eager run of the forward: the one before each capture
    (graph mode) or the open's warm-up invoke (``eager``)."""
    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.analysis import compileledger

    stamps, captures_at = [], []

    def on_data(buf):
        stamps.append(time.perf_counter())
        captures_at.append(_cuda.graphs["captures"])

    _cuda.reset_launches()
    compileledger.reset()
    p = parse_launch(launch.format(frames=frames, seed=seed))
    p.get("out").connect("new-data", on_data)
    t0 = time.perf_counter()
    with eager_filters(eager):
        p.run(timeout=600)
    wall = time.perf_counter() - t0
    launches, graphs = dict(_cuda.launches), dict(_cuda.graphs)
    results = p.get("out").results
    labels = [b.extra.get("index") for b in results]
    if len(results) != frames or any(i is None for i in labels):
        raise AssertionError(f"{len(results)} labelled frames of {frames}")
    # one synchronous streaming thread: a frame reaches the sink before
    # the next is made, so the gap between sink arrivals is the per-frame
    # latency from source to sink
    gaps = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    row = {"phase": phase, "mode": "eager" if eager else "graph",
           "frames": frames, "launches": launches, "graphs": graphs,
           "compile_ledger": compileledger.snapshot(),
           "fps": (len(stamps) - 1) / (stamps[-1] - stamps[0]),
           "p50_ms": statistics.median(gaps),
           "p90_ms": gaps[int(0.9 * (len(gaps) - 1))],
           "wall_s_incl_open": wall, "card": card}
    emit(row)
    # graph mode: one eager run before each of the two captures (open,
    # pushdown), then a replay a frame; eager: the open's warm-up invoke
    # and one run a frame
    warm_runs = 1 if eager else PUSHDOWN_CAPTURES
    want = per_frame * (frames + warm_runs)
    if launches.get(kernel, 0) != want:
        raise AssertionError(f"{kernel} launched {launches.get(kernel, 0)} "
                             f"times on {phase}, expected {want}")
    if graphs != graph_counts(eager, PUSHDOWN_CAPTURES, frames):
        raise AssertionError(f"{phase}: graphs {graphs}, expected "
                             f"{PUSHDOWN_CAPTURES} captures before the "
                             f"stream and a replay a frame")
    if captures_at and captures_at[0] != graphs.get("captures", 0):
        raise AssertionError(f"{phase}: captures inside the stream")
    if row["compile_ledger"] != {"filter.jitexec.invoke": 2}:
        raise AssertionError(f"{phase}: compile ledger "
                             f"{row['compile_ledger']}, expected the open "
                             f"and the pushdown signatures")
    return {"labels": labels, "launches": launches, "fps": row["fps"]}


def labels_equal_eager(phase: str, graph: dict, eager: dict) -> None:
    """The graph run's labels against the eager run's, frame by frame."""
    differ = [i for i, (a, b) in enumerate(zip(graph["labels"],
                                               eager["labels"])) if a != b]
    emit({"phase": "graph_vs_eager", "path": phase,
          "frames": len(graph["labels"]),
          "labels_equal": len(graph["labels"]) - len(differ),
          "fps": {"graph": graph["fps"], "eager": eager["fps"]}})
    if differ or len(graph["labels"]) != len(eager["labels"]):
        raise AssertionError(f"{phase}: graph labels differ from eager on "
                             f"frames {differ}")


def check_graph_logits(phase: str, model: str, custom: dict, frames: int,
                       seed: int) -> None:
    """The filter's outputs in graph mode against its eager outputs, bit
    for bit, frame by frame; every graph output is held until all are
    compared (a replay must not overwrite an earlier frame's)."""
    import torch

    from nnstreamer_tpu_torch.filter import FilterSingle

    custom = ",".join(f"{k}:{v}" for k, v in custom.items())
    imgs = source_frames(frames, seed)
    outs = {}
    for eager in (False, True):
        with eager_filters(eager):
            with FilterSingle(framework="xla", model=model,
                              custom=custom) as single:
                outs[eager] = [single.fw.invoke([img]) for img in imgs]
                torch.cuda.synchronize()
    differ = [i for i, (g, e) in enumerate(zip(outs[False], outs[True]))
              if not all(torch.equal(a, b) for a, b in zip(g, e))]
    emit({"phase": "graph_vs_eager", "path": phase, "model": model,
          "frames": frames, "outputs_bit_equal": frames - len(differ)})
    if differ:
        raise AssertionError(f"{phase}: graph outputs differ from eager "
                             f"on frames {differ}")


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


def top2_margin(logits):
    """Top-1 minus top-2 along the last axis."""
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def check_vit_outputs(labels, frames: int, seed: int) -> None:
    """The ViT path's labels and logits against the same model with plain
    attention (``attn:naive``), frame by frame."""
    import torch

    from nnstreamer_tpu_torch.models.registry import get_model

    custom = {"seed": str(seed)}
    kern_model = get_model("vit", custom).module
    plain_model = get_model("vit", {**custom, "attn": "naive"}).module
    worst, over, compared, differ = 0.0, 0, 0, []
    with torch.inference_mode():
        for i, img in enumerate(source_frames(frames, seed, VIT_SIZE)):
            x = torch.from_numpy(img).cuda()
            kern, plain = kern_model(x)[0], plain_model(x)[0]
            if kern.shape != (VIT_CLASSES,) \
                    or not torch.isfinite(kern).all():
                raise AssertionError("ViT logits not finite or not "
                                     f"({VIT_CLASSES},)")
            diff = (kern - plain).abs()
            worst = max(worst, diff.max().item())
            over += int((diff > LOGITS_ATOL + LOGITS_RTOL * plain.abs())
                        .sum())
            if top2_margin(plain).item() > MARGIN:
                compared += 1
                if labels[i] != int(plain.argmax()):
                    differ.append(i)
    emit({"phase": "vit_outputs", "frames": frames,
          "logits_max_abs_diff_vs_plain": worst, "atol": LOGITS_ATOL,
          "rtol": LOGITS_RTOL, "logits_over_tolerance": over,
          "frames_compared": compared, "margin": MARGIN,
          "labels_differ": differ, "distinct_labels": len(set(labels))})
    if over or differ:
        raise AssertionError(f"ViT kernel run differs from plain attention: "
                             f"{over} logits beyond tolerance (max "
                             f"{worst}), labels on {differ}")


# ---------------------------------------------------------------------------
# micro-batched serving: the JAX package's benchmark strings
# ---------------------------------------------------------------------------

#: frames a micro-batch carries (bench.py:60 STREAM_BATCH)
BATCH = 32
#: distinct frames the sources cycle (cache-frames=64, device-cache=64)
CACHED = 64
#: the JAX package's headline serving string (bench.py:208-229): frames
#: cycled from a cache, 32-frame micro-batches, a queue before the
#: decoder sized (1 + inflight) x batch; videotestsrc's default seed
BATCHED_SIZE = 224
BATCHED_LAUNCH = (
    "videotestsrc num-buffers={frames} pattern=random {cache}=64 ! "
    "video/x-raw,format=RGB,width={size},height={size},framerate=120/1 ! "
    "tensor_converter ! tensor_filter framework=xla model={model} "
    "custom={custom} batch={batch} inflight={inflight} name=f ! "
    "queue max-size-buffers={depth} ! {tail}")
DECODE_TAIL = "tensor_decoder mode=image_labeling ! tensor_sink name=out"
SOURCE_SEED = 42          # videotestsrc's default
#: path -> (model, custom, source cache, inflight, kernel, its launches
#: a replay of the batched graph); bench.py's configs mobilenet,
#: resident (bench.py:88, :926-935) and vit
BATCHED_PATHS = {
    "flagship_batched": ("mobilenet_v2", "seed:0,use_pallas:1",
                         "cache-frames", 1, "normalize_frame", 1),
    "resident_batched": ("mobilenet_v2", "seed:0,use_pallas:1",
                         "device-cache", 8, "normalize_frame", 1),
    "vit_batched": ("vit", "seed:0", "cache-frames", 1,
                    "flash_attention", 12),
}
#: graph captures of a batched labeling stream, all before its first
#: frame reaches the sink: the per-frame forward at open, the batched
#: one at start, and both again fused with the decoder's pushdown
BATCHED_CAPTURES = 4
#: f32 batched logits against per-frame ones, TF32 off: max |diff| <=
#: this x max |per-frame logit| (summation order only)
F32_BATCH_REL = 1e-4


def batched_launch(path: str, frames: int, batch: int = BATCH,
                   tail: str = DECODE_TAIL) -> str:
    model, custom, cache, inflight, _, _ = BATCHED_PATHS[path]
    return BATCHED_LAUNCH.format(
        frames=frames, cache=cache, size=BATCHED_SIZE, model=model,
        custom=custom, batch=batch, inflight=inflight,
        depth=max(8, (1 + inflight) * batch), tail=tail)


def run_batched(path: str, frames: int, card: str, batch: int = BATCH,
                eager: bool = False) -> dict:
    """Drive one batched labeling path (``batch=1``: the same string per
    frame, the reference) in one mode.  Checks: every frame labelled;
    in graph mode every capture made before the first frame reached the
    sink, none after; ``kernel`` launched as often as the captures' eager
    runs plus the replays each launch (its count a replay); the compile
    ledger's events."""
    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.analysis import compileledger

    # a replay of the batched graph launches the kernel as often as one
    # frame's forward does
    *_, kernel, per_replay = BATCHED_PATHS[path]
    stamps, captures_at = [], []

    def on_data(buf):
        stamps.append(time.perf_counter())
        captures_at.append(_cuda.graphs["captures"])

    _cuda.reset_launches()
    compileledger.reset()
    p = parse_launch(batched_launch(path, frames, batch))
    p.get("out").connect("new-data", on_data)
    t0 = time.perf_counter()
    with eager_filters(eager):
        p.run(timeout=600)
    wall = time.perf_counter() - t0
    launches, graphs = dict(_cuda.launches), dict(_cuda.graphs)
    results = p.get("out").results
    labels = [b.extra.get("index") for b in results]
    if len(results) != frames or any(i is None for i in labels):
        raise AssertionError(f"{path}: {len(results)} labelled frames of "
                             f"{frames}")
    gaps = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    buckets = -(-frames // batch)
    row = {"phase": "batched_path", "path": path, "batch": batch,
           "mode": "eager" if eager else "graph", "frames": frames,
           "launches": launches, "graphs": graphs,
           "compile_ledger": compileledger.snapshot(),
           "fps": (len(stamps) - 1) / (stamps[-1] - stamps[0]),
           "p50_gap_ms": statistics.median(gaps),
           "p90_gap_ms": gaps[int(0.9 * (len(gaps) - 1))],
           "wall_s_incl_open": wall, "card": card}
    runs = graphs.get("captures", 0) + graphs.get("replays", 0)
    if batch > 1:
        want_ledger = {"filter.jitexec.invoke": 2, "filter.jitexec.vmap": 2}
        want_graphs = graph_counts(eager, BATCHED_CAPTURES, buckets)
        # eager: the open's warm-up invoke, then one forward a bucket
        want = per_replay * (runs if not eager else 1 + buckets)
        row["launches_per_replay"] = (launches.get(kernel, 0) / runs
                                      if runs else None)
    else:
        want_ledger = {"filter.jitexec.invoke": 2}
        want_graphs = graph_counts(eager, PUSHDOWN_CAPTURES, frames)
        want = per_replay * (runs if not eager else 1 + frames)
    emit(row)
    if launches.get(kernel, 0) != want:
        raise AssertionError(f"{path} (batch {batch}, {row['mode']}): "
                             f"{kernel} launched {launches.get(kernel, 0)} "
                             f"times, expected {want}")
    if graphs != want_graphs:
        raise AssertionError(f"{path} (batch {batch}): graphs {graphs}, "
                             f"expected {want_graphs}")
    if captures_at and captures_at[0] != graphs.get("captures", 0):
        raise AssertionError(f"{path} (batch {batch}): captures inside "
                             "the stream")
    if row["compile_ledger"] != want_ledger:
        raise AssertionError(f"{path} (batch {batch}): compile ledger "
                             f"{row['compile_ledger']}, expected "
                             f"{want_ledger}")
    return {"labels": labels, "launches": launches, "fps": row["fps"]}


def check_batched_outputs(path: str, labels_batched, labels_b1) -> None:
    """The cached frames through the path's model directly: the batched
    forward's labels must equal the stream's batched labels and the
    per-frame forward's the batch=1 stream's (the streams are graphs of
    the same forwards); batched logits are held to per-frame ones as
    check_vit_outputs holds kernel to plain (LOGITS_ATOL/RTOL, labels
    compared where the per-frame top-2 margin exceeds MARGIN); then in
    f32 with TF32 off, within F32_BATCH_REL."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.filter.framework import FilterProperties
    from nnstreamer_tpu_torch.models.registry import get_model

    model_name, custom, *_ = BATCHED_PATHS[path]
    custom = FilterProperties.parse_custom(custom)
    imgs = torch.from_numpy(np.stack(
        source_frames(CACHED, SOURCE_SEED, BATCHED_SIZE))).cuda()

    def both(model):
        with torch.inference_mode():
            batched = torch.cat([model.batched(imgs[i:i + BATCH])[0]
                                 for i in range(0, CACHED, BATCH)])
            per_frame = torch.stack([model.module(x)[0] for x in imgs])
        return batched.float(), per_frame.float()

    batched, per_frame = both(get_model(model_name, custom))
    if not torch.isfinite(batched).all() or batched.shape[0] != CACHED:
        raise AssertionError(f"{path}: batched logits not finite")
    diff = (batched - per_frame).abs()
    over = int((diff > LOGITS_ATOL + LOGITS_RTOL * per_frame.abs()).sum())
    sure = top2_margin(per_frame) > MARGIN
    b_top, p_top = batched.argmax(-1), per_frame.argmax(-1)
    differ = [i for i in range(CACHED) if sure[i] and b_top[i] != p_top[i]]
    stream_b = [labels_batched[i] for i in range(CACHED)]
    stream_1 = [labels_b1[i] for i in range(CACHED)]
    stream_equal = (stream_b == b_top.tolist()
                    and stream_1 == p_top.tolist()
                    and all(labels_batched[i] == labels_batched[i % CACHED]
                            for i in range(len(labels_batched))))
    torch.backends.cudnn.allow_tf32 = False
    try:
        f32_b, f32_p = both(get_model(model_name,
                                      {**custom, "dtype": "float32"}))
    finally:
        torch.backends.cudnn.allow_tf32 = True
    f32_rel = ((f32_b - f32_p).abs().max() / f32_p.abs().max()).item()
    emit({"phase": "batched_outputs", "path": path, "frames": CACHED,
          "logits_max_abs_diff_vs_per_frame": diff.max().item(),
          "atol": LOGITS_ATOL, "rtol": LOGITS_RTOL,
          "logits_over_tolerance": over, "margin": MARGIN,
          "frames_compared": int(sure.sum()),
          "labels_differ_compared": differ,
          "labels_differ_all": int((b_top != p_top).sum()),
          "stream_labels_equal_model": stream_equal,
          "f32_max_rel_diff": f32_rel, "f32_rel_tol": F32_BATCH_REL,
          "distinct_labels": len(set(stream_b))})
    if over or differ or not stream_equal or f32_rel > F32_BATCH_REL:
        raise AssertionError(f"{path}: batched outputs differ from per "
                             f"frame: {over} logits beyond tolerance, "
                             f"labels on {differ}, stream labels equal "
                             f"{stream_equal}, f32 by {f32_rel}")


def check_batched_graph_logits(path: str) -> None:
    """A bucket of the cached frames (and a padded 20-frame one) through
    the batched graph and eagerly: logits bit for bit."""
    from nnstreamer_tpu_torch.filter import FilterSingle

    model_name, custom, *_ = BATCHED_PATHS[path]
    imgs = [[f] for f in source_frames(CACHED, SOURCE_SEED, BATCHED_SIZE)]
    outs = {}
    for eager in (False, True):
        with eager_filters(eager):
            with FilterSingle(framework="xla", model=model_name,
                              custom=custom) as single:
                single.fw.warmup_batched(BATCH)
                handles = [single.fw.invoke_batched(imgs[:BATCH], BATCH),
                           single.fw.invoke_batched(imgs[BATCH:BATCH + 20],
                                                    BATCH)]
                outs[eager] = [row[0] for h in handles for row in h.wait()]
    differ = [i for i, (g, e) in enumerate(zip(outs[False], outs[True]))
              if not (g == e).all()]
    emit({"phase": "graph_vs_eager", "path": path, "frames": len(outs[True]),
          "outputs_bit_equal": len(outs[True]) - len(differ)})
    if differ or len(outs[False]) != BATCH + 20:
        raise AssertionError(f"{path}: batched graph outputs differ from "
                             f"eager on frames {differ}")


def check_inflight_bits(frames: int) -> None:
    """resident-batched without the decoder (raw logits), at inflight=8
    and inflight=1: every frame's logits bit for bit — eight batches'
    outputs live on the card at once, each copied to the host from its
    own clone."""
    import numpy as np

    from nnstreamer_tpu_torch import parse_launch

    model, custom, cache, _, _, _ = BATCHED_PATHS["resident_batched"]
    logits = {}
    for inflight in (8, 1):
        p = parse_launch(BATCHED_LAUNCH.format(
            frames=frames, cache=cache, size=BATCHED_SIZE, model=model,
            custom=custom, batch=BATCH, inflight=inflight,
            depth=(1 + inflight) * BATCH, tail="tensor_sink name=out"))
        p.run(timeout=600)
        logits[inflight] = [b.np(0) for b in p.get("out").results]
    differ = [i for i, (a, b) in enumerate(zip(logits[8], logits[1]))
              if not np.array_equal(a, b)]
    emit({"phase": "inflight_bits", "path": "resident_batched",
          "frames": frames, "inflight": [8, 1],
          "logits_bit_equal": frames - len(differ)})
    if differ or len(logits[8]) != frames or len(logits[1]) != frames:
        raise AssertionError(f"inflight=8 logits differ from inflight=1 "
                             f"on frames {differ}")


#: an A -> B cascade at equal batch: MobileNetV2's (1001,) logits into
#: an MLP that takes them, A's outputs handed on as BatchView rows
#: (``output-device=true``) or through the host
CASCADE_LAUNCH = (
    "videotestsrc num-buffers={frames} pattern=random device-cache=64 ! "
    "video/x-raw,format=RGB,width={size},height={size},framerate=120/1 ! "
    "tensor_converter ! tensor_filter framework=xla model=mobilenet_v2 "
    "custom=seed:0,use_pallas:1 batch=32 {device} name=a ! "
    "tensor_filter framework=xla model=mlp custom=in_dim:1001,seed:0 "
    "batch=32 name=b ! tensor_sink name=out")


def check_cascade(frames: int, reps: int) -> None:
    """The cascade with A's outputs kept on the card against the same
    cascade through the host: B's outputs bit for bit.  On the card the
    hand-over is one device copy a bucket, A's batch into B's static
    input; it is timed here at that shape ((32, 1001) f32)."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.tensor.buffer import BatchView

    outs, handed = {}, {}
    for device in ("output-device=true", ""):
        p = parse_launch(CASCADE_LAUNCH.format(frames=frames,
                                               size=BATCHED_SIZE,
                                               device=device))
        seen = []
        b = p.get("b")

        def counting(pad, buf, chain=b.chain, seen=seen):
            seen.append(isinstance(buf.tensors[0], BatchView))
            return chain(pad, buf)

        b.chain = counting
        p.run(timeout=600)
        outs[device] = [b.np(0) for b in p.get("out").results]
        handed[device] = sum(seen)
    differ = [i for i, (a, b) in enumerate(zip(outs["output-device=true"],
                                               outs[""]))
              if not np.array_equal(a, b)]
    src = torch.randn(BATCH, 1001, device="cuda")
    static = torch.empty_like(src)
    nbytes = 2 * src.numel() * src.element_size()
    emit({"phase": "cascade", "frames": frames,
          "batchview_rows_into_b": handed["output-device=true"],
          "host_rows_into_b": frames - handed[""],
          "outputs_bit_equal": frames - len(differ),
          "handover_copy_ms": time_ms(lambda: static.copy_(src), reps),
          "handover_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
          "handover_bytes": nbytes // 2})
    if (differ or handed["output-device=true"] != frames or handed[""]
            or any(len(o) != frames for o in outs.values())):
        raise AssertionError(f"cascade: device hand-over differs from the "
                             f"host's on frames {differ}")


#: the cross-stream bucket's models: (model, custom, maker of n rows of
#: input, the port kernel it reaches or None); the MLP at the JAX
#: package's defaults (64 -> 4 x 1024 -> 16)
XBATCH_MODELS = {
    "mlp": ("mlp", "seed:0", lambda rng, n: rng.standard_normal(
        (n, 64)).astype("float32"), None),
    "mobilenet_v2": ("mobilenet_v2", "seed:0,use_pallas:1",
                     lambda rng, n: rng.integers(0, 256, (n, 224, 224, 3),
                                                 dtype="uint8"),
                     "normalize_frame"),
}
XBATCH_CAPACITY = 32


def run_xbatch_bucket(card: str) -> dict:
    """invoke_stacked at capacity 32 over fills 1..32: warmup_stacked
    captures each pad shape once (7 shapes), no fill captures after it,
    a replay a fill; every fill's padded outputs equal an eager backend's
    bit for bit."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.analysis import compileledger
    from nnstreamer_tpu_torch.filter import FilterSingle
    from nnstreamer_tpu_torch.filter.backends._torchexec import \
        TorchExecMixin

    fills = range(1, XBATCH_CAPACITY + 1)
    shapes = len({TorchExecMixin.pad_rows(n, XBATCH_CAPACITY)
                  for n in fills})
    all_launches = collections.Counter()
    for name, (model, custom, make, kernel) in XBATCH_MODELS.items():
        rng = np.random.default_rng(0)
        batches = [make(rng, n) for n in fills]
        outs, rows = {}, {}
        for eager in (False, True):
            with eager_filters(eager):
                with FilterSingle(framework="xla", model=model,
                                  custom=custom) as single:
                    fw = single.fw
                    _cuda.reset_launches()
                    compileledger.reset()
                    fw.warmup_stacked(XBATCH_CAPACITY)
                    warm = dict(_cuda.graphs)
                    t0 = time.perf_counter()
                    outs[eager] = [fw.invoke_stacked([b], n, XBATCH_CAPACITY)
                                   [0] for n, b in zip(fills, batches)]
                    torch.cuda.synchronize()
                    fill_s = time.perf_counter() - t0
                    graphs, launches = dict(_cuda.graphs), dict(
                        _cuda.launches)
                    rows[eager] = {
                        "phase": "xbatch_bucket", "model": name,
                        "mode": "eager" if eager else "graph",
                        "capacity": XBATCH_CAPACITY, "fills": len(fills),
                        "pad_shapes": shapes, "graphs_after_warmup": warm,
                        "graphs": graphs, "launches": launches,
                        "compile_ledger": compileledger.snapshot(),
                        "fills_ms": fill_s * 1e3, "card": card}
        graph_row = rows[False]
        differ = [n for n, a, b in zip(fills, outs[False], outs[True])
                  if a.shape[0] != TorchExecMixin.pad_rows(
                      n, XBATCH_CAPACITY) or not torch.equal(a, b)]
        graph_row["fills_bit_equal_eager"] = len(fills) - len(differ)
        emit(rows[True])
        emit(graph_row)
        want_graphs = {"captures": shapes, "replays": len(fills)}
        if (graph_row["graphs"] != want_graphs
                or graph_row["graphs_after_warmup"] != {"captures": shapes}
                or graph_row["compile_ledger"] != {
                    "filter.jitexec.vmap": shapes}
                or rows[True]["compile_ledger"] != {
                    "filter.jitexec.vmap": shapes}):
            raise AssertionError(f"xbatch_bucket ({name}): graphs "
                                 f"{graph_row['graphs']}, expected "
                                 f"{want_graphs}; ledger "
                                 f"{graph_row['compile_ledger']}")
        if kernel is not None:
            want = shapes + len(fills)       # a capture's eager run, replays
            if graph_row["launches"].get(kernel, 0) != want:
                raise AssertionError(f"xbatch_bucket ({name}): {kernel} "
                                     f"launched {graph_row['launches']}, "
                                     f"expected {want}")
            all_launches.update(graph_row["launches"])
        if differ:
            raise AssertionError(f"xbatch_bucket ({name}): replays differ "
                                 f"from eager at fills {differ}")
    return {"launches": dict(all_launches)}


def run_batched_paths(args, card: str) -> dict:
    """Every batched path in graph mode, eagerly and (flagship, vit) at
    batch=1 as the reference, in one call; then their output checks.
    Returns path -> the graph run's row."""
    rows = {}
    for path in BATCHED_PATHS:
        graph = run_batched(path, args.batched_frames, card)
        eager = run_batched(path, args.batched_frames, card, eager=True)
        labels_equal_eager(path, graph, eager)
        check_batched_graph_logits(path)
        rows[path] = graph
    for path in ("flagship_batched", "vit_batched"):
        b1 = run_batched(path, args.batched_frames, card, batch=1)
        emit({"phase": "batched_vs_b1", "path": path,
              "fps": {"batch32": rows[path]["fps"], "batch1": b1["fps"]}})
        check_batched_outputs(path, rows[path]["labels"], b1["labels"])
    if rows["resident_batched"]["labels"] != rows["flagship_batched"][
            "labels"]:
        raise AssertionError("resident_batched labels differ from "
                             "flagship_batched on the same frames")
    check_inflight_bits(args.batched_frames)
    check_cascade(args.batched_frames, args.reps)
    rows["xbatch_bucket"] = run_xbatch_bucket(card)
    return rows


# ---------------------------------------------------------------------------
# the query plane: the README's query pair, served from the card
# ---------------------------------------------------------------------------

#: the server's caps and the two strings of the README's query pair, with
#: the server's cross-stream bucket (the JAX package's tests/test_xbatch.py
#: strings at the flagship's model); ``{batch}`` is empty for batch=1
QUERY_SIZE = 224
QUERY_CAPS = ("other/tensors,format=static,num_tensors=1,"
              f"dimensions=3:{QUERY_SIZE}:{QUERY_SIZE},types=uint8")
QUERY_SERVER = ("tensor_query_serversrc name=qsrc id={sid} port=0 {batch}"
                f"caps={QUERY_CAPS} ! tensor_filter framework=xla "
                "model=mobilenet_v2 custom=seed:0,use_pallas:1 name=f ! "
                "tensor_query_serversink id={sid}")
QUERY_BATCH = "batch=32 batch-timeout-ms=5 "
QUERY_CLIENT = ("videotestsrc num-buffers={frames} pattern=random "
                "cache-frames=64 ! video/x-raw,format=RGB,"
                f"width={QUERY_SIZE},height={QUERY_SIZE},framerate=120/1 ! "
                "tensor_converter ! "
                "tensor_query_client port={port} timeout=120 ! "
                "tensor_decoder mode=image_labeling ! tensor_sink name=out")
#: client connections of query_serve, and the frames each sends
QUERY_CLIENTS = 32
QUERY_FRAMES = 16
#: graphs of the served MobileNetV2: the per-frame forward at open, then
#: the 7 pad shapes of a 32-row bucket (1, 2, 4, 8, 16, 24, 32) at the
#: first cross-stream bucket
QUERY_CAPTURES = 1 + 7


def query_frames(seed: int):
    """Seeded (QUERY_SIZE, QUERY_SIZE, 3) uint8 frames, QUERY_FRAMES for
    each of QUERY_CLIENTS clients; pixel (0, 0) carries (client,
    request), so a bucket's rows name their frames."""
    import numpy as np

    rng = np.random.default_rng(seed)
    frames = []
    for i in range(QUERY_CLIENTS):
        row = []
        for k in range(QUERY_FRAMES):
            f = rng.integers(0, 256, (QUERY_SIZE, QUERY_SIZE, 3),
                             dtype=np.uint8)
            f[0, 0, :2] = (i, k)
            row.append(f)
        frames.append(row)
    return frames


def drive_query_clients(port: int, frames) -> dict:
    """One synchronous ``QueryConnection`` a client, each in a thread,
    started together; every reply's logits (copied out of the pooled
    slab), round trips and the wall from the start to the last reply."""
    import threading

    import numpy as np

    from nnstreamer_tpu_torch.query import QueryConnection
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    outs = [[None] * len(row) for row in frames]
    rtt, done, errors, start = [], [], [], []
    barrier = threading.Barrier(len(frames), timeout=120,
                                action=lambda: start.append(
                                    time.perf_counter()))

    def run(i):
        try:
            conn = QueryConnection("127.0.0.1", port, timeout=120.0)
            conn.connect()
        except Exception as exc:  # noqa: BLE001 - counted and raised below
            errors.append(repr(exc))
            barrier.abort()
            return
        try:
            barrier.wait()
            for k, frame in enumerate(frames[i]):
                t0 = time.perf_counter()
                out = conn.query(TensorBuffer(tensors=[frame]))
                t1 = time.perf_counter()
                rtt.append(t1 - t0)
                done.append(t1)
                outs[i][k] = np.array(out.np(0))
        except Exception as exc:  # noqa: BLE001 - counted and raised below
            errors.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(frames))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    if any(t.is_alive() for t in threads):
        raise AssertionError("query_serve: a client thread hung")
    rtt.sort()
    n = len(rtt)
    return {"outs": outs, "errors": errors, "replies": n,
            "t0": start[0] if start else None,
            "t1": max(done) if done else None,
            "replies_per_s": (n / (max(done) - start[0]) if n and start
                              else 0.0),
            "rtt_p50_ms": statistics.median(rtt) * 1e3 if n else None,
            "rtt_p99_ms": rtt[min(n - 1, int(0.99 * n))] * 1e3 if n
            else None}


@contextlib.contextmanager
def query_server(sid: int, batch: str, frames, before_play=None):
    """The server string (``batch``: QUERY_BATCH or "") started, warmed
    with one frame from each client (the first cross-stream bucket
    captures the pad set), and stopped after: yields (pipeline, port)."""
    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.query import shutdown_server

    p = parse_launch(QUERY_SERVER.format(sid=sid, batch=batch))
    if before_play is not None:
        before_play(p)
    p.play()
    try:
        port = p.get("qsrc").bound_port
        warm = drive_query_clients(port, [row[:1] for row in frames])
        if warm["errors"]:
            raise AssertionError(f"query server warm-up: "
                                 f"{warm['errors'][:3]}")
        yield p, port
    finally:
        p.stop()
        shutdown_server(sid)


def buckets_served(p) -> int:
    """Buckets a batching serversrc has dispatched (one frame or more)."""
    qsrc = p.get("qsrc")
    return qsrc._m_xb_batched.value + qsrc._m_xb_solo.value


def traced_window(p, run):
    """``run()`` under a counters-only tracer on the server pipeline (two
    clock reads a ``chain()``): its result and each element's mean time
    inside ``chain()`` (a bucket's, where the server batches)."""
    tracer = p.enable_tracing()
    try:
        out = run()
    finally:
        p.tracer = None
    return out, {k: v["proctime_avg_us"]
                 for k, v in tracer.report().items()}


def serve_query(batch: str, frames, card: str, child_frames: int = 0,
                extra_frames=()) -> dict:
    """Serve the clients from the server string (``batch``: QUERY_BATCH
    or ""), then (``child_frames``) the README's client string through
    the port's CLI in a child process, or (``extra_frames``) those frames
    from one more connection; the row, the replies and what the server
    recorded (each bucket's captures, and the rows of the timed run's
    buckets)."""
    import numpy as np

    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.analysis import compileledger
    from nnstreamer_tpu_torch.query import QueryConnection
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    buckets, recording = [], [False]

    def record_buckets(p):
        f = p.get("f")

        def chain(pad, buf, chain=f.chain):
            # each bucket's rows by the (client, request) pixel, and the
            # captures once the bucket is dispatched
            t = buf.tensors[0]
            ids = (t[:, 0, 0, :2].numpy() if buf.extra.get("nns_xbatch")
                   else np.asarray(t)[None, 0, 0, :2])
            ret = chain(pad, buf)
            buckets.append({"xbatch": "nns_xbatch" in buf.extra,
                            "rows": [tuple(int(v) for v in r) for r in ids]
                            if recording[0] else None,
                            "captures": _cuda.graphs["captures"]})
            return ret

        f.chain = chain

    _cuda.reset_launches()
    compileledger.reset()
    child, extra = None, []
    with query_server(9100 + bool(batch), batch, frames,
                      record_buckets) as (p, port):
        recording[0] = True
        run, chain_us = traced_window(
            p, lambda: drive_query_clients(port, frames))
        recording[0] = False
        if child_frames:
            child = subprocess.run(
                [sys.executable, "-m", "nnstreamer_tpu_torch.launch",
                 QUERY_CLIENT.format(frames=child_frames, port=port),
                 "--print-sink", "out", "--timeout", "300", "--quiet"],
                capture_output=True, text=True, timeout=600, cwd=HERE,
                env=dict(os.environ, PYTHONPATH=HERE))
        if extra_frames:
            conn = QueryConnection("127.0.0.1", port, timeout=120.0)
            conn.connect()
            try:
                extra = [np.array(conn.query(TensorBuffer(
                    tensors=[x])).np(0)) for x in extra_frames]
            finally:
                conn.close()
        qsrc = p.get("qsrc")
        counters = qsrc.server.counters()
        xb = ((qsrc._m_xb_batched.value, qsrc._m_xb_solo.value,
               qsrc._m_xb_frames.value) if batch else (0, 0, 0))
        evicted = qsrc.server._m_evicted.value
    launches, graphs = dict(_cuda.launches), dict(_cuda.graphs)
    timed = [b for b in buckets if b["rows"]]
    row = {"phase": "query_serve", "batch": 32 if batch else 1,
           "clients": len(frames), "frames": sum(map(len, frames)),
           "replies": run["replies"],
           "replies_per_s": run["replies_per_s"],
           "rtt_p50_ms": run["rtt_p50_ms"], "rtt_p99_ms": run["rtt_p99_ms"],
           "buckets": len(buckets), "timed_buckets": len(timed),
           "mean_fill": (sum(len(b["rows"]) for b in timed) / len(timed)
                         if timed else 0.0),
           "batched_buckets": xb[0], "solo_buckets": xb[1],
           "batched_frames": xb[2],
           "shed": sum(counters["shed"].values()),
           "admitted": sum(counters["admitted"].values()),
           "errors": len(run["errors"]) + evicted,
           "chain_us_per_bucket": chain_us,
           "launches": launches, "graphs": graphs,
           "compile_ledger": compileledger.snapshot(), "card": card}
    if child is not None:
        labels = [int(line.split()[-1]) for line in child.stdout.splitlines()
                  if line.startswith("pts=")]
        row.update(cli_rc=child.returncode, cli_labels=len(labels))
    emit(row)
    if run["errors"] or row["errors"] or row["shed"]:
        raise AssertionError(f"query_serve (batch {row['batch']}): "
                             f"{row['shed']} sheds, errors "
                             f"{run['errors'][:3]}, {evicted} evicted")
    if child is not None and (child.returncode or len(labels)
                              != child_frames):
        raise AssertionError(f"query_serve: the CLI client exited "
                             f"{child.returncode} with {len(labels)} "
                             f"labels of {child_frames}: "
                             f"{child.stderr[-800:]}")
    return {"row": row, "outs": run["outs"], "buckets": buckets,
            "labels": labels if child is not None else None,
            "extra": extra}


def _query_client_process(port: int, frames, out, go) -> None:
    """A process of client threads (``query_pace``): once imported it
    reports ready and waits for ``go``, so every process starts
    together; then its replies, errors and the monotonic start and end
    of its run (the clock is the host's, comparable across its
    processes)."""
    sys.path.insert(0, HERE)
    import nnstreamer_tpu_torch.query  # noqa: F401 - before the start

    out.put("ready")
    if not go.wait(timeout=600):
        raise TimeoutError("query_pace: no start signal")
    run = drive_query_clients(port, frames)
    out.put({k: run[k] for k in ("replies", "errors", "t0", "t1")})


#: the pace variants of the served pair: the clients in QUERY_PROCESSES
#: processes of their own instead of the server's, and the wire without
#: its CRC-32C (both sides' software CRC of every payload)
QUERY_PROCESSES = 4


def run_query_pace(seed: int, card: str) -> None:
    """What sets the pace of ``query_serve`` (with ``--profile``): the
    same batched server and frames with the client threads moved into
    QUERY_PROCESSES processes (the server's interpreter lock no longer
    shared with them), and in-process without the CRC; replies/s and
    each element's time a bucket inside ``chain()`` over the timed
    run."""
    import multiprocessing

    from nnstreamer_tpu_torch.query import protocol

    frames = query_frames(seed)

    def in_processes(port):
        ctx = multiprocessing.get_context("spawn")
        out, go = ctx.Queue(), ctx.Event()
        step = -(-len(frames) // QUERY_PROCESSES)
        procs = [ctx.Process(target=_query_client_process,
                             args=(port, frames[i:i + step], out, go))
                 for i in range(0, len(frames), step)]
        for proc in procs:
            proc.start()
        if [out.get(timeout=600) for _ in procs] != ["ready"] * len(procs):
            raise AssertionError("query_pace: a client process did not "
                                 "start")
        go.set()
        runs = [out.get(timeout=600) for _ in procs]
        for proc in procs:
            proc.join(timeout=60)
        return runs

    def without_crc(port):
        protocol._CRC_FN = False
        try:
            return [drive_query_clients(port, frames)]
        finally:
            protocol._CRC_FN = None

    for variant, drive in (("client_processes", in_processes),
                           ("no_crc", without_crc)):
        with query_server(9103, QUERY_BATCH, frames) as (p, port):
            before = buckets_served(p)
            runs, chain_us = traced_window(p, lambda: drive(port))
            buckets = buckets_served(p) - before
        replies = sum(r["replies"] for r in runs)
        errors = sum(len(r["errors"]) for r in runs)
        wall = max(r["t1"] for r in runs) - min(r["t0"] for r in runs)
        emit({"phase": "query_pace", "variant": variant,
              "clients": len(frames), "replies": replies,
              "replies_per_s": replies / wall, "buckets": buckets,
              "mean_fill": replies / max(buckets, 1), "errors": errors,
              "chain_us_per_bucket": chain_us, "card": card})
        if errors or replies != sum(map(len, frames)):
            raise AssertionError(f"query_pace ({variant}): {replies} "
                                 f"replies, {errors} errors")


def check_query_eager(frames, graph: dict) -> int:
    """Every bucket of the graph run's timed clients, rebuilt from its
    frames, through the same model eagerly: each served reply bit for bit
    (a bucket as ``invoke_stacked`` at capacity 32, a lone frame as
    ``invoke``), so a reply routed to the wrong client or request fails.
    Returns the frames compared, which must be every frame sent."""
    import numpy as np

    from nnstreamer_tpu_torch.filter import FilterSingle

    subset = [b for b in graph["buckets"] if b["rows"]]
    differ, compared = [], 0
    with eager_filters(True):
        with FilterSingle(framework="xla", model="mobilenet_v2",
                          custom="seed:0,use_pallas:1") as single:
            for b in subset:
                rows = b["rows"]
                if b["xbatch"]:
                    stacked = np.stack([frames[i][k] for i, k in rows])
                    out = single.fw.invoke_stacked(
                        [stacked], len(rows), capacity=BATCH)[0]
                    got = out.float().cpu().numpy()[:len(rows)]
                else:
                    i, k = rows[0]
                    got = single.fw.invoke([frames[i][k]])[0].float(
                        ).cpu().numpy()[None]
                for (i, k), g in zip(rows, got):
                    compared += 1
                    if not np.array_equal(g, graph["outs"][i][k]):
                        differ.append((i, k))
    emit({"phase": "graph_vs_eager", "path": "query_serve",
          "buckets": len(subset), "frames": compared,
          "outputs_bit_equal": compared - len(differ)})
    sent = sum(map(len, frames))
    if differ or compared != sent:
        raise AssertionError(f"query_serve: {compared} of {sent} replies "
                             f"replayed eagerly; served logits differ "
                             f"from the eager forward on frames "
                             f"{differ[:8]}")
    return compared


def run_query_serve(args, card: str) -> dict:
    """The README's query pair on the card (the server in this process:
    ``serversrc batch=32 ! tensor_filter model=mobilenet_v2 !
    serversink``; 32 client connections in threads, one more client
    pipeline through the port's CLI in a child process), then the same
    string at batch=1 on the same frames as the reference, then a subset
    of the served buckets eagerly.  Checks: zero sheds and errors; every
    reply within the bf16 bound of batch=1's (LOGITS_ATOL + LOGITS_RTOL
    x |logit|); every reply bit for bit against its bucket replayed
    eagerly; the CLI client's labels against batch=1's wherever batch=1's
    top-2 margin is above twice the largest reply difference (at least
    one label so compared); the graphs: one capture at open
    and the pad set at the first cross-stream bucket, none after it; K1
    launched once a bucket (a replay of a graph that launches it once)
    besides the captures' eager runs; the compile ledger's events."""
    import numpy as np

    frames = query_frames(args.seed)
    child_frames = source_frames(CACHED, SOURCE_SEED, QUERY_SIZE)
    graph = serve_query(QUERY_BATCH, frames, card, child_frames=CACHED)
    row = graph["row"]
    b1 = serve_query("", frames, card, extra_frames=child_frames)
    over, worst, sure, differ, scale = 0, 0.0, 0, [], []
    for i, row_frames in enumerate(frames):
        for k in range(len(row_frames)):
            got, want = graph["outs"][i][k], b1["outs"][i][k]
            if got.shape != (1001,) or not np.isfinite(got).all():
                raise AssertionError(f"query_serve: reply ({i}, {k}) is "
                                     f"{got.shape}, finite "
                                     f"{np.isfinite(got).all()}")
            diff = np.abs(got - want)
            worst = max(worst, float(diff.max()))
            over += int((diff > LOGITS_ATOL + LOGITS_RTOL
                         * np.abs(want)).sum())
            scale.append(np.abs(want))
    # a label is held where batch=1's top-2 margin is more than twice the
    # largest difference of a served reply from batch=1's
    margin = 2 * worst
    for x, label in zip(b1["extra"], graph["labels"]):
        top2 = np.sort(x)[-2:]
        if top2[1] - top2[0] > margin:
            sure += 1
            if int(np.argmax(x)) != label:
                differ.append(label)
    compared = check_query_eager(frames, graph)
    buckets = graph["buckets"]
    first_xb = next((j for j, b in enumerate(buckets) if b["xbatch"]), None)
    late_captures = ([b["captures"] for b in buckets[first_xb:]
                      if b["captures"] != QUERY_CAPTURES]
                     if first_xb is not None else ["no cross-stream bucket"])
    k1 = row["launches"].get("normalize_frame", 0)
    graphs = row["graphs"]
    emit({"phase": "query_serve_outputs",
          "replies_vs_batch1_max_abs_diff": worst,
          "atol": LOGITS_ATOL, "rtol": LOGITS_RTOL,
          "logits_over_tolerance": over,
          "median_abs_logit": float(np.median(np.concatenate(scale))),
          "cli_label_margin": margin,
          "cli_labels_compared": sure, "cli_labels_differ": differ,
          "eager_frames_bit_equal": compared,
          "fps": {"batch32": row["replies_per_s"],
                  "batch1": b1["row"]["replies_per_s"]},
          "rtt_p50_ms": {"batch32": row["rtt_p50_ms"],
                         "batch1": b1["row"]["rtt_p50_ms"]},
          "rtt_p99_ms": {"batch32": row["rtt_p99_ms"],
                         "batch1": b1["row"]["rtt_p99_ms"]},
          "mean_fill": row["mean_fill"], "card": card})
    if over or differ or not sure:
        raise AssertionError(f"query_serve: {over} logits beyond the bf16 "
                             f"bound of batch=1, CLI labels differ on "
                             f"{differ}, {sure} compared")
    if late_captures or graphs.get("captures") != QUERY_CAPTURES:
        raise AssertionError(f"query_serve: graphs {graphs}, captures "
                             f"after the first bucket {late_captures[:4]}")
    if (graphs.get("replays") != row["buckets"]
            or k1 != graphs["captures"] + graphs["replays"]):
        raise AssertionError(f"query_serve: K1 launched {k1} times over "
                             f"{row['buckets']} buckets, graphs {graphs}")
    if row["compile_ledger"] != {"filter.jitexec.invoke": 1,
                                 "filter.jitexec.vmap": 7}:
        raise AssertionError(f"query_serve: compile ledger "
                             f"{row['compile_ledger']}")
    if not row["batched_buckets"]:
        raise AssertionError("query_serve: no bucket held more than one "
                             "frame")
    return {"launches": row["launches"]}


def lm_f32_diff(custom: dict, tokens) -> float:
    """Logits max |kernel - plain| of the LM filter's model built in f32,
    on one frame's tokens."""
    import torch

    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.models.streamformer_lm import forward_logits

    model = get_model("streamformer_lm", {**custom, "dtype": "float32"}
                      ).module
    t = torch.from_numpy(tokens).cuda()
    with torch.inference_mode():
        kern = forward_logits(model.params, t, model.cfg, flash=True)
        plain = forward_logits(model.params, t, model.cfg, flash=False)
    return (kern - plain).abs().max().item()


def stream_lm_filter(frames: int, seed: int, card: str, eager: bool):
    """Push ``frames`` token frames of seq 2048 through the LM filter in
    one mode; returns the row, the tokens and each frame's logits (device
    tensors, all held to the end)."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.analysis import compileledger
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    custom = {**LM_CUSTOM, "seq": str(LM_SEQ), "seed": str(seed)}
    vocab = int(LM_CUSTOM["vocab"])
    rng = np.random.default_rng(seed)
    toks = [rng.integers(0, vocab, LM_SEQ).astype(np.int32)
            for _ in range(frames)]
    stamps, outs = [], []

    def on_data(buf):
        torch.cuda.synchronize()      # the frame's device work is done
        stamps.append(time.perf_counter())
        outs.append(buf.tensors[0])

    _cuda.reset_launches()
    compileledger.reset()
    p = parse_launch(LM_LAUNCH.format(
        seq=LM_SEQ, custom=",".join(f"{k}:{v}" for k, v in custom.items())))
    p.get("out").connect("new-data", on_data)
    with eager_filters(eager):
        p.play()                      # opens the filter: one warm-up invoke
        try:
            t0 = time.perf_counter()
            for t in toks:
                p.get("src").push_buffer(TensorBuffer(tensors=[t]))
            p.get("src").end_of_stream()
            p.wait(timeout=600)
        finally:
            p.stop()
    launches, graphs = dict(_cuda.launches), dict(_cuda.graphs)
    gaps = [(b - a) * 1e3 for a, b in zip([t0] + stamps, stamps)]
    row = {"phase": "lm_filter", "mode": "eager" if eager else "graph",
           "frames": frames, "seq": LM_SEQ, "launches": launches,
           "graphs": graphs, "compile_ledger": compileledger.snapshot(),
           "prefill_tok_s": frames * LM_SEQ / (stamps[-1] - t0),
           "frame_ms": gaps, "card": card}
    # the open's eager run (before its capture, or its warm-up invoke),
    # then one a frame; no pushdown, so one capture
    want = int(LM_CUSTOM["layers"]) * (frames + 1)
    if (len(outs) != frames or launches.get("flash_attention", 0) != want
            or graphs != graph_counts(eager, 1, frames)
            or row["compile_ledger"] != {"filter.jitexec.invoke": 1}):
        emit(row)
        raise AssertionError(f"lm_filter ({row['mode']}): {len(outs)} "
                             f"frames of {frames}, flash_attention launched "
                             f"{launches.get('flash_attention', 0)} times, "
                             f"expected {want}; graphs {graphs}; ledger "
                             f"{row['compile_ledger']}")
    return row, toks, outs


def run_lm_filter(frames: int, seed: int, card: str) -> dict:
    """StreamFormer LM logits as a stream filter at seq 2048: ``frames``
    token frames through appsrc, each answered with (2048, 8192) logits,
    as graph replays that must equal an eager run bit for bit and the
    plain-attention forward of the same model within the bf16 bounds."""
    import torch

    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.models.streamformer_lm import forward_logits

    custom = {**LM_CUSTOM, "seq": str(LM_SEQ), "seed": str(seed)}
    vocab = int(LM_CUSTOM["vocab"])
    row, toks, outs = stream_lm_filter(frames, seed, card, eager=False)
    eager_row, _, eager_outs = stream_lm_filter(frames, seed, card,
                                                eager=True)
    differ = [i for i, (a, b) in enumerate(zip(outs, eager_outs))
              if not torch.equal(a, b)]
    emit(eager_row)
    row["graph_vs_eager_frames_bit_equal"] = frames - len(differ)
    row["eager_prefill_tok_s"] = eager_row["prefill_tok_s"]
    if differ:
        emit(row)
        raise AssertionError(f"lm_filter: graph logits differ from eager "
                             f"on frames {differ}")
    launches = row["launches"]

    model = get_model("streamformer_lm", custom).module
    worst, compared, agree, rows_over = 0.0, 0, 0, 0
    with torch.inference_mode():
        for t, got in zip(toks, outs):
            got = torch.as_tensor(got).cuda()
            if got.shape != (LM_SEQ, vocab) \
                    or not torch.isfinite(got).all():
                raise AssertionError("LM logits not finite or not "
                                     f"({LM_SEQ}, {vocab})")
            plain = forward_logits(model.params, torch.from_numpy(t).cuda(),
                                   model.cfg, flash=False)
            diff = (got - plain).abs().amax(-1)
            worst = max(worst, diff.max().item())
            rows_over += int((diff > LOGITS_ATOL).sum())
            sure = top2_margin(plain) > MARGIN
            compared += int(sure.sum())
            agree += int((got.argmax(-1) == plain.argmax(-1))[sure].sum())
        f32_diff = lm_f32_diff(custom, toks[0])
    row.update({"logits_max_abs_diff_vs_plain": worst, "atol": LOGITS_ATOL,
                "rows_over_atol": rows_over, "rows": frames * LM_SEQ,
                "positions_compared": compared, "argmax_equal": agree,
                "f32_logits_max_abs_diff_vs_plain": f32_diff,
                "f32_atol": F32_LOGITS_ATOL})
    emit(row)
    if (rows_over > BF16_LM_SHARE * frames * LM_SEQ
            or compared - agree > BF16_LM_SHARE * compared
            or f32_diff > F32_LOGITS_ATOL):
        raise AssertionError(f"lm_filter differs from plain attention: "
                             f"{rows_over} rows beyond {LOGITS_ATOL}, "
                             f"argmax on {compared - agree} positions, "
                             f"f32 logits by {f32_diff}")
    return {"launches": launches}


def _serve(params, cfg, prompts, steps: int, mode: str, timed: bool,
           force=None, eager: bool = False):
    """One engine over 8 sessions: warmup() (capturing the whole graph
    set, unless ``eager``), then, with the launch and graph counts set to
    0, prefill, one bucket step, ``steps`` timed bucket steps and (when
    ``timed``) a single-lane step and ``steps`` timed single-lane steps.
    Returns each session's greedy choices, each choice's top-2 margin,
    each prefill's last logits, every dispatch's logits, the window's
    counts and the timings.  With ``force`` (another run's choices) each
    session is fed those tokens instead of its own, so both runs choose
    on the same history at every position."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.analysis import compileledger
    from nnstreamer_tpu_torch.llm import DecodeEngine, KVCachePool

    pool = KVCachePool(cfg, len(prompts))
    eng = DecodeEngine(params, cfg, pool, capacity=len(prompts),
                       prefill_mode=mode)
    eng._eager = eager
    compileledger.reset()
    t0 = time.perf_counter()
    eng.warmup()
    out = {"warmup_s": time.perf_counter() - t0,
           "warm_set": {"step": sorted(eng._step_fns),
                        "prefill": sorted(eng._prefill_fns)},
           "compile_ledger": compileledger.snapshot()}
    _cuda.reset_launches()
    compileledger.reset()
    sessions = [pool.acquire(i) for i in range(len(prompts))]
    streams, margins, firsts, logits = [], [], [], []

    def margin_rows():
        logits.append(eng.last_logits.copy())
        top = np.sort(eng.last_logits, axis=-1)
        return top[:, -1] - top[:, -2]

    def feed(s, tok):
        s.next_token = (force[s.key][len(streams[s.key]) - 1]
                        if force is not None else tok)

    t0 = time.perf_counter()
    for s, pr in zip(sessions, prompts):
        tok = eng.prefill(s, pr)
        streams.append([tok])
        feed(s, tok)
        margins.append([float(margin_rows()[0])])
        firsts.append(torch.from_numpy(eng.last_logits[0].copy()))
    out["prefill_s"] = time.perf_counter() - t0

    def bucket_step():
        for s, tok, m in zip(sessions, eng.step(sessions), margin_rows()):
            streams[s.key].append(tok)
            margins[s.key].append(float(m))
            feed(s, tok)

    bucket_step()
    t0 = time.perf_counter()
    for _ in range(steps):
        bucket_step()
    out["bucket_s"] = time.perf_counter() - t0
    if timed:
        solo = sessions[:1]

        def solo_step():
            solo[0].next_token = eng.step(solo)[0]
            logits.append(eng.last_logits.copy())

        solo_step()
        t0 = time.perf_counter()
        for _ in range(steps):
            solo_step()
        out["solo_s"] = time.perf_counter() - t0
    out.update(streams=streams, margins=margins, firsts=firsts,
               logits=logits, launches=dict(_cuda.launches),
               graphs=dict(_cuda.graphs),
               window_ledger=compileledger.snapshot(), report=eng.report())
    return out


def _agreement(run: dict, ref: dict):
    """Greedy choices of two runs made on the same histories (one forced
    by the other): at the positions where ``ref``'s top-2 margin exceeds
    MARGIN, how many, how many equal, and the sessions where one
    differs."""
    compared, equal, differ = 0, 0, []
    for i, (a, b, m) in enumerate(zip(run["streams"], ref["streams"],
                                      ref["margins"])):
        sure = [j for j, mj in enumerate(m) if mj > MARGIN]
        same = sum(a[j] == b[j] for j in sure)
        compared += len(sure)
        equal += same
        if same < len(sure):
            differ.append(i)
    return compared, equal, differ


def _first_logits_diff(kern: dict, plain: dict) -> float:
    return max((a - b).abs().max().item()
               for a, b in zip(kern["firsts"], plain["firsts"]))


def run_llm_serve(steps: int, seed: int, card: str) -> dict:
    """The dense-slot decode engine at the LM filter's width, max_seq
    2048: 8 sessions of different prompt lengths prefilled through the
    flash kernel, then batched and single-lane decode steps, in bf16.
    Its greedy choices are held to an engine that prefills with plain
    attention and is fed the same tokens, wherever that engine's top-2
    margin exceeds MARGIN: exactly in f32; in bf16, where a near-tied
    expert choice can flip (BF16_LM_SHARE), the agreement is reported."""
    import dataclasses

    import numpy as np
    import torch

    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.models.streamformer_lm import (
        config_from_custom, place_params)
    from nnstreamer_tpu_torch.parallel.train_step import init_params

    cfg = config_from_custom({**LM_CUSTOM, "max_seq": str(LM_SEQ)},
                             device="cuda")
    params = place_params(init_params(cfg, seed), cfg, "cuda")
    rng = np.random.default_rng(seed + 1)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in SERVE_PROMPTS]

    kern = _serve(params, cfg, prompts, steps, "auto", timed=True)
    eager = _serve(params, cfg, prompts, steps, "auto", timed=True,
                   eager=True)
    launches = kern["launches"]
    plain = _serve(params, cfg, prompts, steps, "naive", timed=False,
                   force=kern["streams"])
    bf16_compared, bf16_equal, bf16_differ = _agreement(kern, plain)

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    params32 = place_params(init_params(cfg32, seed), cfg32, "cuda")
    plain32 = _serve(params32, cfg32, prompts, F32_STEPS, "naive",
                     timed=False)
    kern32 = _serve(params32, cfg32, prompts, F32_STEPS, "auto",
                    timed=False, force=plain32["streams"])
    compared, equal, differ = _agreement(kern32, plain32)
    first32 = _first_logits_diff(kern32, plain32)
    n = len(prompts)
    # a dispatch a prefill, 1 + steps bucket steps and 1 + steps solo
    dispatches = n + 2 * (1 + steps)
    logits_differ = sum(not np.array_equal(a, b)
                        for a, b in zip(kern["logits"], eager["logits"]))
    row = {"phase": "llm_serve", "sessions": n, "steps": steps,
           "max_seq": cfg.max_seq, "prompt_lens": list(SERVE_PROMPTS),
           "launches": launches, "graphs": kern["graphs"],
           "warm_set": kern["warm_set"], "warmup_s": kern["warmup_s"],
           "compile_ledger": kern["compile_ledger"],
           "window_ledger": kern["window_ledger"],
           "prefill_tok_s": sum(SERVE_PROMPTS) / kern["prefill_s"],
           "decode_tok_s_bucket8": steps * n / kern["bucket_s"],
           "decode_tok_s_solo": steps / kern["solo_s"],
           "eager": {"launches": eager["launches"],
                     "prefill_tok_s": sum(SERVE_PROMPTS)
                     / eager["prefill_s"],
                     "decode_tok_s_bucket8": steps * n / eager["bucket_s"],
                     "decode_tok_s_solo": steps / eager["solo_s"]},
           "graph_vs_eager_tokens_equal": kern["streams"] == eager["streams"],
           "graph_vs_eager_dispatches_bit_equal":
               len(kern["logits"]) - logits_differ,
           "dispatches": dispatches,
           "margin": MARGIN,
           "bf16_prefill_logits_max_abs_diff_vs_plain":
               _first_logits_diff(kern, plain),
           "bf16_tokens_compared": bf16_compared,
           "bf16_tokens_equal": bf16_equal,
           "bf16_streams_differ": bf16_differ,
           "f32_steps": F32_STEPS,
           "f32_prefill_logits_max_abs_diff_vs_plain": first32,
           "f32_atol": F32_LOGITS_ATOL, "f32_tokens_compared": compared,
           "f32_tokens_equal": equal, "f32_streams_differ": differ,
           "engine": kern["report"], "card": card}
    emit(row)
    want = n * cfg.layers
    for run in (kern, eager):
        if run["launches"].get("flash_attention", 0) != want:
            raise AssertionError(
                f"llm_serve: flash_attention launched "
                f"{run['launches'].get('flash_attention', 0)} times, "
                f"expected {want} ({n} prefills x {cfg.layers} layers)")
    if (kern["graphs"] != {"replays": dispatches} or eager["graphs"]
            or kern["window_ledger"] or eager["window_ledger"]):
        raise AssertionError(f"llm_serve: the serving window captured or "
                             f"compiled: graphs {kern['graphs']} (want "
                             f"{dispatches} replays), ledger "
                             f"{kern['window_ledger']}")
    if (len(kern["warm_set"]["step"]) > 16
            or len(kern["warm_set"]["prefill"]) > 32):
        raise AssertionError(f"llm_serve: warm set {kern['warm_set']} "
                             f"beyond the budgets 16 and 32")
    if kern["streams"] != eager["streams"] or logits_differ:
        raise AssertionError(f"llm_serve: graph run differs from eager: "
                             f"tokens equal {row['graph_vs_eager_tokens_equal']}"
                             f", {logits_differ} dispatches' logits differ")
    if differ or first32 > F32_LOGITS_ATOL:
        raise AssertionError(f"llm_serve: f32 streams {differ} differ from "
                             f"the plain-prefill engine; prefill logits by "
                             f"{first32}")
    return {"launches": launches}


# ---------------------------------------------------------------------------
# the training paths
# ---------------------------------------------------------------------------

#: vit-train: ViT-S/16 in its training form (f32 parameters, bf16
#: compute), Adam lr 1e-3 (the element's default), batches of 32 frames
VIT_TRAIN_BATCH = 32
VIT_TRAIN_LAUNCH = (
    "appsrc name=src caps=other/tensors,format=static,num_tensors=2,"
    f"dimensions=3:{VIT_SIZE}:{VIT_SIZE}:{VIT_TRAIN_BATCH}.{VIT_TRAIN_BATCH},"
    "types=uint8.int32,framerate=0/1 ! "
    "tensor_trainer name=tr framework=mesh-vision "
    "custom=model:vit,seed:{seed},dp:1 ! tensor_sink name=out")
#: lm-train: the LM filter's StreamFormer, bf16 compute, (4, 2048) tokens
#: with labels = tokens rolled by -1
LM_TRAIN_BATCH = 4
LM_TRAIN_LAUNCH = (
    "appsrc name=src caps=other/tensors,format=static,num_tensors=2,"
    "dimensions={seq}:{b}.{seq}:{b},types=int32.int32,framerate=0/1 ! "
    "tensor_trainer name=tr framework=mesh "
    "custom=dp:1,sp:1,tp:1,ep:1,{custom} ! tensor_sink name=out")
#: the MLP trainer (framework=jax) at the size of the JAX package's
#: examples/train_from_datarepo.py: 8 float features, 4 one-hot classes
#: (linearly separable), batches of 8, lr 0.01, the trainer's default
#: hidden width (128); 64 samples, 2 epochs: 16 steps
MLP_FEATURES, MLP_CLASSES, MLP_BATCH, MLP_EPOCHS = 8, 4, 8, 2
MLP_TRAIN_LAUNCH = (
    "appsrc name=src caps=other/tensors,format=static,num_tensors=2,"
    f"dimensions={MLP_FEATURES}.{MLP_CLASSES},types=float32.float32,"
    "framerate=0/1 ! tensor_trainer name=tr framework=jax num-inputs=1 "
    f"num-labels=1 batch-size={MLP_BATCH} num-epochs={MLP_EPOCHS} "
    "lr=0.01 ! tensor_sink name=out")
#: flash launches per training step: ViT's 12 layers, the LM's 4, the
#: MLP's none
TRAIN_PER_STEP = {"vit_train": 12, "lm_train": 4, "mlp_train": 0}
TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")
#: one step with the kernels against the same step with plain attention:
#: f32 (TF32 off) differs in summation order only — loss within 1e-5 rel,
#: each gradient within 1e-4 relative L2; bf16 rounds attention's output
#: and gradients in other places (and flips near-tied MoE routes in the
#: LM), so it is held to a loss within 2e-2 and each gradient within 0.1
#: relative L2
TRAIN_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (2e-2, 0.1)}


def vit_train_samples(steps: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (VIT_TRAIN_BATCH, VIT_SIZE, VIT_SIZE, 3),
                          dtype=np.uint8),
             rng.integers(0, VIT_CLASSES, VIT_TRAIN_BATCH).astype(np.int32))
            for _ in range(steps)]


def lm_train_samples(steps: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, int(LM_CUSTOM["vocab"]),
                            (LM_TRAIN_BATCH, LM_SEQ)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1).astype(np.int32)))
    return out


def mlp_train_samples(n: int, seed: int):
    """(features, one-hot class) frames, the class the argmax of a fixed
    random linear map of the features, as the JAX package's example
    makes its dataset."""
    import numpy as np

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((MLP_FEATURES, MLP_CLASSES)).astype(np.float32)
    x = rng.standard_normal((n, MLP_FEATURES)).astype(np.float32)
    y = np.eye(MLP_CLASSES, dtype=np.float32)[(x @ w).argmax(axis=1)]
    return list(zip(x, y))


def lm_train_launch(seed: int) -> str:
    custom = {**LM_CUSTOM, "max_seq": str(LM_SEQ), "seed": str(seed)}
    return LM_TRAIN_LAUNCH.format(
        seq=LM_SEQ, b=LM_TRAIN_BATCH,
        custom=",".join(f"{k}:{v}" for k, v in custom.items()))


@contextlib.contextmanager
def eager_steps(on: bool):
    """While ``on``, every training step runs eagerly on the card, without
    graphs: the reference run (a private attribute of GraphedStep, not a
    launch property)."""
    from nnstreamer_tpu_torch._cuda import GraphedStep

    was = GraphedStep._eager
    GraphedStep._eager = on
    try:
        yield
    finally:
        GraphedStep._eager = was


def drive_trainer(launch: str, samples, defaults: bool = True):
    """Push ``samples`` through an ``appsrc ! tensor_trainer ! tensor_sink``
    pipeline; the trainer trains at EOS.  Returns the trainer framework.

    The serving checks pin cuDNN to deterministic algorithms; a trainer's
    user gets PyTorch's defaults, so with ``defaults`` the training runs
    with those (the timed runs), else with the settings in force."""
    import torch

    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    pinned = torch.backends.cudnn.deterministic
    if defaults:
        torch.backends.cudnn.deterministic = False
    p = parse_launch(launch)
    p.play()
    try:
        for i, tensors in enumerate(samples):
            p.get("src").push_buffer(TensorBuffer(tensors=list(tensors),
                                                  pts=i))
        p.get("src").end_of_stream()
        p.wait(timeout=900)
    finally:
        p.stop()
        torch.backends.cudnn.deterministic = pinned
    return p.get("tr").trainer


def train_steps(phase: str, samples) -> int:
    """The steps a path must take for the samples pushed: one a sample
    for vit-train and lm-train (each sample a batch), full batches x
    epochs for the MLP trainer."""
    if phase == "mlp_train":
        return len(samples) // MLP_BATCH * MLP_EPOCHS
    return len(samples)


def run_train(phase: str, launch: str, samples, unit: str, per_step: int,
              card: str, eager: bool = False) -> dict:
    """Drive a training path in one mode: ``train_steps`` steps, each
    launching K2, K3 and K4 ``per_step`` times; step times from the
    trainer (host clock, batch copy to the loss read that ends the step).
    In graph mode step 1 is the capture's eager warm-up and every later
    step a replay of the one graph: a launch counts as captured launches
    x replays."""
    import math

    from nnstreamer_tpu_torch import _cuda

    _cuda.reset_launches()
    t0 = time.perf_counter()
    with eager_steps(eager):
        trainer = drive_trainer(launch, samples)
    wall = time.perf_counter() - t0
    launches, graphs = dict(_cuda.launches), dict(_cuda.graphs)
    steps = len(trainer.losses)
    step_ms = [t * 1e3 for t in trainer.step_s]
    p50 = statistics.median(step_ms)
    batch = trainer._batches()[0][0]
    units = batch.shape[0] * (batch.shape[1] if unit == "tokens" else 1)
    captured = {k: dict(g.launched)
                for k, g in trainer.graphed.graphs.items()}
    row = {"phase": phase, "mode": "eager" if eager else "graph",
           "steps": steps, "launches": launches, "graphs": graphs,
           "captured_launches": list(captured.values()),
           "launches_per_step": {k: launches.get(k, 0) / max(steps, 1)
                                 for k in TRAIN_KERNELS},
           "step_ms": step_ms, "step_ms_p50": p50,
           f"{unit}_per_s": units / (p50 / 1e3), "losses": trainer.losses,
           "wall_s_incl_build": wall, "card": card}
    emit(row)
    want_steps = train_steps(phase, samples)
    if steps != want_steps or not all(map(math.isfinite, trainer.losses)):
        raise AssertionError(f"{phase}: {steps} steps of {want_steps}, "
                             f"losses {trainer.losses}")
    for k in TRAIN_KERNELS:
        if launches.get(k, 0) != per_step * steps:
            raise AssertionError(f"{phase}: {k} launched "
                                 f"{launches.get(k, 0)} times, expected "
                                 f"{per_step} a step")
    if graphs != graph_counts(eager, 1, steps - 1):
        raise AssertionError(f"{phase}: graphs {graphs}, expected one "
                             f"capture (step 1) and a replay a later step")
    if not eager and list(captured.values()) != [
            {k: per_step for k in TRAIN_KERNELS if per_step}]:
        raise AssertionError(f"{phase}: the capture recorded {captured}, "
                             f"expected {per_step} launches of each kernel")
    return {"launches": launches, "step_ms_p50": p50,
            "losses": trainer.losses}


def check_mlp_learns(losses, epochs: int) -> None:
    """The MLP trainer's loss falls on its separable task: the last
    epoch's mean loss below the first's (the JAX package's trainer tests
    ask the same of a falling loss)."""
    per_epoch = len(losses) // epochs
    first = statistics.mean(losses[:per_epoch])
    last = statistics.mean(losses[-per_epoch:])
    emit({"phase": "mlp_outputs", "loss_first_epoch": first,
          "loss_last_epoch": last, "epochs": epochs})
    if not last < first:
        raise AssertionError(f"mlp_train: loss did not fall ({first} -> "
                             f"{last})")


#: copies of each training batch a way and a turn in ``time_batch_copies``
BATCH_COPY_REPS = 30


def time_batch_copies(seed: int, card: str) -> dict:
    """What copying one training batch into its static buffers costs a
    step, two ways, in turns (pinned, pageable, pageable, pinned), on the
    host's clock from the copy's start to the data on the card (a step's
    replay waits for it either way): ``pinned`` copies the batch into
    pinned host staging and then to the card without blocking;
    ``pageable`` is one blocking copy from the batch's own memory.
    Medians of BATCH_COPY_REPS copies a turn, microseconds."""
    import torch

    batches = {"vit_train": vit_train_samples(1, seed)[0],
               "lm_train": lm_train_samples(1, seed)[0]}
    rows = {}
    for path, batch in batches.items():
        host = [torch.from_numpy(x) for x in batch]
        statics = [torch.empty_like(x, device="cuda") for x in host]
        staging = [torch.empty_like(x).pin_memory() for x in host]

        def pinned():
            for x, stage, static in zip(host, staging, statics):
                stage.copy_(x)
                static.copy_(stage, non_blocking=True)

        def pageable():
            for x, static in zip(host, statics):
                static.copy_(x)

        ways = {"pinned": pinned, "pageable": pageable}
        us = {w: [] for w in ways}
        for way in ("pinned", "pageable", "pageable", "pinned"):
            times = []
            for _ in range(BATCH_COPY_REPS + 2):
                t0 = time.perf_counter()
                ways[way]()
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e6)
            us[way].append(statistics.median(times[2:]))
            if not all(torch.equal(s.cpu(), x)
                       for s, x in zip(statics, host)):
                raise AssertionError(f"batch copy ({path}, {way}) differs")
        rows[path] = us
        emit({"phase": "batch_copy", "path": path,
              "bytes": sum(x.numel() * x.element_size() for x in host),
              "us_p50": us, "card": card})
    return rows


def compare_train_modes(phase: str, graph: dict, eager: dict) -> None:
    """The step-time ratio graph / eager of one path, from one call."""
    emit({"phase": "train_modes", "path": phase,
          "step_ms_p50": {"graph": graph["step_ms_p50"],
                          "eager": eager["step_ms_p50"]},
          "graph_over_eager": graph["step_ms_p50"] / eager["step_ms_p50"]})


@contextlib.contextmanager
def deterministic_algorithms():
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode,
    warning (not raising) where an operation has none; yields the
    warnings recorded meanwhile."""
    import warnings

    import torch

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            yield caught
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         on, warn_only, cublas) = saved
        torch.use_deterministic_algorithms(on, warn_only=warn_only)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas


def _train_gap(a, b) -> dict:
    """Largest |a - b| over the two runs' losses and over their state
    tensors, and the tensors that differ."""
    losses = max(abs(x - y) for x, y in zip(a[0], b[0]))
    differ = sorted(n for n in b[1] if not a[1][n].equal(b[1][n]))
    tensors = max(((a[1][n].double() - b[1][n].double()).abs().max().item()
                   for n in differ), default=0.0)
    return {"loss": losses, "state": tensors, "tensors_differ": differ}


def check_train_graph_vs_eager(phase: str, launch: str, samples) -> None:
    """A training path in graph mode, then eagerly twice, from the same
    seed under deterministic algorithms: each step's loss, and every
    parameter and Adam moment after the last step, must equal the eager
    run's bit for bit.  Where an operation warns that it has no
    deterministic implementation and the two eager runs differ, the graph
    run is held to the gap between them, and the operations are named."""
    import torch

    runs = {}
    with deterministic_algorithms() as caught:
        for mode in ("graph", "eager", "eager_again"):
            with eager_steps(mode != "graph"):
                trainer = drive_trainer(launch, samples, defaults=False)
            runs[mode] = (list(trainer.losses),
                          {n: x.detach().clone()
                           for n, x in trainer.state_tensors().items()})
            del trainer
            torch.cuda.empty_cache()
    want = train_steps(phase, samples)
    counts = {mode: len(run[0]) for mode, run in runs.items()}
    if set(counts.values()) != {want}:
        raise AssertionError(f"{phase}: steps {counts}, expected {want}")
    warned = sorted({str(w.message).splitlines()[0][:200] for w in caught})
    graph_gap = _train_gap(runs["graph"], runs["eager"])
    eager_gap = _train_gap(runs["eager_again"], runs["eager"])
    bit_equal = (graph_gap["loss"] == 0 and not graph_gap["tensors_differ"]
                 and len(runs["graph"][0]) == len(runs["eager"][0]))
    emit({"phase": "train_graph_vs_eager", "path": phase,
          "steps": len(runs["graph"][0]),
          "state_tensors": len(runs["graph"][1]), "bit_equal": bit_equal,
          "graph_vs_eager": graph_gap, "eager_vs_eager": eager_gap,
          "nondeterministic_warnings": warned})
    if bit_equal:
        return
    if not (warned and eager_gap["tensors_differ"]
            and graph_gap["loss"] <= eager_gap["loss"]
            and graph_gap["state"] <= eager_gap["state"]):
        raise AssertionError(f"{phase}: graph steps differ from eager "
                             f"steps: {graph_gap} (eager vs eager: "
                             f"{eager_gap}; warnings {warned})")


def _grad_gap(got: dict, want: dict):
    """Largest relative L2 distance over the gradient tensors, and its
    tensor's name."""
    worst, where = 0.0, None
    for name, w in want.items():
        gap = ((got[name].float() - w.float()).norm()
               / w.float().norm().clamp_min(1e-30)).item()
        if gap > worst:
            worst, where = gap, name
    return worst, where


def _vit_loss_grads(module, frames, labels):
    import torch

    from nnstreamer_tpu_torch.parallel.vision_train import _nll

    params = dict(module.named_parameters())
    loss = _nll(module(frames)[0], labels)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def check_train_outputs(seed: int) -> None:
    """One training step's loss and gradients with the kernels against
    the same step with plain attention, from the same parameters, for
    both paths in f32 (TF32 off) and bf16 (TRAIN_TOL)."""
    import dataclasses

    import torch

    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.models.streamformer_lm import \
        config_from_custom
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.train_step import (make_train_step,
                                                          value_and_grad)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows, failures = [], []
    frames, labels = vit_train_samples(1, seed + 1)[0]
    frames = torch.from_numpy(frames[:8]).cuda()
    labels = torch.from_numpy(labels[:8]).cuda()
    toks, labs = (torch.from_numpy(x).cuda()
                  for x in lm_train_samples(1, seed + 1)[0])
    mesh = make_mesh(devices=["cuda:0"])
    for dt in ("float32", "bfloat16"):
        custom = {"seed": str(seed), "dtype": dt}
        kern = get_model("vit", {**custom, "attn": "flash"},
                         trainable=True).module
        plain = get_model("vit", {**custom, "attn": "naive"},
                          trainable=True).module
        loss_k, g_k = _vit_loss_grads(kern, frames, labels)
        loss_p, g_p = _vit_loss_grads(plain, frames, labels)
        vit_gap = _grad_gap(g_k, g_p)
        cfg = dataclasses.replace(
            config_from_custom({**LM_CUSTOM, "max_seq": str(LM_SEQ)}),
            dtype=getattr(torch, dt))
        _, params, _, _ = make_train_step(mesh, cfg, seed=seed)
        lm_k, lg_k = value_and_grad(params, toks, labs, cfg, flash=True)
        lm_p, lg_p = value_and_grad(params, toks, labs, cfg, flash=False)
        lm_gap = _grad_gap(lg_k, lg_p)
        loss_tol, grad_tol = TRAIN_TOL[dt]
        for path, (lk, lp), (gap, where) in (
                ("vit_train", (loss_k, loss_p), vit_gap),
                ("lm_train", (lm_k, lm_p), lm_gap)):
            lk, lp = float(lk), float(lp)
            loss_ok = (abs(lk - lp) <= loss_tol * abs(lp) if dt == "float32"
                       else abs(lk - lp) <= loss_tol)
            ok = loss_ok and gap <= grad_tol
            rows.append({"path": path, "dtype": dt, "loss_kernel": lk,
                         "loss_plain": lp, "loss_abs_diff": abs(lk - lp),
                         "grad_max_rel_l2": gap, "worst_tensor": where,
                         "loss_tol": loss_tol, "grad_tol": grad_tol,
                         "ok": ok})
            if not ok:
                failures.append(f"{path}/{dt}")
        del kern, plain, params, g_k, g_p, lg_k, lg_p
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    emit({"phase": "train_outputs", "vit_batch": int(frames.shape[0]),
          "lm_tokens": list(toks.shape), "rows": rows})
    if failures:
        raise AssertionError(f"training step with the kernels differs from "
                             f"plain attention at {failures}")


#: host calls that put work on the card: kernel launches (eager), graph
#: launches (a replay) and asynchronous copies
KERNEL_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel",
                      "cuLaunchKernelEx", "cudaLaunchKernelExC")
HOST_LAUNCH_KEYS = KERNEL_LAUNCH_KEYS + ("cudaGraphLaunch",
                                         "cudaMemcpyAsync")
#: the serving paths --profile traces in both modes, in turns
MODE_TURNS = (False, True, True, False)       # eager?


def trace(name: str, out_dir: str, run, units, marker=None,
          per_unit: int = 1) -> dict:
    """Trace ``run()`` on the card: device time by kernel (the op table
    goes to ``out_dir/<name>_ops.txt``), and per unit of work (``units(t0,
    t1)``: the units the window, in ``time.perf_counter`` seconds, held)
    the device busy time, the device kernels and the host calls that
    launch work (kernels, graphs, copies); the device's idle share over
    the window.  ``marker``: a part of a kernel's name; its device events
    divided by ``per_unit`` count the units a second way (which shows
    whether graph-launched kernels reach the trace), and its device time
    a call is reported.  Returns the row."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
    wall_us = (t1 - t0) * 1e6
    events = prof.key_averages()
    # torch renamed the device-time fields from *_cuda_* to *_device_*
    field = ("self_device_time_total"
             if hasattr(events[0], "self_device_time_total")
             else "self_cuda_time_total")
    with open(os.path.join(out_dir, f"{name}_ops.txt"), "w") as f:
        f.write(events.table(sort_by=field, row_limit=60))
    # device time from the device's own events (kernels, copies): an
    # operator recorded on this thread also carries its kernels' time, and
    # a user annotation's range on the device (the optimizer's step)
    # spans kernels counted already
    on_card = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(getattr(e, field) for e in on_card)
    kernels = sum(e.count for e in on_card
                  if not e.key.startswith(("Memcpy", "Memset")))
    n = max(units(t0, t1), 1)
    host = {k: sum(e.count for e in events if e.key == k)
            for k in HOST_LAUNCH_KEYS}
    top = sorted(on_card, key=lambda e: -getattr(e, field))[:6]
    row = {"phase": "profile", "path": name, "units_in_window": n,
           "wall_us": wall_us, "device_busy_us": busy_us,
           "device_busy_us_per_unit": busy_us / n,
           "device_kernels_per_unit": kernels / n,
           "launches_per_unit": sum(host[k] for k in KERNEL_LAUNCH_KEYS) / n,
           "host_launch_calls_per_unit": sum(host.values()) / n,
           "host_calls_per_unit": {k: v / n for k, v in host.items() if v},
           "device_idle_share": 1.0 - busy_us / wall_us,
           "top_device_share": {e.key[:60]: getattr(e, field) / busy_us
                                for e in top},
           "out": out_dir}
    if marker:
        marked = [e for e in on_card if marker in e.key]
        calls = sum(e.count for e in marked)
        row["marker_units"] = round(calls / per_unit)
        row["marker_device_us_per_call"] = (
            sum(getattr(e, field) for e in marked) / max(calls, 1))
    return row


def _latency(stamps, t0, t1) -> dict:
    """fps and p50/p90 of the gaps between sink arrivals inside [t0, t1]."""
    inside = [t for t in stamps if t0 <= t <= t1]
    gaps = sorted((b - a) * 1e3 for a, b in zip(inside, inside[1:]))
    if not gaps:
        return {}
    return {"fps": len(gaps) / (inside[-1] - inside[0]),
            "p50_ms": statistics.median(gaps),
            "p90_ms": gaps[int(0.9 * (len(gaps) - 1))]}


def profile_path(name: str, launch: str, frames: int, seed: int,
                 out_dir: str, marker: str, per_frame: float, eager: bool,
                 turn: int, batch: int = 1) -> dict:
    """Trace a steady window of a labeling path in one mode: the trace
    starts after the first frame reached the sink (the filter has opened
    and captured its graphs by then); a unit is a frame that reached the
    sink inside the window (``per_frame`` marker events each: a fraction
    for a batched path), and a batched path's row also gives busy time
    and host launch calls a ``batch``-frame bucket."""
    from nnstreamer_tpu_torch import parse_launch

    stamps = []
    p = parse_launch(launch.format(frames=frames, seed=seed))
    p.get("out").connect("new-data",
                         lambda buf: stamps.append(time.perf_counter()))
    mode = "eager" if eager else "graph"
    with eager_filters(eager):
        p.play()
        try:
            while not stamps:
                time.sleep(0.001)
            window = {}

            def units(t0, t1):
                window.update(_latency(stamps, t0, t1))
                return sum(t0 <= t <= t1 for t in stamps)

            row = trace(f"{name}_{mode}{turn}", out_dir,
                        lambda: p.wait(timeout=600), units, marker,
                        per_frame)
        finally:
            p.stop()
    row.update(window, path=name, mode=mode, turn=turn)
    if batch > 1:
        row.update(device_busy_us_per_bucket=row["device_busy_us_per_unit"]
                   * batch,
                   host_launch_calls_per_bucket=row[
                       "host_launch_calls_per_unit"] * batch)
    emit(row)
    return row


def profile_lm_filter(frames: int, seed: int, out_dir: str, eager: bool,
                      turn: int) -> dict:
    """Trace the LM filter in one mode: a unit is a 2048-token frame,
    pushed after the filter opened (and captured its graph)."""
    import numpy as np

    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    custom = {**LM_CUSTOM, "seq": str(LM_SEQ), "seed": str(seed)}
    rng = np.random.default_rng(seed)
    p = parse_launch(LM_LAUNCH.format(
        seq=LM_SEQ, custom=",".join(f"{k}:{v}" for k, v in custom.items())))
    mode = "eager" if eager else "graph"

    def push_all():
        for _ in range(frames):
            toks = rng.integers(0, int(LM_CUSTOM["vocab"]), LM_SEQ)
            p.get("src").push_buffer(
                TensorBuffer(tensors=[toks.astype(np.int32)]))
        p.get("src").end_of_stream()
        p.wait(timeout=600)

    with eager_filters(eager):
        p.play()
        try:
            row = trace(f"lm_filter_{mode}{turn}", out_dir, push_all,
                        lambda t0, t1: frames, K2_MARKER,
                        int(LM_CUSTOM["layers"]))
        finally:
            p.stop()
    row.update(path="lm_filter", mode=mode, turn=turn,
               prefill_tok_s=frames * LM_SEQ / (row["wall_us"] / 1e6))
    emit(row)
    return row


def profile_llm_serve(steps: int, seed: int, out_dir: str, eager: bool,
                      turn: int) -> dict:
    """Trace the decode engine's 8-lane bucket in one mode: the engine is
    warmed (its graph set captured), the 8 sessions prefilled and stepped
    once before the trace; a unit is a step."""
    import numpy as np

    from nnstreamer_tpu_torch.llm import DecodeEngine, KVCachePool
    from nnstreamer_tpu_torch.models.streamformer_lm import (
        config_from_custom, place_params)
    from nnstreamer_tpu_torch.parallel.train_step import init_params

    rng = np.random.default_rng(seed)
    cfg = config_from_custom({**LM_CUSTOM, "max_seq": str(LM_SEQ)},
                             device="cuda")
    params = place_params(init_params(cfg, seed), cfg, "cuda")
    pool = KVCachePool(cfg, len(SERVE_PROMPTS))
    eng = DecodeEngine(params, cfg, pool, capacity=len(SERVE_PROMPTS))
    eng._eager = eager
    eng.warmup()
    sessions = [pool.acquire(i) for i in range(len(SERVE_PROMPTS))]
    for s, n in zip(sessions, SERVE_PROMPTS):
        s.next_token = eng.prefill(s, rng.integers(0, cfg.vocab, n))
    step_ms = []

    def bucket_steps(count):
        for _ in range(count):
            t0 = time.perf_counter()
            for s, tok in zip(sessions, eng.step(sessions)):
                s.next_token = tok
            step_ms.append((time.perf_counter() - t0) * 1e3)

    bucket_steps(1)
    step_ms.clear()
    mode = "eager" if eager else "graph"
    row = trace(f"llm_serve_{mode}{turn}", out_dir,
                lambda: bucket_steps(steps), lambda t0, t1: steps)
    step_ms.sort()
    row.update(path="llm_serve", mode=mode, turn=turn,
               decode_tok_s_bucket8=steps * len(sessions)
               / (row["wall_us"] / 1e6),
               step_ms_p50=statistics.median(step_ms),
               step_ms_p90=step_ms[int(0.9 * (len(step_ms) - 1))])
    emit(row)
    return row


#: the metrics a profile_modes line puts side by side
MODE_KEYS = ("fps", "p50_ms", "p90_ms", "p99_ms", "mean_fill",
             "prefill_tok_s",
             "device_busy_us_per_bucket", "host_launch_calls_per_bucket",
             "decode_tok_s_bucket8", "step_ms_p50", "step_ms_p90",
             "device_busy_us_per_unit", "device_idle_share",
             "device_kernels_per_unit", "host_launch_calls_per_unit",
             "launches_per_unit", "units_in_window", "marker_units",
             "marker_device_us_per_call")


def profile_modes(paths: dict) -> None:
    """Each path in graph and eager mode, in turns (graph, eager, eager,
    graph), then one line a path with both modes side by side: each
    metric's values in turn order."""
    for name, run in paths.items():
        rows = [run(eager, turn) for turn, eager in enumerate(MODE_TURNS)]
        emit({"phase": "profile_modes", "path": name, **{
            mode: {k: [r[k] for r in rows if r["mode"] == mode]
                   for k in MODE_KEYS if k in rows[0]}
            for mode in ("graph", "eager")}})


def train_runs(args) -> dict:
    """name -> (launch, samples, unit of the rate) of each training
    path."""
    return {
        "vit_train": (VIT_TRAIN_LAUNCH.format(seed=args.seed),
                      vit_train_samples(args.vit_train_steps, args.seed),
                      "images"),
        "lm_train": (lm_train_launch(args.seed),
                     lm_train_samples(args.lm_train_steps, args.seed),
                     "tokens"),
        "mlp_train": (MLP_TRAIN_LAUNCH,
                      mlp_train_samples(args.mlp_train_samples, args.seed),
                      "samples"),
    }


def profiled_paths(args) -> dict:
    """name -> ``run(eager, turn)`` tracing that path in one mode: the
    seven serving paths, then the three training paths."""
    paths = {
        "main_path": functools.partial(
            profile_path, "main_path", LAUNCH, args.frames, args.seed,
            args.profile, "normalize_frame_kernel", 1),
        "vit_path": functools.partial(
            profile_path, "vit_path", VIT_LAUNCH, args.vit_frames,
            args.seed, args.profile, K2_MARKER, 12),
        "lm_filter": functools.partial(
            profile_lm_filter, args.lm_frames, args.seed, args.profile),
        "llm_serve": functools.partial(
            profile_llm_serve, args.steps, args.seed, args.profile),
    }
    for path, (*_, kernel, per_replay) in BATCHED_PATHS.items():
        paths[path] = functools.partial(
            profile_path, path, batched_launch(path, args.batched_frames),
            args.batched_frames, SOURCE_SEED, args.profile,
            "normalize_frame_kernel" if kernel == "normalize_frame"
            else K2_MARKER, per_replay / BATCH, batch=BATCH)
    for name, (launch, samples, _) in train_runs(args).items():
        paths[name] = functools.partial(
            profile_train, name, launch, samples, args.profile,
            TRAIN_PER_STEP[name])
    paths["query_serve"] = functools.partial(
        profile_query_serve, args.seed, args.profile)
    return paths


def profile_query_serve(seed: int, out_dir: str, eager: bool,
                        turn: int) -> dict:
    """Trace the served query pair in one mode: the server is started and
    warmed (one frame a client: the pad set captured at the first
    bucket), then the clients' frames are traced; a unit is a frame, and
    the row gives busy time and host launch calls a bucket too."""
    frames = query_frames(seed)
    mode = "eager" if eager else "graph"
    run = {}
    with eager_filters(eager):
        with query_server(9102, QUERY_BATCH, frames) as (p, port):
            before = buckets_served(p)
            row = trace(f"query_serve_{mode}{turn}", out_dir,
                        lambda: run.update(drive_query_clients(port,
                                                               frames)),
                        lambda t0, t1: QUERY_CLIENTS * QUERY_FRAMES,
                        "normalize_frame_kernel", 1)
            buckets = buckets_served(p) - before
    n = QUERY_CLIENTS * QUERY_FRAMES
    row.update(path="query_serve", mode=mode, turn=turn,
               fps=run["replies_per_s"], p50_ms=run["rtt_p50_ms"],
               p99_ms=run["rtt_p99_ms"], buckets=buckets,
               mean_fill=n / max(buckets, 1),
               device_busy_us_per_bucket=row["device_busy_us"]
               / max(buckets, 1),
               host_launch_calls_per_bucket=row[
                   "host_launch_calls_per_unit"] * n / max(buckets, 1))
    emit(row)
    return row


#: tries of a path's traces.  A profiler session now and then crashed the
#: process in a native thread (a segfault, or glibc's "double free"),
#: more often the more sessions and CUDA graphs the process had held, so
#: each path is traced in a process of its own
PROFILE_TRIES = 2


def profile_all(args, argv) -> None:
    """Trace every path in a child process of its own (this script with
    ``--profile-path``), in both modes in turns; its profile lines are
    printed here.  A child that crashes is run once more."""
    for name in profiled_paths(args):
        for _ in range(PROFILE_TRIES):
            out = subprocess.run(
                [sys.executable, os.path.abspath(__file__), *argv,
                 "--profile-path", name], capture_output=True, text=True,
                timeout=1800)
            if out.returncode == 0:
                break
            emit({"phase": "profile_crash", "path": name,
                  "rc": out.returncode, "stderr": out.stderr[-800:]})
        else:
            raise AssertionError(f"the profile of {name} failed "
                                 f"{PROFILE_TRIES} times")
        for line in out.stdout.splitlines():
            if line.startswith('{"phase": "profile'):
                print(line, flush=True)


def profile_train(name: str, launch: str, samples, out_dir: str,
                  per_step: int, eager: bool, turn: int) -> dict:
    """Trace a training path's steps in one mode: the path runs once
    through its pipeline (building the trainer; in graph mode capturing
    its step), then the trainer's steps run again over one epoch of its
    batches inside the trace, as its finish loop runs them (copy into the
    static buffers, replay or eager step, loss read).  A unit is a
    step."""
    import torch

    mode = "eager" if eager else "graph"
    pinned = torch.backends.cudnn.deterministic
    with eager_steps(eager):
        trainer = drive_trainer(launch, samples)
        batches = trainer._batches()
        done = len(trainer.step_s)

        def steps():
            for batch in batches:
                trainer._run_step(*batch)

        torch.backends.cudnn.deterministic = False      # as drive_trainer
        try:
            row = trace(f"{name}_{mode}{turn}", out_dir, steps,
                        lambda t0, t1: len(batches),
                        K2_MARKER if per_step else None, per_step)
        finally:
            torch.backends.cudnn.deterministic = pinned
    step_ms = sorted(t * 1e3 for t in trainer.step_s[done:])
    row.update(path=name, mode=mode, turn=turn,
               step_ms_p50=statistics.median(step_ms),
               step_ms_p90=step_ms[int(0.9 * (len(step_ms) - 1))])
    emit(row)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=64,
                    help="frames of the MobileNetV2 main path")
    ap.add_argument("--vit-frames", type=int, default=64)
    ap.add_argument("--batched-frames", type=int, default=16 * BATCH,
                    help="frames of each batched path (a multiple of "
                         f"{BATCH})")
    ap.add_argument("--lm-frames", type=int, default=4)
    ap.add_argument("--steps", type=int, default=64,
                    help="timed decode steps of the LLM engine")
    ap.add_argument("--vit-train-steps", type=int, default=8)
    ap.add_argument("--lm-train-steps", type=int, default=6)
    ap.add_argument("--mlp-train-samples", type=int, default=64,
                    help="samples of the MLP trainer (2 epochs of batches "
                         "of 8)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=200,
                    help="timed launches per kernel measurement")
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace every path into DIR")
    # one path's traces in this process (profile_all runs each path so)
    ap.add_argument("--profile-path", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.batched_frames % BATCH or args.batched_frames < 2 * CACHED:
        ap.error(f"--batched-frames must be a multiple of {BATCH} and at "
                 f"least {2 * CACHED}")
    # CUPTI torn down after a trace and set up again crashes a process that
    # has replayed CUDA graphs: keep it up between the traces, and set it
    # up eagerly (the workaround torch.profiler applies for its own graphs)
    os.environ["TEARDOWN_CUPTI"] = "0"
    os.environ["DISABLE_CUPTI_LAZY_REINIT"] = "1"

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
    from nnstreamer_tpu_torch.analysis import compileledger

    compileledger.configure(True)       # each path prints its ledger
    if args.profile_path:
        from torch.profiler import ProfilerActivity, profile

        # CUPTI set up for the first time after the process has captured
        # CUDA graphs crashed it or lost the graphs' events: set it up
        # before any graph exists
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        profile_modes({args.profile_path:
                       profiled_paths(args)[args.profile_path]})
        return 0

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    _cuda.build()
    build_s = time.perf_counter() - t0
    ptxas, spills = build_report()
    emit({"phase": "build", "torch": torch.__version__,
          "cuda": torch.version.cuda, "card": card, "build_s": build_s,
          "ptxas": ptxas})
    if spills:
        return fail("; ".join(spills))
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False

    try:
        if args.profile:
            # before this process makes a CUDA context: a profiled child
            # beside another process's context on the card crashed
            profile_all(args, sys.argv[1:] if argv is None else argv)
        k1, k1_event_ms = check_normalize_frame(args.reps)
        kernels = [k1]
        k1_floor(card, k1_event_ms)
        kernels += [check_flash_attention(args.reps),
                   *check_flash_backward(args.reps)]
        time_flash_versions(args.reps)
        main_path = run_labeling("main_path", LAUNCH, args.frames,
                                 args.seed, card, "normalize_frame", 1)
        labels_equal_eager("main_path", main_path, run_labeling(
            "main_path", LAUNCH, args.frames, args.seed, card,
            "normalize_frame", 1, eager=True))
        check_graph_logits("main_path", "mobilenet_v2",
                           {"seed": args.seed, "use_pallas": 1},
                           GRAPH_LOGITS_FRAMES, args.seed)
        check_outputs(main_path["labels"], args.frames, args.seed)
        vit = run_labeling("vit_path", VIT_LAUNCH, args.vit_frames,
                           args.seed, card, "flash_attention", 12)
        labels_equal_eager("vit_path", vit, run_labeling(
            "vit_path", VIT_LAUNCH, args.vit_frames, args.seed, card,
            "flash_attention", 12, eager=True))
        check_graph_logits("vit_path", "vit", {"seed": args.seed},
                           GRAPH_LOGITS_FRAMES, args.seed)
        check_vit_outputs(vit["labels"], args.vit_frames, args.seed)
        batched = run_batched_paths(args, card)
        query = run_query_serve(args, card)
        if args.profile:
            run_query_pace(args.seed, card)
        lm = run_lm_filter(args.lm_frames, args.seed, card)
        serve = run_llm_serve(args.steps, args.seed, card)
        trains = train_runs(args)
        train_rows = {}
        for name, (launch, samples, unit) in trains.items():
            graph, eager = (run_train(name, launch, samples, unit,
                                      TRAIN_PER_STEP[name], card, eager=e)
                            for e in (False, True))
            compare_train_modes(name, graph, eager)
            check_train_graph_vs_eager(name, launch, samples)
            train_rows[name] = graph
        check_mlp_learns(train_rows["mlp_train"]["losses"], MLP_EPOCHS)
        time_batch_copies(args.seed, card)
        check_train_outputs(args.seed)
        for k in kernels:
            # launches summed over every path's own run (graph mode)
            k["launches"] = sum(path["launches"].get(k["name"], 0)
                                for path in (main_path, vit, lm, serve,
                                             query, *batched.values(),
                                             *train_rows.values()))
            if k["launches"] == 0:
                raise AssertionError(f"{k['name']} never launched on the "
                                     "paths")
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
