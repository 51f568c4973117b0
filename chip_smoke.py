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
   - ``fuse_tiers``: the segment compiler's tiers (``Pipeline(fuse=…)``:
     ``interpret``, ``python`` — the default every other path runs
     under — and ``xla``, where a lowered segment runs as one CUDA graph)
     on ``main_path`` and ``vit_path``, in turns, and ``xla`` again at
     ``NNS_FUSE_DEPTH=1``: fps, p50/p90 gap, captures and replays, K1/K2
     launches and the ``plans()`` rows a run, with the host launch calls
     a frame and the idle share of each tier from traces taken first in a
     child process (TIER_TURNS); labels bit-equal across the tiers and
     depths, the filter's logits too (the strings cut before the
     decoder, 8 frames); under xla the segment lowered whole, one capture
     before the first frame reaches the sink and none after, K1 once and
     K2 12 times a replay of the segment's graph; MobileNetV2 in f32
     under xla on the card against the CPU within 1e-3; and
     ``query_serve`` once more under xla: the plan row says xla, the
     segment's 8 graphs (7 pad shapes, a lone frame's) at the first
     cross-stream bucket and none after, K1 once a replay, every reply
     bit for bit against its bucket through the filter's own graphs (the
     python tier's path), zero sheds and errors;
   - ``model_files``: the model-file backends (``tests/torch_model_files
     .py`` writes the files from the seed into ``_model_files/``): the
     flagship string with ``tensor_filter framework=tensorflow-lite`` on
     MobileNetV2 1.0 (224, 1001 classes) as a uint8 file under
     ``compute:int8``, ``w8`` and ``float32`` and as a float file under
     ``auto`` (bf16) and ``float32``, and ``framework=pytorch`` on its
     TorchScript trace, each per frame (graph, then eager: labels equal)
     and at ``batch=32``; through ``FilterSingle`` each mode's outputs
     graph against eager bit for bit (frames and a bucket), the card
     (TF32 off) against the CPU (f32 within MF_F32_ATOL, uint8 within one
     step, the differing elements counted), bf16 against f32 within
     0.05 + 0.05|x|, labels against the f32 run (and TorchScript's
     against the xla MobileNetV2 in f32) where the margin exceeds twice
     the frame's difference; LeNet-5 through tensorflow, caffe2 and mxnet
     (graph vs eager, card vs CPU, formats agree); python, lua,
     custom-easy and dummy once each.  No K1-K4 launch on it; a row a
     mode with fps, event-timed busy ms a frame and a bucket, idle share,
     and the int8 products' routes;
   - ``llm_stream``: the LLM serving tier, ``tensor_query_serversrc !
     tensor_llm ! tensor_query_serversink`` at the LM's full width
     (max_seq 2048, bf16) in this process, 16 gold ``TokenStreamClient``
     threads sending 4 requests each (prompts of SERVE_PROMPTS' lengths,
     32 new tokens): ``dense`` (``slots=8 batch=8``: prefill through K2,
     4 launches a prompt) and ``paged`` (``slots=32 page-size=16
     pages=1151 prefill-chunk=32 prefix-cache=1``, an arena of the dense
     pool's bytes; phase A the same mix, phase B one shared 128-token
     system prompt and unique tails); a row a part: served tok/s, TTFT
     and ITL p50/p99 (the element's ``TokenObs``; the clients' own TTFT
     beside), mean decode fill, peak resident sessions, arena bytes,
     prefix tokens reused and the serversink's time a token.  Every
     stream complete and in order, 0 sheds and errors, no capture after
     ``warmup()`` (its ledger: 4 step + 9 prefill graphs dense, 32 paged
     steps + 7 chunks paged), prefix hits in phase B only, no page leak;
     each served stream teacher-forced through the plain forward (bf16:
     at most BF16_LM_SHARE of the confident choices differ; the same
     strings in f32 at a small load: none); a scripted paged engine
     (whole and chunked prefill, a prefix hit) bit-equal graph vs eager;
     and the dense string served by ``python -m
     nnstreamer_tpu_torch.launch`` in a child process to one more client
     (the child drains and exits 0 on SIGTERM);
   - the among-device transports, after ``offload_reference`` (the
     main path's string at OFFLOAD_FRAMES frames: the labels and fps
     each offload is held to): ``edge_offload``, ``mqtt_offload`` and
     ``shm_offload`` run three pipelines, ``videotestsrc ! ... !
     tensor_converter`` into the transport, ``src ! tensor_filter
     model=mobilenet_v2 custom=seed:0,use_pallas:1 ! sink`` on the card
     and ``src ! tensor_decoder mode=image_labeling ! tensor_sink``
     (edge and MQTT in this process through one in-process broker; the
     shm producer a spawned child on the CPU): fps first to last
     arrival, p50/p90 arrival gap and the bytes a frame puts on a hop;
     every frame arrives once and in order (the source's pts on both
     hops), the logits the tail receives equal byte for byte those the
     filter handed its sink, the labels equal the reference's, one
     capture and a replay a frame (K1 once a replay), and every shm end
     ran the native ring with ``tw_shm_push2`` bound (its producer
     starts first, so its start-up overlaps the edge and MQTT paths);
     ``hybrid_query`` is query_serve's batched pair (32 clients x 16
     frames) with ``connect-type=HYBRID`` on the serversrc and every
     client through the port's MQTT broker: the clients find the bound
     port there, every reply bit for bit against its bucket,
     query_serve's graph checks, and the record is cleared at stop.
     gRPC is left out: the card host is not known to have ``grpcio``;
   - the observability and SLO tier: ``observe_flagship`` runs the main
     path's string (OBSERVE_FRAMES frames) through ``python -m
     nnstreamer_tpu_torch.launch`` in a child with ``--profile
     --metrics-port 0 --top``, beside the same string unprofiled in
     another child; mid-run scrapes of ``/metrics`` until ``nns_mfu``
     (the filter's FLOPs a frame from the cost counter, over the H100
     peak) reads in (0, 1] with the bytes/s and memory gauges present,
     while ``/healthz`` says serving; the three profile artifacts; every
     frame's attributed states summing to its end-to-end time; the blame
     table's states, both fps and the cost counter's FLOPs and bytes a
     frame printed.  ``slo_query_serve``: query_serve's pair under the
     open-loop load generator, Poisson arrivals at SLO_LOAD of the
     unloaded replies/s (same call), QUERY_CLIENTS connections, SLO_S
     seconds gated live by the demo spec (PASS, 0 errors and sheds),
     then SLO_STRICT_S seconds more, span-traced, under a spec whose p99
     bound is 1 µs (FAIL, a flight-recorder bundle); K1 once a bucket;
     the CLI's ``--soak --slo`` under that spec exits 3.  ``slo_llm_stream``: the token mode against
     ``tensor_llm`` (the dense string) with ttft/itl objectives: the
     verdict and TTFT/ITL p50/p99, every stream whole, K2 ``layers``
     times a prefill.  ``federation``: two CLI workers (echo query
     servers) push with ``--push-metrics`` into a collector here; the
     federated counters equal the workers' own.  ``check_cli``:
     ``--check`` exits 0 on the main path's string and 1 on it with a
     caps dead end, named by its element path;
   - the serving fleet and the analysis tier: ``fleet`` runs the port's
     ``TensorQueryRouter`` in this process over FLEET_WORKERS ``launch.py
     --soak`` workers of query_serve's batched server string on the card
     (each this script's ``--fleet-worker`` around ``launch.main``,
     spawned by ``WorkerPool``, ready once its warm bucket came back),
     through the three legs of ``fleet/soak.py``: a capacity probe with
     query_serve's 32 clients, a kill leg (one worker SIGKILLed, the
     pool restarts it), a scale-up leg (the autoscaler adds a fourth)
     and an idle leg (one drained: route-away, SIGTERM drain, reap);
     a line a leg (replies/s, round trip p50/p99) and one for the fleet
     (routed connections a worker, restarts, spawn/ready/drain times);
     zero client errors, K1 at least once a bucket in every worker that
     exited by SIGTERM, every reply within the bf16 bound of its frame's
     per-frame logits (labels where the margin allows).
     ``sanitized_main``: the main path in a child under ``NNS_DEBUG=1``,
     no findings, the unsanitized labels.  ``check_jit``: ``launch.py
     --check --jit`` exits 0;

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
   engine that prefills with plain attention, the served token streams
   against the plain-attention forward, and one training step of
   each model with the kernels against the same step with plain attention
   (loss and every gradient, in f32 and bf16).

The ``fuse_tiers`` traces run first in every call (a child process,
``--profile-path fuse_tiers``); with ``--profile DIR`` the seven serving
paths, the three training
paths, ``query_serve``, ``llm_stream`` (dense and paged: a unit is a
decode step), the three offload paths (a unit is a frame reaching the
decoding end) and ``hybrid_query`` are traced first, each in a process
of its own, in graph and eager mode in turns (graph, eager, eager,
graph): device busy time, device kernels and host launch calls a unit
(and a bucket, on the batched paths), the idle share and the rates, one
``profile_modes`` line a path with both modes side by side;
``query_pace`` serves the query pair twice more, with the clients in
processes of their own and without the wire's CRC; and ``offload_pace``
runs edge and MQTT with the producer in a child process, and edge
without the wire's CRC, each in turns with the default path.

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
    # train_dist's sp2 ring steps (f32, a rank's half of (4, 2048)): a
    # key block from the past (every key visible) and one from the future
    # (no row sees a key: out 0, lse -inf)
    ("ring_past", 4, 1024, 1024, 8, 64, True, "float32", 1024, 0),
    ("ring_future", 4, 1024, 1024, 8, 64, True, "float32", 0, 1024),
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
    # train_dist's sp2 ring steps, as in FLASH_ROWS; the future block's
    # lse cotangent is 0 (the ring's merge weighs it 0)
    ("ring_past", 4, 1024, 1024, 8, 64, True, "float32", 1024, 0, True),
    ("ring_future", 4, 1024, 1024, 8, 64, True, "float32", 0, 1024, False),
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
                 eager: bool = False, tier=None, depth: int = 2,
                 traced=None) -> dict:
    """Drive an image-labeling pipeline of ``frames`` frames under the
    segment compiler's ``tier`` (None: the default) and
    ``NNS_FUSE_DEPTH``.  In graph mode the filter captures its forward
    at open and again, fused with the decoder's pushdown, before the
    first frame; every frame is a replay, of the filter's graph or, under
    xla, of the segment's, captured at the first frame (the plan row
    must say xla).  ``kernel`` must launch ``per_frame`` times a replay
    and as often in each eager run of the forward: the one before each
    capture (graph mode) or the open's warm-up invoke (``eager``).
    ``traced``: the tier's host launch calls and idle share, from the
    trace in a child, for the row."""
    from nnstreamer_tpu_torch import Pipeline, _cuda, parse_launch
    from nnstreamer_tpu_torch.analysis import compileledger

    stamps, captures_at = [], []

    def on_data(buf):
        stamps.append(time.perf_counter())
        captures_at.append(_cuda.graphs["captures"])

    _cuda.reset_launches()
    compileledger.reset()
    with fuse_depth(depth):
        p = parse_launch(launch.format(frames=frames, seed=seed),
                         Pipeline(fuse=tier))
    p.get("out").connect("new-data", on_data)
    t0 = time.perf_counter()
    with eager_filters(eager):
        p.play()
        try:
            p.wait(timeout=600)
            plans = p.planner.plans() if p.planner is not None else []
        finally:
            p.stop()
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
           "fuse": p.fuse_tier, "depth": depth, "frames": frames,
           "launches": launches, "graphs": graphs,
           "compile_ledger": compileledger.snapshot(),
           "fps": (len(stamps) - 1) / (stamps[-1] - stamps[0]),
           "p50_ms": statistics.median(gaps),
           "p90_ms": gaps[int(0.9 * (len(gaps) - 1))],
           "wall_s_incl_open": wall, **(traced or {}), "plans": plans,
           "card": card}
    emit(row)
    xla = p.fuse_tier == "xla"
    if xla and not eager and (len(plans) != 1 or plans[0]["lowering"]
                              != "xla" or "fallback" in plans[0]):
        raise AssertionError(f"{phase} under xla: plans {plans}")
    # graph mode: one eager run before each of the two captures (open,
    # pushdown) and, under xla, the segment's at the first frame, then a
    # replay a later frame; eager: the open's warm-up invoke and one run
    # a frame
    captures = PUSHDOWN_CAPTURES + (xla and not eager)
    replays = frames - (xla and not eager)
    want = per_frame * (frames + 1 if eager else captures + replays)
    if launches.get(kernel, 0) != want:
        raise AssertionError(f"{kernel} launched {launches.get(kernel, 0)} "
                             f"times on {phase}, expected {want}")
    if graphs != graph_counts(eager, captures, replays):
        raise AssertionError(f"{phase}: graphs {graphs}, expected "
                             f"{captures} captures before the stream's "
                             f"first frame reached the sink, {replays} "
                             "replays")
    if captures_at and captures_at[0] != graphs.get("captures", 0):
        raise AssertionError(f"{phase}: captures inside the stream")
    ledger = {"filter.jitexec.invoke": 2,
              **({"pipeline.segment": 1} if xla else {})}
    if row["compile_ledger"] != ledger:
        raise AssertionError(f"{phase}: compile ledger "
                             f"{row['compile_ledger']}, expected {ledger}")
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
# the segment compiler's tiers on the per-frame paths
# ---------------------------------------------------------------------------

#: the segment compiler's tiers (pipeline/schedule.py), in turn order
FUSE_TIERS = ("interpret", "python", "xla")
#: path -> (launch, kernel, its launches a frame) of the fuse_tiers runs
TIER_PATHS = {"main_path": (LAUNCH, "normalize_frame", 1),
              "vit_path": (VIT_LAUNCH, "flash_attention", 12)}
#: the tiers --profile-path fuse_tiers traces, in turns
TIER_TURNS = ("interpret", "python", "xla", "xla", "python", "interpret")


def logits_launch(path: str) -> str:
    """A fuse_tiers path's string cut before its decoder: the filter's
    logits reach the sink."""
    launch = TIER_PATHS[path][0]
    return launch[:launch.index("tensor_decoder")] + "tensor_sink name=out"


@contextlib.contextmanager
def fuse_depth(depth: int):
    """``NNS_FUSE_DEPTH`` while the block builds its pipelines."""
    was = os.environ.get("NNS_FUSE_DEPTH")
    os.environ["NNS_FUSE_DEPTH"] = str(depth)
    try:
        yield
    finally:
        if was is None:
            os.environ.pop("NNS_FUSE_DEPTH")
        else:
            os.environ["NNS_FUSE_DEPTH"] = was


def tier_logits(path: str, seed: int, tier: str, depth: int,
                custom: str = "", device: str = "cuda"):
    """The filter's outputs of GRAPH_LOGITS_FRAMES frames through the
    path's string cut before its decoder, under one tier; every output
    held until all arrived (a replay must not overwrite an earlier
    frame's).  ``custom`` is appended to the filter's properties;
    ``device="cpu"`` runs the filter on the CPU."""
    import torch

    from nnstreamer_tpu_torch import Pipeline, parse_launch

    launch = logits_launch(path).format(frames=GRAPH_LOGITS_FRAMES,
                                        seed=seed)
    if custom:
        launch = launch.replace(f"custom=seed:{seed}",
                                f"custom=seed:{seed},{custom}")
    if device == "cpu":
        launch = launch.replace("name=f ", "name=f accelerator=true:cpu ")
    with fuse_depth(depth):
        p = parse_launch(launch, Pipeline(fuse=tier))
    p.run(timeout=600)
    outs = [b.tensors[0] for b in p.get("out").results]
    return [o.cpu() if isinstance(o, torch.Tensor) else torch.from_numpy(o)
            for o in outs]


def run_fuse_tiers(args, card: str, traced: dict) -> dict:
    """Phase ``fuse_tiers``: the flagship and ViT paths under the three
    tiers in turns (and xla at ``NNS_FUSE_DEPTH=1``); labels bit-equal
    across them, the filter's logits too (the strings cut before the
    decoder); MobileNetV2 in f32 under xla on the card against the CPU
    within the main path's bound."""
    import torch

    out = {}
    for path in TIER_PATHS:
        frames = args.frames if path == "main_path" else args.vit_frames
        launch, kernel, per_frame = TIER_PATHS[path]
        runs = {}
        for tier, depth in (("interpret", 2), ("python", 2), ("xla", 2),
                            ("xla", 1)):
            runs[tier, depth] = run_labeling(
                f"fuse_tiers/{path}", launch, frames, args.seed, card,
                kernel, per_frame, tier=tier, depth=depth,
                traced=traced.get(path, {}).get(tier))
        logits = {key: tier_logits(path, args.seed, *key) for key in runs}
        ref_labels = runs["python", 2]["labels"]
        ref_logits = logits["python", 2]
        differ = {f"{t}/{d}": [i for i, (a, b) in enumerate(zip(
            r["labels"], ref_labels)) if a != b]
                  for (t, d), r in runs.items()}
        bits = {f"{t}/{d}": sum(torch.equal(a, b) for a, b in zip(
            lg, ref_logits)) for (t, d), lg in logits.items()}
        emit({"phase": "fuse_tiers_bits", "path": path, "frames": frames,
              "labels_differ_from_python": differ,
              "logits_frames": GRAPH_LOGITS_FRAMES,
              "logits_bit_equal_to_python": bits})
        if any(differ.values()) or any(v != GRAPH_LOGITS_FRAMES
                                       for v in bits.values()):
            raise AssertionError(f"fuse_tiers {path}: labels differ "
                                 f"{differ}, logits bit-equal {bits}")
        out[path] = {"launches": dict(sum(
            (collections.Counter(r["launches"]) for r in runs.values()),
            collections.Counter()))}
    # the card's f32 segment graph against the CPU's eager segment
    torch.backends.cudnn.allow_tf32 = False
    try:
        gpu = tier_logits("main_path", args.seed, "xla", 2,
                          "dtype:float32")[:2]
        cpu = tier_logits("main_path", args.seed, "xla", 2,
                          "dtype:float32", device="cpu")[:2]
    finally:
        torch.backends.cudnn.allow_tf32 = True
    diff = max((a - b).abs().max().item() for a, b in zip(gpu, cpu))
    emit({"phase": "fuse_tiers_f32_card_vs_cpu", "fuse": "xla",
          "max_abs_diff": diff, "atol": 1e-3})
    if diff > 1e-3 or any(int(a.argmax()) != int(b.argmax())
                          for a, b in zip(gpu, cpu)):
        raise AssertionError(f"fuse_tiers: f32 logits under xla differ "
                             f"from the CPU by {diff} > 1e-3")
    return out


def profile_fuse_tiers(args) -> None:
    """``--profile-path fuse_tiers``: trace each fuse_tiers path's steady
    window under the three tiers in turns (TIER_TURNS), then one
    ``profile_tiers`` line a path: each metric's values by tier, in turn
    order."""
    was = os.environ.get("NNS_FUSE")
    out_dir = args.profile or os.path.join(HERE, "nnstreamer_tpu_torch",
                                           "_build", "profile_fuse_tiers")
    try:
        for path, (launch, kernel, per_frame) in TIER_PATHS.items():
            frames = args.frames if path == "main_path" else args.vit_frames
            marker = ("normalize_frame_kernel" if kernel == "normalize_frame"
                      else K2_MARKER)
            rows = []
            for turn, tier in enumerate(TIER_TURNS):
                os.environ["NNS_FUSE"] = tier
                row = profile_path(f"{path}_{tier}", launch, frames,
                                   args.seed, out_dir, marker, per_frame,
                                   False, turn)
                rows.append((tier, row))
            emit({"phase": "profile_tiers", "path": path, **{
                tier: {k: [r[k] for t, r in rows if t == tier]
                       for k in ("host_launch_calls_per_unit",
                                 "device_idle_share",
                                 "device_busy_us_per_unit", "fps",
                                 "p50_ms") if k in rows[0][1]}
                for tier in FUSE_TIERS}})
    finally:
        if was is None:
            os.environ.pop("NNS_FUSE", None)
        else:
            os.environ["NNS_FUSE"] = was


def trace_fuse_tiers(argv) -> dict:
    """The fuse_tiers traces in a child process (``profile_child``):
    path -> tier -> host launch calls a frame and idle share, each the
    median of the tier's turns."""
    traced = {}
    for line in profile_child("fuse_tiers", argv):
        if line.startswith('{"phase": "profile_tiers"'):
            row = json.loads(line)
            traced[row["path"]] = {tier: {
                "host_launch_calls_a_frame": statistics.median(
                    row[tier]["host_launch_calls_per_unit"]),
                "device_idle_share": statistics.median(
                    row[tier]["device_idle_share"])}
                for tier in FUSE_TIERS}
    return traced


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
                eager: bool = False, launch: str = None,
                phase: str = "batched_path") -> dict:
    """Drive one batched labeling path (``batch=1``: the same string per
    frame, the reference) in one mode.  Checks: every frame labelled;
    in graph mode every capture made before the first frame reached the
    sink, none after; ``kernel`` launched as often as the captures' eager
    runs plus the replays each launch (its count a replay); the compile
    ledger's events.  ``launch``: a string of another path, whose filter
    holds no kernel of the table: then none may launch."""
    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.analysis import compileledger

    # a replay of the batched graph launches the kernel as often as one
    # frame's forward does
    *_, kernel, per_replay = BATCHED_PATHS.get(path, (None, 0))
    launch = launch or batched_launch(path, frames, batch)
    stamps, captures_at = [], []

    def on_data(buf):
        stamps.append(time.perf_counter())
        captures_at.append(_cuda.graphs["captures"])

    _cuda.reset_launches()
    compileledger.reset()
    p = parse_launch(launch)
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
    row = {"phase": phase, "path": path, "batch": batch,
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
                                      if runs and kernel else None)
    else:
        want_ledger = {"filter.jitexec.invoke": 2}
        want_graphs = graph_counts(eager, PUSHDOWN_CAPTURES, frames)
        want = per_replay * (runs if not eager else 1 + frames)
    emit(row)
    if kernel is None and launches:
        raise AssertionError(f"{path}: kernels {launches} launched on a "
                             "path that holds none")
    if kernel is not None and launches.get(kernel, 0) != want:
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
# the vision zoo: the JAX benchmark's ssd, deeplab and posenet strings
# ---------------------------------------------------------------------------

#: path -> (model, input size, decoder options): bench.py's configs ssd,
#: deeplab and posenet (bench.py:973-992); ``{priors}`` is SSD's box
#: priors file (bench.py's ``_ssd_priors_file`` recipe)
ZOO_PATHS = {
    "detect": ("ssd_mobilenet_v2", 300,
               "mode=bounding_boxes option1=mobilenet-ssd option3={priors} "
               "option4=300:300 option5=300:300"),
    "segment": ("deeplab_v3", 257, "mode=image_segment"),
    "pose": ("posenet", 257,
             "mode=pose_estimation option1=257:257 option2=257:257"),
}
ZOO_LAUNCH = ("videotestsrc num-buffers={frames} pattern=random seed={seed} ! "
              "video/x-raw,format=RGB,width={size},height={size},"
              "framerate=30/1 ! tensor_converter ! "
              "tensor_filter name=f framework=xla model={model} "
              "custom=seed:0 ! tensor_decoder {decoder} ! "
              "tensor_sink name=out")
#: keypoints of the pushdown against the host decode (f32 on the card,
#: f64 on the host)
KEYPOINT_ATOL = 1e-5
#: box corners of the device NMS against the host decode, and of the
#: card's NMS against the CPU's over the same raw heads
BOX_ATOL = 1e-5
#: f32 card against CPU, TF32 off: summation order only
F32_ZOO_ATOL = 1e-3


def zoo_priors() -> str:
    """SSD's box priors at 300x300 (cy cx h w rows x anchors), written
    once into the build directory by the JAX benchmark's recipe
    (``default_rng(0)``; bench.py ``_ssd_priors_file``)."""
    import numpy as np

    from nnstreamer_tpu_torch.models.ssd import anchor_count

    n = anchor_count(ZOO_PATHS["detect"][1])
    path = os.path.join(HERE, "nnstreamer_tpu_torch", "_build",
                        f"ssd_priors_{n}.txt")
    if not os.path.exists(path):
        rng = np.random.default_rng(0)
        rows = (rng.random(n), rng.random(n), np.full(n, 0.2),
                np.full(n, 0.2))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            for row in rows:
                f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
    return path


def zoo_decoder(path: str) -> str:
    return ZOO_PATHS[path][2].format(priors=zoo_priors())


def zoo_launch(path: str, frames: int, seed: int, batch: int = 1,
               pushdown: bool = True) -> str:
    model, size, _ = ZOO_PATHS[path]
    decoder = f"{zoo_decoder(path)} pushdown={str(pushdown).lower()}"
    if batch > 1:
        return BATCHED_LAUNCH.format(
            frames=frames, cache="cache-frames", size=size, model=model,
            custom="seed:0", batch=batch, inflight=1,
            depth=max(8, 2 * batch),
            tail=f"tensor_decoder {decoder} ! tensor_sink name=out")
    return ZOO_LAUNCH.format(frames=frames, seed=seed, size=size,
                             model=model, decoder=decoder)


def zoo_reduction(path: str, out_info):
    """The decoder of ``path``'s string, configured by its options, and
    its device reduction for a model of ``out_info``."""
    from nnstreamer_tpu_torch.decoders import find_decoder
    from nnstreamer_tpu_torch.tensor.info import TensorsConfig

    opts = dict(kv.split("=", 1) for kv in zoo_decoder(path).split())
    dec = find_decoder(opts.pop("mode"))()
    for key, value in opts.items():
        dec.set_option(int(key[len("option"):]), value)
    fn, _ = dec.device_reduce_spec(TensorsConfig(info=out_info))
    return dec, fn


def zoo_result(path: str, buf):
    """What a decoded frame of ``path`` carries: the detected objects
    (class, score, corners), the class map, or the keypoints."""
    import numpy as np

    if path == "detect":
        return [(o.class_id, o.score, o.ymin, o.xmin, o.ymax, o.xmax)
                for o in buf.extra["objects"]]
    if path == "segment":
        return buf.extra["class_map"]
    return np.array(buf.extra["keypoints"], np.float64)


def zoo_equal(path: str, a, b) -> bool:
    if path == "detect":
        return a == b
    return a.shape == b.shape and bool((a == b).all())


def run_zoo(path: str, frames: int, seed: int, card: str, batch: int = 1,
            eager: bool = False, pushdown: bool = True) -> dict:
    """Drive one zoo string in one mode.  Checks: every frame decoded; no
    kernel of the port launched (the zoo models preprocess with the plain
    cast and scale, and no TPU kernel is behind their decoders); in graph
    mode every capture made before the first frame reached the sink (per
    frame: the open's and, with the pushdown, the fused forward's;
    batched: the per-frame and batched forwards, each again fused) and a
    replay a frame or bucket; the compile ledger's events."""
    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.analysis import compileledger

    stamps, captures_at = [], []

    def on_data(buf):
        stamps.append(time.perf_counter())
        captures_at.append(_cuda.graphs["captures"])

    _cuda.reset_launches()
    compileledger.reset()
    p = parse_launch(zoo_launch(path, frames, seed, batch, pushdown))
    p.get("out").connect("new-data", on_data)
    t0 = time.perf_counter()
    with eager_filters(eager):
        p.run(timeout=900)
    wall = time.perf_counter() - t0
    launches, graphs = dict(_cuda.launches), dict(_cuda.graphs)
    results = p.get("out").results
    if len(results) != frames:
        raise AssertionError(f"{path}: {len(results)} decoded frames of "
                             f"{frames}")
    gaps = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    sites = 1 + int(pushdown)           # open, then fused
    if batch > 1:
        units = -(-frames // batch)
        want_ledger = {"filter.jitexec.invoke": sites,
                       "filter.jitexec.vmap": sites}
        captures = 2 * sites
    else:
        units = frames
        want_ledger = {"filter.jitexec.invoke": sites}
        captures = sites
    row = {"phase": f"{path}_path", "model": ZOO_PATHS[path][0],
           "batch": batch, "mode": "eager" if eager else "graph",
           "pushdown": pushdown, "frames": frames, "launches": launches,
           "graphs": graphs, "compile_ledger": compileledger.snapshot(),
           "fps": (len(stamps) - 1) / (stamps[-1] - stamps[0]),
           "p50_gap_ms": statistics.median(gaps),
           "p90_gap_ms": gaps[int(0.9 * (len(gaps) - 1))],
           "wall_s_incl_open": wall, "card": card}
    emit(row)
    if launches:
        raise AssertionError(f"{path}: kernels of the port launched on a "
                             f"path that has none: {launches}")
    if graphs != graph_counts(eager, captures, units):
        raise AssertionError(f"{path} (batch {batch}, {row['mode']}): "
                             f"graphs {graphs}, expected {captures} "
                             f"captures and {units} replays")
    if captures_at and captures_at[0] != graphs.get("captures", 0):
        raise AssertionError(f"{path} (batch {batch}): captures inside "
                             "the stream")
    if row["compile_ledger"] != want_ledger:
        raise AssertionError(f"{path} (batch {batch}): compile ledger "
                             f"{row['compile_ledger']}, expected "
                             f"{want_ledger}")
    return {"results": [zoo_result(path, b) for b in results],
            "fps": row["fps"], "launches": launches}


def zoo_results_equal(path: str, what: str, a: dict, b: dict) -> None:
    """Two runs' decoded frames, frame by frame, exactly."""
    differ = [i for i, (x, y) in enumerate(zip(a["results"], b["results"]))
              if not zoo_equal(path, x, y)]
    emit({"phase": "graph_vs_eager", "path": path, "what": what,
          "frames": len(a["results"]),
          "decoded_equal": len(a["results"]) - len(differ),
          "fps": {"graph": a["fps"], "eager": b["fps"]}})
    if differ or len(a["results"]) != len(b["results"]):
        raise AssertionError(f"{path}: {what} differ on frames {differ}")


def check_zoo_graph_outputs(path: str, seed: int) -> None:
    """The filter's raw outputs and its outputs fused with the decoder's
    reduction, per frame (8 frames) and batched (a bucket of 32 and a
    padded one of 20), in graph mode against eager mode, bit for bit."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.filter import FilterSingle

    model, size, _ = ZOO_PATHS[path]
    imgs = source_frames(GRAPH_LOGITS_FRAMES, seed, size)
    bucket = [[f] for f in source_frames(BATCH + 20, SOURCE_SEED, size)]

    def batched(fw):
        handles = [fw.invoke_batched(bucket[:BATCH], BATCH),
                   fw.invoke_batched(bucket[BATCH:], BATCH)]
        return [row for h in handles for row in h.wait()]

    outs = {}
    for eager in (False, True):
        with eager_filters(eager):
            with FilterSingle(framework="xla", model=model,
                              custom="seed:0") as single:
                fw = single.fw
                fw.warmup_batched(BATCH)
                raw = [[o.cpu() for o in fw.invoke([img])] for img in imgs]
                raw_b = batched(fw)
                _, fn = zoo_reduction(path, fw.get_model_info()[1])
                fw.set_postprocess(fn)
                fw.warmup_batched(BATCH)
                red = [[o.cpu() for o in fw.invoke([img])] for img in imgs]
                red_b = batched(fw)
                torch.cuda.synchronize()
        outs[eager] = {"raw": raw, "reduced": red, "raw_batched": raw_b,
                       "reduced_batched": red_b}
    counts = {}
    for key, graph in outs[False].items():
        eager = outs[True][key]
        same = [all(np.array_equal(np.asarray(a), np.asarray(b))
                    for a, b in zip(g, e)) for g, e in zip(graph, eager)]
        counts[key] = [sum(same), len(same)]
        if not all(same) or len(graph) != len(eager):
            emit({"phase": "graph_vs_eager", "path": path,
                  "outputs_bit_equal": counts})
            raise AssertionError(f"{path}: {key} graph outputs differ from "
                                 "eager")
    emit({"phase": "graph_vs_eager", "path": path, "model": model,
          "outputs_bit_equal": counts})


def check_zoo_outputs(path: str, card: str) -> None:
    """The model of ``path`` directly on the cached frames of the batched
    string: finite outputs of the registry's shapes; the batched forward
    within the bf16 bound (LOGITS_ATOL/RTOL) of the per-frame one; in f32
    with TF32 off, the card within F32_ZOO_ATOL of the CPU on two frames;
    for SSD, the decoder's device NMS on the card against the same
    reduction on the CPU over the fetched raw heads (classes, scores and
    survivor counts exact, corners within BOX_ATOL)."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.models.registry import get_model

    name, size, _ = ZOO_PATHS[path]
    model = get_model(name, {"seed": "0"})
    imgs = torch.from_numpy(np.stack(
        source_frames(CACHED, SOURCE_SEED, size))).cuda()
    with torch.inference_mode():
        batched = [torch.cat(parts) for parts in zip(
            *(model.batched(imgs[i:i + BATCH])
              for i in range(0, CACHED, BATCH)))]
        per_frame = [torch.stack(parts) for parts in zip(
            *(model.module(x) for x in imgs))]
    row = {"phase": f"{path}_outputs", "model": name, "frames": CACHED,
           "atol": LOGITS_ATOL, "rtol": LOGITS_RTOL, "card": card,
           "outputs": []}
    bad = []
    for i, (b, p) in enumerate(zip(batched, per_frame)):
        want = (CACHED,) + model.out_info[i].np_shape
        diff = (b - p).abs()
        over = int((diff > LOGITS_ATOL + LOGITS_RTOL * p.abs()).sum())
        row["outputs"].append({
            "shape": list(b.shape), "finite": bool(torch.isfinite(b).all()),
            "max_abs": p.abs().max().item(),
            "batched_max_abs_diff_vs_per_frame": diff.max().item(),
            "over_tolerance": over})
        if tuple(b.shape) != want or not torch.isfinite(b).all() or over:
            bad.append(f"output {i}: shape {tuple(b.shape)} (want {want}), "
                       f"{over} beyond the bf16 bound")
    torch.backends.cudnn.allow_tf32 = False
    try:
        f32 = {"seed": "0", "dtype": "float32"}
        gpu = get_model(name, f32).module
        cpu = get_model(name, f32, device="cpu").module
        worst = 0.0
        with torch.inference_mode():
            for x in imgs[:2]:
                for a, b in zip(gpu(x), cpu(x.cpu())):
                    worst = max(worst, (a.cpu() - b).abs().max().item())
    finally:
        torch.backends.cudnn.allow_tf32 = True
    row.update(f32_card_vs_cpu_max_abs_diff=worst, f32_atol=F32_ZOO_ATOL)
    if worst > F32_ZOO_ATOL:
        bad.append(f"f32 card differs from the CPU by {worst}")
    if path == "detect":
        _, fn = zoo_reduction(path, model.out_info)
        counts, box_diff, differ = [], 0.0, []
        with torch.inference_mode():
            for j in range(GRAPH_LOGITS_FRAMES):
                raw = [o[j] for o in per_frame]
                card_out = [t.cpu() for t in fn(raw)]
                cpu_out = fn([t.cpu() for t in raw])
                counts.append(int(card_out[3][0]))
                box_diff = max(box_diff, (card_out[0] - cpu_out[0]).abs()
                               .max().item())
                if not all(torch.equal(card_out[k], cpu_out[k])
                           for k in (1, 2, 3)):
                    differ.append(j)
        row.update(nms_card_vs_cpu={"frames": GRAPH_LOGITS_FRAMES,
                                    "survivors": counts,
                                    "frames_differ": differ,
                                    "box_max_abs_diff": box_diff,
                                    "box_atol": BOX_ATOL})
        if differ or box_diff > BOX_ATOL:
            bad.append(f"device NMS differs from the CPU's on frames "
                       f"{differ} (corners by {box_diff})")
    emit(row)
    if bad:
        raise AssertionError(f"{path}: " + "; ".join(bad))


def ssd_candidate_cut(frames, seed: int):
    """Per frame of the per-frame string: the score at which the decoder's
    DETECTION_MAX candidate cut falls, and whether it falls on a tie (the
    candidates ranked DETECTION_MAX and DETECTION_MAX + 1 score equal);
    None where fewer candidates pass the threshold."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.decoders.boundingbox import (
        DEFAULT_THRESHOLD, DETECTION_MAX)
    from nnstreamer_tpu_torch.models.registry import get_model

    model = get_model(ZOO_PATHS["detect"][0], {"seed": "0"})
    cuts = []
    with torch.inference_mode():
        for img in source_frames(frames, seed, ZOO_PATHS["detect"][1]):
            _, scores = model.module(torch.from_numpy(img).cuda())
            sc = np.sort(scores[:, 1:].amax(1).cpu().numpy())[::-1]
            sc = sc[sc >= DEFAULT_THRESHOLD]
            if len(sc) <= DETECTION_MAX:
                cuts.append(None)
            else:
                cut = float(sc[DETECTION_MAX - 1])
                cuts.append((cut, cut == float(sc[DETECTION_MAX])))
    return cuts


def check_zoo_pushdown_vs_host(path: str, device: dict, host: dict,
                               seed: int) -> None:
    """The device pushdown's decoded frames against the host decode's
    (``pushdown=false``) over the same frames: class maps exactly,
    keypoints within KEYPOINT_ATOL; detected objects equal in class and
    score and within BOX_ATOL in their corners — where the candidate cut
    falls on a tied score the two pick different candidates among the
    tie, and only the objects scored above the tie are compared."""
    import numpy as np

    row = {"phase": "pushdown_vs_host", "path": path,
           "frames": len(device["results"]),
           "fps": {"pushdown": device["fps"], "host": host["fps"]}}
    differ = []
    if path == "detect":
        cuts = ssd_candidate_cut(len(device["results"]), seed)
        ties, compared = [], 0
        for i, (d, h, cut) in enumerate(zip(device["results"],
                                            host["results"], cuts)):
            if cut is not None and cut[1]:
                ties.append(i)
                d = [o for o in d if o[1] > cut[0]]
                h = [o for o in h if o[1] > cut[0]]
            compared += len(d)
            if len(d) != len(h) or any(
                    a[:2] != b[:2] or max(abs(x - y) for x, y in
                                          zip(a[2:], b[2:])) > BOX_ATOL
                    for a, b in zip(d, h)):
                differ.append(i)
        row.update(objects_compared=compared, cut_on_a_tie=ties,
                   objects_per_frame=[len(d) for d in device["results"]],
                   box_atol=BOX_ATOL)
    else:
        worst = 0.0
        for i, (d, h) in enumerate(zip(device["results"],
                                       host["results"])):
            if path == "segment":
                ok = d.shape == h.shape and bool((d == h).all())
            else:
                err = float(np.abs(d - h).max())
                worst = max(worst, err)
                ok = d.shape == h.shape and err <= KEYPOINT_ATOL
            if not ok:
                differ.append(i)
        if path == "pose":
            row.update(keypoint_max_abs_diff=worst,
                       keypoint_atol=KEYPOINT_ATOL)
    row["frames_differ"] = differ
    emit(row)
    if differ:
        raise AssertionError(f"{path}: the pushdown's decoded frames differ "
                             f"from the host decode's on frames {differ}")


def time_nms_scan(seed: int, reps: int, card: str) -> None:
    """SSD's forward graph alone and fused with the decoder's device NMS,
    per frame and as a 32-frame bucket: device time of one replay (the
    replays queued back to back) and the NMS tail's share of the fused
    graph; and the torch operations one NMS call dispatches (a count of
    the non-view aten calls of an eager run, roughly its kernels)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from nnstreamer_tpu_torch.filter import FilterSingle
    from nnstreamer_tpu_torch.filter.backends._torchexec import INVOKE_SITE

    class _Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops += not func.is_view
            return func(*args, **(kwargs or {}))

    model, size, _ = ZOO_PATHS["detect"]
    ms = {}
    with FilterSingle(framework="xla", model=model,
                      custom="seed:0") as single:
        fw = single.fw
        fw.warmup_batched(BATCH)
        raw = fw.invoke([source_frames(1, seed, size)[0]])
        graphs = {"model": dict(fw._execs)}
        _, fn = zoo_reduction("detect", fw.get_model_info()[1])
        fw.set_postprocess(fn)
        fw.warmup_batched(BATCH)
        graphs["model+nms"] = dict(fw._execs)
        for name, execs in graphs.items():
            for (site, _sig), graph in execs.items():
                unit = "frame" if site == INVOKE_SITE else "bucket"
                ms[f"{name}_per_{unit}"] = time_ms(graph.graph.replay,
                                                   reps=max(reps // 4, 20))
    count = _Count()
    with torch.inference_mode(), count:
        fn(raw)
    row = {"phase": "nms_scan", "card": card, "replay_ms": ms,
           "nms_share_per_frame": 1 - ms["model_per_frame"]
           / ms["model+nms_per_frame"],
           "nms_share_per_bucket": 1 - ms["model_per_bucket"]
           / ms["model+nms_per_bucket"],
           "nms_ms_per_frame": ms["model+nms_per_frame"]
           - ms["model_per_frame"],
           "nms_ms_per_bucket": ms["model+nms_per_bucket"]
           - ms["model_per_bucket"],
           "aten_ops_per_nms_call": count.ops}
    emit(row)


def run_zoo_paths(args, card: str) -> dict:
    """detect_path, segment_path and pose_path: each string per frame and
    batched, in graph mode then eagerly (decoded frames equal), the raw
    and reduced outputs graph against eager bit for bit, the model's
    outputs checked, and the pushdown held to the host decode; then the
    NMS tail timed.  Returns path -> the graph runs' rows."""
    rows = {}
    for path in ZOO_PATHS:
        graph = run_zoo(path, args.frames, args.seed, card)
        eager = run_zoo(path, args.frames, args.seed, card, eager=True)
        zoo_results_equal(path, "per-frame decoded frames", graph, eager)
        batched = run_zoo(path, args.batched_frames, args.seed, card,
                          batch=BATCH)
        batched_eager = run_zoo(path, args.batched_frames, args.seed, card,
                                batch=BATCH, eager=True)
        zoo_results_equal(path, "batched decoded frames", batched,
                          batched_eager)
        check_zoo_graph_outputs(path, args.seed)
        check_zoo_outputs(path, card)
        host = run_zoo(path, args.frames, args.seed, card, pushdown=False)
        check_zoo_pushdown_vs_host(path, graph, host, args.seed)
        rows[f"{path}_b1"], rows[f"{path}_batched"] = graph, batched
    time_nms_scan(args.seed, args.reps, card)
    return rows


#: the transform on frames resident on the card: normalize then move the
#: channel axis first, each tensor_transform on the device (acceleration
#: true) or through numpy (false)
TRANSFORM_LAUNCH = (
    "videotestsrc num-buffers={frames} pattern=random device-cache=64 ! "
    "video/x-raw,format=RGB,width=224,height=224,framerate=120/1 ! "
    "tensor_converter ! tensor_transform mode=arithmetic "
    "option=typecast:float32,add:-127.5,div:127.5 acceleration={acc} ! "
    "tensor_transform mode=transpose option=1:2:0:3 acceleration={acc} ! "
    "tensor_sink name=out")


# ---------------------------------------------------------------------------
# the model-file backends (model_files)
# ---------------------------------------------------------------------------

#: where the phase writes its seeded model files (gitignored)
MF_DIR = os.path.join(HERE, "_model_files")
#: frames of the FilterSingle checks (graph vs eager, card vs CPU)
MF_CHECK_FRAMES = 8
#: frames of each LeNet-5 string, and of each host backend's string
MF_LENET_FRAMES = 256
MF_HOST_FRAMES = 64
#: the TFLite modes: (file, compute)
MF_TFLITE_MODES = (("quant", "int8"), ("quant", "w8"), ("quant", "float32"),
                   ("float", "auto"), ("float", "float32"))
#: f32 on the card (TF32 off) against the CPU: softmax probabilities
#: within the CPU tests' bound (F32_ATOL of tests/test_torch_model_files.py),
#: logits within the port's f32 bound on its other paths (F32_ZOO_ATOL)
MF_F32_PROB_ATOL = 2e-5
MF_F32_LOGIT_ATOL = F32_ZOO_ATOL
#: bf16 against f32 on the probabilities the reference gives the classes
#: of its top 5 (those of at least one uint8 output step): at most this
#: share of the reference apart (and one output step for uint8 outputs)
MF_BF16_TOP5_RTOL = 0.1
MF_TOP_K = 5


@contextlib.contextmanager
def no_tf32():
    """TF32 off in cuDNN and in matmuls for the block, the flags as they
    were after it (matmul TF32 is off by default, cuDNN's on)."""
    import torch

    was = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = was


def build_model_files(seed: int) -> dict:
    """The phase's files, written from ``seed`` by the test suite's fixture
    writers: MobileNetV2 1.0 at 224x224, 1001 classes as a uint8-quantized
    and a float32 ``.tflite`` and as a TorchScript trace of the port's own
    model, and a LeNet-5 as TensorFlow, Caffe2 and MXNet files."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_model_files as mf

    os.makedirs(MF_DIR, exist_ok=True)
    t0 = time.perf_counter()
    files = {
        "quant": mf.mobilenet_v2_tflite(os.path.join(MF_DIR, "mnv2_q.tflite"),
                                        True, seed=seed),
        "float": mf.mobilenet_v2_tflite(os.path.join(MF_DIR, "mnv2_f.tflite"),
                                        False, seed=seed),
        "pt": mf.mobilenet_v2_torchscript(os.path.join(MF_DIR, "mnv2.pt"),
                                          seed=seed),
        "pb": mf.lenet_graphdef(os.path.join(MF_DIR, "lenet.pb"), seed),
        "caffe2": mf.lenet_caffe2(MF_DIR, seed),
        "mxnet": mf.lenet_mxnet(MF_DIR, seed),
    }
    emit({"phase": "model_files_build", "s": time.perf_counter() - t0,
          "bytes": {k: sum(os.path.getsize(p) for p in v.split(","))
                    for k, v in files.items()}})
    return files


def mf_filter(framework: str, model: str, custom: str = "") -> str:
    props = f"framework={framework} model={model}"
    if framework == "pytorch":
        props += " input=3:224:224 inputtype=uint8"
    return props + (f" custom={custom}" if custom else "")


def mf_launch(filt: str, frames: int, seed: int, batch: int = 1) -> str:
    stage = (f"tensor_filter name=f {filt}" if batch == 1 else
             f"tensor_filter name=f {filt} batch={batch} inflight=1 ! queue")
    return (f"videotestsrc num-buffers={frames} pattern=random seed={seed} ! "
            "video/x-raw,format=RGB,width=224,height=224,framerate=30/1 ! "
            f"tensor_converter ! {stage} ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")


def run_mf_strings(name: str, filt: str, args, card: str) -> dict:
    """One model file in one mode through the flagship string: per frame
    (graph, then eager: labels equal) over the main path's frames, and
    at batch=32 over the batched paths' frames; no kernel of the table
    may launch (none lies on this path)."""
    per, eager = (run_batched(name, args.frames, card, 1, e, phase=
                              "model_files", launch=mf_launch(
                                  filt, args.frames, args.seed))
                  for e in (False, True))
    labels_equal_eager(name, per, eager)
    bat = run_batched(name, args.batched_frames, card, BATCH,
                      phase="model_files", launch=mf_launch(
                          filt, args.batched_frames, args.seed, BATCH))
    return {"per_frame": per, "batched": bat}


def mf_outputs(filt: dict, imgs, cpu: bool = False, eager: bool = False,
               batched: bool = False) -> dict:
    """The filter's own outputs on ``imgs`` through ``FilterSingle``: per
    frame (and, ``batched``, one padded 32-frame bucket through the
    batched forward), as host arrays."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.filter import FilterSingle

    out = {}
    with eager_filters(eager):
        with FilterSingle(accelerator="true:cpu" if cpu else None,
                          **filt) as single:
            fw = single.fw
            frames = [fw.invoke([img]) for img in imgs]
            out["frames"] = [[o.cpu().numpy() for o in f] for f in frames]
            if batched:
                stacked = [torch.as_tensor(np.stack(
                    list(imgs) * (BATCH // len(imgs))))]
                outs = fw.invoke_stacked(stacked, BATCH, BATCH)
                out["bucket"] = [o.cpu().numpy() for o in outs]
            if hasattr(fw, "routes"):
                out["routes"] = fw.routes
    return out


def mf_busy(filt: dict, frame, fps: dict) -> dict:
    """The card's busy time for one frame's invoke (and, where ``fps``
    has a batched rate, one 32-frame bucket's) in graph mode, from
    ``time_ms`` with a backlog; the device's idle share at each rate of
    ``fps`` (1 - busy x rate)."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch.filter import FilterSingle

    row = {}
    with FilterSingle(**filt) as single:
        fw = single.fw
        x = torch.as_tensor(frame).cuda()
        row["frame_device_ms"] = time_ms(lambda: fw.invoke([x]), reps=100)
        row["per_frame_fps"] = fps["per_frame"]
        row["idle_share_per_frame"] = \
            1 - row["frame_device_ms"] * fps["per_frame"] / 1e3
        if "batched" in fps:
            xb = torch.as_tensor(np.stack([frame] * BATCH)).cuda()
            row["bucket_device_ms"] = time_ms(
                lambda: fw.invoke_stacked([xb], BATCH, BATCH), reps=60)
            row["batched_fps"] = fps["batched"]
            row["idle_share_batched"] = \
                1 - row["bucket_device_ms"] * fps["batched"] / BATCH / 1e3
    return row


def mf_bits_equal(name: str, graph: dict, eager: dict) -> None:
    import numpy as np

    pairs = list(zip(graph["frames"], eager["frames"]))
    if "bucket" in graph:
        pairs.append((graph["bucket"], eager["bucket"]))
    differ = [i for i, (g, e) in enumerate(pairs)
              if not all(np.array_equal(a, b) for a, b in zip(g, e))]
    emit({"phase": "graph_vs_eager", "path": name,
          "outputs_bit_equal": len(pairs) - len(differ),
          "compared": len(pairs)})
    if differ:
        raise AssertionError(f"{name}: graph outputs differ from eager on "
                             f"{differ}")


def mf_quant_vs(name: str, what: str, a, b, max_steps=1, **extra) -> dict:
    """Two uint8 outputs: the elements that differ and the largest
    difference in quantization steps (at most ``max_steps``; None:
    reported only)."""
    import numpy as np

    d = np.abs(np.stack(a).astype(np.int32) - np.stack(b).astype(np.int32))
    row = {"phase": "model_files_outputs", "path": name, "vs": what,
           "elements_differing": int((d > 0).sum()), "elements": d.size,
           "max_steps": int(d.max()), "bound_steps": max_steps, **extra}
    emit(row)
    if max_steps is not None and row["max_steps"] > max_steps:
        raise AssertionError(f"{name} vs {what}: {row}")
    return row


def mf_f32_vs(name: str, what: str, got, ref, atol: float) -> None:
    """Two f32 outputs, element by element, within ``atol``."""
    import numpy as np

    diff = max(float(np.abs(a - b).max()) for a, b in zip(got, ref))
    emit({"phase": "model_files_outputs", "path": name, "vs": what,
          "max_abs_diff": diff, "atol": atol})
    if diff > atol:
        raise AssertionError(f"{name} vs {what}: {diff} > {atol}")


def mf_bf16_vs(name: str, got, ref, step: float) -> None:
    """bf16 probabilities against f32 ones (``step``: the uint8 output's
    scale, 0 for float outputs): element by element within the port's
    bf16 logit bound 0.05 + 0.05|x|, and on the reference's top-5
    classes within ``MF_BF16_TOP5_RTOL`` of the reference plus one step;
    the ranks of those classes (top-1 and top-5 membership) equal."""
    import numpy as np

    got = np.stack(got).reshape(len(got), -1).astype(np.float64) * \
        (step or 1)
    ref = np.stack(ref).reshape(len(ref), -1).astype(np.float64) * \
        (step or 1)
    over = float((np.abs(got - ref) - (0.05 + 0.05 * np.abs(ref))).max())
    top = np.argsort(-ref, axis=1, kind="stable")[:, :MF_TOP_K]
    r_top = np.take_along_axis(ref, top, 1)
    g_top = np.take_along_axis(got, top, 1)
    held = r_top >= max(step, 1 / 256)
    rel = np.maximum(np.abs(g_top - r_top)[held] - step, 0)
    worst = float((rel / r_top[held]).max()) if held.any() else None
    got_top = np.argsort(-got, axis=1, kind="stable")[:, :MF_TOP_K]
    top1 = int((got.argmax(1) == ref.argmax(1)).sum())
    top5 = int(sum(len(set(a) & set(b)) for a, b in zip(top, got_top)))
    row = {"phase": "model_files_outputs", "path": name, "vs": "f32",
           "max_abs_diff": float(np.abs(got - ref).max()),
           "bf16_bound": "0.05 + 0.05|x|", "worst_over_bound": over,
           "top5_classes_held": int(held.sum()),
           "top5_worst_rel_diff": worst, "top5_rtol": MF_BF16_TOP5_RTOL,
           "top5_ref_got": [[[float(r), float(g)] for r, g in zip(rr, gg)]
                            for rr, gg in zip(r_top, g_top)],
           "top1_equal": top1, "top5_overlap": top5, "frames": len(ref)}
    emit(row)
    if over > 0 or worst is None or worst > MF_BF16_TOP5_RTOL:
        raise AssertionError(f"{name} beyond its bf16 bounds: {row}")


def mf_labels_vs(name: str, what: str, got, ref) -> None:
    """argmax of ``got`` against ``ref``, frame by frame, where ``ref``'s
    top-2 margin exceeds twice the frame's largest difference between
    the two; the count compared is printed, and at least one frame must
    be."""
    import numpy as np

    got = np.stack(got).reshape(len(got), -1).astype(np.float64)
    ref = np.stack(ref).reshape(len(ref), -1).astype(np.float64)
    top2 = np.sort(ref, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    sure = margin > 2 * np.abs(got - ref).max(axis=1)
    differ = int((got.argmax(1) != ref.argmax(1))[sure].sum())
    emit({"phase": "model_files_labels", "path": name, "vs": what,
          "compared": int(sure.sum()), "of": len(ref), "differ": differ})
    if differ or not sure.any():
        raise AssertionError(f"{name} vs {what}: {differ} labels differ, "
                             f"{int(sure.sum())} compared")


def run_model_files(args, card: str) -> dict:
    """The model-file backends' path: the flagship string with
    ``tensor_filter framework=tensorflow-lite`` on MobileNetV2 1.0 (uint8
    file under int8, w8 and f32 emulation; float file under auto = bf16
    and f32), per frame and at batch=32, ``framework=pytorch`` on the
    traced MobileNetV2, graph then eager; LeNet-5 through tensorflow,
    caffe2 and mxnet; python, lua, custom-easy and dummy once each.
    Returns the rows whose launches the kernel table sums (all empty)."""
    import torch

    files = build_model_files(args.seed)
    imgs = source_frames(MF_CHECK_FRAMES, args.seed)
    rows, res, busy = {}, {}, {}
    for kind, compute in MF_TFLITE_MODES:
        name = f"tflite_{kind}_{compute}"
        filt = {"framework": "tensorflow-lite", "model": files[kind],
                "custom": f"compute:{compute}"}
        runs = run_mf_strings(name, mf_filter(**filt), args, card)
        rows[name] = runs["per_frame"]
        rows[name + "_batched"] = runs["batched"]
        # cuDNN's flags as the pipeline leaves them (TF32 on)
        res[name] = mf_outputs(filt, imgs, batched=True)
        mf_bits_equal(name, res[name],
                      mf_outputs(filt, imgs, eager=True, batched=True))
        busy[name] = mf_busy(filt, imgs[0], {
            "per_frame": runs["per_frame"]["fps"],
            "batched": runs["batched"]["fps"]})
        if compute == "int8":
            emit({"phase": "model_files_routes", "path": name,
                  "routes": {f"{i}:{k}": r for i, k, r in
                             res[name]["routes"]},
                  "count": {r: sum(1 for *_, x in res[name]["routes"]
                                   if x == r)
                            for r in ("int_mm", "f32", "f64")}})
    # native int8 on the card, as served, against the CPU: one float op
    # (the average pool) sits between the int ops and the softmax, so at
    # most one step
    q_cpu = mf_outputs({"framework": "tensorflow-lite",
                        "model": files["quant"], "custom": "compute:int8"},
                       imgs, cpu=True)
    mf_quant_vs("tflite_quant_int8", "cpu",
                [f[0] for f in res["tflite_quant_int8"]["frames"]],
                [f[0] for f in q_cpu["frames"]],
                cudnn_allow_tf32=torch.backends.cudnn.allow_tf32)
    # the float modes against the CPU, TF32 off on the card
    with no_tf32():
        card32 = {}
        # (w8 computes in bf16 on the card: it is held to f32 below)
        for kind in ("quant", "float"):
            name = f"tflite_{kind}_float32"
            filt = {"framework": "tensorflow-lite", "model": files[kind],
                    "custom": "compute:float32"}
            card32[name] = [f[0] for f in mf_outputs(filt, imgs)["frames"]]
            cpu = [f[0] for f in mf_outputs(filt, imgs, cpu=True)["frames"]]
            if kind == "quant":
                mf_quant_vs(name, "cpu", card32[name], cpu)
            else:
                mf_f32_vs(name, "cpu", card32[name], cpu, MF_F32_PROB_ATOL)
        pt_filt = {"framework": "pytorch", "model": files["pt"]}
        from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsInfo
        from nnstreamer_tpu_torch.tensor.types import TensorType

        pt_filt["input_info"] = TensorsInfo(
            [TensorInfo(TensorType.UINT8, (3, 224, 224))])
        pt_card = [f[0] for f in mf_outputs(pt_filt, imgs)["frames"]]
        mf_f32_vs("torchscript", "cpu", pt_card,
                  [f[0] for f in mf_outputs(pt_filt, imgs, cpu=True)
                   ["frames"]], MF_F32_LOGIT_ATOL)
        xla32 = mf_outputs({"framework": "xla", "model": "mobilenet_v2",
                            "custom": f"seed:{args.seed},dtype:float32,"
                                      "use_pallas:1"}, imgs)
        mf_labels_vs("torchscript", "xla mobilenet_v2 f32", pt_card,
                     [f[0] for f in xla32["frames"]])
    # each mode against its file's f32 run on the card
    f32q = card32["tflite_quant_float32"]
    for name in ("tflite_quant_int8", "tflite_quant_w8"):
        got = [f[0] for f in res[name]["frames"]]
        mf_quant_vs(name, "f32 emulation", got, f32q, max_steps=None)
        mf_labels_vs(name, "f32 emulation", got, f32q)
    # bf16 against f32: w8 in real units (the softmax's scale 1/256)
    mf_bf16_vs("tflite_quant_w8", [f[0] for f in res["tflite_quant_w8"]
                                   ["frames"]], f32q, 1 / 256)
    got = [f[0] for f in res["tflite_float_auto"]["frames"]]
    mf_bf16_vs("tflite_float_auto", got, card32["tflite_float_float32"], 0)
    mf_labels_vs("tflite_float_auto", "f32", got,
                 card32["tflite_float_float32"])
    # TorchScript through the string, graph and eager, per frame and batched
    runs = run_mf_strings("torchscript", mf_filter("pytorch", files["pt"]),
                          args, card)
    rows["torchscript"] = runs["per_frame"]
    rows["torchscript_batched"] = runs["batched"]
    mf_bits_equal("torchscript", mf_outputs(pt_filt, imgs, batched=True),
                  mf_outputs(pt_filt, imgs, eager=True, batched=True))
    busy["torchscript"] = mf_busy(pt_filt, imgs[0], {
        "per_frame": runs["per_frame"]["fps"],
        "batched": runs["batched"]["fps"]})
    lenet_rows, lenet_busy = run_lenet_formats(files, args.seed, card)
    rows.update(lenet_rows)
    busy.update(lenet_busy)
    busy.update(run_host_backends(args.seed, card))
    emit({"phase": "model_files_fps", "card": card, "fps": busy})
    return rows


def run_lenet_formats(files: dict, seed: int, card: str):
    """LeNet-5 as a TensorFlow, Caffe2 and MXNet file through ``appsrc !
    tensor_filter ! tensor_sink`` on the card, graph then eager (outputs
    bit for bit), and the card's f32 (TF32 off) against the CPU's; the
    three formats compute the same function.  Returns the rows whose
    launches the kernel table sums, and each format's rate and busy
    time."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.filter import FilterSingle
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsInfo
    from nnstreamer_tpu_torch.tensor.types import TensorType

    rng = np.random.default_rng(seed)
    xs = [rng.random((1, 28, 28, 1), np.float32)
          for _ in range(MF_LENET_FRAMES)]
    specs = {"tensorflow": (files["pb"], False),
             "caffe2": (files["caffe2"], True),
             "mxnet": (files["mxnet"], True)}
    rows, firsts, busy = {}, {}, {}
    for fw, (model, nchw) in specs.items():
        dims = "28:28:1:1" if nchw else "1:28:28:1"
        launch = ("appsrc name=src caps=other/tensors,format=static,"
                  f"num_tensors=1,dimensions={dims},types=float32,"
                  "framerate=0/1 ! tensor_filter name=f "
                  f"framework={fw} model={model} custom=compute:float32"
                  + (f" input={dims} inputtype=float32" if nchw else "")
                  + " ! tensor_sink name=out")
        frames = [x.transpose(0, 3, 1, 2).copy() if nchw else x for x in xs]
        outs, fps = {}, {}
        for eager in (False, True):
            with no_tf32():
                _cuda.reset_launches()
                p = parse_launch(launch)
                with eager_filters(eager):
                    p.play()
                    t0 = time.perf_counter()
                    for x in frames:
                        p.get("src").push_buffer(TensorBuffer(tensors=[x]))
                    p.get("src").end_of_stream()
                    p.wait(timeout=120)
                    # no host read of the outputs on this string: the
                    # rate counts a frame once the card has computed it
                    torch.cuda.synchronize()
                    fps[eager] = len(frames) / (time.perf_counter() - t0)
                    p.stop()
                graphs = dict(_cuda.graphs)
            outs[eager] = [b.np(0).copy() for b in p.get("out").results]
            emit({"phase": "model_files", "path": f"lenet_{fw}",
                  "mode": "eager" if eager else "graph", "frames": len(xs),
                  "fps": fps[eager], "graphs": graphs,
                  "launches": dict(_cuda.launches), "card": card})
            if len(outs[eager]) != len(xs):
                raise AssertionError(f"lenet_{fw}: {len(outs[eager])} of "
                                     f"{len(xs)} frames")
            # the open's capture, then a replay a frame
            if graphs != graph_counts(eager, 1, len(xs)):
                raise AssertionError(f"lenet_{fw}: graphs {graphs}")
        if not all(np.array_equal(a, b) for a, b in zip(outs[False],
                                                         outs[True])):
            raise AssertionError(f"lenet_{fw}: graph outputs differ from "
                                 "eager")
        kw = {"input_info": TensorsInfo([TensorInfo(
            TensorType.FLOAT32, (28, 28, 1, 1))])} if nchw else {}
        filt = {"framework": fw, "model": model, "custom": "compute:float32",
                **kw}
        with FilterSingle(accelerator="true:cpu", **filt) as single:
            cpu = single.invoke([frames[0]])[0]
        mf_f32_vs(f"lenet_{fw}", "cpu", [outs[False][0].reshape(-1)],
                  [cpu.reshape(-1)], MF_F32_PROB_ATOL)
        busy[f"lenet_{fw}"] = mf_busy(filt, frames[0],
                                      {"per_frame": fps[False]})
        firsts[fw] = outs[False][0].reshape(-1)
        rows[f"lenet_{fw}"] = {"launches": dict(_cuda.launches)}
    mf_f32_vs("lenet", "formats", list(firsts.values()),
              [firsts["tensorflow"]] * len(firsts), MF_F32_PROB_ATOL)
    return rows, busy


def run_host_backends(seed: int, card: str) -> dict:
    """python, lua, custom-easy and dummy, each in a string after the
    flagship's converter (host backends: numpy payloads, no graph on the
    card).  Returns each one's rate."""
    import numpy as np

    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.filter.backends.custom import (
        register_custom_easy, unregister_custom_easy)
    from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsInfo
    from nnstreamer_tpu_torch.tensor.types import TensorType

    py = os.path.join(MF_DIR, "invert.py")
    with open(py, "w") as f:
        f.write("class CustomFilter:\n"
                "    def getInputDim(self):\n"
                "        return [((3, 16, 16, 1), 'uint8')]\n"
                "    def getOutputDim(self):\n"
                "        return [((3, 16, 16, 1), 'uint8')]\n"
                "    def invoke(self, inputs):\n"
                "        return [255 - inputs[0]]\n")
    lua = os.path.join(MF_DIR, "invert.lua")
    with open(lua, "w") as f:
        f.write("inputTensorsInfo = {num=1, dim={{3, 16, 16, 1}}, "
                "type={'uint8'}}\n"
                "outputTensorsInfo = {num=1, dim={{3, 16, 16, 1}}, "
                "type={'uint8'}}\n"
                "function nnstreamer_invoke()\n"
                "  local i, o = input_tensor(1), output_tensor(1)\n"
                "  for k=1,768 do o[k] = 255 - i[k] end\n"
                "end\n")
    info = TensorsInfo([TensorInfo(TensorType.UINT8, (3, 16, 16, 1))])
    register_custom_easy("mf_invert", lambda ins: [255 - ins[0]], info, info)
    src = (f"videotestsrc num-buffers={MF_HOST_FRAMES} pattern=random "
           f"seed={seed} ! "
           "video/x-raw,format=RGB,width=16,height=16,framerate=30/1 ! "
           "tensor_converter ! ")
    rates = {}
    try:
        ref = parse_launch(src + "tensor_sink name=out")
        ref.run(timeout=60)
        frames = [b.np(0).copy() for b in ref.get("out").results]
        for name, filt in (("python", f"framework=python model={py}"),
                           ("lua", f"framework=lua model={lua}"),
                           ("custom-easy",
                            "framework=custom-easy model=mf_invert"),
                           ("dummy", "framework=dummy input=3:16:16:1 "
                            "inputtype=uint8 output=3:16:16:1 "
                            "outputtype=uint8")):
            stamps = []
            _cuda.reset_launches()
            p = parse_launch(src + f"tensor_filter {filt} ! "
                             "tensor_sink name=out")
            p.get("out").connect("new-data", lambda buf: stamps.append(
                time.perf_counter()))
            p.run(timeout=60)
            got = [b.np(0) for b in p.get("out").results]
            want = [np.zeros_like(x) if name == "dummy" else 255 - x
                    for x in frames]
            ok = len(got) == len(want) and all(
                np.array_equal(a.reshape(-1), b.reshape(-1))
                for a, b in zip(got, want))
            rates[name] = {"per_frame_fps": (len(stamps) - 1)
                           / (stamps[-1] - stamps[0]),
                           "graphs": dict(_cuda.graphs),
                           "launches": dict(_cuda.launches)}
            emit({"phase": "model_files", "path": name, "frames": len(got),
                  "outputs_equal": ok, **rates[name], "card": card})
            if not ok:
                raise AssertionError(f"{name}: outputs differ")
            if rates[name]["graphs"] or rates[name]["launches"]:
                raise AssertionError(f"{name}: a host backend ran work on "
                                     f"the card: {rates[name]}")
    finally:
        unregister_custom_easy("mf_invert")
    return rates


def run_transform_path(frames: int, card: str) -> None:
    """tensor_transform on device-resident frames, on the card, against
    the same string through numpy: every frame equal bit for bit, and the
    device run's frames left on the card."""
    import numpy as np
    import torch

    from nnstreamer_tpu_torch import parse_launch

    out = {}
    for acc in ("true", "false"):
        p = parse_launch(TRANSFORM_LAUNCH.format(frames=frames, acc=acc))
        t0 = time.perf_counter()
        p.run(timeout=600)
        wall = time.perf_counter() - t0
        results = p.get("out").results
        out[acc] = {"on_card": all(isinstance(b.tensors[0], torch.Tensor)
                                   and b.tensors[0].is_cuda
                                   for b in results),
                    "frames": [b.np(0) for b in results], "wall_s": wall}
    differ = [i for i, (a, b) in enumerate(zip(out["true"]["frames"],
                                               out["false"]["frames"]))
              if a.dtype != b.dtype or not np.array_equal(a, b)]
    emit({"phase": "transform_path", "frames": frames, "card": card,
          "shape": list(out["true"]["frames"][0].shape),
          "dtype": str(out["true"]["frames"][0].dtype),
          "device_frames_on_card": out["true"]["on_card"],
          "frames_equal": frames - len(differ),
          "wall_s": {"device": out["true"]["wall_s"],
                     "numpy": out["false"]["wall_s"]}})
    if differ or not out["true"]["on_card"] \
            or len(out["true"]["frames"]) != frames:
        raise AssertionError(f"transform_path: the device transform differs "
                             f"from numpy on frames {differ} (on the card: "
                             f"{out['true']['on_card']})")


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
#: hybrid_query: the topic under which the HYBRID serversrc advertises its
#: data address on the MQTT broker (``nns/query/<topic>``)
HYBRID_TOPIC = "mobilenet_v2"
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


def hybrid_client(broker_port: int, name: str):
    """A ``tensor_query_client connect-type=HYBRID`` that knows only the
    MQTT broker (its ``_server_address`` is the element's discovery)."""
    from nnstreamer_tpu_torch.query.client import TensorQueryClient

    return TensorQueryClient(name, **{
        "connect-type": "HYBRID", "dest-host": "127.0.0.1",
        "dest-port": broker_port, "topic": HYBRID_TOPIC, "timeout": 60.0})


def drive_query_clients(port: int, frames, hybrid=None) -> dict:
    """One synchronous ``QueryConnection`` a client, each in a thread,
    started together; every reply's logits (copied out of the pooled
    slab), round trips and the wall from the start to the last reply.
    ``hybrid``: the MQTT broker's port; each client then finds the
    server's address there (``port`` unused) and the ports found are
    returned."""
    import threading

    import numpy as np

    from nnstreamer_tpu_torch.query import QueryConnection
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    outs = [[None] * len(row) for row in frames]
    rtt, done, errors, start, found = [], [], [], [], []
    barrier = threading.Barrier(len(frames), timeout=120,
                                action=lambda: start.append(
                                    time.perf_counter()))

    def run(i):
        try:
            host, at = "127.0.0.1", port
            if hybrid is not None:
                host, at = hybrid_client(hybrid,
                                         f"c{i}")._server_address()
                found.append(at)
            conn = QueryConnection(host, at, timeout=120.0)
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
    done.sort()
    gaps = sorted((b - a) * 1e3 for a, b in zip(done, done[1:]))
    return {"outs": outs, "errors": errors, "replies": n,
            "found_ports": sorted(set(found)),
            "t0": start[0] if start else None,
            "t1": max(done) if done else None,
            "arrival_gap_p50_ms": statistics.median(gaps) if gaps else None,
            "arrival_gap_p90_ms": (gaps[int(0.9 * (len(gaps) - 1))]
                                   if gaps else None),
            "replies_per_s": (n / (max(done) - start[0]) if n and start
                              else 0.0),
            "rtt_p50_ms": statistics.median(rtt) * 1e3 if n else None,
            "rtt_p99_ms": rtt[min(n - 1, int(0.99 * n))] * 1e3 if n
            else None}


@contextlib.contextmanager
def query_server(sid: int, batch: str, frames, before_play=None,
                 tier=None, hybrid=None):
    """The server string (``batch``: QUERY_BATCH or "") started under the
    segment compiler's ``tier`` (None: the default), warmed with one frame
    from each client (the first cross-stream bucket captures the pad set),
    and stopped after: yields (pipeline, port).  ``hybrid``: the MQTT
    broker's port; the serversrc runs ``connect-type=HYBRID`` and
    advertises itself there, and the clients find it there."""
    from nnstreamer_tpu_torch import Pipeline, parse_launch
    from nnstreamer_tpu_torch.query import shutdown_server

    if hybrid is not None:
        batch += (f"connect-type=HYBRID dest-host=127.0.0.1 "
                  f"dest-port={hybrid} topic={HYBRID_TOPIC} ")
    p = parse_launch(QUERY_SERVER.format(sid=sid, batch=batch),
                     Pipeline(fuse=tier))
    if before_play is not None:
        before_play(p)
    p.play()
    try:
        port = p.get("qsrc").bound_port
        warm = drive_query_clients(port, [row[:1] for row in frames],
                                   hybrid)
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
                extra_frames=(), tier=None, hybrid=None) -> dict:
    """Serve the clients from the server string (``batch``: QUERY_BATCH
    or "") under ``tier`` (None: the default), then (``child_frames``)
    the README's client string through the port's CLI in a child process,
    or (``extra_frames``) those frames from one more connection; the row,
    the replies and what the server recorded (each bucket's captures, and
    the rows of the timed run's buckets).  ``hybrid``: the MQTT broker's
    port, through which the server and the clients find each other."""
    import numpy as np

    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.analysis import compileledger
    from nnstreamer_tpu_torch.query import QueryConnection
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    buckets, recording = [], [False]

    def record_buckets(p):
        qsrc = p.get("qsrc")

        def push(buf, pad=None, push=qsrc.push):
            # each bucket's rows by the (client, request) pixel, and the
            # captures once the bucket went through the pipeline (at the
            # source, so every tier is seen alike)
            xb = "nns_xbatch" in buf.extra
            t = buf.tensors[0]
            ids = t[:, 0, 0, :2].numpy() if xb else np.asarray(t)[None,
                                                                  0, 0, :2]
            ret = push(buf, pad)
            buckets.append({"xbatch": xb,
                            "rows": [tuple(int(v) for v in r) for r in ids]
                            if recording[0] else None,
                            "captures": _cuda.graphs["captures"]})
            return ret

        qsrc.push = push

    _cuda.reset_launches()
    compileledger.reset()
    child, extra = None, []
    sid = (9100 + bool(batch) + 2 * (tier == "xla")
           + 10 * (hybrid is not None))
    with query_server(sid, batch, frames, record_buckets, tier,
                      hybrid) as (p, port):
        recording[0] = True
        run, chain_us = traced_window(
            p, lambda: drive_query_clients(port, frames, hybrid))
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
        plans = p.planner.plans() if p.planner is not None else []
    launches, graphs = dict(_cuda.launches), dict(_cuda.graphs)
    phase = "query_serve" if hybrid is None else "hybrid_query"
    cleared = hybrid is None or hybrid_record(hybrid, 0.3) is None
    timed = [b for b in buckets if b["rows"]]
    row = {"phase": phase, "batch": 32 if batch else 1,
           "fuse": p.fuse_tier, "plans": plans,
           "clients": len(frames), "frames": sum(map(len, frames)),
           "replies": run["replies"],
           "replies_per_s": run["replies_per_s"],
           "rtt_p50_ms": run["rtt_p50_ms"], "rtt_p99_ms": run["rtt_p99_ms"],
           "first_to_last_s": run["t1"] - run["t0"],
           "arrival_gap_p50_ms": run["arrival_gap_p50_ms"],
           "arrival_gap_p90_ms": run["arrival_gap_p90_ms"],
           "wire_bytes_per_frame": {
               "in": transport_bytes("query", frames[0][0]),
               "out": transport_bytes("query", run["outs"][0][0])},
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
    if hybrid is not None:
        row.update(bound_port=port, found_ports=run["found_ports"],
                   record_cleared_at_stop=cleared)
    emit(row)
    if hybrid is not None and (run["found_ports"] != [port]
                               or not cleared):
        raise AssertionError(f"hybrid_query: clients found ports "
                             f"{run['found_ports']}, the server bound "
                             f"{port}; record cleared at stop: {cleared}")
    if run["errors"] or row["errors"] or row["shed"]:
        raise AssertionError(f"{phase} (batch {row['batch']}): "
                             f"{row['shed']} sheds, errors "
                             f"{run['errors'][:3]}, {evicted} evicted")
    if child is not None and (child.returncode or len(labels)
                              != child_frames):
        raise AssertionError(f"{phase}: the CLI client exited "
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


def check_served_graphs(graph: dict) -> None:
    """The graphs of a batched served run: one capture at open and the
    pad set at the first cross-stream bucket, none after; a replay a
    bucket and K1 once a replay (besides the captures' eager runs); the
    compile ledger's events; at least one bucket of several frames."""
    row, buckets = graph["row"], graph["buckets"]
    phase, graphs = row["phase"], row["graphs"]
    first_xb = next((j for j, b in enumerate(buckets) if b["xbatch"]), None)
    late_captures = ([b["captures"] for b in buckets[first_xb:]
                      if b["captures"] != QUERY_CAPTURES]
                     if first_xb is not None else ["no cross-stream bucket"])
    k1 = row["launches"].get("normalize_frame", 0)
    if late_captures or graphs.get("captures") != QUERY_CAPTURES:
        raise AssertionError(f"{phase}: graphs {graphs}, captures "
                             f"after the first bucket {late_captures[:4]}")
    if (graphs.get("replays") != row["buckets"]
            or k1 != graphs["captures"] + graphs["replays"]):
        raise AssertionError(f"{phase}: K1 launched {k1} times over "
                             f"{row['buckets']} buckets, graphs {graphs}")
    if row["compile_ledger"] != {"filter.jitexec.invoke": 1,
                                 "filter.jitexec.vmap": 7}:
        raise AssertionError(f"{phase}: compile ledger "
                             f"{row['compile_ledger']}")
    if not row["batched_buckets"]:
        raise AssertionError(f"{phase}: no bucket held more than one "
                             "frame")


def check_query_eager(frames, graph: dict, eager: bool = True,
                      phase: str = "graph_vs_eager") -> int:
    """Every bucket of the served run's timed clients, rebuilt from its
    frames, through the same model (eagerly; or, ``eager=False``, the
    filter's own graphs: the python tier's path): each served reply bit
    for bit (a bucket as ``invoke_stacked`` at capacity 32, a lone frame
    as ``invoke``), so a reply routed to the wrong client or request
    fails.  Returns the frames compared, which must be every frame
    sent."""
    import numpy as np

    from nnstreamer_tpu_torch.filter import FilterSingle

    subset = [b for b in graph["buckets"] if b["rows"]]
    differ, compared = [], 0
    with eager_filters(eager):
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
    emit({"phase": phase, "path": graph["row"]["phase"],
          "fuse": graph["row"]["fuse"], "against": "eager" if eager
          else "filter graphs", "buckets": len(subset), "frames": compared,
          "outputs_bit_equal": compared - len(differ)})
    sent = sum(map(len, frames))
    if differ or compared != sent:
        raise AssertionError(f"{graph['row']['phase']}: {compared} of "
                             f"{sent} replies "
                             f"replayed; served logits differ from the "
                             f"{'eager forward' if eager else 'filter graphs'}"
                             f" on frames {differ[:8]}")
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
    check_served_graphs(graph)
    xla = check_query_xla(frames, card)
    return {"launches": dict(collections.Counter(row["launches"])
                             + collections.Counter(xla["launches"])),
            "replies_per_s": row["replies_per_s"]}


#: the served pair's graphs under fuse=xla: the filter's own at open, and
#: the segment's at the first cross-stream bucket (the 7 pad shapes and a
#: lone frame's)
QUERY_XLA_CAPTURES = 1 + 7 + 1


def check_query_xla(frames, card: str) -> dict:
    """The query pair once more under ``fuse=xla`` (phase ``fuse_tiers``,
    path ``query_serve``): the serversrc's segment (the filter) lowered to
    one CUDA graph a signature, every bucket through ``run_stacked``.
    Checks: the plan row says ``xla``; 0 sheds and errors; the segment's
    8 graphs captured at the first cross-stream bucket and none after;
    every replay one of the segment's (replays = its cache hits) and K1
    launched once a replay besides the captures' eager runs; every reply
    bit for bit against its bucket through the filter's own graphs (the
    python tier's path)."""
    served = serve_query(QUERY_BATCH, frames, card, tier="xla")
    row = served["row"]
    graphs, k1 = row["graphs"], row["launches"].get("normalize_frame", 0)
    plans = [pl for pl in row["plans"] if pl["head"] == "qsrc.src"]
    buckets = served["buckets"]
    first_xb = next((j for j, b in enumerate(buckets) if b["xbatch"]), None)
    late = ([b["captures"] for b in buckets[first_xb:]
             if b["captures"] != QUERY_XLA_CAPTURES]
            if first_xb is not None else ["no cross-stream bucket"])
    compared = check_query_eager(frames, served, eager=False,
                                 phase="fuse_tiers_bits")
    seg = plans[0] if plans else {}
    emit({"phase": "fuse_tiers", "path": "query_serve", "fuse": "xla",
          "plans": row["plans"], "graphs": graphs, "launches":
          row["launches"], "compile_ledger": row["compile_ledger"],
          "buckets": row["buckets"], "replies_per_s": row["replies_per_s"],
          "rtt_p50_ms": row["rtt_p50_ms"], "rtt_p99_ms": row["rtt_p99_ms"],
          "mean_fill": row["mean_fill"], "frames_bit_equal_python_tier":
          compared, "card": card})
    if seg.get("lowering") != "xla" or "fallback" in seg:
        raise AssertionError(f"query_serve under xla: plans {row['plans']}")
    if late or graphs.get("captures") != QUERY_XLA_CAPTURES:
        raise AssertionError(f"query_serve under xla: graphs {graphs}, "
                             f"captures after the first bucket {late[:4]}")
    if graphs.get("replays") != seg["exec_cache_hits"] \
            or k1 != graphs["captures"] + graphs["replays"]:
        raise AssertionError(f"query_serve under xla: K1 launched {k1} "
                             f"times, graphs {graphs}, plan {seg}")
    if row["compile_ledger"] != {"filter.jitexec.invoke": 1,
                                 "pipeline.segment": 8}:
        raise AssertionError(f"query_serve under xla: compile ledger "
                             f"{row['compile_ledger']}")
    return {"launches": row["launches"]}


# ---------------------------------------------------------------------------
# the among-device transports
# ---------------------------------------------------------------------------

#: frames of each offload path (``source_frames(seed)``: the main path's)
OFFLOAD_FRAMES = 256
OFFLOAD_SOURCE = ("videotestsrc num-buffers={frames} pattern=random "
                  "seed={seed} ! video/x-raw,format=RGB,width=224,"
                  "height=224,framerate=30/1 ! tensor_converter ! {sink}")
OFFLOAD_CARD = ("{src} ! tensor_filter name=f framework=xla "
                "model=mobilenet_v2 custom=seed:{seed},use_pallas:1 ! "
                "{sink}")
OFFLOAD_TAIL = ("{src} ! tensor_decoder mode=image_labeling ! "
                "tensor_sink name=out")
OFFLOAD_KINDS = ("edge", "mqtt", "shm")
#: hops a frame makes: publisher -> broker -> subscriber, or one ring slot
OFFLOAD_HOPS = {"edge": 2, "mqtt": 2, "shm": 1}


def transport_bytes(kind: str, arr) -> int:
    """Bytes one frame of ``arr`` (one tensor) puts on one hop of a
    transport, from the port's own framing: the query wire's message
    (``edge``, ``query``), the MQTT PUBLISH with its 1024-byte header
    (``mqtt``), the ring slot with its 16-byte header (``shm``)."""
    from nnstreamer_tpu_torch.query import mqtt, protocol
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    parts = protocol.tensor_parts(TensorBuffer(tensors=[arr]))
    body = sum(memoryview(p).nbytes for p in parts)
    if kind in ("edge", "query"):
        return protocol.HEADER.size + body
    if kind == "shm":
        return 16 + body
    # topic "frames"/"logits": 2-byte length + 6 bytes
    remaining = 2 + 6 + mqtt.HDR_LEN + arr.nbytes
    return 1 + len(mqtt._remaining_len(remaining)) + remaining


def hybrid_record(broker_port: int, timeout: float):
    """The retained discovery record of HYBRID_TOPIC, or None."""
    from nnstreamer_tpu_torch.query.mqtt import fetch_retained_record

    return fetch_retained_record("127.0.0.1", broker_port,
                                 f"nns/query/{HYBRID_TOPIC}", timeout,
                                 "chip-smoke-check")


def _offload_producer(sink: str, frames: int, seed: int, out, go) -> None:
    """An offload's producer in a spawned child, CPU only: the source
    string into ``sink``, built, then reported ready, and played once
    ``go`` is set; reports the pts it sent, its own rate (first to last
    hand-over to the sink) and, for a ring, whether it was the native
    one with the scatter push bound."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    sys.path.insert(0, HERE)
    from nnstreamer_tpu_torch import native, parse_launch

    native.available()
    p = parse_launch(OFFLOAD_SOURCE.format(frames=frames, seed=seed,
                                           sink=sink))
    stamps = []
    pts = tap_pts(p.get("tx"), stamps)
    out.put("ready")
    if not go.wait(timeout=600):
        raise TimeoutError("offload producer: no start signal")
    p.play()
    try:
        p.wait(timeout=600)
        report = {"pts": pts, "fps": (len(stamps) - 1)
                  / (stamps[-1] - stamps[0])}
        ring = getattr(p.get("tx"), "_ring", None)
        if ring is not None:
            report.update(native=ring.is_native,
                          push2=hasattr(ring._lib, "tw_shm_push2"))
        out.put(report)
    finally:
        p.stop()


def tap_pts(sink, stamps=None) -> list:
    """The pts of every buffer ``sink`` takes, in order (a wrapper of its
    ``chain``); ``stamps`` also gets the time of each."""
    seen = []

    def chain(pad, buf, chain=sink.chain):
        seen.append(buf.pts)
        if stamps is not None:
            stamps.append(time.perf_counter())
        return chain(pad, buf)

    sink.chain = chain
    return seen


def start_producer(sink: str, frames: int, seed: int):
    """Spawn an offload's producer (``_offload_producer``) now; its
    start-up (a fresh interpreter, torch's import) runs while the caller
    goes on.  Returns ``(process, out, go)``."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    out, go = ctx.Queue(), ctx.Event()
    proc = ctx.Process(target=_offload_producer,
                       args=(sink, frames, seed, out, go))
    proc.start()
    return proc, out, go


def ring_ends(what: str):
    """shm_offload's element strings (sink, src) of the ``frames`` or
    ``logits`` ring, a name unique to this process."""
    name = f"nns-offload-{what}-{os.getpid()}"
    return (f"tensor_shm_sink name=tx path={name} timeout=120",
            f"tensor_shm_src name=rx path={name} timeout=120")


@contextlib.contextmanager
def offload_ends(kind: str):
    """The broker or ring names of one offload run, released after:
    yields ``(ends, broker)``, ``ends(what, frames) -> (sink, src)`` the
    element strings of the ``frames`` and ``logits`` streams."""
    from nnstreamer_tpu_torch.query.edge import EdgeBroker
    from nnstreamer_tpu_torch.query.mqtt import MqttBroker

    broker = {"edge": EdgeBroker, "mqtt": MqttBroker}.get(kind,
                                                          lambda: None)()

    def ends(what: str, frames: int):
        if kind == "edge":
            return (f"edge_sink name=tx port={broker.port} topic={what}",
                    f"edge_src name=rx port={broker.port} topic={what} "
                    f"num-buffers={frames}")
        if kind == "mqtt":
            return (f"mqttsink name=tx port={broker.port} pub-topic={what}",
                    f"mqttsrc name=rx port={broker.port} sub-topic={what} "
                    f"num-buffers={frames}")
        return ring_ends(what)

    try:
        yield ends, broker
    finally:
        if broker is not None:
            broker.close()
        for what in ("frames", "logits"):
            with contextlib.suppress(OSError):
                os.unlink(f"/dev/shm/nns-offload-{what}-{os.getpid()}")


def wait_subscribed(kind: str, broker, topics) -> None:
    """An edge broker registers a subscription on its own thread: wait
    until it holds one for each topic (a publish before that is lost:
    pub/sub is QoS 0).  MQTT subscribes synchronously (SUBACK)."""
    if kind != "edge":
        return
    deadline = time.monotonic() + 30
    while not all(broker._subs.get(t) for t in topics):
        if time.monotonic() > deadline:
            raise AssertionError(f"edge_offload: no subscription on "
                                 f"{topics}")
        time.sleep(0.001)


def drive_offload(kind: str, frames: int, seed: int, eager: bool = False,
                  during=None, producer_child=None, spawned=None) -> dict:
    """The three offload pipelines of ``kind``: the source string into the
    transport (``frames``), ``src ! tensor_filter model=mobilenet_v2 !
    sink`` on the card (``frames`` -> ``logits``), and ``src !
    tensor_decoder ! tensor_sink`` (edge, mqtt: in this process through
    one in-process broker; shm, or ``producer_child``: the producer in a
    spawned child, CPU only).  Records what the card's filter handed its
    sink (pts and the logits, still on the card) and what the tail's
    source received (pts, logits on the host), the tail sink's arrival
    stamps and labels, the graphs and launches of the run, the producer's
    own rate (a child's) and, for shm, whether each end's ring was
    native.  ``during(wait, stamps)``: called once the first frame
    reached the tail sink, with a function that waits for the end (the
    profile's window).  ``spawned``: the child producer, already started
    by ``start_producer`` (its start-up then overlaps earlier work)."""
    import numpy as np

    from nnstreamer_tpu_torch import _cuda, native, parse_launch
    from nnstreamer_tpu_torch.analysis import compileledger

    native.available()
    if producer_child is None:
        producer_child = kind == "shm"
    sent, got, stamps, labels, captures_at = [], [], [], [], []
    producer, released = None, False
    with offload_ends(kind) as (ends, broker):
        frames_sink, frames_src = ends("frames", frames)
        logits_sink, logits_src = ends("logits", frames)
        if producer_child and spawned is None:
            spawned = start_producer(frames_sink, frames, seed)
        child, out, go = spawned if producer_child else (None, None, None)
        tail = parse_launch(OFFLOAD_TAIL.format(src=logits_src))
        on_card = parse_launch(OFFLOAD_CARD.format(src=frames_src,
                                                   sink=logits_sink,
                                                   seed=seed))
        source = (parse_launch(OFFLOAD_SOURCE.format(
            frames=frames, seed=seed, sink=frames_sink))
            if not producer_child else None)
        card_tx, tail_rx = on_card.get("tx"), tail.get("rx")

        def handed(pad, buf, chain=card_tx.chain):
            sent.append((buf.pts, buf.tensors[0]))
            return chain(pad, buf)

        def received(create=tail_rx.create):
            buf = create()
            if buf is not None:
                got.append((buf.pts, np.array(buf.np(0))))
            return buf

        def arrived(buf):
            stamps.append(time.perf_counter())
            labels.append(buf.extra.get("index"))
            captures_at.append(_cuda.graphs["captures"])

        card_tx.chain, tail_rx.create = handed, received
        tail.get("out").connect("new-data", arrived)
        source_pts = [] if source is None else tap_pts(source.get("tx"))
        _cuda.reset_launches()
        compileledger.reset()
        pipelines = [p for p in (tail, on_card, source) if p is not None]
        native_ends = {}
        try:
            with eager_filters(eager):
                tail.play()
                on_card.play()
                wait_subscribed(kind, broker, ("frames", "logits"))
                if source is not None:
                    source.play()
                else:
                    if out.get(timeout=600) != "ready":
                        raise AssertionError(f"{kind}_offload: the "
                                             "producer did not start")
                    go.set()
                    released = True

                def wait():
                    for p in pipelines:
                        p.wait(timeout=600)

                if during is not None:
                    deadline = time.monotonic() + 600
                    while not stamps and time.monotonic() < deadline:
                        time.sleep(0.001)
                    during(wait, stamps)
                else:
                    wait()
                if child is not None:
                    producer = out.get(timeout=600)
                    source_pts = producer.pop("pts")
                if kind == "shm":
                    native_ends = {
                        "producer": {k: producer[k]
                                     for k in ("native", "push2")},
                        "card_src": on_card.get("rx")._ring.is_native,
                        "card_sink": card_tx._ring.is_native,
                        "tail_src": tail_rx._ring.is_native}
        finally:
            for p in reversed(pipelines):
                p.stop()
            if child is not None:
                # a producer never released waits on ``go``: end it now
                child.join(timeout=60 if released else 1)
                if child.is_alive():
                    child.kill()
                    child.join(timeout=10)
    return {"source_pts": source_pts, "sent": sent, "got": got,
            "stamps": stamps, "labels": labels,
            "captures_at": captures_at, "native": native_ends,
            "launches": dict(_cuda.launches), "graphs": dict(_cuda.graphs),
            "compile_ledger": compileledger.snapshot(),
            "producer_fps": producer and producer["fps"],
            "child_rc": None if child is None else child.exitcode}


def offload_delivery(run: dict, frames: int) -> dict:
    """An offload run's arrivals at the decoding end (fps first to last,
    p50/p90 gap) and whether it was lossless: ``in_order`` (every frame
    once and in order: the source's rising pts on both hops) and
    ``logits_bit_equal`` (frames whose logits the tail received equal,
    byte for byte, those the card's filter handed its sink)."""
    import numpy as np

    from nnstreamer_tpu_torch.tensor.buffer import to_host

    want_pts = run["source_pts"]
    stamps = run["stamps"]
    gaps = sorted((b - a) * 1e3 for a, b in zip(stamps, stamps[1:]))
    return {
        "arrived": len(stamps),
        "fps": (len(stamps) - 1) / (stamps[-1] - stamps[0])
        if len(stamps) > 1 else 0.0,
        "first_to_last_s": stamps[-1] - stamps[0] if stamps else None,
        "p50_ms": statistics.median(gaps) if gaps else None,
        "p90_ms": gaps[int(0.9 * (len(gaps) - 1))] if gaps else None,
        "in_order": ([pts for pts, _ in run["sent"]] == want_pts
                     == [pts for pts, _ in run["got"]]
                     and len(want_pts) == len(stamps) == frames
                     and want_pts == sorted(set(want_pts))),
        "logits_bit_equal": sum(
            got.dtype == np.float32 and got.shape == (1001,)
            and bool(np.isfinite(got).all())
            and to_host(t).tobytes() == got.tobytes()
            for (_, t), (_, got) in zip(run["sent"], run["got"]))}


def check_offload(kind: str, run: dict, frames: int, reference: dict,
                  card: str) -> dict:
    """One offload run's row and checks: every frame arrived, in order
    and once, with its logits byte-equal (``offload_delivery``); the
    labels equal the flagship per-frame path's on the same frames
    (``reference``, run in this call); one capture (the filter's open;
    no pushdown, the decoder is in another pipeline) before the first
    arrival, a replay a frame and K1 once a replay; for shm, every end
    on the native ring with ``tw_shm_push2`` bound."""
    import numpy as np

    phase = f"{kind}_offload"
    delivery = offload_delivery(run, frames)
    labels_equal = sum(a == b for a, b in zip(run["labels"],
                                              reference["labels"]))
    launches, graphs = run["launches"], run["graphs"]
    k1 = launches.get("normalize_frame", 0)
    row = {"phase": phase, "frames": frames, **delivery,
           "flagship_b1_fps": reference["fps"],
           "wire_bytes_per_frame": {
               "in": transport_bytes(kind, np.zeros((224, 224, 3),
                                                    np.uint8)),
               "out": transport_bytes(kind, np.zeros(1001, np.float32))},
           "hops": OFFLOAD_HOPS[kind], "labels_equal_flagship":
           labels_equal, "launches": launches, "graphs": graphs,
           "compile_ledger": run["compile_ledger"], "card": card}
    if kind == "shm":
        row.update(native=run["native"], producer_fps=run["producer_fps"],
                   producer_rc=run["child_rc"])
    emit(row)
    if not delivery["in_order"]:
        raise AssertionError(f"{phase}: {len(run['sent'])} frames reached "
                             f"the card's sink, {len(run['got'])} the "
                             f"tail, {delivery['arrived']} its sink, of "
                             f"{frames}, or not once each in order")
    if delivery["logits_bit_equal"] != frames or labels_equal != frames:
        raise AssertionError(f"{phase}: logits byte-equal on "
                             f"{delivery['logits_bit_equal']}, labels "
                             f"equal to the flagship on {labels_equal} of "
                             f"{frames}")
    if graphs != graph_counts(False, 1, frames) or k1 != 1 + frames \
            or any(c != 1 for c in run["captures_at"]):
        raise AssertionError(f"{phase}: graphs {graphs}, K1 {k1}, "
                             f"expected 1 capture before the first "
                             f"arrival and {frames} replays")
    if run["compile_ledger"] != {"filter.jitexec.invoke": 1}:
        raise AssertionError(f"{phase}: compile ledger "
                             f"{run['compile_ledger']}")
    if kind == "shm":
        native = run["native"]
        if run["child_rc"] != 0 or native["producer"] != {
                "native": True, "push2": True} or not all(
                native[k] for k in ("card_src", "card_sink", "tail_src")):
            raise AssertionError(f"shm_offload: not every end ran the "
                                 f"native ring: {native}, producer exit "
                                 f"{run['child_rc']}")
    return {"launches": launches, "fps": row["fps"]}


def run_hybrid_query(args, card: str) -> dict:
    """query_serve's batched pair, 32 clients x 16 frames, with
    ``connect-type=HYBRID`` on the serversrc and every client, through
    the port's MQTT broker: each client finds the server's address there
    (``TensorQueryClient._server_address``, the element's discovery);
    every reply bit for bit against its bucket replayed eagerly; the
    graphs, K1 and ledger of query_serve; the record cleared when the
    server stops."""
    from nnstreamer_tpu_torch.query.mqtt import MqttBroker

    frames = query_frames(args.seed)
    broker = MqttBroker()
    try:
        graph = serve_query(QUERY_BATCH, frames, card, hybrid=broker.port)
    finally:
        broker.close()
    check_query_eager(frames, graph)
    check_served_graphs(graph)
    return {"launches": graph["row"]["launches"]}


def run_transports(args, card: str) -> dict:
    """The flagship per-frame path on OFFLOAD_FRAMES frames (the
    reference of every offload's labels, and its fps beside theirs), then
    ``edge_offload``, ``mqtt_offload``, ``shm_offload`` and
    ``hybrid_query``; each path's launches."""
    # the shm producer's child starts first: its start-up (a fresh
    # interpreter importing torch) overlaps the paths before it
    shm = start_producer(ring_ends("frames")[0], OFFLOAD_FRAMES, args.seed)
    try:
        reference = run_labeling("offload_reference", LAUNCH,
                                 OFFLOAD_FRAMES, args.seed, card,
                                 "normalize_frame", 1)
        paths = {"offload_reference": reference}
        for kind in OFFLOAD_KINDS:
            run = drive_offload(kind, OFFLOAD_FRAMES, args.seed,
                                spawned=shm if kind == "shm" else None)
            paths[f"{kind}_offload"] = check_offload(
                kind, run, OFFLOAD_FRAMES, reference, card)
    finally:
        if shm[0].is_alive():      # an earlier path failed
            shm[0].kill()
            shm[0].join(timeout=10)
    paths["hybrid_query"] = run_hybrid_query(args, card)
    return paths


#: the pace variants of the offloads (``--profile``): the producer in a
#: child process of its own (the card process's interpreter lock no
#: longer shared with the source), and the edge wire without its CRC-32C
#: (the sender's, the broker's and the subscriber's pass over each frame)
OFFLOAD_PACE = (("edge", "producer_child"), ("mqtt", "producer_child"),
                ("edge", "no_crc"))


def run_offload_pace(seed: int, card: str) -> None:
    """What sets the pace of the edge and MQTT offloads (with
    ``--profile``): each OFFLOAD_PACE variant in turns with the default
    path (default, variant, variant, default), a row a run with its fps,
    gaps and the producer's own rate; every run must stay lossless."""
    from nnstreamer_tpu_torch.query import protocol

    for kind, variant in OFFLOAD_PACE:
        # default, variant, variant, default
        for turn, on in enumerate(MODE_TURNS):
            if on and variant == "no_crc":
                protocol._CRC_FN = False
            try:
                run = drive_offload(kind, OFFLOAD_FRAMES, seed,
                                    producer_child=on and variant
                                    == "producer_child")
            finally:
                protocol._CRC_FN = None
            delivery = offload_delivery(run, OFFLOAD_FRAMES)
            emit({"phase": "offload_pace", "path": f"{kind}_offload",
                  "variant": variant if on else "default", "turn": turn,
                  **delivery, "producer_fps": run["producer_fps"],
                  "card": card})
            if not delivery["in_order"] \
                    or delivery["logits_bit_equal"] != OFFLOAD_FRAMES:
                raise AssertionError(f"offload_pace ({kind}, {variant}): "
                                     "not lossless")


def profile_offload(kind: str, seed: int, out_dir: str, eager: bool,
                    turn: int) -> dict:
    """Trace an offload path in one mode: the window opens once the first
    frame reached the tail sink (the filter has opened and captured by
    then) and closes at the end of the run; a unit is a frame that
    reached the tail sink inside it."""
    mode = "eager" if eager else "graph"
    rows = []

    def during(wait, stamps):
        window = {}

        def units(t0, t1):
            window.update(_latency(stamps, t0, t1))
            return sum(t0 <= t <= t1 for t in stamps)

        rows.append(trace(f"{kind}_offload_{mode}{turn}", out_dir, wait,
                          units, "normalize_frame_kernel", 1))
        rows[0].update(window)

    drive_offload(kind, OFFLOAD_FRAMES, seed, eager, during)
    row = rows[0]
    row.update(path=f"{kind}_offload", mode=mode, turn=turn)
    emit(row)
    return row


def profile_hybrid_query(seed: int, out_dir: str, eager: bool,
                         turn: int) -> dict:
    """profile_query_serve's trace of the batched pair, with the server
    and its clients meeting through the MQTT broker (HYBRID)."""
    from nnstreamer_tpu_torch.query.mqtt import MqttBroker

    broker = MqttBroker()
    try:
        return profile_query_serve(seed, out_dir, eager, turn,
                                   hybrid=broker.port)
    finally:
        broker.close()


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
# the LLM serving tier: tensor_llm over the query plane
# ---------------------------------------------------------------------------

#: the request frame: [prompt_len, max_new, stop_token] and room for 320
#: prompt tokens (SERVE_PROMPTS reach 300)
LLM_REQ = 3 + 320
LLM_CAPS = ("other/tensors,format=static,num_tensors=1,"
            f"dimensions={LLM_REQ},types=int32,framerate=0/1")
LLM_DENSE = "slots=8 batch=8 max-new-tokens=64"
#: an arena byte-identical to the dense pool's: (8 + 1) x 2048 / 16 - 1
#: pages and the scratch page, for 4x the resident sessions
LLM_PAGED = ("slots=32 batch=8 max-new-tokens=64 page-size=16 pages=1151 "
             "prefill-chunk=32 prefix-cache=1")
#: a request waits for a slot instead of shedding (16 clients share the
#: dense pool's 8 slots); the clients are gold, whose slot admission
#: sheds only at the hard no-free-slot boundary
LLM_WAIT = "admit-timeout-ms=120000"
LLM_SERVER = ("tensor_query_serversrc name=qsrc id={sid} port={port} "
              f"caps={LLM_CAPS} ! tensor_llm name={{name}} "
              "custom={custom} seed={seed} {props} " + LLM_WAIT
              + " id={sid} ! tensor_query_serversink name=qsink id={sid}")


def llm_server(sid: int, port: int, name: str, props: str, seed: int,
               custom: str = "") -> str:
    return LLM_SERVER.format(sid=sid, port=port, name=name, props=props,
                             seed=seed, custom=custom or llm_custom())
#: client connections, requests each (one after the other) and new tokens
#: a request
LLM_CLIENTS = 16
LLM_REQUESTS = 4
LLM_NEW = 32
#: phase B's shared system prompt: 8 full 16-token pages
LLM_SYSTEM = 128
#: the f32 served runs (exactness): clients, requests each, new tokens
LLM_F32 = (4, 2, 16)
#: graphs tensor_llm captures in start(): dense, 4 lane buckets x (a
#: step) + 9 prompt buckets; paged, 4 lane buckets x 8 table widths + the
#: 32-token chunk at the 7 widths that hold it
LLM_WARM = {"dense": {"llm.engine.step": 4, "llm.engine.prefill": 9},
            "paged": {"llm.engine.pstep": 32, "llm.engine.chunk": 7}}


def llm_custom(dtype=None) -> str:
    custom = {**LM_CUSTOM, "max_seq": str(LM_SEQ)}
    if dtype:
        custom["dtype"] = dtype
    return ",".join(f"{k}:{v}" for k, v in custom.items())


def llm_jobs(seed: int, clients: int, requests: int, system: bool):
    """Each client's prompts: SERVE_PROMPTS' lengths in turn, unique
    tokens; or (``system``) one shared LLM_SYSTEM-token system prompt and
    a unique 16-64-token tail."""
    import numpy as np

    vocab = int(LM_CUSTOM["vocab"])
    rng = np.random.default_rng(seed + (3 if system else 2))
    shared = rng.integers(0, vocab, LLM_SYSTEM)
    jobs = []
    for i in range(clients):
        row = []
        for k in range(requests):
            if system:
                tail = rng.integers(0, vocab, int(rng.integers(16, 65)))
                row.append(np.concatenate([shared, tail]).astype(np.int32))
            else:
                n = SERVE_PROMPTS[(i * requests + k) % len(SERVE_PROMPTS)]
                row.append(rng.integers(0, vocab, n).astype(np.int32))
        jobs.append(row)
    return jobs


def drive_token_clients(port: int, jobs, new: int) -> dict:
    """One ``TokenStreamClient`` (gold) a client, each in a thread,
    started together, sending its requests one after the other; each
    stream (order-checked by the client) and the wall from the start to
    the last token."""
    import threading

    from nnstreamer_tpu_torch.llm import TokenStreamClient

    from nnstreamer_tpu_torch.obs.clock import mono_ns

    streams = [[None] * len(row) for row in jobs]
    ttft_ms, errors, start, done = [], [], [], []
    barrier = threading.Barrier(len(jobs), timeout=300,
                                action=lambda: start.append(
                                    time.perf_counter()))

    def run(i):
        try:
            cli = TokenStreamClient("127.0.0.1", port, timeout=300.0,
                                    qos="gold").connect()
        except Exception as exc:  # noqa: BLE001 - counted and raised below
            errors.append(repr(exc))
            barrier.abort()
            return
        try:
            barrier.wait()
            for k, prompt in enumerate(jobs[i]):
                sent = mono_ns()
                streams[i][k] = cli.generate(prompt, new,
                                             frame_len=LLM_REQ)
                ttft_ms.append((cli.stamps_ns[0] - sent) / 1e6)
            done.append(time.perf_counter())
        except Exception as exc:  # noqa: BLE001 - counted and raised below
            errors.append(repr(exc))
        finally:
            cli.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if any(t.is_alive() for t in threads):
        raise AssertionError("llm_stream: a client thread hung")
    tokens = sum(len(s) for row in streams for s in row if s)
    wall = (max(done) - start[0]) if done and start else 0.0
    ttft_ms.sort()
    n = len(ttft_ms)
    return {"streams": streams, "errors": errors, "tokens": tokens,
            "wall_s": wall, "tok_s": tokens / wall if wall else 0.0,
            "client_ttft_p50_ms": statistics.median(ttft_ms) if n else None,
            "client_ttft_p99_ms": ttft_ms[min(n - 1, int(0.99 * n))]
            if n else None}


class _PeakResident:
    """Polls a pool's resident sessions every millisecond in a thread;
    ``peak`` is the most seen."""

    def __init__(self, pool) -> None:
        import threading

        self.pool, self.peak = pool, 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(0.001):
            self.peak = max(self.peak, self.pool.live)

    def close(self) -> int:
        self._stop.set()
        self._thread.join(timeout=10)
        return self.peak


def _hist_counts(tobs, family: str):
    return list(tobs._hist(family, "gold").state()[2])


def serve_llm(mode: str, props: str, parts, seed: int, card: str, sid: int,
              new: int = LLM_NEW, custom: str = "", traced: bool = True
              ) -> dict:
    """Serve ``parts`` (``[(part, jobs)]``, one after the other) from the
    ``tensor_llm`` string in ``mode`` (``props``: LLM_DENSE or LLM_PAGED)
    in this process; each part's row: served tok/s, TTFT and ITL p50/p99
    (the element's ``TokenObs`` histograms), mean decode fill, peak
    resident sessions, prefix hits and tokens reused, and (``traced``) the
    serversink's time a token from a counters-only tracer.  Returns the
    rows, every part's prompts and streams, the run's launches, graphs
    and ledgers, and the served parameters."""
    import numpy as np

    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.analysis import compileledger
    from nnstreamer_tpu_torch.llm.tokenobs import ITL_US, TTFT_US
    from nnstreamer_tpu_torch.obs.metrics import quantile_from_counts
    from nnstreamer_tpu_torch.query import shutdown_server

    name = f"llm_{mode}"
    p = parse_launch(llm_server(sid, 0, name, props, seed, custom))
    compileledger.reset()
    t0 = time.perf_counter()
    p.play()
    out = {"warmup_s": time.perf_counter() - t0,
           "compile_ledger": compileledger.snapshot(), "rows": [],
           "prompts": [], "streams": []}
    llm = p.get(name)
    eng, pool, tobs = llm.engine, llm.pool, llm._tok_obs
    _cuda.reset_launches()
    compileledger.reset()
    port = p.get("qsrc").bound_port
    peak = None
    try:
        for part, jobs in parts:
            before = {"steps": eng.steps_total, "fill": eng.step_tokens,
                      "stats": pool.stats() if eng.paged else {},
                      TTFT_US: _hist_counts(tobs, TTFT_US),
                      ITL_US: _hist_counts(tobs, ITL_US)}
            peak = _PeakResident(pool)
            if traced:
                run, chain_us = traced_window(
                    p, lambda: drive_token_clients(port, jobs, new))
            else:
                run, chain_us = drive_token_clients(port, jobs, new), {}
            row = {"phase": "llm_stream", "mode": mode, "part": part,
                   "clients": len(jobs),
                   "sessions": sum(map(len, jobs)), "new": new,
                   "tokens": run["tokens"], "served_tok_s": run["tok_s"],
                   "wall_s": run["wall_s"], "errors": run["errors"][:3],
                   "client_ttft_p50_ms": run["client_ttft_p50_ms"],
                   "client_ttft_p99_ms": run["client_ttft_p99_ms"],
                   "peak_resident": peak.close(),
                   "steps": eng.steps_total - before["steps"],
                   "mean_fill": (eng.step_tokens - before["fill"])
                   / max(1, eng.steps_total - before["steps"]),
                   "sink_us_per_token": chain_us.get("qsink")}
            peak = None
            for key, family in (("ttft", TTFT_US), ("itl", ITL_US)):
                counts = [a - b for a, b in zip(_hist_counts(tobs, family),
                                                before[family])]
                for q in (0.5, 0.99):
                    row[f"{key}_p{round(q * 100)}_ms"] = (
                        quantile_from_counts(counts, q) / 1e3
                        if sum(counts) else None)
            if eng.paged:
                now = pool.stats()
                row.update({k: now[k] - before["stats"][k] for k in (
                    "prefix_hits", "prefix_misses", "prefix_tokens_reused",
                    "pages_reclaimed")})
            out["rows"].append(row)
            out["prompts"] += [pr for r in jobs for pr in r]
            out["streams"] += [s for r in run["streams"] for s in r]
            if run["errors"]:
                raise AssertionError(f"llm_stream ({mode}, {part}): client "
                                     f"errors {run['errors'][:3]}")
        counters = p.get("qsrc").server.counters()
        out.update(
            launches=dict(_cuda.launches), graphs=dict(_cuda.graphs),
            window_ledger=compileledger.snapshot(), shed=llm.shed_total,
            wire_shed=sum(counters["shed"].values()),
            evicted=llm.evicted_total, rejected=llm.rejected_total,
            arena_bytes=pool.cache_bytes(), engine=eng.report(),
            params=eng.params, cfg=eng.cfg,
            warm_set=[len(eng._step_fns), len(eng._prefill_fns)])
    finally:
        if peak is not None:
            peak.close()
        p.stop()
        shutdown_server(sid)
    out["leaks"] = pool.check_leaks() if eng.paged else []
    out["live_after_stop"] = pool.live
    for row in out["rows"]:
        row.update(arena_bytes=out["arena_bytes"], card=card)
        emit(row)
    return out


def teacher_forced(params, cfg, prompts, streams):
    """Each served stream teacher-forced through the plain-attention
    forward (its prompt and its own tokens but the last): at the
    positions where that forward's top-2 margin exceeds MARGIN, how many
    greedy choices were compared and how many differ."""
    import torch

    from nnstreamer_tpu_torch.models.streamformer_lm import forward_logits

    device = params["embed"].device
    compared = differ = 0
    with torch.inference_mode():
        for prompt, toks in zip(prompts, streams):
            seq = torch.as_tensor(list(prompt) + list(toks[:-1]),
                                  device=device)
            logits = forward_logits(params, seq, cfg, flash=False)
            top = logits[len(prompt) - 1:].float().topk(2, dim=-1)
            sure = (top.values[:, 0] - top.values[:, 1]) > MARGIN
            served = torch.as_tensor(toks, device=device)
            compared += int(sure.sum())
            differ += int(((top.indices[:, 0] != served) & sure).sum())
    return compared, differ


def llm_scripted_paged(params, cfg, seed: int, eager: bool) -> dict:
    """A scripted paged engine at the served width (the element's paged
    sizing, 8 lanes, 32-token chunks), in a fixed order: a 300-token
    prompt prefilled whole (every chunk inline), a 100-token one chunked
    between decode steps, a 168-token one (a 128-token system prompt)
    whole, and at the 4th step a 148-token one on the same system prompt,
    a prefix hit, chunked; 24 tokens each.  Every dispatch's logits (each
    prefill's last, each step's) and the streams."""
    import numpy as np

    from nnstreamer_tpu_torch.llm import DecodeEngine, PagedKVCachePool

    pool = PagedKVCachePool(cfg, 1151, 16, slots=32,
                            device=params["embed"].device)
    eng = DecodeEngine(params, cfg, pool, capacity=8, chunk=32)
    eng._eager = eager
    eng.warmup()
    rng = np.random.default_rng(seed + 5)
    system = rng.integers(0, cfg.vocab, LLM_SYSTEM)
    prompts = [rng.integers(0, cfg.vocab, 300), rng.integers(0, cfg.vocab,
                                                             100),
               np.concatenate([system, rng.integers(0, cfg.vocab, 40)]),
               np.concatenate([system, rng.integers(0, cfg.vocab, 20)])]
    new, logits, streams = 24, [], {}

    def first(s, tok):
        s.next_token = tok
        streams[s.key] = [tok]
        logits.append(eng.last_logits.copy())

    def admit(i, whole):
        s = pool.acquire(i, prompt=prompts[i].astype(np.int32), max_new=new)
        if whole:
            first(s, eng.prefill(s, prompts[i]))

    admit(0, True)
    admit(1, False)
    admit(2, True)
    step = 0
    while step < 4 or any(len(streams.get(s.key, ())) < new
                          for s in pool.sessions()):
        if step == 4:
            admit(3, False)
        ready = [s for s in pool.sessions()
                 if not s.prefilling and len(streams[s.key]) < new]
        if ready:
            for s, tok in zip(ready, eng.step(ready)):
                streams[s.key].append(tok)
                s.next_token = tok
            logits.append(eng.last_logits.copy())
        waiting = [s for s in pool.sessions() if s.prefilling]
        if waiting:
            tok = eng.prefill_chunk_step(waiting[0])
            if tok is not None:
                first(waiting[0], tok)
        step += 1
    hits, reused = pool.prefix_hits, pool.prefix_tokens_reused
    for s in pool.sessions():
        pool.release(s.key)
    return {"streams": [streams[i] for i in range(4)], "logits": logits,
            "prefix_hits": hits, "prefix_tokens_reused": reused,
            "leaks": pool.check_leaks(), "chunks": eng.prefill_chunks_total}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def llm_cli_stream(seed: int, prompt, card: str) -> dict:
    """The dense string served by ``python -m nnstreamer_tpu_torch.launch``
    in a child process, one more client's stream from it, then SIGTERM
    (the CLI drains and exits 0)."""
    import signal

    from nnstreamer_tpu_torch.llm import TokenStreamClient

    port = free_port()
    launch = llm_server(9310, port, "llm", LLM_DENSE, seed)
    child = subprocess.Popen(
        [sys.executable, "-m", "nnstreamer_tpu_torch.launch", launch,
         "--timeout", "900", "--quiet"], cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while True:
            if child.poll() is not None:
                raise AssertionError(f"llm_stream: the CLI server exited "
                                     f"{child.returncode}: "
                                     f"{child.stderr.read()[-800:]}")
            try:
                cli = TokenStreamClient("127.0.0.1", port, timeout=300.0,
                                        qos="gold").connect()
                break
            except OSError:
                if time.perf_counter() - t0 > 300:
                    raise
                time.sleep(0.5)
        try:
            toks = cli.generate(prompt, LLM_NEW, frame_len=LLM_REQ)
        finally:
            cli.close()
        took = time.perf_counter() - t0
        child.send_signal(signal.SIGTERM)
        _, err = child.communicate(timeout=120)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    return {"tokens": toks, "rc": child.returncode, "stderr": err[-800:],
            "start_to_stream_s": took}


def run_llm_stream(seed: int, card: str) -> dict:
    """``tensor_query_serversrc ! tensor_llm ! tensor_query_serversink``
    at the LM's full width in bf16, dense (LLM_DENSE: prefill through
    K2) and paged (LLM_PAGED: phase A, the dense mix; phase B, one shared
    system prompt), 16 clients x 4 requests x 32 tokens each; then the
    same strings in f32 at LLM_F32's load, a scripted paged engine in
    graph and eager mode, and the dense string through the CLI."""
    import numpy as np
    import torch

    mix = llm_jobs(seed, LLM_CLIENTS, LLM_REQUESTS, system=False)
    dense = serve_llm("dense", LLM_DENSE, [("mix", mix)], seed, card, 9300)
    paged = serve_llm("paged", LLM_PAGED, [
        ("A", mix),
        ("B", llm_jobs(seed, LLM_CLIENTS, LLM_REQUESTS, system=True))],
        seed, card, 9301)
    params, cfg = dense["params"], dense["cfg"]
    n_dense = len(dense["prompts"])
    bf16 = {mode: teacher_forced(params, cfg, run["prompts"],
                                 run["streams"])
            for mode, run in (("dense", dense), ("paged", paged))}

    allow = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        clients, requests, new = LLM_F32
        small = llm_jobs(seed, clients, requests, system=False)
        f32 = {}
        for mode, props, sid in (("dense", LLM_DENSE, 9302),
                                 ("paged", LLM_PAGED, 9303)):
            run = serve_llm(mode, props, [("f32", small)], seed, card, sid,
                            new=new, custom=llm_custom("float32"),
                            traced=False)
            f32[mode] = teacher_forced(run["params"], run["cfg"],
                                       run["prompts"], run["streams"])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow

    graph = llm_scripted_paged(params, cfg, seed, eager=False)
    eager = llm_scripted_paged(params, cfg, seed, eager=True)
    bits_differ = sum(not np.array_equal(a, b)
                      for a, b in zip(graph["logits"], eager["logits"]))
    cli = llm_cli_stream(seed, mix[0][0], card)
    cli_forced = teacher_forced(params, cfg, [mix[0][0]], [cli["tokens"]])

    k2 = dense["launches"].get("flash_attention", 0)
    row = {"phase": "llm_stream_checks", "card": card,
           "dense_prompts": n_dense, "k2_launches_dense": k2,
           "k2_launches_paged": paged["launches"].get("flash_attention", 0),
           "graphs": {m: r["graphs"] for m, r in (("dense", dense),
                                                   ("paged", paged))},
           "compile_ledger": {m: r["compile_ledger"] for m, r in (
               ("dense", dense), ("paged", paged))},
           "window_ledger": {m: r["window_ledger"] for m, r in (
               ("dense", dense), ("paged", paged))},
           "warmup_s": {m: r["warmup_s"] for m, r in (("dense", dense),
                                                      ("paged", paged))},
           "sheds": {m: [r["shed"], r["wire_shed"]] for m, r in (
               ("dense", dense), ("paged", paged))},
           "evicted": dense["evicted"] + paged["evicted"],
           "leaks": paged["leaks"], "margin": MARGIN,
           "bf16_share": BF16_LM_SHARE,
           "bf16_compared_differ": bf16, "f32_compared_differ": f32,
           "scripted_paged": {"dispatches": len(graph["logits"]),
                              "bit_differ": bits_differ,
                              "tokens_equal": graph["streams"]
                              == eager["streams"],
                              "prefix_hits": graph["prefix_hits"],
                              "prefix_tokens_reused":
                                  graph["prefix_tokens_reused"],
                              "chunks": graph["chunks"],
                              "leaks": graph["leaks"] + eager["leaks"]},
           "cli": {"rc": cli["rc"], "tokens": len(cli["tokens"]),
                   "compared_differ": cli_forced,
                   "start_to_stream_s": cli["start_to_stream_s"]},
           "engine": {m: r["engine"] for m, r in (("dense", dense),
                                                   ("paged", paged))}}
    emit(row)

    problems = []
    for mode, run in (("dense", dense), ("paged", paged)):
        if run["shed"] or run["wire_shed"] or run["evicted"] \
                or run["rejected"]:
            problems.append(f"{mode}: {run['shed']} + {run['wire_shed']} "
                            f"sheds, {run['evicted']} evicted, "
                            f"{run['rejected']} rejected")
        if any(len(s) != LLM_NEW for s in run["streams"]):
            problems.append(f"{mode}: a stream is incomplete")
        if run["graphs"].get("captures") or not run["graphs"].get(
                "replays") or run["window_ledger"]:
            problems.append(f"{mode}: captured after warmup: graphs "
                            f"{run['graphs']}, ledger "
                            f"{run['window_ledger']}")
        if run["compile_ledger"] != LLM_WARM[mode]:
            problems.append(f"{mode}: warm-up ledger "
                            f"{run['compile_ledger']}, want {LLM_WARM[mode]}")
        compared, differ = bf16[mode]
        if not compared or differ > BF16_LM_SHARE * compared:
            problems.append(f"{mode}: bf16 served tokens differ from the "
                            f"plain forward at {differ} of {compared}")
        compared, differ = f32[mode]
        if not compared or differ:
            problems.append(f"{mode}: f32 served tokens differ from the "
                            f"plain forward at {differ} of {compared}")
    if k2 != n_dense * cfg.layers:
        problems.append(f"dense: flash_attention launched {k2} times, want "
                        f"{n_dense} prompts x {cfg.layers} layers")
    a, b = paged["rows"]
    if a["prefix_hits"] or not b["prefix_hits"]:
        problems.append(f"paged: prefix hits {a['prefix_hits']} in phase A "
                        f"and {b['prefix_hits']} in phase B")
    if paged["leaks"] or paged["live_after_stop"]:
        problems.append(f"paged: leaks {paged['leaks']}")
    sp = row["scripted_paged"]
    if bits_differ or not sp["tokens_equal"] or sp["prefix_hits"] != 1 \
            or sp["leaks"]:
        problems.append(f"scripted paged engine: {sp}")
    if cli["rc"] != 0 or len(cli["tokens"]) != LLM_NEW:
        problems.append(f"CLI server: rc {cli['rc']}, "
                        f"{len(cli['tokens'])} tokens: {cli['stderr']}")
    if problems:
        raise AssertionError("llm_stream: " + "; ".join(problems))
    return {"launches": dense["launches"]}


# ---------------------------------------------------------------------------
# observability and SLO gating: the attribution profiler, /metrics and
# /healthz, nns-top, the SLO harness, federation and the static verifier
# ---------------------------------------------------------------------------

#: frames of the observed flagship run: long enough for mid-run scrapes
#: (the first scrape counts the forward's cost on the meta device)
OBSERVE_FRAMES = 3000
#: the SLO runs: seconds of open-loop load, and the share of the unloaded
#: query-serve's replies/s (same call) the Poisson arrivals offer
SLO_S = 15.0
SLO_LOAD = 0.5
#: the strict spec's run: armed after 3 fast windows (2 s each)
SLO_STRICT_S = 8.0
#: the CLI soak under the strict spec, seconds
SOAK_S = 10.0
#: the token SLO run: clients, stream requests a client a second, the
#: prompt's tokens, and the objectives' thresholds
SLO_LLM_CLIENTS = 8
SLO_LLM_RATE = 1.0
SLO_LLM_PROMPT = 64
SLO_TTFT_US = 500_000.0
SLO_ITL_US = 100_000.0
#: federation: worker processes and the frames the parent sends each
FED_WORKERS = 2
FED_FRAMES = (40, 70)
FED_CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
            "types=float32,framerate=0/1")
#: the flagship string with a caps dead end between source and converter
DEAD_END = LAUNCH.replace("video/x-raw,format=RGB,width=224,height=224,"
                          "framerate=30/1", "audio/x-raw").replace(
    "tensor_converter", "tensor_converter name=conv")


def cli_child(argv, err_path: str) -> "subprocess.Popen":
    """``python -m nnstreamer_tpu_torch.launch argv`` in a child process,
    its standard error into ``err_path``."""
    with open(err_path, "w", encoding="utf-8") as err:
        return subprocess.Popen(
            [sys.executable, "-m", "nnstreamer_tpu_torch.launch", *argv],
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE),
            stdout=subprocess.DEVNULL, stderr=err, text=True)


def child_result(child, err_path: str, timeout: float):
    """(exit code, standard error) of a child; killed past ``timeout``."""
    try:
        rc = child.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        child.kill()
        child.wait()
        rc = "killed"
    with open(err_path, encoding="utf-8") as fh:
        return rc, fh.read()


def scrape(url: str):
    """(HTTP status, body) of one GET; an error status is returned."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def prom_values(text: str, family: str) -> dict:
    """``{key: value}`` of a Prometheus exposition's samples of
    ``family`` (key: the name with its labels)."""
    out = {}
    for line in text.splitlines():
        if line.startswith(family + "{") or line.startswith(family + " "):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def run_observe_flagship(seed: int, card: str, main_fps: float) -> None:
    """flagship-b1 through the port's CLI in a child with ``--profile
    --metrics-port 0 --top``, beside the same string unprofiled (a
    counters-only ``--trace-out``) in another child.  Mid-run scrapes of
    ``/metrics`` until ``nns_mfu`` reads in (0, 1] (the H100 peaks) with
    the bytes/s and memory gauges present, and ``/healthz`` serving; at
    the end the three profile artifacts, every frame's attributed states
    summing to its end-to-end time (recomputed from ``trace.json``), the
    blame table's top states, both fps (the profiler's cost is printed,
    not held to a bound) and the FLOPs and bytes a frame the cost counter
    gives for the filter's forward."""
    import shutil
    import tempfile

    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.obs import attrib
    from nnstreamer_tpu_torch.obs.profile import pipeline_maps
    from nnstreamer_tpu_torch.obs.span import Span

    launch = LAUNCH.format(frames=OBSERVE_FRAMES, seed=seed)
    tmp = tempfile.mkdtemp(prefix="nns-observe-")
    try:
        plain_err = os.path.join(tmp, "plain.err")
        rc, err = child_result(cli_child(
            [launch, "--quiet", "--trace-out",
             os.path.join(tmp, "plain.json")], plain_err), plain_err, 600)
        if rc != 0:
            raise AssertionError(f"observe_flagship: the unprofiled CLI "
                                 f"run exited {rc}: {err[-800:]}")
        with open(os.path.join(tmp, "plain.json"), encoding="utf-8") as fh:
            plain_fps = json.load(fh)["trace"]["out"]["fps"]
        out_dir = os.path.join(tmp, "profile")
        err_path = os.path.join(tmp, "observed.err")
        child = cli_child([launch, "--profile", "--profile-out", out_dir,
                           "--metrics-port", "0", "--top", "0.5"], err_path)
        url = None
        scrapes, readings, gauges, health = 0, [], {}, None
        try:
            t0 = time.perf_counter()
            while child.poll() is None and time.perf_counter() - t0 < 600:
                if url is None:
                    with open(err_path, encoding="utf-8") as fh:
                        m = re.search(r"metrics endpoint on (http://\S+)",
                                      fh.read())
                    if m is None:
                        time.sleep(0.1)
                        continue
                    url = m.group(1)
                try:
                    status, text = scrape(url)
                    hstatus, hbody = scrape(url.replace("/metrics",
                                                        "/healthz"))
                except OSError:
                    break           # the run ended under the scrape
                scrapes += 1
                values = prom_values(text, "nns_mfu")
                hz = (hstatus, json.loads(hbody))
                if status == 200 and values and hz[1].get("state") \
                        == "serving":
                    # mid-run: the pipeline serves while its gauges
                    # read.  The first reading is over the run's
                    # lifetime (its open included), each later one since
                    # the previous scrape
                    readings.append(max(values.values()))
                    gauges = {fam: prom_values(text, fam) for fam in (
                        "nns_mfu", "nns_device_bytes_per_s",
                        "nns_device_mem_bytes")}
                    health = hz
                    if len([r for r in readings if r > 0]) >= 3:
                        break
                time.sleep(0.25)
            rc, err = child_result(child, err_path, 900)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
        if rc != 0:
            raise AssertionError(f"observe_flagship: the profiled CLI run "
                                 f"exited {rc}: {err[-800:]}")
        mfu = readings[-1] if readings else 0.0
        if not 0.0 < mfu <= 1.0 or not all(gauges.values()):
            raise AssertionError(f"observe_flagship: after {scrapes} "
                                 f"scrapes nns_mfu readings {readings}, "
                                 f"gauges {gauges}, /healthz {health}")
        if health is None or health[0] != 200 \
                or health[1].get("state") != "serving":
            raise AssertionError(f"observe_flagship: /healthz {health}")
        arts = {n: os.path.getsize(os.path.join(out_dir, n))
                for n in ("profile.json", "trace.json", "flame.folded")
                if os.path.exists(os.path.join(out_dir, n))}
        if len(arts) != 3 or not all(arts.values()):
            raise AssertionError(f"observe_flagship: artifacts {arts}")
        with open(os.path.join(out_dir, "profile.json"),
                  encoding="utf-8") as fh:
            doc = json.load(fh)
        with open(os.path.join(out_dir, "trace.json"),
                  encoding="utf-8") as fh:
            events = json.load(fh)["traceEvents"]
        spans = [Span(e["name"], e["tid"], round(e["ts"] * 1e3),
                      round(e["dur"] * 1e3), e["args"]["seq"],
                      int(e["args"]["trace_id"], 16))
                 for e in events if e["ph"] == "X" and e["pid"] == 1]
        states, transit = pipeline_maps(parse_launch(launch))
        frames = attrib.attribute_frames(spans, states, transit)
        broken = [fr.seq for fr, st in frames
                  if sum(st.values()) != fr.t1 - fr.t0]
        if len(frames) < OBSERVE_FRAMES // 2 or broken:
            raise AssertionError(f"observe_flagship: {len(frames)} frames "
                                 f"attributed, not conserved: {broken[:5]}")
        blame = doc["profile"]["blame"]
        flops, nbytes = attrib.module_cost(
            get_model("mobilenet_v2", {"seed": seed, "use_pallas": "1"},
                      "cuda").module,
            get_model("mobilenet_v2", {"seed": seed}, "cpu").in_info)
        peak_flops, peak_bw = attrib.device_peaks(
            __import__("torch").device("cuda", 0))
        fps = doc["trace"]["out"]["fps"]
        emit({"phase": "observe_flagship", "frames": blame["frames"],
              "frames_conserved": len(frames), "scrapes": scrapes,
              "nns_mfu": mfu, "nns_mfu_readings": readings,
              "gauges": gauges, "healthz": health[1],
              "artifact_bytes": arts, "blame_top": blame["top"],
              "states_us_per_frame": {
                  s: row["per_frame_us"]
                  for s, row in blame["states"].items()},
              "e2e_us": blame["e2e_us"],
              "conservation": blame["conservation"],
              "elements": doc["profile"].get("elements"),
              "device_gauges_at_report": doc["profile"].get("device"),
              "fps_profiled": fps, "fps_unprofiled_cli": plain_fps,
              "fps_main_path": main_fps,
              "profiler_cost_pct": 100.0 * (1.0 - fps / plain_fps),
              "cost_counter": {"flops_per_frame": flops,
                               "bytes_per_frame": nbytes},
              "peaks": {"flops": peak_flops, "bytes_per_s": peak_bw},
              "mfu_at_profiled_fps": fps * flops / peak_flops,
              "card": card})
        print("\n".join("observe_flagship: " + line for line in
                        err.splitlines() if line.startswith(
                            ("profile:", "state ")) or any(
                            line.startswith(s) for s in attrib.STATES)),
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def strict_spec(duration_s: float):
    """The demo spec with its p99 threshold at 1 µs, plus the same bound on
    every element's time inside ``chain()`` (the tracer's histograms): a
    spec no served stream can meet."""
    from nnstreamer_tpu_torch.slo.spec import Objective, SLOSpec, demo_spec

    demo = demo_spec(duration_s, p99_threshold_us=1.0)
    return SLOSpec(
        name="strict", window_fast_s=demo.window_fast_s,
        window_slow_s=demo.window_slow_s,
        burn_threshold=demo.burn_threshold, tick_s=demo.tick_s,
        objectives=demo.objectives + (Objective(
            "element_p99", "latency", target=0.90, threshold_us=1.0,
            metric="nns_element_proctime_us"),))


def slo_load(p, port: int, frames, rate: float, seconds: float, seed: int,
             evaluators) -> dict:
    """One open-loop run against the served pair ``p`` gated live by an
    ``SLOMonitor`` an evaluator: the summary, the K1 launches and the
    buckets the run dispatched."""
    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.slo import LoadGenerator, SLOMonitor

    gen = LoadGenerator("127.0.0.1", port, clients=QUERY_CLIENTS,
                        rate_hz=rate, duration_s=seconds,
                        schedule="poisson", seed=seed, timeout=30.0,
                        payload=frames[0][0])
    monitors = [SLOMonitor(ev) for ev in evaluators]
    _cuda.reset_launches()
    before = buckets_served(p)
    for m in monitors:
        m.start()
    try:
        summary = gen.run()
    finally:
        for m in monitors:
            m.stop(final_tick=True)
    return {"summary": summary, "launches": dict(_cuda.launches),
            "buckets": buckets_served(p) - before}


def verdict_row(v: dict) -> dict:
    return {"verdict": v["verdict"], "ticks": v["ticks"],
            "breaches": [b["objective"] for b in v["breaches"]],
            "worst_burn": {o["name"]: o["worst_burn_rate"]
                           for o in v["objectives"]}}


def run_slo_query_serve(seed: int, card: str, unloaded_rps: float) -> dict:
    """query-serve under the port's open-loop load generator: Poisson
    arrivals at SLO_LOAD of the unloaded replies/s, QUERY_CLIENTS
    connections.  First SLO_S seconds gated live by the demo spec (must
    PASS, with 0 errors and 0 sheds and the monitor ticking through the
    run); then SLO_STRICT_S seconds with span tracing on, gated by the
    strict spec (must FAIL and write a flight-recorder bundle; its dump
    at the breach holds the interpreter lock, so it gets a run of its
    own).  K1 once a bucket in both.  Then the CLI form: the flagship
    string under ``--soak SOAK_S --slo <strict spec>`` in a child must
    exit 3 with a bundle."""
    import shutil
    import tempfile

    from nnstreamer_tpu_torch.slo import (Evaluator, FlightRecorder,
                                          demo_spec)

    frames = query_frames(seed)
    rate = SLO_LOAD * unloaded_rps / QUERY_CLIENTS
    tmp = tempfile.mkdtemp(prefix="nns-slo-")
    try:
        with query_server(9520, QUERY_BATCH, frames) as (p, port):
            demo = Evaluator(demo_spec(SLO_S))
            runs = {"demo": slo_load(p, port, frames, rate, SLO_S, seed,
                                     [demo])}
            # the spans a breach bundle carries, and the per-element
            # histograms the strict spec's second objective reads
            tracer = p.enable_tracing(spans=True)
            recorder = FlightRecorder(os.path.join(tmp, "flightrec"),
                                      tracer=tracer)
            strict = Evaluator(strict_spec(SLO_STRICT_S),
                               on_breach=recorder.on_breach)
            strict.on_tick = recorder.record
            runs["strict"] = slo_load(p, port, frames, rate, SLO_STRICT_S,
                                      seed + 1, [strict])
            p.tracer = None
        verdicts = {"demo": demo.verdict(), "strict": strict.verdict()}
        bundles = {os.path.basename(b): sorted(os.listdir(b))
                   for b in recorder.dumps}
        spec_path = os.path.join(tmp, "strict.json")
        strict_spec(SOAK_S).dump(spec_path)
        err_path = os.path.join(tmp, "soak.err")
        rc, err = child_result(cli_child(
            [LAUNCH.format(frames=10 ** 7, seed=seed), "--soak",
             str(SOAK_S), "--slo", spec_path, "--slo-out",
             os.path.join(tmp, "cli_flightrec"), "--trace-out",
             os.path.join(tmp, "soak.json"), "--quiet"], err_path),
            err_path, 600)
        cli_bundles = (sorted(os.listdir(os.path.join(tmp, "cli_flightrec")))
                       if os.path.isdir(os.path.join(tmp, "cli_flightrec"))
                       else [])
        for name, run in runs.items():
            emit({"phase": "slo_query_serve", "spec": name,
                  "offered_rate_hz": run["summary"]["offered_rate_hz"],
                  "unloaded_replies_per_s": unloaded_rps,
                  "summary": run["summary"], "buckets": run["buckets"],
                  "launches": run["launches"],
                  "verdict": verdict_row(verdicts[name]),
                  **({"bundles": bundles, "cli_soak_rc": rc,
                      "cli_bundles": cli_bundles}
                     if name == "strict" else {}), "card": card})
        summary = runs["demo"]["summary"]
        # the monitor ticked through the run, not only at its end
        ticks = verdicts["demo"]["ticks"]
        if not verdicts["demo"]["pass"] or summary["errors"] \
                or summary["shed"] or not summary["ok"] \
                or ticks < SLO_S / (2 * demo_spec(SLO_S).tick_s):
            raise AssertionError(f"slo_query_serve: demo spec "
                                 f"{verdicts['demo']['verdict']} in "
                                 f"{ticks} ticks, summary {summary}")
        want = {"breach.json", "manifest.json", "metrics_final.json",
                "metrics_timeline.jsonl", "trace.json"}
        if verdicts["strict"]["pass"] or not bundles \
                or not all(want <= set(b) for b in bundles.values()):
            raise AssertionError(f"slo_query_serve: strict spec "
                                 f"{verdicts['strict']['verdict']}, "
                                 f"bundles {bundles}")
        for name, run in runs.items():
            if run["launches"].get("normalize_frame", 0) != run["buckets"]:
                raise AssertionError(f"slo_query_serve ({name}): K1 "
                                     f"{run['launches']}, "
                                     f"{run['buckets']} buckets")
        if rc != 3 or '"verdict": "FAIL"' not in err or not cli_bundles:
            raise AssertionError(f"slo_query_serve: the CLI soak exited "
                                 f"{rc}: {err[-800:]}")
        return {"launches": dict(
            collections.Counter(runs["demo"]["launches"])
            + collections.Counter(runs["strict"]["launches"]))}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_slo_llm_stream(seed: int, card: str) -> dict:
    """The token mode of the load generator against ``tensor_llm`` (the
    dense string at the LM's full width, in this process): SLO_LLM_CLIENTS
    gold clients opening streams by Poisson arrivals, SLO_S seconds,
    gated by ``ttft``/``itl``/availability objectives; the verdict and
    TTFT/ITL p50/p99 printed, every stream complete, no shed, K2 launched
    ``layers`` times a prefill."""
    import numpy as np

    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.query import shutdown_server
    from nnstreamer_tpu_torch.slo import Evaluator, SLOMonitor
    from nnstreamer_tpu_torch.slo.loadgen import TokenLoadGenerator
    from nnstreamer_tpu_torch.slo.spec import Objective, SLOSpec

    sid = 9530
    p = parse_launch(llm_server(sid, 0, "llm_slo", LLM_DENSE, seed))
    p.play()
    try:
        port = p.get("qsrc").bound_port
        prompt = np.random.default_rng(seed + 5).integers(
            0, int(LM_CUSTOM["vocab"]), SLO_LLM_PROMPT).astype(np.int32)
        fast = SLO_S / 6.0
        spec = SLOSpec(name="llm-stream", window_fast_s=fast,
                       window_slow_s=10 * fast, tick_s=fast / 10,
                       objectives=(
                           Objective("availability", "availability",
                                     target=0.95),
                           Objective("ttft", "ttft", target=0.90,
                                     threshold_us=SLO_TTFT_US),
                           Objective("itl", "itl", target=0.90,
                                     threshold_us=SLO_ITL_US)))
        ev = Evaluator(spec)
        monitor = SLOMonitor(ev)
        gen = TokenLoadGenerator(
            "127.0.0.1", port, prompt=prompt, max_new=LLM_NEW,
            frame_len=LLM_REQ, clients=SLO_LLM_CLIENTS,
            rate_hz=SLO_LLM_RATE, duration_s=SLO_S, schedule="poisson",
            seed=seed, timeout=120.0, token_timeout=60.0,
            classes=(("gold", 1.0),), qos=True)
        _cuda.reset_launches()
        monitor.start()
        try:
            summary = gen.run()
        finally:
            monitor.stop(final_tick=True)
        launches = dict(_cuda.launches)
    finally:
        p.stop()
        shutdown_server(sid)
    verdict = ev.verdict()
    lat = summary["token_latency"]
    emit({"phase": "slo_llm_stream", "verdict": verdict["verdict"],
          "breaches": [b["objective"] for b in verdict["breaches"]],
          "ttft_ms": {q: v / 1e3 for q, v in lat["ttft_us"].items()},
          "itl_ms": {q: v / 1e3 for q, v in lat["itl_us"].items()},
          "thresholds_ms": {"ttft": SLO_TTFT_US / 1e3,
                            "itl": SLO_ITL_US / 1e3},
          "summary": {k: summary[k] for k in (
              "offered_rate_hz", "achieved_rate_hz", "sent", "ok",
              "errors", "shed")},
          "launches": launches, "card": card})
    layers = int(LM_CUSTOM["layers"])
    if summary["errors"] or summary["shed"] or not summary["ok"] \
            or launches.get("flash_attention", 0) != layers * summary["ok"]:
        raise AssertionError(f"slo_llm_stream: {summary}, launches "
                             f"{launches}")
    return {"launches": launches}


def run_federation(card: str) -> None:
    """FED_WORKERS port CLI workers (an echo query server each, ``--soak``)
    pushing their registries with ``--push-metrics`` into a port
    collector in this process; this process sends each worker its
    FED_FRAMES.  The federated counters (per origin, and summed) must
    equal the workers' own, which each wrote with ``--trace-out``."""
    import shutil
    import tempfile

    import numpy as np

    from nnstreamer_tpu_torch.obs.federation import (CollectorServer,
                                                     MetricsCollector)
    from nnstreamer_tpu_torch.query import QueryConnection
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    tmp = tempfile.mkdtemp(prefix="nns-fed-")
    collector = MetricsCollector(registry=None)
    server = CollectorServer(collector)
    children = []
    try:
        for i in range(FED_WORKERS):
            port = free_port()
            launch = (f"tensor_query_serversrc id={i + 1} port={port} "
                      f"caps={FED_CAPS} ! tensor_query_serversink "
                      f"id={i + 1}")
            err = os.path.join(tmp, f"w{i}.err")
            children.append((port, err, cli_child(
                [launch, "--soak", "5", "--push-metrics",
                 f"127.0.0.1:{server.port}", "--push-interval", "0.2",
                 "--trace-out", os.path.join(tmp, f"w{i}.json"),
                 "--quiet"], err)))
        for (port, _, child), n in zip(children, FED_FRAMES):
            t0 = time.perf_counter()
            while True:
                try:
                    conn = QueryConnection("127.0.0.1", port, timeout=30.0)
                    conn.connect()
                    break
                except OSError:
                    if child.poll() is not None \
                            or time.perf_counter() - t0 > 120:
                        raise
                    time.sleep(0.2)
            try:
                for k in range(n):
                    out = conn.query(TensorBuffer(
                        tensors=[np.full(4, k, np.float32)]))
                    if not np.array_equal(out.np(0),
                                          np.full(4, k, np.float32)):
                        raise AssertionError("federation: echo differs")
            finally:
                conn.close()
        own = {}
        for i, (port, err, child) in enumerate(children):
            rc, text = child_result(child, err, 300)
            if rc != 0:
                raise AssertionError(f"federation: worker {i} exited {rc}:"
                                     f" {text[-800:]}")
            with open(os.path.join(tmp, f"w{i}.json"),
                      encoding="utf-8") as fh:
                own[port] = json.load(fh)["metrics"]
        fed = collector.snapshot_state(prefix="nns_query_server_")
        text = collector.render_prometheus()
    finally:
        for _, _, child in children:
            if child.poll() is None:
                child.kill()
                child.wait()
        server.close()
        shutil.rmtree(tmp, ignore_errors=True)
    fams = ("nns_query_server_accepted_total",
            "nns_query_server_admitted_total")
    sums, mine = {}, {}
    for key, st in fed.items():
        if st.get("kind") == "counter" and key.startswith(fams):
            fam = key.partition("{")[0]
            sums[fam] = sums.get(fam, 0) + st["value"]
    for metrics in own.values():
        for key, value in metrics.items():
            if key.startswith(fams):
                fam = key.partition("{")[0]
                mine[fam] = mine.get(fam, 0) + value
    origins = collector.origins()
    emit({"phase": "federation", "workers": FED_WORKERS,
          "frames": list(FED_FRAMES), "federated": sums, "workers_own": mine,
          "origins": [o["origin"] for o in origins],
          "exposition_lines": len(text.splitlines()), "card": card})
    if len(origins) != FED_WORKERS or sums != mine \
            or mine.get("nns_query_server_admitted_total") \
            != sum(FED_FRAMES):
        raise AssertionError(f"federation: origins {origins}, federated "
                             f"{sums}, workers {mine}")


def run_check_cli(seed: int, card: str) -> None:
    """``--check`` through the port's CLI: 0 on the flagship string, 1 on
    the same string with a caps dead end, named by its element path."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="nns-check-")
    try:
        runs = {}
        for name, launch in (("flagship", LAUNCH), ("dead_end", DEAD_END)):
            err = os.path.join(tmp, name + ".err")
            runs[name] = (cli_child(["--check", launch.format(
                frames=1, seed=seed)], err), err)
        out = {name: child_result(child, err, 300)
               for name, (child, err) in runs.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "check_cli", "rc": {k: v[0] for k, v in out.items()},
          "dead_end": [ln for ln in out["dead_end"][1].splitlines()
                       if "error" in ln or "FAIL" in ln],
          "card": card})
    rc_ok, err_ok = out["flagship"]
    rc_bad, err_bad = out["dead_end"]
    if rc_ok != 0 or "check: OK" not in err_ok:
        raise AssertionError(f"check_cli: flagship {rc_ok}: {err_ok[-800:]}")
    if rc_bad != 1 or "caps-mismatch" not in err_bad \
            or "conv -> f -> " not in err_bad:
        raise AssertionError(f"check_cli: dead end {rc_bad}: "
                             f"{err_bad[-800:]}")


def run_observability(args, card: str, main_fps: float,
                      query_rps: float) -> dict:
    """The observability and SLO phases; the launches of the two that
    drive kernels in this process."""
    run_observe_flagship(args.seed, card, main_fps)
    slo = run_slo_query_serve(args.seed, card, query_rps)
    llm = run_slo_llm_stream(args.seed, card)
    run_federation(card)
    run_check_cli(args.seed, card)
    return {"slo_query_serve": slo, "slo_llm_stream": llm}


# ---------------------------------------------------------------------------
# the serving fleet and the analysis tier
# ---------------------------------------------------------------------------

#: the fleet phase: FLEET_WORKERS workers of query_serve's batched server
#: string behind the port's router (one more at the scale-up leg)
FLEET_WORKERS = 3
FLEET_SID = 9300
FLEET_TEMPLATE = QUERY_SERVER.replace("port=0", "port={{port}}").format(
    sid=FLEET_SID, batch=QUERY_BATCH)
#: the legs' lengths, seconds
FLEET_KILL_S = 14.0
FLEET_SCALE_S = 12.0
#: a worker on the card is ready once its warm bucket came back (graphs
#: captured at open and at the first cross-stream bucket): the pool's
#: ready timeout for it, and the client and router timeouts
FLEET_READY_S = 150.0
FLEET_TIMEOUT_S = 30.0
FLEET_DRAIN_S = 5.0
#: frames of the main path run under the sanitizer
SANITIZED_FRAMES = 64


def _fleet_warm(port: int, marker: str, buckets) -> None:
    """A fleet worker's warm-up (a thread of the worker): once its server
    answers, QUERY_CLIENTS connections send one frame each together, so
    the first cross-stream bucket captures the pad set before any routed
    client arrives; then the ready marker, which the pool's readiness
    test reads."""
    import threading

    import numpy as np

    from nnstreamer_tpu_torch.query import QueryConnection
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    t0 = time.perf_counter()
    rng = np.random.default_rng(port)
    frames = [rng.integers(0, 256, (QUERY_SIZE, QUERY_SIZE, 3),
                           dtype=np.uint8) for _ in range(QUERY_CLIENTS)]
    conns = []
    while len(conns) < QUERY_CLIENTS:
        try:
            conn = QueryConnection("127.0.0.1", port, timeout=120.0)
            conn.connect()
            conns.append(conn)
        except OSError:
            if time.perf_counter() - t0 > FLEET_READY_S:
                return
            time.sleep(0.2)
    outs, barrier = [None] * len(conns), threading.Barrier(len(conns))

    def one(i):
        barrier.wait()
        out = conns[i].query(TensorBuffer(tensors=[frames[i]]))
        outs[i] = None if out is None else tuple(out.np(0).shape)

    threads = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(len(conns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=FLEET_READY_S)
    for conn in conns:
        conn.close()
    if outs != [(1001,)] * len(conns):
        return
    with open(marker, "w", encoding="utf-8") as fh:
        json.dump({"warm_s": time.perf_counter() - t0,
                   "warm_buckets": buckets[0]}, fh)


def fleet_worker(log: str, port: int, argv) -> int:
    """A fleet worker (``chip_smoke.py --fleet-worker LOG PORT --
    <launch.py argv>``): the port's ``launch.main`` on ``argv``, its
    server's buckets counted at the serversrc's ``push``, the warm-up in
    a thread; at exit (the SIGTERM drain included) the worker's kernel
    launches, graphs and buckets into ``LOG``."""
    import threading

    import torch

    sys.path.insert(0, HERE)
    if not torch.cuda.is_available():
        print("fleet worker: no CUDA device", file=sys.stderr)
        return 1
    from nnstreamer_tpu_torch import _cuda, launch
    from nnstreamer_tpu_torch.query.server import TensorQueryServerSrc

    buckets = [0]
    push = TensorQueryServerSrc.push

    def counted(self, buf, pad=None):
        buckets[0] += 1
        return push(self, buf, pad)

    TensorQueryServerSrc.push = counted
    threading.Thread(target=_fleet_warm, args=(port, log + ".ready",
                                               buckets),
                     daemon=True).start()
    rc = 1
    try:
        rc = launch.main(argv)
    except SystemExit as exc:     # the SIGTERM drain exits through here
        rc = exc.code
    finally:
        with open(log, "w", encoding="utf-8") as fh:
            json.dump({"rc": rc, "pid": os.getpid(),
                       "launches": dict(_cuda.launches),
                       "graphs": dict(_cuda.graphs),
                       "buckets": buckets[0],
                       "device": torch.cuda.get_device_name(0)}, fh)
    return rc if isinstance(rc, int) else 1


def fleet_spawner(log_dir: str):
    """The pool's spawn function for a collector port: a worker is this
    script's ``--fleet-worker`` around the port's ``launch.main`` on
    FLEET_TEMPLATE with ``--soak --push-metrics --drain-grace`` (the
    arguments ``fleet.launch_spawn_fn`` gives ``launch.py``), on the
    card."""
    def make(collector_port: int):
        def spawn(host: str, port: int):
            log = os.path.join(log_dir, f"worker-{port}")
            argv = [sys.executable, os.path.join(HERE, "chip_smoke.py"),
                    "--fleet-worker", log, str(port), "--",
                    FLEET_TEMPLATE.format(port=port), "--soak", "3600",
                    "--quiet", "--drain-grace", str(FLEET_DRAIN_S),
                    "--push-metrics", f"127.0.0.1:{collector_port}",
                    "--push-interval", "0.5"]
            with open(log + ".err", "w", encoding="utf-8") as err:
                return subprocess.Popen(
                    argv, cwd=HERE, stdout=err, stderr=err,
                    env=dict(os.environ, PYTHONPATH=HERE,
                             NNS_FLEET_ROLE="worker"))
        return spawn
    return make


class _RoutedSampler:
    """The dashboard's fleet rows (``obs.dashboard.build_view`` over the
    router's live ``nns_fleet_*`` gauges) sampled every half second: the
    most connections each worker held, and whether it was seen
    draining."""

    def __init__(self):
        import threading

        self.rows, self._stop = {}, threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from nnstreamer_tpu_torch.obs.dashboard import build_view
        from nnstreamer_tpu_torch.obs.metrics import REGISTRY
        from nnstreamer_tpu_torch.obs.timeseries import flatten_state

        while not self._stop.wait(0.5):
            view = build_view([(0.0, flatten_state(REGISTRY.snapshot_state(
                prefix="nns_fleet")))])
            for w in view["fleet"]:
                row = self.rows.setdefault(w["worker"], {
                    "max_routed": 0, "seen_draining": False})
                row["max_routed"] = max(row["max_routed"],
                                        int(w.get("routed", 0)))
                row["seen_draining"] |= bool(w.get("draining"))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5)
        return self.rows


def _leg_row(name: str, summary: dict) -> dict:
    """One leg's line: replies/s over the leg, round trip (send to reply)
    and schedule-anchored latency quantiles, sheds and errors."""
    return {"phase": "fleet_leg", "leg": name,
            "replies": summary["ok"], "sent": summary["sent"],
            "replies_per_s": (summary["ok"] / summary["duration_s"]
                              if summary["duration_s"] else 0.0),
            "offered_rps": summary["offered_rate_hz"],
            "rtt_p50_ms": summary["service_us"].get("p50", 0.0) / 1e3,
            "rtt_p99_ms": summary["service_us"].get("p99", 0.0) / 1e3,
            "latency_p99_ms": summary["latency_us"].get("p99", 0.0) / 1e3,
            "shed": summary["shed"], "errors": summary["errors"]}


def per_frame_logits(frames) -> dict:
    """``{(client, request): logits}`` of query_serve's frames, each
    through the served model one frame at a time in this process (the
    filter's per-frame graph)."""
    from nnstreamer_tpu_torch.filter import FilterSingle

    ref = {}
    with FilterSingle(framework="xla", model="mobilenet_v2",
                      custom="seed:0,use_pallas:1") as single:
        for c, row in enumerate(frames):
            for k, frame in enumerate(row):
                ref[c, k] = single.fw.invoke([frame])[0].float(
                    ).cpu().numpy()
    return ref


def run_fleet_phase(args, card: str) -> dict:
    """The serving fleet on the card: the port's router in this process
    over FLEET_WORKERS ``launch.py --soak`` workers of query_serve's
    batched MobileNetV2 server string, spawned by the port's
    ``WorkerPool`` through this script's spawn function; the three legs
    of ``nnstreamer_tpu_torch.fleet.soak.run_fleet`` (kill, scale-up,
    idle) with the autoscaler's thresholds from a capacity probe through
    the router (query_serve's 32 clients, ``drive_query_clients``), the
    legs' load the soak's open-loop generator over the same 32 clients
    and frames.  The clients send no model token: the router keys each
    connection by itself.  Checks: zero client errors in every leg; the
    killed worker restarted and serving; the serving count at 4, then
    one worker drained (route-away, SIGTERM, reap); every worker that
    exited by SIGTERM launched K1 at least once a bucket it served;
    every reply within the bf16 bound of its frame's per-frame logits
    from this process, and its label equal to the per-frame label
    wherever that label's top-2 margin exceeds twice the largest reply
    difference.  Returns the workers' summed launches."""
    import shutil
    import tempfile

    import numpy as np

    from nnstreamer_tpu_torch.fleet import soak

    t_phase = time.perf_counter()
    frames = query_frames(args.seed)
    replies, probe = [], {}

    def on_reply(c, i, out):
        replies.append((c % QUERY_CLIENTS, i % QUERY_FRAMES,
                        np.array(out.np(0))))

    def capacity(port):
        run = drive_query_clients(port, frames)
        probe.update(run)
        return run["replies_per_s"]

    log_dir = tempfile.mkdtemp(prefix="nns-fleet-")
    sampler = _RoutedSampler()
    t0 = time.perf_counter()
    try:
        rc = soak.run_fleet(
            out_dir=log_dir, template=FLEET_TEMPLATE,
            workers=FLEET_WORKERS, clients=QUERY_CLIENTS, seed=args.seed,
            timeout_s=FLEET_TIMEOUT_S, drain_grace_s=FLEET_DRAIN_S,
            make_spawn=fleet_spawner(log_dir),
            ready_fn=lambda w: os.path.exists(os.path.join(
                log_dir, f"worker-{w.port}.ready")),
            ready_timeout_s=FLEET_READY_S, up_timeout_s=2 * FLEET_READY_S,
            router_timeout_s=FLEET_TIMEOUT_S, capacity_fn=capacity,
            payload_fn=lambda c, i: frames[c % QUERY_CLIENTS][
                i % QUERY_FRAMES],
            on_reply=on_reply, kill_leg_s=FLEET_KILL_S,
            scale_leg_s=FLEET_SCALE_S, recover_s=FLEET_READY_S,
            spawn_wait_s=FLEET_READY_S, stop_drain=True)
        wall = time.perf_counter() - t0
        routed = sampler.stop()
        verdict = os.path.join(log_dir, "verdict.json")
        v = None
        if os.path.exists(verdict):
            with open(verdict, encoding="utf-8") as fh:
                v = json.load(fh)
        # each worker's files: the exit log, the ready marker, its output
        logs, warm, errs = {}, {}, {}
        for name in sorted(os.listdir(log_dir)):
            stem, _, ext = name.partition(".")
            if not stem.startswith("worker-"):
                continue
            with open(os.path.join(log_dir, name), encoding="utf-8") as fh:
                text = fh.read()
            port = int(stem.split("-")[1])
            if ext == "err":
                errs[port] = text[-600:]
            else:
                (warm if ext == "ready" else logs)[port] = json.loads(text)
    finally:
        sampler.stop()
        shutil.rmtree(log_dir, ignore_errors=True)
    if v is None:
        raise AssertionError(f"fleet: the soak ended with {rc} before its "
                             f"verdict; worker logs: {errs}")
    for name, summary in (("capacity_probe", None),
                          ("kill", v["kill_leg"]["loadgen"]),
                          ("scale_up", v["autoscale_leg"]["loadgen"])):
        if summary is None:
            emit({"phase": "fleet_leg", "leg": name,
                  "replies": probe["replies"],
                  "replies_per_s": probe["replies_per_s"],
                  "rtt_p50_ms": probe["rtt_p50_ms"],
                  "rtt_p99_ms": probe["rtt_p99_ms"],
                  "errors": len(probe["errors"]), "card": card})
        else:
            emit({**_leg_row(name, summary), "card": card})
    events = v["pool_events"]
    spawned = {e["worker"] for e in events if e["event"] == "spawned"}
    killed = v["kill"].get("worker")
    launches = collections.Counter()
    k1_short = []
    for port, log in logs.items():
        launches.update(log["launches"])
        k1 = log["launches"].get("normalize_frame", 0)
        if log["rc"] != 0 or not log["buckets"] or k1 < log["buckets"]:
            k1_short.append((port, log["rc"], log["buckets"], k1))
    clean = {f"127.0.0.1:{p}" for p, log in logs.items() if log["rc"] == 0}
    emit({"phase": "fleet", "workers": FLEET_WORKERS,
          "template": "query_serve batch=32 (MobileNetV2 1.0, bf16)",
          "keying": "per connection (no model token)",
          "soak_verdict": v["verdict"], "soak_checks": v["checks"],
          "capacity_routed_rps": v["fleet"]["capacity_routed_rps"],
          "rate_kill_leg_rps": v["fleet"]["rate_kill_leg_rps"],
          "rate_autoscale_leg_rps": v["fleet"]["rate_autoscale_leg_rps"],
          "spawn_watermark_rps": v["fleet"]["spawn_watermark_rps"],
          "peak_serving": v["fleet"]["peak_serving"],
          "routed_max_per_worker": routed, "kill": v["kill"],
          "restarted": v["restarted"],
          "restarts": sum(e["event"] == "crashed" for e in events),
          "spawns": v["autoscaler"]["spawns"],
          "drains": v["autoscaler"]["drains"],
          "times_s": {**v["times"],
                      "idle_to_reaped": v["idle_leg"]["idle_to_reaped_s"],
                      "warm": {p: round(d["warm_s"], 3)
                               for p, d in warm.items()}},
          "worker_exits": {p: log["rc"] for p, log in logs.items()},
          "worker_buckets": {p: log["buckets"] for p, log in logs.items()},
          "worker_k1": {p: log["launches"].get("normalize_frame", 0)
                        for p, log in logs.items()},
          "launches": dict(launches), "wall_s": wall, "card": card})
    checks = v["checks"]
    errors = (v["kill_leg"]["loadgen"]["errors"]
              + v["autoscale_leg"]["loadgen"]["errors"]
              + len(probe["errors"]))
    if errors or not (checks["zero_client_errors"]
                      and checks["worker_killed_mid_run"]
                      and checks["pool_recovered"] and v["restarted"]
                      and checks["spawn_on_sustained_load"]
                      and v["fleet"]["peak_serving"] >= FLEET_WORKERS + 1
                      and checks["drain_on_idle"]):
        raise AssertionError(f"fleet: {errors} client errors, checks "
                             f"{checks}, restarted {v['restarted']}, "
                             f"events {events[-12:]}, logs {errs}")
    if k1_short or clean != spawned - {killed}:
        raise AssertionError(f"fleet: workers that did not exit by SIGTERM "
                             f"with K1 >= buckets: {k1_short}; spawned "
                             f"{sorted(spawned)}, killed {killed}, clean "
                             f"{sorted(clean)}; logs {errs}")
    # every reply against its frame's per-frame logits from this process
    ref = per_frame_logits(frames)
    got = [(c, k, out) for c, k, out in replies]
    got += [(c, k, out) for c, row in enumerate(probe["outs"])
            for k, out in enumerate(row)]
    worst, over = 0.0, 0
    for c, k, out in got:
        want = ref[c, k]
        if out.shape != want.shape or not np.isfinite(out).all():
            raise AssertionError(f"fleet: reply ({c}, {k}) is {out.shape}")
        diff = np.abs(out - want)
        worst = max(worst, float(diff.max()))
        over += int((diff > LOGITS_ATOL + LOGITS_RTOL * np.abs(want)).sum())
    margin, compared, differ = 2 * worst, 0, []
    for c, k, out in got:
        top2 = np.sort(ref[c, k])[-2:]
        if top2[1] - top2[0] > margin:
            compared += 1
            if int(np.argmax(out)) != int(np.argmax(ref[c, k])):
                differ.append((c, k))
    emit({"phase": "fleet_outputs", "replies": len(got),
          "vs_per_frame_max_abs_diff": worst, "atol": LOGITS_ATOL,
          "rtol": LOGITS_RTOL, "logits_over_tolerance": over,
          "label_margin": margin, "labels_compared": compared,
          "labels_differ": differ[:16],
          "phase_s": time.perf_counter() - t_phase, "card": card})
    if over or differ or not compared:
        raise AssertionError(f"fleet: {over} logits beyond the bf16 bound of "
                             f"the per-frame forward, labels differ on "
                             f"{differ[:8]}, {compared} compared")
    return {"launches": dict(launches)}


def sanitized_main(out: str, frames: int, seed: int) -> int:
    """The main path under ``NNS_DEBUG=1`` (``chip_smoke.py
    --sanitized-main OUT``, a child process): labels, K1 launches and the
    sanitizer's findings into ``OUT``."""
    sys.path.insert(0, HERE)
    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.analysis import sanitizer

    p = parse_launch(LAUNCH.format(frames=frames, seed=seed))
    p.run(timeout=600)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump({"enabled": sanitizer.enabled(),
                   "labels": [b.extra.get("index")
                              for b in p.get("out").results],
                   "launches": dict(_cuda.launches),
                   "findings": [str(f) for f in sanitizer.findings()]}, fh)
    return 0


def run_sanitized_main(args, card: str, labels) -> None:
    """``sanitized_main``: the main path at SANITIZED_FRAMES frames in a
    child with ``NNS_DEBUG=1`` (every lock instrumented from import on):
    no findings, and the labels of the unsanitized run's first
    SANITIZED_FRAMES frames."""
    import shutil
    import tempfile

    n = min(SANITIZED_FRAMES, len(labels))
    tmp = tempfile.mkdtemp(prefix="nns-san-")
    try:
        out = os.path.join(tmp, "out.json")
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, os.path.join(HERE, "chip_smoke.py"),
             "--sanitized-main", out, str(n), str(args.seed)], capture_output=True, text=True, timeout=900,
            cwd=HERE, env=dict(os.environ, PYTHONPATH=HERE, NNS_DEBUG="1"))
        wall = time.perf_counter() - t0
        got = {}
        if child.returncode == 0:
            with open(out, encoding="utf-8") as fh:
                got = json.load(fh)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = got.get("labels") == list(labels[:n])
    emit({"phase": "sanitized_main", "frames": n,
          "rc": child.returncode, "sanitizer_on": got.get("enabled"),
          "findings": len(got.get("findings", ())),
          "labels_equal_unsanitized": same,
          "launches": got.get("launches"), "wall_s": wall, "card": card})
    if child.returncode or not got.get("enabled") or got["findings"] \
            or not same:
        raise AssertionError(f"sanitized_main: rc {child.returncode}, "
                             f"findings {got.get('findings', [])[:2]}, "
                             f"labels equal {same}: "
                             f"{child.stderr[-800:]}")


def run_check_jit(card: str) -> None:
    """``check_jit``: ``python -m nnstreamer_tpu_torch.launch --check
    --jit`` on the committed tree exits 0 (the graph-capture boundary
    audit clean) and prints the compile budgets."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.launch", "--check",
         "--jit"], capture_output=True, text=True, timeout=300, cwd=HERE,
        env=dict(os.environ, PYTHONPATH=HERE))
    lines = [ln for ln in r.stderr.splitlines() if ln.startswith("check:")]
    emit({"phase": "check_jit", "rc": r.returncode, "lines": lines,
          "wall_s": time.perf_counter() - t0, "card": card})
    if r.returncode or "check: jit: OK" not in lines \
            or not any(" budget " in ln for ln in lines):
        raise AssertionError(f"check_jit: rc {r.returncode}: "
                             f"{r.stderr[-800:]}")


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


# ---------------------------------------------------------------------------
# train, save, serve: MobileNetV2's training form through the flagship
# ---------------------------------------------------------------------------

#: mobilenet-train: MobileNetV2 1.0 at 224x224, 1001 classes, in its
#: training form (f32 parameters, bf16 compute; K1 normalizes each batch,
#: ``use_pallas:1``), batches of 32, Adam lr 1e-3 (the element's
#: default); the trainer writes its checkpoint at EOS
MNV2_TRAIN_BATCH = 32
MNV2_TRAIN_LAUNCH = (
    "appsrc name=src caps=other/tensors,format=static,num_tensors=2,"
    f"dimensions=3:224:224:{MNV2_TRAIN_BATCH}.{MNV2_TRAIN_BATCH},"
    "types=uint8.int32,framerate=0/1 ! "
    "tensor_trainer name=tr framework=mesh-vision model-save-path={path} "
    "custom=model:mobilenet_v2,seed:{seed},use_pallas:1,dp:1 ! "
    "tensor_sink name=out")
#: frames the flagship string serves from the trained checkpoint, and the
#: reload stream's frames (the second checkpoint swapped in at half)
SERVE_CKPT_FRAMES = 64
RELOAD_FRAMES = 16
RELOAD_CAPS = ("other/tensors,format=static,num_tensors=1,"
               "dimensions=3:224:224,types=uint8,framerate=0/1")


def mnv2_train_samples(steps: int, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (MNV2_TRAIN_BATCH, 224, 224, 3),
                          dtype=np.uint8),
             rng.integers(0, 1001, MNV2_TRAIN_BATCH).astype(np.int32))
            for _ in range(steps)]


def checkpoint_launch(path: str) -> str:
    """The flagship string, serving ``path``'s weights."""
    return LAUNCH.replace("custom=seed:{seed},use_pallas:1",
                          f"custom=seed:{{seed}},use_pallas:1,"
                          f"checkpoint:{path}")


def run_mobilenet_train(path: str, samples, seed: int, card: str):
    """The timed graph-mode run: one capture (step 1's eager warm-up) and
    a replay a later step, K1 once a step; the checkpoint at ``path``.
    Returns the row and the trainer."""
    import math

    from nnstreamer_tpu_torch import _cuda

    _cuda.reset_launches()
    trainer = drive_trainer(MNV2_TRAIN_LAUNCH.format(path=path, seed=seed),
                            samples)
    launches, graphs = dict(_cuda.launches), dict(_cuda.graphs)
    steps = len(trainer.losses)
    step_ms = [t * 1e3 for t in trainer.step_s]
    p50 = statistics.median(step_ms)
    row = {"phase": "mobilenet_train", "mode": "graph", "steps": steps,
           "batch": MNV2_TRAIN_BATCH, "launches": launches,
           "graphs": graphs, "step_ms": step_ms, "step_ms_p50": p50,
           "images_per_s": MNV2_TRAIN_BATCH / (p50 / 1e3),
           "losses": trainer.losses, "checkpoint_bytes":
           os.path.getsize(path) if os.path.exists(path) else None,
           "card": card}
    emit(row)
    if steps != len(samples) or not all(map(math.isfinite,
                                            trainer.losses)):
        raise AssertionError(f"mobilenet_train: {steps} steps of "
                             f"{len(samples)}, losses {trainer.losses}")
    if launches.get("normalize_frame", 0) != steps or any(
            launches.get(k, 0) for k in TRAIN_KERNELS):
        raise AssertionError(f"mobilenet_train: launches {launches}, "
                             f"expected normalize_frame once a step")
    if graphs != graph_counts(False, 1, steps - 1):
        raise AssertionError(f"mobilenet_train: graphs {graphs}")
    if row["checkpoint_bytes"] is None:
        raise AssertionError(f"mobilenet_train: no checkpoint at {path}")
    return row, trainer


def served_logits(path: str, frames) -> list:
    """The filter's logits for ``frames`` from ``path``'s weights (graph
    mode), as host arrays."""
    import torch

    from nnstreamer_tpu_torch.filter import FilterSingle

    with FilterSingle(framework="xla", model="mobilenet_v2",
                      custom=f"use_pallas:1,checkpoint:{path}") as single:
        outs = [single.fw.invoke([img])[0] for img in frames]
        torch.cuda.synchronize()
    return [o.float().cpu() for o in outs]


def check_served_checkpoint(labels, module, path: str, seed: int) -> dict:
    """The flagship's labels and the filter's logits from the trained
    checkpoint against the trained module's own forward (training form:
    f32 parameters, bf16 compute) on the same frames: logits within
    LOGITS_ATOL + LOGITS_RTOL * |module|; labels equal where the module's
    top-2 margin exceeds twice the largest logit difference (a random
    model a few steps trained is near-uniform over 1001 classes: its
    margins sit far below MARGIN), at least one frame compared."""
    import torch

    imgs = source_frames(len(labels), seed)
    served = served_logits(path, imgs)
    worst, beyond, wants = 0.0, 0, []
    with torch.no_grad():
        for img, got in zip(imgs, served):
            want = module(torch.from_numpy(img).cuda())[0].float().cpu()
            if got.shape != (1001,) or not torch.isfinite(got).all():
                raise AssertionError("served logits not finite (1001,)")
            diff = (got - want).abs()
            worst = max(worst, diff.max().item())
            beyond += int((diff > LOGITS_ATOL
                           + LOGITS_RTOL * want.abs()).any())
            wants.append(want)
    margin = 2 * worst
    pairs = [(label, want) for label, want in zip(labels, wants)
             if top2_margin(want).item() > margin]
    compared = len(pairs)
    equal = sum(label == int(want.argmax()) for label, want in pairs)
    row = {"phase": "train_save_serve_outputs", "frames": len(labels),
           "logits_max_abs_diff": worst, "frames_beyond_bound": beyond,
           "atol": LOGITS_ATOL, "rtol": LOGITS_RTOL,
           "labels_compared": compared, "labels_equal": equal,
           "margin": margin}
    emit(row)
    if beyond or not compared or equal != compared:
        raise AssertionError(f"served checkpoint vs the trained module: "
                             f"{row}")
    return row


def check_reload(path_a: str, path_b: str, seed: int, card: str) -> dict:
    """``RELOAD_MODEL`` with a second checkpoint mid-stream: the frames
    before the event answer with the first checkpoint's weights, those
    after with the second's — each frame's logits bit-equal to a filter
    opened on its checkpoint (graph mode both)."""
    import torch

    from nnstreamer_tpu_torch import _cuda, parse_launch
    from nnstreamer_tpu_torch.pipeline.element import CustomEvent
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    imgs = source_frames(RELOAD_FRAMES, seed + 7)
    half = RELOAD_FRAMES // 2
    _cuda.reset_launches()
    p = parse_launch(
        f"appsrc name=src caps={RELOAD_CAPS} ! tensor_filter name=f "
        "framework=xla model=mobilenet_v2 "
        f"custom=use_pallas:1,checkpoint:{path_a} is-updatable=true ! "
        "tensor_sink name=out")
    got = []
    p.get("out").connect("new-data",
                         lambda b: got.append(b.tensors[0].float().cpu()
                                              if isinstance(b.tensors[0],
                                                            torch.Tensor)
                                              else torch.from_numpy(
                                                  b.np(0).copy())))
    p.play()
    try:
        src = p.get("src")
        for i, img in enumerate(imgs):
            if i == half:
                src.push_event(CustomEvent("tensor_filter_update_model",
                                           {"checkpoint": path_b}))
            src.push_buffer(TensorBuffer(tensors=[img], pts=i))
        src.end_of_stream()
        p.wait(timeout=300)
    finally:
        p.stop()
    launches, graphs = dict(_cuda.launches), dict(_cuda.graphs)
    want_a, want_b = served_logits(path_a, imgs), served_logits(path_b,
                                                                imgs)
    if len(got) != RELOAD_FRAMES:
        raise AssertionError(f"reload: {len(got)} frames of "
                             f"{RELOAD_FRAMES}")
    right = [torch.equal(g, (want_a if i < half else want_b)[i])
             for i, g in enumerate(got)]
    other = [torch.equal(g, (want_b if i < half else want_a)[i])
             for i, g in enumerate(got)]
    row = {"phase": "train_save_serve_reload", "frames": len(got),
           "swap_at": half, "bit_equal_own_checkpoint": sum(right),
           "equal_other_checkpoint": sum(other), "launches": launches,
           "graphs": graphs, "card": card}
    emit(row)
    if not all(right) or any(other):
        raise AssertionError(f"reload: {row}")
    # one capture at open, a replay a frame; the swap captures nothing
    if graphs != graph_counts(False, 1, RELOAD_FRAMES):
        raise AssertionError(f"reload: graphs {graphs}")
    return {"launches": launches}


def check_round_trips(seed: int) -> None:
    """ViT-S/16's and the LM's parameters through ``save_checkpoint`` and
    ``restore_params`` into templates of another seed: every tensor bit
    for bit."""
    import tempfile

    import torch

    from nnstreamer_tpu_torch.models.registry import (get_model,
                                                      named_tensors,
                                                      restore_params,
                                                      save_checkpoint)
    from nnstreamer_tpu_torch.models.streamformer_lm import \
        config_from_custom
    from nnstreamer_tpu_torch.parallel.train_step import init_params

    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg = config_from_custom({**LM_CUSTOM, "max_seq": str(LM_SEQ)})
        cases = {
            "vit": (get_model("vit", {"seed": str(seed)}, trainable=True),
                    get_model("vit", {"seed": str(seed + 1)},
                              trainable=True)),
            "streamformer_lm": (
                {k: v for k, v in init_params(cfg, seed).items()},
                init_params(cfg, seed + 1)),
        }
        for name, (src, dst) in cases.items():
            if isinstance(src, dict):
                src = {k: (v.cuda() if isinstance(v, torch.Tensor) else
                           [{n: w.cuda() for n, w in lyr.items()}
                            for lyr in v]) for k, v in src.items()}
            path = os.path.join(tmp, f"{name}.pt")
            save_checkpoint(src, path)
            back = restore_params(dst, path)
            want, got = named_tensors(src), named_tensors(back)
            same = sum(torch.equal(got[k].cuda(), t) for k, t in want.items())
            rows.append({"model": name, "tensors": len(want),
                         "bit_equal": same,
                         "bytes": os.path.getsize(path)})
    emit({"phase": "checkpoint_round_trips", "rows": rows})
    for r in rows:
        if r["bit_equal"] != r["tensors"]:
            raise AssertionError(f"checkpoint round trip: {r}")


def run_train_save_serve(args, card: str) -> dict:
    """mobilenet-train in graph mode (timed) and held graph vs eager; its
    checkpoint served by the flagship string; a reload to a second
    checkpoint mid-stream; ViT's and the LM's round trips."""
    import tempfile

    from nnstreamer_tpu_torch.models.registry import (get_model,
                                                      save_checkpoint)

    samples = mnv2_train_samples(args.mnv2_train_steps, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        path_a = os.path.join(tmp, "mobilenet_v2_trained.pt")
        row, trainer = run_mobilenet_train(path_a, samples, args.seed, card)
        module = trainer._model.module
        served = run_labeling("train_save_serve", checkpoint_launch(path_a),
                              SERVE_CKPT_FRAMES, args.seed, card,
                              "normalize_frame", 1)
        check_served_checkpoint(served["labels"], module, path_a, args.seed)
        del trainer, module
        # the second checkpoint: the training form at another seed
        path_b = os.path.join(tmp, "mobilenet_v2_other.pt")
        save_checkpoint(get_model("mobilenet_v2",
                                  {"seed": str(args.seed + 1)},
                                  trainable=True), path_b)
        reload = check_reload(path_a, path_b, args.seed, card)
        check_train_graph_vs_eager(
            "mobilenet_train", MNV2_TRAIN_LAUNCH.format(
                path=os.path.join(tmp, "graph_vs_eager.pt"),
                seed=args.seed), samples)
    check_round_trips(args.seed)
    return {"train": {"launches": row["launches"]}, "serve": served,
            "reload": reload, "step_ms_p50": row["step_ms_p50"]}


# ---------------------------------------------------------------------------
# train-dist: two ranks on the one card over gloo
# ---------------------------------------------------------------------------

#: the multi-rank checks' steps (each rank's step is eager: a gloo
#: collective cannot be captured) and their tolerances against the
#: one-rank step on the same global batches, both in f32 with TF32 off:
#: the first step's gradients within DIST_GRAD_RTOL relative L2 a tensor
#: and every step's loss within DIST_LOSS_RTOL (the ranks' halves sum in
#: another order than the whole batch); the parameters after the steps
#: within 2·lr a step of each other — Adam's m/sqrt(v) turns that rounding
#: on a gradient near 0 into a step of up to lr either way
DIST_STEPS = 3
DIST_LOSS_RTOL = 1e-4
DIST_GRAD_RTOL = 1e-3
DIST_LR = 1e-3


def _max_abs(a: dict, b: dict) -> float:
    return max((a[n].double() - b[n].double()).abs().max().item()
               for n in b)


def _f32_off_tf32():
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


def dist_vision_task(seed: int, steps: int) -> dict:
    """On every rank: mesh-vision MobileNetV2 (f32) data parallel over the
    2-rank group, each rank its half of each global batch of 32; rank 0
    then runs the one-rank step on the same global batches from the same
    start (eagerly) and compares (the first step's gradients, as the
    step left them in ``.grad``: averaged over dp on the ranks)."""
    import torch
    import torch.distributed as dist

    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.vision_train import \
        make_vision_train_step

    _f32_off_tf32()
    props = {"seed": str(seed), "use_pallas": "1", "dtype": "float32"}
    batches = mnv2_train_samples(steps, seed + 3)

    def run(mesh):
        model = get_model("mobilenet_v2", props, device="cuda:0",
                          trainable=True)
        step, module, opt, _ = make_vision_train_step(mesh, model,
                                                      lr=DIST_LR)
        # eager, so each step's gradients are in .grad after it (a graph
        # keeps them in its pool until a replay)
        step.graphed._eager = True
        losses, grads = [], None
        t0 = time.perf_counter()
        for f, l in batches:
            losses.append(float(step(module, opt, f, l)[2]))
            if grads is None:
                grads = {n: p.grad.detach().clone()
                         for n, p in module.named_parameters()}
        wall = time.perf_counter() - t0
        state = {n: p.detach().clone() for n, p in module.named_parameters()}
        return losses, grads, state, wall

    mesh = make_mesh(n_devices=2, axis_sizes={"dp": 2}, devices=["cuda:0"])
    _cuda.reset_launches()
    losses, grads, state, wall = run(mesh)
    out = {"rank": dist.get_rank(), "mesh": mesh.shape, "losses": losses,
           "launches": dict(_cuda.launches), "step_s": wall / steps}
    if dist.get_rank() == 0:
        ref_losses, ref_grads, ref_state, _ = run(
            make_mesh(devices=["cuda:0"]))
        gap, where = _grad_gap(grads, ref_grads)
        out.update(one_rank_losses=ref_losses, grad_rel_l2=gap,
                   worst_tensor=where,
                   param_max_abs_diff=_max_abs(state, ref_state))
    return out


def dist_lm_task(seed: int, steps: int) -> dict:
    """On every rank: the LM (f32) sequence parallel over the 2-rank
    group through the flash ring (a K2 launch with offsets a ring step,
    K3/K4 in the backward), each rank half of every sequence: the first
    batch's gradients (synced as the step syncs them), then the steps;
    rank 0 then does the same with the one-rank step on the whole
    sequences from the same start and compares.  The JAX package's
    sharded gradient is the one-device gradient times the (dp, sp) size
    (its loss psum transposes to a psum; ROADMAP §C), and the port's
    follows it: the one-rank gradients are scaled by it before the
    comparison (Adam's update does not see the scale)."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.models.streamformer_lm import \
        config_from_custom
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.mesh import shard
    from nnstreamer_tpu_torch.parallel.train_step import (init_params,
                                                          leaves,
                                                          make_train_step,
                                                          value_and_grad)

    _f32_off_tf32()
    # capacity_factor = experts: no expert drops a token, on a rank's
    # half or on the whole batch (the capacity counts the member's own
    # tokens, as in the JAX package, so a binding capacity would route
    # the two steps differently)
    cfg = dataclasses.replace(
        config_from_custom({**LM_CUSTOM, "max_seq": str(LM_SEQ)}),
        dtype=torch.float32, lr=DIST_LR,
        capacity_factor=float(LM_CUSTOM["experts"]))
    start = init_params(cfg, seed)
    batches = lm_train_samples(steps, seed + 3)

    def run(mesh, ranks):
        step, params, opt, _ = make_train_step(mesh, cfg, params=start,
                                               flash=True)
        toks, labs = (torch.from_numpy(shard(x, mesh, ("dp", "sp")))
                      .cuda() for x in batches[0])
        _, grads = value_and_grad(params, toks, labs, cfg, True, ranks)
        t0 = time.perf_counter()
        losses = [float(step(params, opt, t, l)[2]) for t, l in batches]
        wall = time.perf_counter() - t0
        return losses, grads, {n: x.detach().clone()
                               for n, x in leaves(params)}, wall

    mesh = make_mesh(axis_sizes={"sp": 2}, devices=["cuda:0"])
    _cuda.reset_launches()
    losses, grads, state, wall = run(mesh, mesh)
    out = {"rank": dist.get_rank(), "mesh": mesh.shape, "losses": losses,
           "launches": dict(_cuda.launches), "step_s": wall / steps}
    if dist.get_rank() == 0:
        ref_losses, ref_grads, ref_state, _ = run(
            make_mesh(devices=["cuda:0"]), None)
        scale = mesh.axis_size(("dp", "sp"))
        gap, where = _grad_gap(grads, {n: g * scale
                                       for n, g in ref_grads.items()})
        out.update(one_rank_losses=ref_losses, grad_rel_l2=gap,
                   worst_tensor=where, grad_scale=scale,
                   param_max_abs_diff=_max_abs(state, ref_state))
    return out


def run_train_dist(args, card: str) -> dict:
    """dp=2 (mesh-vision MobileNetV2) and sp=2 (the LM through the flash
    ring) as two processes on the one card over gloo (NCCL refuses two
    ranks on one device), each held to the one-rank step on the same
    global batches in f32.  Each rank's K1 (dp) or K2/K3/K4 (sp)
    launches: a count a step, the batch's first gradients' included
    (sp: one more forward and backward)."""
    from nnstreamer_tpu_torch.parallel.multihost import LocalWorld

    t0 = time.perf_counter()
    totals = {}
    layers = int(LM_CUSTOM["layers"])
    with LocalWorld(2, backend="gloo", threads=2, timeout_s=600) as world:
        start_s = time.perf_counter() - t0
        for name, task, want in (
                ("dp2_mobilenet", dist_vision_task,
                 {"normalize_frame": DIST_STEPS}),
                ("sp2_lm_flash_ring", dist_lm_task,
                 {k: 2 * layers * (DIST_STEPS + 1) for k in TRAIN_KERNELS})):
            results = world.run(task, args.seed, DIST_STEPS)
            r0 = results[0]
            bound = 2 * DIST_LR * DIST_STEPS
            row = {"phase": "train_dist", "path": name,
                   "ranks": len(results), "backend": "gloo",
                   "mesh": r0["mesh"], "steps": DIST_STEPS,
                   "losses": r0["losses"],
                   "one_rank_losses": r0["one_rank_losses"],
                   "grad_rel_l2": r0["grad_rel_l2"],
                   "worst_tensor": r0["worst_tensor"],
                   "param_max_abs_diff": r0["param_max_abs_diff"],
                   "launches_per_rank": [r["launches"] for r in results],
                   "step_s_per_rank": [r["step_s"] for r in results],
                   "loss_rtol": DIST_LOSS_RTOL, "grad_rtol": DIST_GRAD_RTOL,
                   "param_atol": bound, "card": card}
            emit(row)
            loss_ok = all(abs(a - b) <= DIST_LOSS_RTOL * abs(b)
                          for a, b in zip(r0["losses"],
                                          r0["one_rank_losses"]))
            same = all(r["losses"] == r0["losses"] for r in results)
            if not (loss_ok and same
                    and r0["grad_rel_l2"] <= DIST_GRAD_RTOL
                    and r0["param_max_abs_diff"] <= bound):
                raise AssertionError(f"train_dist {name}: {row}")
            for r in results:
                for k, n in want.items():
                    if r["launches"].get(k, 0) != n:
                        raise AssertionError(
                            f"train_dist {name}: rank {r['rank']} launched "
                            f"{k} {r['launches'].get(k, 0)} times, "
                            f"expected {n}")
                for k, n in r["launches"].items():
                    totals[k] = totals.get(k, 0) + n
    emit({"phase": "train_dist_summary", "world_start_s": start_s,
          "wall_s": time.perf_counter() - t0, "card": card})
    return {"launches": totals}


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
             "prefill_tok_s", "served_tok_s",
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
    serving paths, then the training paths."""
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
    for path in ZOO_PATHS:
        for suffix, batch, pushdown in (("b1", 1, True),
                                        ("batched", BATCH, True),
                                        ("b1_host", 1, False)):
            if suffix == "b1_host" and path != "detect":
                continue
            frames = args.frames if batch == 1 else args.batched_frames
            paths[f"{path}_{suffix}"] = functools.partial(
                profile_path, f"{path}_{suffix}",
                zoo_launch(path, frames, args.seed, batch, pushdown),
                frames, args.seed, args.profile, None, 1, batch=batch)
    for name, (launch, samples, _) in train_runs(args).items():
        paths[name] = functools.partial(
            profile_train, name, launch, samples, args.profile,
            TRAIN_PER_STEP[name])
    paths["mobilenet_train"] = functools.partial(
        profile_train, "mobilenet_train", MNV2_TRAIN_LAUNCH.format(
            path=os.path.join(args.profile or ".", "mobilenet_v2.pt"),
            seed=args.seed),
        mnv2_train_samples(args.mnv2_train_steps, args.seed), args.profile,
        0)
    paths["query_serve"] = functools.partial(
        profile_query_serve, args.seed, args.profile)
    paths["hybrid_query"] = functools.partial(
        profile_hybrid_query, args.seed, args.profile)
    for kind in OFFLOAD_KINDS:
        paths[f"{kind}_offload"] = functools.partial(
            profile_offload, kind, args.seed, args.profile)
    for mode in ("dense", "paged"):
        paths[f"llm_stream_{mode}"] = functools.partial(
            profile_llm_stream, mode, args.seed, args.profile)
    return paths


def profile_llm_stream(mode: str, seed: int, out_dir: str, eager: bool,
                       turn: int) -> dict:
    """Trace the served ``tensor_llm`` string (``mode``: dense or paged)
    in one mode: the server is started (its engine's graph set captured,
    or, eager, each executable run once) before the trace, then the 16
    clients' dense mix is traced; a unit is a decode step."""
    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.llm import DecodeEngine
    from nnstreamer_tpu_torch.query import shutdown_server

    jobs = llm_jobs(seed, LLM_CLIENTS, LLM_REQUESTS, system=False)
    props = LLM_DENSE if mode == "dense" else LLM_PAGED
    kind = "eager" if eager else "graph"
    sid = 9320 + turn
    was = DecodeEngine._eager
    DecodeEngine._eager = eager
    run = {}
    try:
        p = parse_launch(llm_server(sid, 0, "llm", props, seed))
        p.play()
        try:
            eng = p.get("llm").engine
            steps, fill = eng.steps_total, eng.step_tokens
            port = p.get("qsrc").bound_port
            row = trace(f"llm_stream_{mode}_{kind}{turn}", out_dir,
                        lambda: run.update(drive_token_clients(
                            port, jobs, LLM_NEW)),
                        lambda t0, t1: eng.steps_total - steps)
            steps = eng.steps_total - steps
            fill = (eng.step_tokens - fill) / max(1, steps)
        finally:
            p.stop()
            shutdown_server(sid)
    finally:
        DecodeEngine._eager = was
    if run["errors"]:
        raise AssertionError(f"llm_stream profile: {run['errors'][:3]}")
    row.update(path=f"llm_stream_{mode}", mode=kind, turn=turn,
               served_tok_s=run["tok_s"], mean_fill=fill, steps=steps)
    emit(row)
    return row


def profile_query_serve(seed: int, out_dir: str, eager: bool,
                        turn: int, hybrid=None) -> dict:
    """Trace the served query pair in one mode: the server is started and
    warmed (one frame a client: the pad set captured at the first
    bucket), then the clients' frames are traced; a unit is a frame, and
    the row gives busy time and host launch calls a bucket too.
    ``hybrid``: the MQTT broker's port through which they meet."""
    frames = query_frames(seed)
    mode = "eager" if eager else "graph"
    path = "query_serve" if hybrid is None else "hybrid_query"
    run = {}
    with eager_filters(eager):
        with query_server(9102, QUERY_BATCH, frames,
                          hybrid=hybrid) as (p, port):
            before = buckets_served(p)
            row = trace(f"{path}_{mode}{turn}", out_dir,
                        lambda: run.update(drive_query_clients(
                            port, frames, hybrid)),
                        lambda t0, t1: QUERY_CLIENTS * QUERY_FRAMES,
                        "normalize_frame_kernel", 1)
            buckets = buckets_served(p) - before
    n = QUERY_CLIENTS * QUERY_FRAMES
    row.update(path=path, mode=mode, turn=turn,
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


def profile_child(name: str, argv) -> list:
    """Trace path ``name`` in a child process of its own (this script
    with ``--profile-path``), run before this process makes a CUDA
    context (a profiled child beside another process's context crashed);
    its profile lines are printed here and returned.  A child that
    crashes is run once more."""
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
    lines = [line for line in out.stdout.splitlines()
             if line.startswith('{"phase": "profile')]
    for line in lines:
        print(line, flush=True)
    return lines


def profile_all(args, argv) -> None:
    """Trace every path in a child process of its own, in both modes in
    turns."""
    for name in profiled_paths(args):
        profile_child(name, argv)


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
    os.makedirs(out_dir, exist_ok=True)     # mobilenet_train saves there
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
    argv = sys.argv[1:] if argv is None else argv
    # the processes this script starts of itself: a fleet worker, the
    # sanitized main path
    if argv[:1] == ["--fleet-worker"] and argv[3:4] == ["--"]:
        return fleet_worker(argv[1], int(argv[2]), argv[4:])
    if argv[:1] == ["--sanitized-main"] and len(argv) == 4:
        return sanitized_main(argv[1], int(argv[2]), int(argv[3]))
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
    ap.add_argument("--mnv2-train-steps", type=int, default=8,
                    help="steps of the MobileNetV2 trainer (batches of "
                         f"{MNV2_TRAIN_BATCH})")
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
        if args.profile_path == "fuse_tiers":
            profile_fuse_tiers(args)
        elif args.profile_path == "offload_pace":
            run_offload_pace(args.seed, card_line())
        else:
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
        # before this process makes a CUDA context: a profiled child
        # beside another process's context on the card crashed
        if args.profile:
            profile_all(args, sys.argv[1:] if argv is None else argv)
        traced = trace_fuse_tiers(sys.argv[1:] if argv is None else argv)
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
        fuse = run_fuse_tiers(args, card, traced)
        batched = run_batched_paths(args, card)
        zoo = run_zoo_paths(args, card)
        run_transform_path(args.frames, card)
        model_files = run_model_files(args, card)
        query = run_query_serve(args, card)
        if args.profile:
            run_query_pace(args.seed, card)
        offload = run_transports(args, card)
        if args.profile:
            run_offload_pace(args.seed, card)
        lm = run_lm_filter(args.lm_frames, args.seed, card)
        serve = run_llm_serve(args.steps, args.seed, card)
        stream = run_llm_stream(args.seed, card)
        obs = run_observability(args, card, main_path["fps"],
                                query["replies_per_s"])
        fleet = run_fleet_phase(args, card)
        run_sanitized_main(args, card, main_path["labels"])
        run_check_jit(card)
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
        tss = run_train_save_serve(args, card)
        dist = run_train_dist(args, card)
        for k in kernels:
            # launches summed over every path's own run (graph mode)
            k["launches"] = sum(path["launches"].get(k["name"], 0)
                                for path in (main_path, vit, lm, serve,
                                             stream, query, fleet,
                                             *obs.values(),
                                             *fuse.values(),
                                             *offload.values(),
                                             *batched.values(),
                                             *zoo.values(),
                                             *model_files.values(),
                                             *train_rows.values(),
                                             tss["train"], tss["serve"],
                                             tss["reload"], dist))
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
