"""Shared torch execution engine for device backends.

The counterpart of ``nnstreamer_tpu/filter/backends/_jitexec.py``: any
backend whose model is an ``nn.Module`` taking one frame per input, with
its forward over a leading batch axis beside it, gets the same hot-path
discipline —

- the model lives on its device from open onward (weights move once);
- one executable per site and input signature (the ``(shape, dtype)`` of
  each input, the key of the JAX package's ``_ledger_note``): on the card
  a ``torch.cuda.CUDAGraph`` (:class:`~nnstreamer_tpu_torch._cuda.
  CapturedGraph`) with static input buffers, captured after one eager
  run of the forward on a side stream; a dispatch copies its inputs into
  the static inputs on the current stream and replays.  The per-frame
  forward's executables are site ``filter.jitexec.invoke``, the batched
  forward's ``filter.jitexec.vmap`` (the JAX package's ``jax.vmap``
  executable); both live in one cache.  A capture or replay that fails
  raises :class:`FilterError`; nothing falls back to eager execution.
  On the CPU (``accelerator=true:cpu``) the forwards run eagerly;
- each new signature is a compile: it is recorded in the compile ledger
  at its site on either device;
- a warm-up invoke at open, so frame 1 is steady state (the open
  signature is captured then, cuDNN picks its algorithms and the CUDA
  kernels are built); :meth:`warmup_batched` and :meth:`warmup_stacked`
  capture the batched graphs before a stream needs them;
- ``invoke`` enqueues the work and returns device tensors WITHOUT a host
  sync; :meth:`TensorBuffer.np` downstream is the one sync point.  A
  replay's outputs are cloned before they are handed on: a sink may hold
  device tensors, and the next replay overwrites the graph's own (a
  clone is one device copy an output, and right whatever a consumer
  keeps, where a ring of graphs would be right only while it holds fewer
  frames than the ring has slots).  A batch's device→host copies start
  from those clones, into pinned memory its handle owns;
- micro-batched invoke (:meth:`invoke_batched`, :meth:`invoke_stacked`)
  pads a partial batch to a bounded set of shapes, so a bounded set of
  graphs serves every fill;
- one lock serializes every dispatch, capture and :meth:`set_postprocess`
  of an instance: the copy into a graph's static inputs, its replay and
  the clone of its outputs are one step, so threads may share the
  instance (``THREADSAFE_INVOKE``);
- :meth:`set_postprocess` composes a decoder-pushed reduction into both
  forwards, so only the reduced (small) outputs cross to the host.  The
  fused forwards take over (dropping the graphs) at the next ``invoke``
  or warm-up, never inside a batched dispatch: a pushdown may arrive on
  another thread while batches stream, and the element then captures
  the fused graphs with :meth:`warmup_batched` before its next
  dispatch.

:func:`_wrap_compute_dtype` and :meth:`TorchExecMixin._resolve_compute`
are the JAX package's compute-dtype policy for lowered-graph backends
(``custom=compute:auto|float32|bfloat16``).

:meth:`TorchExecMixin._resolve_mesh` is ``custom=mesh:dp=N``, with the JAX
package's spec parsing and messages (``_jitexec.py:197-225``): ``dp=1`` is
the plain filter; ``dp=N>1`` needs N devices of the filter's kind
(``cuda:0..N-1``), holds a replica of the weights on each and splits each
batched dispatch along its batch axis into N equal parts (a bucket that N
does not divide is refused), one a device, gathered back on the filter's
device.  The split dispatch runs eagerly on each device; the per-frame
forward stays on the filter's device.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List

import numpy as np
import torch

from ... import _cuda
from ...analysis import compileledger
from ...device import resolve_device
from ...pipeline.tracing import annotate, annotation_active
from ...tensor.buffer import BatchView, is_device_array
from ..framework import Accelerator, FilterError, start_output_transfers

#: compile-ledger sites (the JAX package's): the per-frame forward, the
#: batched forward
INVOKE_SITE = "filter.jitexec.invoke"
VMAP_SITE = "filter.jitexec.vmap"


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (a torch dtype passes through)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, np.dtype(dtype))).dtype


def _wrap_compute_dtype(forward_fn, params, dtype, example_inputs=None):
    """Cast the float32 entries of ``params`` (name -> tensor) to ``dtype``
    and wrap ``forward_fn(params, *inputs)`` so float inputs enter in
    ``dtype`` and every float output leaves in its ORIGINAL dtype: the
    external tensor meta is unchanged, native f16/bf16 outputs included,
    which a run of the unwrapped forward on the meta device recovers when
    example inputs are given.  Returns ``(wrapped, params)``."""
    out_dtypes = None
    if example_inputs is not None:
        try:
            meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                    for k, v in params.items()}
            outs = forward_fn(meta, *[
                torch.empty(tuple(x.shape), dtype=torch_dtype(x.dtype),
                            device="meta") for x in example_inputs])
            out_dtypes = [o.dtype for o in outs]
        except (RuntimeError, NotImplementedError, TypeError, ValueError,
                IndexError):
            out_dtypes = None
    params = {k: v.to(dtype) if v.dtype == torch.float32 else v
              for k, v in params.items()}

    def _restore(o, want):
        if not isinstance(o, torch.Tensor) or not o.is_floating_point():
            return o
        if want is not None:
            return o.to(want) if want.is_floating_point and o.dtype != want \
                else o
        # no probe: at least undo the compute-dtype leak
        return o.float() if o.dtype == dtype else o

    def wrapped(p, *xs):
        xs = [x.to(dtype) if x.is_floating_point() else x for x in xs]
        outs = forward_fn(p, *xs)
        wants = out_dtypes or [None] * len(outs)
        return tuple(_restore(o, w) for o, w in zip(outs, wants))

    return wrapped, params


def _signature(inputs) -> tuple:
    """The executable key of a dispatch: ``(shape, dtype name)`` of each
    input, with ``uint8`` for ``torch.uint8`` and ``np.dtype('uint8')``
    alike (the name ``str`` gives a JAX array's dtype)."""
    return tuple((tuple(x.shape), str(x.dtype).rpartition(".")[2])
                 for x in inputs)


def _record(key) -> None:
    """A new ``(site, signature)``: its compile-ledger event."""
    if compileledger.ENABLED:
        site, sig = key
        compileledger.record(site, tuple(
            (f"arg[{i}]", k) for i, k in enumerate(sig)))


class BatchHandle:
    """An in-flight batched invoke: the batch's outputs (clones of the
    graph's) and its live frame count.

    Unless the outputs stay on the device (``emit_device``), their copies
    to pinned host memory owned by this handle start at dispatch;
    ``wait()`` synchronizes on them and hands back zero-copy numpy rows
    per frame.  ``views()`` instead hands back :class:`BatchView` handles:
    nothing crosses to the host, and a downstream batched filter consumes
    the underlying tensors directly (cascade mode)."""

    def __init__(self, outs, n: int, emit_device: bool = False) -> None:
        self._outs = outs
        self._n = n
        self._host = None if emit_device else start_output_transfers(outs)

    def wait(self) -> List[List[np.ndarray]]:
        host = self._host or start_output_transfers(self._outs)
        mats = host.wait()
        return [[m[i] for m in mats] for i in range(self._n)]

    def views(self) -> List[List[BatchView]]:
        caches = [{} for _ in self._outs]
        return [[BatchView(o, i, c) for o, c in zip(self._outs, caches)]
                for i in range(self._n)]


class _FlushHandle:
    """Tiny-tail twin of :class:`BatchHandle`: per-frame outputs of the
    per-frame graph, same ``wait()``/``views()`` contract (per-frame
    device tensors are already valid device-resident payloads)."""

    def __init__(self, per_frame_outs, emit_device: bool = False) -> None:
        self._outs = per_frame_outs
        self._host = None if emit_device else [
            start_output_transfers(frame) for frame in per_frame_outs]

    def wait(self) -> List[List[np.ndarray]]:
        host = self._host or [start_output_transfers(frame)
                              for frame in self._outs]
        return [h.wait() for h in host]

    def views(self):
        return [list(frame) for frame in self._outs]


class CastingHandle:
    """Wraps a :class:`BatchHandle`, applying per-output host dtype casts
    at ``wait()`` (``None`` keeps an output as it is).  ``views()`` falls
    back to host materialization: a cast output has no device-resident
    form."""

    def __init__(self, inner: BatchHandle, casts) -> None:
        self._inner = inner
        self._casts = casts

    def wait(self) -> List[List[np.ndarray]]:
        return [[o if c is None else np.asarray(o).astype(c)
                 for o, c in zip(frame, self._casts)]
                for frame in self._inner.wait()]

    def views(self):
        return self.wait()


class TorchExecMixin:
    """Execution engine over ``self._forward_fn`` / ``self._batched_fn``
    / ``self._device`` (set by :meth:`_setup_exec`)."""

    SUPPORTS_BATCHING = True
    #: dispatches of one instance serialize on its lock, so
    #: tensor_filter's workers share ONE instance: graphs are captured
    #: once and the weights live on the card once
    THREADSAFE_INVOKE = True

    #: private: run the forward eagerly on the card as well, for a
    #: reference run to hold the graphs to (set on the class or an
    #: instance by tests and chip_smoke.py; not a launch property)
    _eager = False

    def _setup_exec(self, forward_fn, device: torch.device,
                    warmup_inputs=None, batched_fn=None, mesh=None):
        """Stage the forwards and run the optional warm-up invoke, which
        captures the open signature on the card.  ``batched_fn``: the
        forward over a leading batch axis (``None``: ``torch.func.vmap``
        of ``forward_fn``).  ``mesh`` (from :meth:`_resolve_mesh`): a
        list of ``(device, batched forward)``, one a replica, the first
        this filter's own.  Returns the warm-up outputs."""
        self._mesh = mesh
        self._device = device
        self._exec_lock = threading.RLock()
        self._forward_fn = forward_fn
        self._batched_fn = (torch.func.vmap(forward_fn) if batched_fn is None
                            else batched_fn)
        self._postprocess_fn = None
        self._pending_fusion = None
        self._drop_execs()
        if warmup_inputs is None:
            return None
        outs = self._invoke_device(warmup_inputs)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return outs

    def _teardown_exec(self) -> None:
        self._mesh = None
        self._forward_fn = None
        self._batched_fn = None
        self._postprocess_fn = None
        self._pending_fusion = None
        self._drop_execs()

    def _drop_execs(self) -> None:
        """Forget every executable: the next dispatch of each signature
        is a compile again."""
        #: (site, signature) -> its CapturedGraph (None where the forward
        #: runs eagerly: the CPU, or ``_eager``)
        self._execs = {}
        self._graph_memory = None

    @staticmethod
    def _pick_device(accelerators) -> torch.device:
        """``accelerator=true:cpu`` runs on the CPU; anything else runs on
        ``cuda:0`` and raises when this host has no CUDA device."""
        want = accelerators[0] if accelerators else Accelerator.AUTO
        if want is Accelerator.CPU:
            return torch.device("cpu")
        if want is Accelerator.NONE:
            raise FilterError("accelerator=false: this backend runs on a "
                              "device; ask for the CPU with "
                              "accelerator=true:cpu")
        try:
            return resolve_device(None)
        except RuntimeError as exc:
            raise FilterError(str(exc)) from exc

    @staticmethod
    def _resolve_mesh(props, device: torch.device):
        """``custom=mesh:dp=N``: the N devices of a data-parallel serving
        mesh of ``device``'s kind, ``device`` first.  None when the prop
        is absent or N == 1; FilterError on bad syntax or too few
        devices (the JAX package's messages, with its platform names)."""
        spec = str(getattr(props, "custom_properties", {}).get(
            "mesh", "")).strip()
        if not spec:
            return None
        if not spec.startswith("dp="):
            raise FilterError(
                f"mesh spec {spec!r} not understood (expected mesh:dp=N; "
                "tp/pp serving shardings are model-parallel training "
                "territory — see parallel/)")
        try:
            dp = int(spec[3:])
        except ValueError:
            raise FilterError(f"mesh:dp={spec[3:]!r} is not an integer")
        if dp < 1:
            raise FilterError(f"mesh:dp={dp} must be >= 1")
        if dp == 1:
            return None
        if device.type == "cuda":
            platform, count = "gpu", torch.cuda.device_count()
        else:
            platform, count = device.type, 1
        if count < dp:
            raise FilterError(
                f"mesh:dp={dp} but only {count} {platform} "
                "device(s) visible")
        first = device.index or 0
        return [device] + [torch.device(device.type, i)
                           for i in range(count) if i != first][:dp - 1]

    @staticmethod
    def _resolve_compute(props, device: torch.device):
        """``custom=compute:{auto,float32,bfloat16}`` for lowered-graph
        backends: auto is bfloat16 on the card and float32 on the CPU
        (None stands for float32: no cast)."""
        choice = str(getattr(props, "custom_properties", {}).get(
            "compute", "auto")).lower()
        if choice in ("float32", "fp32", "f32"):
            return None
        if choice in ("bfloat16", "bf16"):
            return torch.bfloat16
        if choice != "auto":
            raise FilterError(
                f"unknown compute dtype {choice!r} "
                "(auto | float32 | bfloat16)")
        return torch.bfloat16 if device.type == "cuda" else None

    @staticmethod
    def pad_rows(n: int, capacity: int = 0) -> int:
        """Quantized pad target for an ``n``-row partial bucket: next
        power of two up to 8, then multiples of 8, capped at
        ``capacity`` — waste <= 7 rows above 8 and a bounded set of
        shapes (``4 + capacity/8``) over every fill."""
        cap = max(int(capacity), n, 1)
        if n <= 8:
            bucket = 1
            while bucket < n:
                bucket <<= 1
        else:
            bucket = (n + 7) & ~7
        return min(bucket, cap)

    # -- hot path ------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x if x.device == self._device else \
                x.to(self._device, non_blocking=True)
        return _cuda.host_tensor(x, self._device.type == "cuda").to(
            self._device, non_blocking=True)

    def _graphed(self) -> bool:
        return self._device.type == "cuda" and not self._eager

    def _fn(self, site: str):
        return self._forward_fn if site == INVOKE_SITE else self._batched_fn

    def _run(self, site: str, inputs: List[Any]):
        """One dispatch through the executable of ``site`` and the inputs'
        signature (compiled on its first dispatch)."""
        key = (site, _signature(inputs))
        with self._exec_lock, torch.inference_mode():
            fn = self._fn(site)
            if key not in self._execs:
                outs = self._compile(key, fn, inputs)
                if outs is not None:
                    return outs
            graph = self._execs[key]
            if graph is not None:
                return self._replay(graph, inputs)
            return fn(*[self._to_device(x) for x in inputs])

    def _invoke_device(self, inputs: List[Any]):
        inputs = [x.device_slice() if isinstance(x, BatchView) else x
                  for x in inputs]
        return self._run(INVOKE_SITE, inputs)

    def _dispatch_batched(self, stacked: List[Any]):
        if getattr(self, "_mesh", None) is not None:
            return self._dispatch_mesh(stacked)
        return self._run(VMAP_SITE, stacked)

    def _dispatch_mesh(self, stacked: List[Any]):
        """The batch split along axis 0 over the mesh: part i runs on
        replica i's device, the outputs gather on this filter's device."""
        dp = len(self._mesh)
        bucket = int(stacked[0].shape[0])
        if bucket % dp:
            raise FilterError(
                f"stream batch {bucket} not divisible by mesh dp={dp} "
                "(set tensor_filter batch= to a multiple)")
        rows = bucket // dp
        key = (VMAP_SITE, _signature(stacked))
        with self._exec_lock, torch.inference_mode():
            if key not in self._execs:
                _record(key)
                self._execs[key] = None
            parts = []
            for i, (dev, fn) in enumerate(self._mesh):
                xs = []
                for x in stacked:
                    x = x[i * rows:(i + 1) * rows]
                    if not isinstance(x, torch.Tensor):
                        x = _cuda.host_tensor(x, dev.type == "cuda")
                    xs.append(x.to(dev, non_blocking=True))
                parts.append(fn(*xs))
            return tuple(torch.cat([p[k].to(self._device, non_blocking=True)
                                    for p in parts])
                         for k in range(len(parts[0])))

    def _compile(self, key, fn, inputs: List[Any]):
        """A new signature: record it in the compile ledger and, on the
        card, capture ``fn``.  Returns the outputs of the eager run that
        precedes the capture (this dispatch's result), or None where the
        forward stays eager."""
        _record(key)
        if not self._graphed():
            self._execs[key] = None
            return None
        if self._graph_memory is None:
            self._graph_memory = _cuda.graph_memory(self._device)
        statics = [self._to_device(x).clone() for x in inputs]
        try:
            # other threads of the pipeline (a queue's drain, a host
            # consumer's copies) may call CUDA while this one captures
            graph = _cuda.CapturedGraph(fn, statics, self._graph_memory,
                                        error_mode="thread_local")
        except RuntimeError as exc:
            raise FilterError(f"{self.NAME}: CUDA graph capture of the "
                              f"forward for {key} failed: {exc}") from exc
        self._execs[key] = graph
        return tuple(graph.first)

    def _replay(self, graph, inputs: List[Any]):
        try:
            for static, x in zip(graph.inputs, inputs):
                static.copy_(_cuda.host_tensor(x, static.is_cuda),
                             non_blocking=True)
            outs = graph.replay()
        except RuntimeError as exc:
            raise FilterError(f"{self.NAME}: CUDA graph replay failed: "
                              f"{exc}") from exc
        return tuple(o.clone() for o in outs)

    def _warm(self, site: str, inputs: List[Any]) -> None:
        """Compile the forward of ``site`` for ``inputs``' signature now
        (a staged fusion first takes over), outside the statistics: on
        the card a capture (with its eager run on the inputs), where the
        forward runs eagerly only the ledger's record."""
        key = (site, _signature(inputs))
        with self._exec_lock:
            self._apply_fusion()
            if key in self._execs:
                return
            with torch.inference_mode():
                self._compile(key, self._fn(site), inputs)
            if self._graphed():
                torch.cuda.synchronize(self._device)

    def _zeros(self, rows=None) -> List[np.ndarray]:
        in_info, _ = self.get_model_info()
        lead = () if rows is None else (rows,)
        return [np.zeros(lead + i.np_shape, i.np_dtype) for i in in_info]

    def warmup(self) -> None:
        """Compile the forward for the model's input signature now, so
        the next frame is steady state: the element calls it when a
        decoder's pushdown has just dropped the graphs."""
        self._warm(INVOKE_SITE, self._zeros())

    def warmup_batched(self, bucket: int) -> None:
        """Compile BOTH batching executables — the bucket-wide forward and
        the per-frame one the tiny-tail flush rides — before the stream:
        a capture inside it would stall a frame and could meet another
        thread's CUDA calls."""
        self._warm(VMAP_SITE, self._zeros(bucket))
        self.warmup()

    def warmup_stacked(self, capacity: int) -> None:
        """Compile EVERY padded-bucket shape a ``capacity``-sized
        cross-stream bucket can dispatch (:meth:`pad_rows`), once, off the
        steady state: without it each pad shape's first live bucket would
        stall on a capture."""
        shapes = sorted({self.pad_rows(n, capacity)
                         for n in range(1, max(1, int(capacity)) + 1)})
        for rows in shapes:
            self._warm(VMAP_SITE, self._zeros(rows))

    def _annotate(self, t0: int, known: int) -> None:
        """Record the dispatch ``[t0, now]`` in the statistics and, under
        a span-recording tracer, as this frame's device-invoke span, or
        device-compile where it compiled a signature (``known``: the
        executables before it).  On the card a replay is asynchronous:
        the span ends at the launch, and the device time itself lands at
        the materialization sync (``TensorBuffer.np``)."""
        t1 = time.monotonic_ns()
        self.stats.record(t1 - t0)
        if annotation_active():
            annotate("device-compile" if len(self._execs) > known
                     else "device-invoke", t0, t1)

    def invoke(self, inputs: List[Any]) -> List[Any]:
        t0 = time.monotonic_ns()
        with self._exec_lock:
            self._apply_fusion()
            known = len(self._execs)
            outs = self._invoke_device(inputs)
        self._annotate(t0, known)
        return list(outs)

    def invoke_batched(self, frames, bucket: int, emit_device: bool = False):
        """One stage + one dispatch + one device→host copy stream for up
        to ``bucket`` frames: the per-dispatch cost is paid once a batch.
        Short batches are padded by repeating the last frame (sliced away
        in ``wait()``), so one graph serves every fill — EXCEPT tiny
        flush tails (EOS / renegotiation drains, ≤ bucket/8 frames),
        which dispatch per frame through the per-frame graph: a 1-frame
        flush at bucket=64 would otherwise burn 64× the FLOPs.

        ``emit_device=True`` (cascade mode): the outputs stay on the
        device and the handle's ``views()`` hands out :class:`BatchView`
        payloads; no device→host copy starts."""
        n = len(frames)
        t0 = time.monotonic_ns()
        known = len(self._execs)
        if 8 * n <= bucket:
            handle = _FlushHandle([self._invoke_device(list(f))
                                   for f in frames], emit_device)
        else:
            stacked = [self._stage_batch([f[k] for f in frames], bucket)
                       for k in range(len(frames[0]))]
            handle = BatchHandle(list(self._dispatch_batched(stacked)), n,
                                 emit_device)
        self._annotate(t0, known)
        return handle

    def invoke_stacked(self, stacked: List[Any], n: int,
                       capacity: int = 0) -> List[Any]:
        """Cross-stream batched invoke over PRE-STACKED ``(n, …)`` inputs
        (a serving plane's bucket): pad axis 0 to :meth:`pad_rows` (capped
        at ``capacity``) by repeating the last live row, so a BOUNDED set
        of graphs (warmed by :meth:`warmup_stacked`) serves every partial
        fill; rows past ``n`` are padding the caller never replies
        (:class:`~nnstreamer_tpu_torch.tensor.buffer.XBatchMeta`).

        Returns the PADDED stacked outputs as device tensors without a
        sync: the split point's first host touch is the bucket's one
        sync."""
        bucket = self.pad_rows(n, capacity)
        padded = []
        for arr in stacked:
            arr = arr.device_slice() if isinstance(arr, BatchView) else arr
            rows = int(arr.shape[0])
            if rows < bucket:
                if isinstance(arr, torch.Tensor):
                    # a host stack (a query server's bucket, in pinned
                    # memory) pads on the device: its one host copy was
                    # the stacking
                    arr = self._to_device(arr)
                    arr = torch.cat([arr, arr[-1:].expand(
                        (bucket - rows,) + tuple(arr.shape[1:]))])
                else:
                    arr = np.asarray(arr)
                    arr = np.concatenate([arr, np.broadcast_to(
                        arr[-1:], (bucket - rows,) + arr.shape[1:])])
            padded.append(arr)
        t0 = time.monotonic_ns()
        known = len(self._execs)
        outs = self._dispatch_batched(padded)
        self._annotate(t0, known)
        return list(outs)

    def _stage_batch(self, arrs, bucket: int):
        """One input's frames → one ``(bucket, …)`` batch.

        Cascade fast path: contiguous :class:`BatchView` runs over shared
        underlying tensors are re-joined with at most one device op per
        run (none when one upstream batch maps 1:1: it goes on to the
        replay's copy into this graph's static input as it is).  Device
        tensors stack on the device; host frames stack into pinned host
        memory, from which the replay's copy to the card is
        asynchronous."""
        n = len(arrs)
        if not all(map(is_device_array, arrs)):
            return _cuda.stack_host(arrs, bucket,
                                    self._device.type == "cuda")
        if all(isinstance(a, BatchView) for a in arrs):
            # group consecutive rows of the same underlying batch
            segs, i = [], 0
            while i < n:
                v, j = arrs[i], i + 1
                while (j < n and arrs[j].batch is v.batch
                       and arrs[j].index == arrs[j - 1].index + 1):
                    j += 1
                segs.append((v.batch, v.index, arrs[j - 1].index + 1))
                i = j
            b0, lo, _hi = segs[0]
            if len(segs) == 1 and lo == 0 and b0.shape[0] == bucket:
                # 1:1 with the upstream batch (padding rows included:
                # upstream pads by repeating its last frame, this stage's
                # own policy)
                return b0
            parts = [self._to_device(b[lo:hi]) for b, lo, hi in segs]
            if n < bucket:
                parts.append(parts[-1][-1:].expand(
                    (bucket - n,) + tuple(parts[-1].shape[1:])))
            return torch.cat(parts)
        # plain device tensors (a device source, flush-tail outputs):
        # stack ON THE DEVICE -- one small op instead of a round trip
        arrs = [self._to_device(a.device_slice() if isinstance(a, BatchView)
                                else a) for a in arrs]
        return torch.stack(arrs + [arrs[-1]] * (bucket - n))

    def set_postprocess(self, fn) -> bool:
        """Compose a decoder-pushed reduction into both forwards (the
        batched one maps it over the batch axis, as the JAX package's
        ``jax.vmap`` of its fused forward does): the reduced (small)
        outputs are what cross to the host.  Staged: the fused forwards
        take over at the next ``invoke`` or warm-up."""
        with self._exec_lock:
            self._pending_fusion = fn
            # marker for the element's post-reload re-apply: a backend
            # that carries the fusion must NOT be fused again
            self._postprocess_fn = fn
        return True

    def _apply_fusion(self) -> None:
        """Let a staged reduction take over the forwards; the graphs go
        (new executables: signatures reset).  Caller holds the exec
        lock."""
        fn, self._pending_fusion = self._pending_fusion, None
        if fn is None:
            return
        base_fwd, base_batched = self._forward_fn, self._batched_fn
        reduce_rows = torch.func.vmap(lambda *outs: tuple(fn(list(outs))))

        def fused(*xs):
            return tuple(fn(list(base_fwd(*xs))))

        def fused_batched(*xs):
            return reduce_rows(*base_batched(*xs))

        self._forward_fn = fused
        self._batched_fn = fused_batched
        self._drop_execs()

    def has_postprocess(self) -> bool:
        return getattr(self, "_postprocess_fn", None) is not None

    def segment_forward(self):
        """What a fused segment composes (``tensor_filter.lower_step``):
        ``(forward, batched, device)``, the EAGER per-frame and batched
        forwards (a staged pushdown taking over first) and their device.
        The segment captures them into its own CUDA graph, with the
        steps around the filter; this backend's graphs stay for the
        python tier."""
        with self._exec_lock:
            self._apply_fusion()
            return self._forward_fn, self._batched_fn, self._device
