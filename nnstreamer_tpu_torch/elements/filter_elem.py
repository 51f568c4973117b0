"""tensor_filter: THE inference element.

The counterpart of ``nnstreamer_tpu/elements/filter_elem.py``, with its
parity to gst/nnstreamer/tensor_filter/tensor_filter.c (+ the shared
property/lifecycle logic of tensor_filter_common.c):

- properties: framework (incl. ``auto``), model, forced input/output
  dims/types, accelerator string, custom properties, input-combination /
  output-combination, latency/throughput readouts, shared key, is-updatable
  (reference property table tensor_filter_common.c)
- start() opens the backend (reference :1492-1504 → open_fw :2420)
- caps: sink accepts static tensors; src caps derived from model output info
  (reference transform_caps/configure :902-1280), with per-buffer
  validation in the hot loop (:557-626)
- hot loop (reference transform :631-894): validate → input-combination →
  invoke → output-combination/wrap → push, keeping device tensors unsynced
- model-update custom event (``tensor_filter_update_model``) triggers
  backend reload (reference :1413-1446)

- micro-batching (``batch``, ``batch-timeout-ms``, ``inflight``): frames
  coalesce into one device dispatch of the backend's batched forward (one
  CUDA graph per pad shape on the card), double-buffered, with a deadline
  thread for partial buckets; ``output-device`` cascades hand
  :class:`~nnstreamer_tpu_torch.tensor.buffer.BatchView` rows on;
  cross-stream buckets (``buf.extra["nns_xbatch"]``) dispatch as one
  padded invoke (:class:`CrossStreamBatcher` is the shared bucket core);
- the ``workers`` invoke pool, reassembling results in stream order.

The JAX package's fused-dispatch hooks (``plan_step``, ``lower_step``),
its metrics gauges and its trace spans are not ported: the port's
pipeline has the interpret tier only and no observability plane yet.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np

from ..analysis.sanitizer import make_condition, make_lock
from ..filter.framework import (Accelerator, FilterError, FilterProperties,
                                close_backend, open_backend)
from ..pipeline.element import (CustomEvent, Element, EOSEvent, FlowReturn,
                                QoSEvent)
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer, to_host
from ..tensor.caps_util import (caps_from_config, config_from_caps,
                                static_tensors_caps)
from ..tensor.info import TensorsConfig, TensorsInfo
from ..utils.log import ml_logw


def _parse_combination(s) -> Optional[List[int]]:
    if s in (None, ""):
        return None
    return [int(x) for x in str(s).split(",")]


class CrossStreamBatcher:
    """Bucket/dispatch core of the ``batch-timeout-ms`` coalescer (the JAX
    package's, for the cross-stream serving plane to share).

    A collecting bucket of opaque items dispatches when it FILLS (``add``
    returns True) or when the earliest resident deadline expires.
    Deadlines are PER ITEM — each ``add`` may carry its own residency
    budget (the QoS lever: ``query/overload.py bucket_budget`` gives gold
    a quarter of the configured timeout, so a gold frame landing in a
    bucket that bronze traffic opened pulls the dispatch deadline in) —
    and the bucket's effective deadline is the minimum over residents.

    Threadless by design: the owner supplies the waiting and the
    dispatch.  ``tensor_filter`` pairs it with its deadline-watcher
    thread.  Not itself thread-safe — callers serialize ``add``/``take``
    under their own coalesce lock where producers and watchers race.
    """

    __slots__ = ("capacity", "timeout_s", "items", "_t0", "_deadline",
                 "_clock")

    def __init__(self, capacity: int, timeout_s: float = 0.0,
                 clock=None) -> None:
        self.capacity = max(1, int(capacity))
        self.timeout_s = max(0.0, float(timeout_s))
        self._clock = clock if clock is not None else time.monotonic
        self.items: list = []
        self._t0: Optional[float] = None       # arrival of oldest item
        self._deadline: Optional[float] = None  # min(arrival + budget)

    @property
    def fill(self) -> int:
        return len(self.items)

    def full(self) -> bool:
        return len(self.items) >= self.capacity

    def opened_at(self) -> Optional[float]:
        """Arrival time of the oldest resident item (None when empty)."""
        return self._t0

    def deadline(self) -> Optional[float]:
        """Absolute dispatch deadline (None when empty)."""
        return self._deadline if self.items else None

    def add(self, item, budget_s: Optional[float] = None) -> bool:
        """Append one item; returns True when the bucket is now full
        (caller must dispatch).  ``budget_s`` overrides the bucket-wide
        ``timeout_s`` for this item's residency deadline."""
        now = self._clock()
        if not self.items:
            self._t0 = now
        budget = self.timeout_s if budget_s is None else max(0.0, budget_s)
        deadline = now + budget
        if self._deadline is None or deadline < self._deadline:
            self._deadline = deadline
        self.items.append(item)
        return len(self.items) >= self.capacity

    def expired(self, now: Optional[float] = None) -> bool:
        """True when a resident item's budget has run out (caller must
        dispatch the partial bucket)."""
        if not self.items or self._deadline is None:
            return False
        return (self._clock() if now is None else now) >= self._deadline

    def remaining(self, now: Optional[float] = None) -> float:
        """Seconds until the earliest resident deadline (0 when expired,
        +inf when empty)."""
        if not self.items or self._deadline is None:
            return float("inf")
        return max(0.0, self._deadline
                   - (self._clock() if now is None else now))

    def take(self) -> list:
        """Pop every resident item (bucket order) and reset."""
        items, self.items = self.items, []
        self._t0 = None
        self._deadline = None
        return items


@register_element
class TensorFilter(Element):
    FACTORY = "tensor_filter"
    PROPERTIES = {
        "framework": ("auto", "backend name or auto"),
        "model": (None, "model name/path/object"),
        "input-dim": (None, "forced input dims"),
        "input-type": (None, "forced input types"),
        "output-dim": (None, "forced output dims"),
        "output-type": (None, "forced output types"),
        "accelerator": (None, "e.g. true:gpu, or true:cpu for the CPU"),
        "custom": (None, "key:value,... custom properties"),
        "inputname": (None, "graph input tensor name(s) (reference "
                            "property; merged into custom props)"),
        "outputname": (None, "graph output tensor name(s)"),
        "inputlayout": (None, "reference per-tensor layout hints "
                              "(NHWC/NCHW/ANY/NONE) — accepted and "
                              "forwarded to the backend custom props"),
        "outputlayout": (None, "see inputlayout"),
        "inputranks": (None, "reference READABLE property: rank per "
                             "input tensor of the opened model"),
        "outputranks": (None, "reference READABLE property: rank per "
                              "output tensor"),
        "sub-plugins": (None, "reference READABLE property: registered "
                              "filter backends"),
        # "latency"/"throughput" (reference READABLE stats) are python
        # properties on this class — get_property reaches them via
        # getattr, so they must NOT appear here (the defaults loop
        # would try to assign the read-only descriptors)
        "input-combination": (None, "indices of input tensors to feed"),
        "output-combination": (None, "i0,i1/o0,o1 passthrough+output mix"),
        "shared-tensor-filter-key": (None, "share backend across instances"),
        "is-updatable": (False, "allow model-update events"),
        "latency-report": (False, "report invoke latency"),
        "batch": (1, "micro-batch N frames into one device invoke "
                     "(latency/throughput trade; backend-gated)"),
        "batch-timeout-ms": (0.0, "adaptive micro-batch deadline: with "
                                  "batch>1, dispatch the collecting "
                                  "bucket when it FILLS or when the "
                                  "oldest queued frame has waited this "
                                  "long, and flush in-flight results "
                                  "whose frames' budget expired.  0 = "
                                  "fixed batching (wait for a full "
                                  "bucket / EOS)"),
        "inflight": (1, "dispatched micro-batches kept in flight before "
                        "the oldest is awaited (pipeline depth).  1 = "
                        "double-buffered (one collecting, one "
                        "dispatched); costs K batches of output memory "
                        "and latency"),
        "workers": (1, "parallel invoke workers: N>1 spawns a pool that "
                       "consumes frames concurrently (per-worker backend "
                       "instance unless the backend declares "
                       "THREADSAFE_INVOKE) and reassembles results in "
                       "sequence order before pushing downstream.  With "
                       "batch>1 the micro-batch+inflight machinery "
                       "already overlaps dispatch, so workers is forced "
                       "to 1 there"),
        "output-device": (False, "emit device-resident outputs (BatchView "
                                 "payloads with batch>1, CUDA tensors "
                                 "otherwise): a downstream batched filter "
                                 "consumes them without a host round "
                                 "trip.  Host consumers still work: they "
                                 "copy one batch to the host on first "
                                 "touch"),
    }

    #: the reference's own property names for the same settings
    #: (gsttensor_filter_common: "input"/"inputtype"/"output"/
    #: "outputtype" set forced dims/types)
    REFERENCE_PROP_ALIASES = {
        "input": "input-dim", "inputtype": "input-type",
        "output": "output-dim", "outputtype": "output-type",
    }

    #: reference G_PARAM_READABLE-only properties (enforced by
    #: Element.set_property)
    READONLY_PROPERTIES = ("sub-plugins", "inputranks", "outputranks",
                           "latency", "throughput")

    def set_property(self, key, value):
        super().set_property(self.REFERENCE_PROP_ALIASES.get(key, key),
                             value)

    def get_property(self, key):
        key = self.REFERENCE_PROP_ALIASES.get(key, key)
        if key in ("sub-plugins", "sub_plugins"):
            from ..filter.framework import list_filters

            return ",".join(list_filters())   # registry is sorted
        if key in ("inputranks", "outputranks"):
            fw = getattr(self, "fw", None)
            if fw is None:
                return ""
            in_info, out_info = fw.get_model_info()
            info = in_info if key == "inputranks" else out_info
            return ",".join(str(len(t.dims)) for t in info)
        return super().get_property(key)

    def _make_pads(self):
        self.add_sink_pad(static_tensors_caps(), "sink")
        self.add_src_pad(static_tensors_caps(), "src")

    # -- lifecycle -----------------------------------------------------------
    def start(self):
        in_info = out_info = None
        if self.input_dim and self.input_type:
            in_info = TensorsInfo.from_strings(str(self.input_dim),
                                               str(self.input_type))
        if self.output_dim and self.output_type:
            out_info = TensorsInfo.from_strings(str(self.output_dim),
                                                str(self.output_type))
        custom = FilterProperties.parse_custom(self.custom)
        # "inputname=data" / "outputname=prob" (and the layout hints)
        # are first-class reference properties; backends read them from
        # the custom map
        for key in ("inputname", "outputname", "inputlayout",
                    "outputlayout"):
            val = getattr(self, key, None)
            if val not in (None, "") and key not in custom:
                custom[key] = str(val)
        props = FilterProperties(
            framework=str(self.framework or "auto"), model=self.model,
            input_info=in_info, output_info=out_info,
            accelerators=Accelerator.parse(self.accelerator),
            custom_properties=custom,
            shared_key=self.shared_tensor_filter_key)
        self.fw = open_backend(props)
        self._props = props
        self.stats = getattr(self.fw, "stats", None)
        self._in_comb = _parse_combination(self.input_combination)
        self._throttle_ns = 0          # QoS-driven drop interval
        self._last_kept_pts: Optional[int] = None
        self.dropped = 0               # frames throttle-dropped
        self._out_comb = None
        if self.output_combination not in (None, ""):
            ins, _, outs = str(self.output_combination).partition("/")
            self._out_comb = (_parse_combination(ins) or [],
                              _parse_combination(outs) or [])
        # micro-batching state (double-buffered: one batch collecting, one
        # dispatched-in-flight — see FilterFramework.invoke_batched);
        # batch=0 and unset both mean no micro-batching
        self._batch = max(1, int(self.batch or 1))
        if self._batch > 1 and not getattr(self.fw, "SUPPORTS_BATCHING",
                                           False):
            self._batch = 1
        self._emit_device = bool(self.output_device)
        # cross-stream batch accounting: invokes/frames served through
        # pre-batched buffers
        self._xb_invokes = 0
        self._xb_frames = 0
        self._xb_warm = 0      # capacity whose pad shapes are captured
        # FIFO of dispatched (bufs, handle, t0) batches; stream order is
        # the queue order
        self._inflight: deque = deque()
        self._inflight_depth = max(1, int(self.inflight or 1))
        if self._inflight_depth > 1 and self._batch <= 1:
            ml_logw("%s: inflight=%d needs micro-batching (batch>1); "
                    "running per-frame", self.name, self._inflight_depth)
            self._inflight_depth = 1
        self._rewarm = False            # capture owed after a pushdown
        self._pushdown = None           # fn of a fused device reduction
        # adaptive micro-batching: with batch-timeout-ms set, the watcher
        # thread dispatches a partial bucket (and flushes expired
        # in-flight results) once the OLDEST queued frame's latency
        # budget runs out
        self._batch_deadline = max(0.0,
                                   float(self.batch_timeout_ms or 0)) / 1e3
        if self._batch_deadline > 0 and self._batch <= 1:
            ml_logw("%s: batch-timeout-ms needs micro-batching (batch>1);"
                    " ignored", self.name)
            self._batch_deadline = 0.0
        # collecting bucket of (tensors, buf) pairs
        self._bucket = CrossStreamBatcher(self._batch, self._batch_deadline)
        self._coalesce_lock = make_lock("filter.coalesce")
        self._deadline_stop = threading.Event()
        self._deadline_thread = None
        # parallel invoke workers: a pool of N invoke threads fed from
        # chain(), with a pusher reassembling results in strict sequence
        # order; batch>1 already overlaps dispatch, so workers is 1 there
        self._workers_n = max(1, int(self.workers or 1))
        if self._workers_n > 1 and self._batch > 1:
            ml_logw("%s: workers=%d with batch>1: micro-batching already "
                    "overlaps dispatch (use inflight=); running workers=1",
                    self.name, self._workers_n)
            self._workers_n = 1
        thread_safe = bool(getattr(type(self.fw), "THREADSAFE_INVOKE",
                                   False))
        if self._workers_n > 1 and props.shared_key and not thread_safe:
            ml_logw("%s: workers=%d needs per-worker backend instances, "
                    "which shared-tensor-filter-key forbids (backend not "
                    "THREADSAFE_INVOKE); running workers=1",
                    self.name, self._workers_n)
            self._workers_n = 1
        if self._workers_n > 1:
            self._start_workers(thread_safe)
        if self._batch > 1:
            # every graph of the stream is captured here, before it: a
            # capture inside it would stall a batch and race the threads
            # a queue or the deadline watcher add
            self.fw.warmup_batched(self._batch)
        if self._batch_deadline > 0:
            self._deadline_thread = threading.Thread(
                target=self._deadline_loop, daemon=True,
                name=f"batch-deadline:{self.name}")
            self._deadline_thread.start()

    def stop(self):
        self._deadline_stop.set()
        if self._deadline_thread is not None:
            self._deadline_thread.join(timeout=10)
            self._deadline_thread = None
        self._stop_workers()
        close_backend(getattr(self, "fw", None), self._props)
        self.fw = None

    # -- negotiation ---------------------------------------------------------
    def set_caps(self, pad, caps):
        self._drain_batches()   # renegotiation must not reorder frames
        self._drain_workers()
        in_cfg = config_from_caps(caps)
        model_in, model_out = self.fw.get_model_info()
        if self._in_comb is not None:
            expect_sel = TensorsInfo([in_cfg.info[i] for i in self._in_comb])
            if not expect_sel.is_equal(model_in):
                raise ValueError(
                    f"{self.name}: input-combination {self._in_comb} gives "
                    f"{expect_sel}, model wants {model_in}")
        elif not in_cfg.info.is_equal(model_in):
            # try dynamic renegotiation (reference SET_INPUT_INFO path)
            try:
                _, model_out = self.fw.set_input_info(in_cfg.info)
            except FilterError:
                raise ValueError(
                    f"{self.name}: incoming {in_cfg.info} != model "
                    f"input {model_in}") from None
            # per-worker backend instances serve the same stream: they
            # renegotiate too
            for wfw in getattr(self, "_wk_backends", []):
                if wfw is not self.fw:
                    wfw.set_input_info(in_cfg.info)
        self._in_config = in_cfg
        out_infos = model_out
        if self._out_comb is not None:
            ins, outs = self._out_comb
            combined = [in_cfg.info[i] for i in ins] + \
                       [model_out[i] for i in outs]
            out_infos = TensorsInfo(combined)
        self._out_config = TensorsConfig(info=out_infos, rate=in_cfg.rate)
        self.announce_src_caps(caps_from_config(self._out_config))

    # -- hot loop ------------------------------------------------------------
    def _preprocess(self, buf: TensorBuffer):
        """QoS throttle-drop + per-buffer validation + input-combination.
        Returns the selected input tensor list, or ``FlowReturn.DROPPED``."""
        # QoS throttle-drop (reference :609): after a downstream QoS event,
        # drop frames arriving faster than the reported consumption rate
        if self._throttle_ns and buf.pts is not None:
            last = self._last_kept_pts
            if last is not None and buf.pts - last < self._throttle_ns:
                self.dropped += 1
                return FlowReturn.DROPPED
            self._last_kept_pts = buf.pts
        elif buf.pts is not None:
            self._last_kept_pts = buf.pts
        # per-buffer validation against negotiated meta (reference :557-626)
        in_info = self._in_config.info
        if buf.num_tensors != in_info.num_tensors:
            raise ValueError(
                f"{self.name}: buffer has {buf.num_tensors} tensors, "
                f"negotiated {in_info.num_tensors}")
        tensors = buf.tensors
        if self._in_comb is not None:
            tensors = [tensors[i] for i in self._in_comb]
        return tensors

    def chain(self, pad, buf: TensorBuffer) -> FlowReturn:
        fw = self.fw
        if fw is None or not fw.opened:
            raise RuntimeError(f"{self.name}: not started")
        xb = buf.extra.get("nns_xbatch")
        if xb is not None:
            # cross-stream batch: the frames arrive pre-coalesced, stacked
            # along a leading axis — one shared device invoke serves them
            # all.  Pre-batched traffic supersedes local micro-batching
            # and the worker pool (it IS the batching).
            return self.push(self._invoke_xbatch(buf, xb))
        tensors = self._preprocess(buf)
        if tensors.__class__ is FlowReturn:
            return tensors
        if self._batch > 1:
            if self._batch_deadline > 0:
                # the deadline watcher dispatches/flushes concurrently, so
                # collection and dispatch serialize on the coalesce lock
                # (stream order is the lock order)
                with self._coalesce_lock:
                    return self._collect_frame(tensors, buf)
            return self._collect_frame(tensors, buf)
        if self._workers_n > 1:
            return self._submit_frame(tensors, buf)
        return self._push_result(buf, fw.invoke(list(tensors)))

    def _invoke_xbatch(self, buf: TensorBuffer, xb) -> TensorBuffer:
        """One shared device invoke for a cross-stream batch buffer
        (``buf.extra["nns_xbatch"]``): tensors are pre-stacked ``(n,
        *frame_shape)`` rows from up to ``xb.capacity`` client streams.  A
        batching backend dispatches them through its padded-bucket graphs
        (``invoke_stacked``: one warm shape per pad bucket whatever the
        fill); others fall back to a row-wise invoke loop (correct, not
        faster).

        No QoS throttle-drop here: every row is an ADMITTED client
        request, and dropping one would strand its client's reply."""
        in_info = self._in_config.info
        if buf.num_tensors != in_info.num_tensors:
            raise ValueError(
                f"{self.name}: batch buffer has {buf.num_tensors} "
                f"tensors, negotiated {in_info.num_tensors}")
        tensors = buf.tensors
        if self._in_comb is not None:
            tensors = [tensors[i] for i in self._in_comb]
        fw = self.fw
        n = xb.n
        if getattr(fw, "SUPPORTS_BATCHING", False):
            if self._xb_warm != xb.capacity:
                # first bucket (or a capacity change): capture every pad
                # shape NOW, not one capture stall per shape spread
                # across the serving steady state
                fw.warmup_stacked(xb.capacity)
                self._xb_warm = xb.capacity
            outs = fw.invoke_stacked(list(tensors), n, capacity=xb.capacity)
        else:
            rows = [fw.invoke([t[i] for t in tensors]) for i in range(n)]
            outs = [np.stack([to_host(r[k]) for r in rows])
                    for k in range(len(rows[0]))]
        self._xb_invokes += 1
        self._xb_frames += n
        return self._compose_output(buf, list(outs))

    def _compose_output(self, buf: TensorBuffer, outs) -> TensorBuffer:
        out_tensors = outs
        if self._out_comb is not None:
            ins, sel = self._out_comb
            out_tensors = [buf.tensors[i] for i in ins] + \
                          [outs[i] for i in sel]
        return buf.with_tensors(out_tensors)

    def _push_result(self, buf: TensorBuffer, outs) -> FlowReturn:
        return self.push(self._compose_output(buf, list(outs)))

    # -- parallel invoke workers ---------------------------------------------
    def _start_workers(self, thread_safe: bool) -> None:
        """Spawn the invoke pool + ordered pusher.  Where the backend is
        not thread-safe each worker gets its OWN backend instance (same
        props, so same model and weights); a THREADSAFE_INVOKE backend is
        shared, so its graphs and device weights exist once."""
        backends = []
        for i in range(self._workers_n):
            if thread_safe or i == 0:
                backends.append(self.fw)
            else:
                backends.append(open_backend(dataclasses.replace(
                    self._props)))
        self._wk_backends = backends
        self._wk_tasks: queue.Queue = queue.Queue()
        self._wk_cv = make_condition("filter.workers")
        self._wk_results: dict = {}   # seq -> (buf, outs, exc)
        self._wk_seq = 0                # frames submitted
        self._wk_pushed = 0             # frames pushed (or error-skipped)
        self._wk_error = None
        self._wk_stop = False
        # in-flight bound: backpressure so a slow downstream or a burst
        # does not queue unbounded frames inside the element
        self._wk_sem = threading.Semaphore(self._workers_n * 2)
        self._wk_threads = [
            threading.Thread(target=self._worker_loop, args=(fw,),
                             daemon=True, name=f"invoke:{self.name}:{i}")
            for i, fw in enumerate(backends)]
        self._wk_pusher = threading.Thread(
            target=self._pusher_loop, daemon=True,
            name=f"invoke-push:{self.name}")
        for t in self._wk_threads:
            t.start()
        self._wk_pusher.start()

    def _submit_frame(self, tensors, buf: TensorBuffer) -> FlowReturn:
        self._wk_sem.acquire()
        with self._wk_cv:
            if self._wk_stop:
                self._wk_sem.release()
                return FlowReturn.EOS
            if self._wk_error is not None:
                self._wk_sem.release()
                return FlowReturn.ERROR
            seq = self._wk_seq
            self._wk_seq += 1
            # enqueue under the cv: _stop_workers sets _wk_stop under the
            # same lock BEFORE queueing the pool's exit sentinels, so a
            # task can never land behind a sentinel
            self._wk_tasks.put((seq, list(tensors), buf))
        return FlowReturn.OK

    def _worker_loop(self, fw) -> None:
        while True:
            item = self._wk_tasks.get()
            if item is None:
                return
            seq, tensors, buf = item
            try:
                res = (buf, list(fw.invoke(tensors)), None)
            except Exception as exc:  # noqa: BLE001 — surfaced by pusher
                res = (buf, None, exc)
            with self._wk_cv:
                self._wk_results[seq] = res
                self._wk_cv.notify_all()

    def _pusher_loop(self) -> None:
        """Reassemble worker results in strict sequence order and push
        downstream: output order is arrival order whatever each frame's
        invoke latency."""
        while True:
            with self._wk_cv:
                self._wk_cv.wait_for(
                    lambda: self._wk_pushed in self._wk_results
                    or (self._wk_stop
                        and self._wk_pushed >= self._wk_seq))
                if self._wk_pushed not in self._wk_results:
                    return              # stopped and fully drained
                buf, outs, exc = self._wk_results.pop(self._wk_pushed)
                failed = self._wk_error is not None
            if not failed:
                try:
                    if exc is not None:
                        raise exc
                    if self._push_result(buf, outs) is FlowReturn.ERROR:
                        raise RuntimeError(
                            f"{self.name}: downstream error from invoke "
                            "worker")
                except Exception as err:  # noqa: BLE001
                    with self._wk_cv:
                        self._wk_error = err
                    if self.pipeline is not None:
                        self.pipeline.post_error(self, err)
            # count the frame pushed (or skipped after an error, so
            # draining still converges) and free a submit slot
            with self._wk_cv:
                self._wk_pushed += 1
                self._wk_cv.notify_all()
            self._wk_sem.release()

    def _drain_workers(self) -> None:
        """Block until every submitted frame has been pushed, in order
        (EOS, renegotiation, model swap).  Raises on a worker/downstream
        failure so the event path posts a pipeline error."""
        if getattr(self, "_workers_n", 1) <= 1:
            return
        with self._wk_cv:
            self._wk_cv.wait_for(
                lambda: self._wk_pushed >= self._wk_seq)
            if self._wk_error is not None:
                raise RuntimeError(
                    f"{self.name}: invoke worker failed while draining"
                ) from self._wk_error

    def unblock(self):
        if getattr(self, "_workers_n", 1) > 1:
            with self._wk_cv:
                self._wk_stop = True
                self._wk_cv.notify_all()
            self._wk_sem.release()   # wake a producer blocked on the bound

    def _stop_workers(self) -> None:
        if getattr(self, "_workers_n", 1) <= 1:
            return
        with self._wk_cv:
            self._wk_stop = True
            self._wk_cv.notify_all()
        for _ in self._wk_threads:
            self._wk_tasks.put(None)
        for t in self._wk_threads:
            t.join(timeout=10)
        self._wk_pusher.join(timeout=10)
        for fw in self._wk_backends:
            if fw is not self.fw:
                fw.close()
        self._workers_n = 1

    # -- micro-batching ------------------------------------------------------
    def _collect_frame(self, tensors, buf: TensorBuffer) -> FlowReturn:
        """Append one frame to the collecting bucket; dispatch when it
        fills.  Caller holds the coalesce lock when the deadline watcher
        is active."""
        if self._rewarm:
            # owed by a pushdown fusion, which may have arrived on a
            # downstream queue's drain thread: capture both fused graphs
            # here, on the producer's thread, before the next dispatch
            self._rewarm = False
            self.fw.warmup_batched(self._batch)
        if self._bucket.add((list(tensors), buf)):
            return self._dispatch_pending()
        return FlowReturn.OK

    def _dispatch_pending(self) -> FlowReturn:
        """Dispatch the collecting batch, then — once the in-flight queue
        is at depth — push the OLDEST batch's results (the device→host
        copies of every queued batch overlap this batch's collection)."""
        t0 = self._bucket.opened_at()
        items = self._bucket.take()
        pending = [tensors for tensors, _ in items]
        bufs = [b for _, b in items]
        handle = self.fw.invoke_batched(pending, self._batch,
                                        emit_device=self._emit_device)
        self._inflight.append((bufs, handle, t0))
        if len(self._inflight) > self._inflight_depth:
            return self._push_inflight(self._inflight.popleft())
        return FlowReturn.OK

    def _push_inflight(self, inflight) -> FlowReturn:
        bufs, handle, _t0 = inflight
        per_frame = handle.views() if self._emit_device else handle.wait()
        ret = FlowReturn.OK
        for buf, outs in zip(bufs, per_frame):
            r = self._push_result(buf, outs)
            if r is FlowReturn.ERROR:
                return r
            ret = r
        return ret

    def _deadline_loop(self) -> None:
        """Coalescer watcher: dispatch a partial bucket (and flush expired
        in-flight batches) once the oldest queued frame has waited
        batch-timeout-ms.  Under throughput load buckets fill before
        their deadline and this thread just sleeps; on underrun it bounds
        per-frame latency.  A failure is posted as a pipeline error."""
        to = self._batch_deadline
        while not self._deadline_stop.is_set():
            try:
                with self._coalesce_lock:
                    now = time.monotonic()
                    oldest = self._oldest_t0()
                    if oldest is not None and now - oldest >= to:
                        self._flush_expired(now)
                        oldest = self._oldest_t0()
                wait = (to / 2 if oldest is None
                        else oldest + to - time.monotonic())
            except Exception as exc:  # noqa: BLE001 — becomes pipeline err
                if self.pipeline is not None:
                    self.pipeline.post_error(self, exc)
                return
            self._deadline_stop.wait(max(0.001, min(wait, to / 2)))

    def _oldest_t0(self):
        """Arrival time of the oldest un-pushed frame (None when idle).
        Caller holds the coalesce lock."""
        if self._inflight:
            return self._inflight[0][2]
        return self._bucket.opened_at()

    def _flush_expired(self, now: float) -> None:
        """Push every batch whose oldest frame's budget expired, oldest
        first; dispatch the partial bucket if ITS budget expired.  Caller
        holds the coalesce lock; stream order is preserved because both
        this thread and chain() push under it."""
        to = self._batch_deadline
        while self._inflight and now - self._inflight[0][2] >= to:
            if self._push_inflight(self._inflight.popleft()) \
                    is FlowReturn.ERROR:
                raise RuntimeError(
                    f"{self.name}: downstream error on deadline flush")
        if self._bucket.expired(now):
            # _dispatch_pending may itself push an over-depth batch: its
            # ERROR must propagate like the loop pushes' do
            if self._dispatch_pending() is FlowReturn.ERROR:
                raise RuntimeError(
                    f"{self.name}: downstream error on deadline flush")
            while self._inflight and now - self._inflight[0][2] >= to:
                if self._push_inflight(self._inflight.popleft()) \
                        is FlowReturn.ERROR:
                    raise RuntimeError(
                        f"{self.name}: downstream error on deadline flush")

    def _drain_batches(self) -> None:
        """Flush the collecting partial batch and the in-flight batches, in
        stream order (EOS, renegotiation, model swap).  A downstream ERROR
        raises so the event path posts a pipeline error."""
        if self._batch <= 1:
            return
        if self._batch_deadline > 0:
            with self._coalesce_lock:
                self._drain_batches_locked()
        else:
            self._drain_batches_locked()

    def _drain_batches_locked(self) -> None:
        ret = FlowReturn.OK
        if self._bucket.fill:
            ret = self._dispatch_pending()
        while self._inflight:
            r = self._push_inflight(self._inflight.popleft())
            ret = r if r is FlowReturn.ERROR else ret
        if ret is FlowReturn.ERROR:
            raise RuntimeError(
                f"{self.name}: downstream error while draining batches")

    # -- events --------------------------------------------------------------
    def on_upstream_event(self, pad, event):
        if isinstance(event, QoSEvent):
            # Reference src_event QOS handling (:1454-1485): derive a
            # throttling interval from the reported slowdown and the
            # stream's frame cadence; a catch-up report (jitter <= 0)
            # clears it.  Also auto-enables latency accounting.
            if event.jitter_ns <= 0:
                self._throttle_ns = 0
            else:
                rate = getattr(self, "_in_config", None)
                rate = rate.rate if rate is not None else None
                if rate and rate > 0:
                    frame_ns = (1_000_000_000 * rate.denominator
                                // rate.numerator)
                elif event.proportion > 1.0:
                    # jitter = dur·(proportion-1) at the reporter, so the
                    # frame duration is recoverable even without caps rate
                    frame_ns = max(
                        int(event.jitter_ns / (event.proportion - 1.0)), 1)
                else:
                    frame_ns = max(event.jitter_ns, 1)
                self._throttle_ns = int(frame_ns * max(1.0,
                                                       event.proportion))
                self.latency_report = True
            # keep propagating so upstream sources can throttle too — the
            # filter is a participant, not the owner
            super().on_upstream_event(pad, event)
            return True
        if isinstance(event, CustomEvent) and \
                event.name == "nns/device-reduce":
            # Reduction pushdown from a downstream decoder: compose its
            # device reduction into the backend's forward and re-announce
            # the (smaller) output caps.  The new caps travel in-band, and
            # decoders dispatch on actual tensor shapes.
            if self._out_comb is not None:
                # output-combination re-indexes/mixes the model outputs
                # AFTER invoke; a reduction computed against the combined
                # view cannot be fused onto the raw outputs
                return False
            if self._workers_n > 1:
                # the worker pool invokes concurrently, possibly on
                # per-worker backend instances: fusing into self.fw alone
                # would emit mixed output shapes under the reduced caps
                return False
            fn = event.data["fn"]
            if not self._fuse(fn):
                return False
            # remember the fusion: a model reload rebuilds the backend
            # (close+open), which would silently drop the device-fused
            # tail back to host decode — the update handler re-applies it
            self._pushdown = fn
            self._out_config = TensorsConfig(info=event.data["out_info"],
                                             rate=self._in_config.rate)
            self.announce_src_caps(caps_from_config(self._out_config))
            return True
        return super().on_upstream_event(pad, event)

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            self._drain_batches()
            self._drain_workers()   # all in-flight frames precede EOS
        if isinstance(event, CustomEvent) and \
                event.name == "tensor_filter_update_model":
            if not self.is_updatable:
                raise RuntimeError(f"{self.name}: not is-updatable")
            self._drain_batches()  # frames of the old model flush first
            self._drain_workers()
            try:
                self.fw.handle_event("reload_model", event.data)
                # per-worker backend instances serve the same model
                for wfw in getattr(self, "_wk_backends", []):
                    if wfw is not self.fw:
                        wfw.handle_event("reload_model", event.data)
            except Exception as exc:  # noqa: BLE001
                # a rejected reload keeps the old model serving — log and
                # keep streaming instead of erroring the pipeline (unless
                # the backend could not be restored at all)
                if not self.fw.opened:
                    raise
                ml_logw("%s: model reload rejected, keeping old model: %s",
                        self.name, exc)
            if self._batch > 1:
                self._rewarm = True     # a reload rebuilt the forward
            self._reapply_pushdown()
            return  # consumed, like the reference custom-event sink
        super().on_event(pad, event)

    def _fuse(self, fn) -> bool:
        """Compose a decoder's reduction into the backend's forwards and
        compile the fused forwards before the next dispatch (on the card:
        capture their graphs), so the stream finds them warm.  Per frame
        that is now; with micro-batching it is the producer's next
        chain(), since this may run on a downstream queue's drain
        thread: until then the backend keeps dispatching its unfused
        graphs (decoders dispatch on actual shapes)."""
        if not self.fw.set_postprocess(fn):
            return False
        self._xb_warm = 0               # the pad set is captured anew
        if self._batch > 1:
            self._rewarm = True
            return True
        warmup = getattr(self.fw, "warmup", None)
        if warmup is not None:
            warmup()
        return True

    def _reapply_pushdown(self) -> None:
        """Restore a device-fused decoder reduction after a model reload:
        a close+open swap rebuilt the backend WITHOUT the fused tail.  The
        reload interface check guarantees the model's tensor io is
        unchanged, so the stored reduction still applies.  If the fresh
        backend refuses the fusion, fall back loudly to the full output
        caps (decoders dispatch on actual shapes, so correctness holds
        either way)."""
        if self._pushdown is None or not getattr(self.fw, "opened", False):
            return
        if self.fw.has_postprocess():
            # the backend kept its fusion: re-fusing would compose the
            # reduction over the already-reduced outputs
            return
        if self._fuse(self._pushdown):
            return
        ml_logw("%s: device-reduce fusion could not be re-applied after "
                "reload; serving full outputs (host decode)", self.name)
        self._pushdown = None
        _, model_out = self.fw.get_model_info()
        self._out_config = TensorsConfig(info=model_out,
                                         rate=self._in_config.rate)
        self.announce_src_caps(caps_from_config(self._out_config))

    def report_latency(self) -> int:
        """LATENCY-query contribution: rolling average invoke latency in ns
        when latency-report is on (reference tensor_filter.c:1313-1377)."""
        if not self.latency_report:
            return 0
        lat_us = self.latency
        return lat_us * 1000 if lat_us > 0 else 0

    # -- stats readout (reference readable props :2163-2171) -----------------
    @property
    def latency(self) -> int:
        stats = getattr(self, "stats", None)
        return stats.latency_us if stats else -1

    @property
    def throughput(self) -> float:
        stats = getattr(self, "stats", None)
        return stats.throughput if stats else 0.0
