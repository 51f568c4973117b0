"""Segment compiler: fused dispatch plans for linear pipeline runs.

The counterpart of ``nnstreamer_tpu/pipeline/schedule.py``, with its three
**lowering tiers** and their spellings (``Pipeline(fuse=…)``,
``NNS_FUSE``, ``NNS_FUSE_DEPTH``, the :meth:`SegmentPlanner.plans` rows
and the fallback reasons), so one launch string gives the same plan under
both packages:

``interpret``
    No segment compiler: per-pad ``Pad.push`` dispatch.  ``fuse=False``
    / ``NNS_FUSE=0``.
``python`` (fuse-python, the default)
    Maximal linear element runs flatten into one loop over bound
    :meth:`~nnstreamer_tpu_torch.pipeline.element.Element.plan_step`
    closures: the per-element dispatch cost is gone, each step still runs
    its host code (the filter replays its own CUDA graph).
``xla`` (fuse-xla)
    A segment whose every step also offers :meth:`~nnstreamer_tpu_torch.
    pipeline.element.Element.lower_step` runs its whole
    converter→transform→filter→decoder chain as ONE CUDA graph on the card
    (:class:`SegmentExec`, one ``_cuda.CapturedGraph`` a signature: the
    counterpart of one ``jax.jit`` executable), and as one eager call on
    the CPU.  Intermediate tensors stay on the device and the host sync
    moves to segment exit.  A segment with any non-lowerable step runs
    fuse-python (the plan row names the element and the reason).

Mechanics shared by the fused tiers (as the reference's):

- At ``Pipeline.play()`` a :class:`SegmentPlanner` finds every **head
  pad**: a linked src pad whose element cannot sit inside a run (source,
  queue, tee branch, any opt-out element).  Linear 1-sink/1-src elements
  downstream of a head that offer ``plan_step`` are fused: the head pad's
  ``push`` becomes one flat executor ending in the boundary element's
  ``_chain_entry``.
- Plans build lazily on the first buffer (caps are negotiated by then)
  and **invalidate** on caps renegotiation, custom events (model update)
  and request-pad links after play; ``enable_tracing`` only swaps the
  executors (:meth:`SegmentPlanner.retrace`), keeping warm graphs.
- fuse-xla graphs are cached per segment and input signature; a steady
  stream or a padded-bucket stream (``pad_rows``) captures each distinct
  signature once (:class:`SegmentExec` counts ``compiles`` vs ``hits``).
  On the card the first cross-stream bucket of a capacity captures every
  pad shape and a lone frame's signature, as the filter's open and
  ``warmup_stacked`` do, so no later bucket or frame stalls on a
  capture.
- fuse-xla dispatch is **double-buffered** (``NNS_FUSE_DEPTH``, default
  2): the executor holds a finished frame and pushes it once the next one
  is dispatched, ONLY while the head element already has the next item
  queued (``Element.has_pending_input``), so a quiescent stream pushes
  synchronously.  Any in-band event flushes the held slot first.  A
  segment's outputs are clones of the graph's static outputs, so a held
  frame is never overwritten by the next replay.
- Tracing: the fuse-python traced executor wraps each step in the same
  ``enter``/``exit`` pair ``_chain_entry`` uses; the fuse-xla one records
  one ``device-invoke`` (first call of a signature: ``device-compile``)
  window a segment and zero-length marks for the other fused elements.
  With no tracer the executors hold no tracer reference.

Install/uninstall shadows ``Pad.push`` with an instance attribute on head
pads only: interpreted pipelines never pay a check, and ``uninstall()``
(at ``Pipeline.stop``) restores the class method.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import _cuda
from ..analysis import compileledger
from ..analysis.sanitizer import make_rlock
from ..tensor.buffer import BatchView
from .element import Element, FlowReturn, LoweredStep, Pad

#: the lowering tiers, in ascending order of ambition
FUSE_TIERS = ("interpret", "python", "xla")

#: the compile-ledger site of a segment's executables (the reference's)
SEGMENT_SITE = "pipeline.segment"


def resolve_tier(value=None) -> str:
    """Normalize a ``fuse=`` value (bool / str / None) to a tier name.

    ``None`` reads ``NNS_FUSE`` (default ``python``); booleans keep the
    historical ``fuse=False`` → interpret meaning; strings accept the
    tier names plus ``0``/``1``/``fuse-python``/``fuse-xla`` spellings.
    """
    if value is None:
        value = os.environ.get("NNS_FUSE", "1")
    if isinstance(value, bool):
        return "python" if value else "interpret"
    v = str(value).strip().lower()
    if v in ("0", "false", "no", "off", "interpret", "none"):
        return "interpret"
    if v in ("", "1", "true", "yes", "on", "python", "fuse-python"):
        return "python"
    if v in ("2", "xla", "fuse-xla"):
        return "xla"
    raise ValueError(
        f"unknown fuse tier {value!r} (interpret | python | xla)")


def _is_linear_fusable(el: Element) -> bool:
    """Can ``el`` appear *inside* a fused run?  Exactly one sink and one
    src pad, and the element offers a plan step."""
    return (len(el.sink_pads) == 1 and len(el.src_pads) == 1
            and el.plan_step() is not None)


def _push_held(pending: list) -> None:
    """Push every held frame to the tail it was produced for, in order
    (each entry carries its own tail binding)."""
    while pending:
        entry, tp, out, _t = pending.pop(0)
        entry(tp, out)


def _dtype_name(x) -> str:
    """``float32`` for ``torch.float32`` and ``np.dtype('float32')``
    alike (the name a JAX array's dtype gives)."""
    return str(x.dtype).rpartition(".")[2]


class SegmentExec:
    """One fuse-xla segment's composed function and its executables.

    ``steps`` are the :class:`~nnstreamer_tpu_torch.pipeline.element.
    LoweredStep` s in segment order.  The segment runs on its steps'
    device (a filter's), else on the device of its first input tensor,
    else on the CPU.  On the card each input signature (shape and dtype
    of each input; the stacked ones of a cross-stream bucket apart) is a
    ``_cuda.CapturedGraph`` of the composed steps: its capture's eager
    run answers the call that built it, every later call copies the
    inputs into the graph's static inputs, replays, and clones the
    outputs (the next replay overwrites the graph's own).  On the CPU the
    composed steps run eagerly.  ``compiles`` counts the signatures built
    (each recorded in the compile ledger at ``pipeline.segment``),
    ``hits`` the calls that found theirs."""

    __slots__ = ("fns", "batched", "device", "post", "compiles", "hits",
                 "_cache", "_memory", "_warm")

    def __init__(self, steps: List[LoweredStep]) -> None:
        self.fns = tuple(ls.fn for ls in steps)
        self.batched = tuple(ls.batched if ls.batched is not None
                             else torch.func.vmap(ls.fn) for ls in steps)
        devices = [ls.device for ls in steps if ls.device is not None]
        self.device = torch.device(devices[0]) if devices else None
        self.post = steps[-1].post if steps else None
        self.compiles = 0
        self.hits = 0
        self._cache: Dict[tuple, object] = {}
        self._memory = None
        self._warm = 0       # capacity whose pad shapes are captured

    # plain torch over the steps, in segment order
    def _composed(self, *arrays):
        ts = list(arrays)
        for fn in self.fns:
            ts = list(fn(ts))
        return tuple(ts)

    def _composed_batched(self, *arrays):
        ts = list(arrays)
        for fn in self.batched:
            ts = list(fn(ts))
        return tuple(ts)

    def _inputs(self, arrays) -> list:
        """The inputs as tensors: device tensors as they are, host arrays
        as host tensors (pinned when the segment runs on the card).  The
        first call fixes the segment's device when no step names one."""
        arrays = [a.device_slice() if isinstance(a, BatchView) else a
                  for a in arrays]
        if self.device is None:
            first = next((a for a in arrays if isinstance(a, torch.Tensor)),
                         None)
            self.device = (first.device if first is not None
                           else torch.device("cpu"))
        return [_cuda.host_tensor(a, self._graphed()) for a in arrays]

    def _on_device(self, args) -> list:
        return [a if a.device == self.device
                else a.to(self.device, non_blocking=True) for a in args]

    @staticmethod
    def _sig(arrays, extra: tuple = ()) -> tuple:
        # the reference's key: (shape, dtype, weak_type) of each input;
        # arity is fixed: `arrays` is the segment's input tuple, whose
        # length the compiled plan pins at build time
        # nnsjit: allow(unbounded-signature)
        return extra + tuple((tuple(a.shape), _dtype_name(a), False)
                             for a in arrays)

    def _graphed(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def _compile(self, key: tuple, fun, args) -> Optional[tuple]:
        """Build the executable of ``key``: on the card a capture, whose
        eager run's outputs are returned; on the CPU a cache entry (the
        call then runs eagerly: None)."""
        self.compiles += 1
        compileledger.record(SEGMENT_SITE, key)
        if not self._graphed():
            self._cache[key] = None
            return None
        if self._memory is None:
            self._memory = _cuda.graph_memory(self.device)
        statics = [a.clone() for a in self._on_device(args)]
        with torch.inference_mode():
            try:
                # a queue's drain or a host consumer may call CUDA on
                # other threads while this one captures
                graph = _cuda.CapturedGraph(fun, statics, self._memory,
                                            error_mode="thread_local")
            except RuntimeError as exc:
                raise RuntimeError(f"CUDA graph capture of the segment for "
                                   f"{key} failed: {exc}") from exc
        self._cache[key] = graph
        return tuple(graph.first)

    def _call(self, key: tuple, fun, args) -> list:
        if key not in self._cache:
            outs = self._compile(key, fun, args)
            if outs is not None:
                return list(outs)
        else:
            self.hits += 1
        graph = self._cache[key]
        if graph is None:
            with torch.inference_mode():
                return list(fun(*self._on_device(args)))
        for static, x in zip(graph.inputs, args):
            static.copy_(x, non_blocking=True)
        return [o.clone() for o in graph.replay()]

    def run(self, arrays) -> list:
        """One per-frame dispatch through the segment."""
        args = self._inputs(arrays)
        return self._call(self._sig(args), self._composed, args)

    @staticmethod
    def _pad(args, rows: int) -> list:
        """Stacked inputs cut or padded to ``rows`` rows, padding by
        repeating the last live row (the padded-bucket policy of
        ``TorchExecMixin.invoke_stacked``)."""
        out = []
        for a in args:
            have = int(a.shape[0])
            if have > rows:
                a = a[:rows]
            elif have < rows:
                a = torch.cat([a, a[-1:].expand(
                    (rows - have,) + tuple(a.shape[1:]))])
            out.append(a)
        return out

    def run_stacked(self, arrays, n: int, capacity: int) -> list:
        """One cross-stream bucket (stacked ``(n, …)`` buffers) through
        the batched segment: rows pad to the ``pad_rows`` quantization,
        so a BOUNDED set of executables serves every fill; rows past
        ``n`` are padding and are never replied (XBatchMeta contract).
        Returns the PADDED stacked outputs."""
        from ..filter.backends._torchexec import TorchExecMixin

        # a host stack (a query server's bucket, pinned) pads on the
        # device: its one host copy was the stacking
        args = self._on_device(self._inputs(arrays))
        bucket = TorchExecMixin.pad_rows(n, capacity)
        padded = self._pad(args, bucket)
        if self._graphed() and self._warm != capacity:
            # the first bucket of a capacity captures every signature the
            # stream can dispatch (each pad shape, and a lone frame's,
            # which a serving plane sends unstacked), so no later bucket
            # or frame stalls on a capture
            self._warm = capacity
            lone = [a[0] for a in args]
            if self._sig(lone) not in self._cache:
                self._compile(self._sig(lone), self._composed, lone)
            for rows in sorted({TorchExecMixin.pad_rows(k, capacity)
                                for k in range(1, max(1, capacity) + 1)}):
                warm = self._pad(args, rows)
                key = self._sig(warm, extra=("xb",))
                if rows != bucket and key not in self._cache:
                    self._compile(key, self._composed_batched, warm)
        return self._call(self._sig(padded, extra=("xb",)),
                          self._composed_batched, padded)


class SegmentPlanner:
    """Owns the fused dispatch plans of one playing pipeline."""

    def __init__(self, pipeline) -> None:
        self.pipeline = pipeline
        #: lowering tier ("python" | "xla"); "interpret" never constructs
        #: a planner (Pipeline.play gates on pipeline.fuse)
        self.tier = getattr(pipeline, "fuse_tier", "python")
        #: fuse-xla double-buffer depth: 1 = synchronous push, 2 (the
        #: default) holds one finished frame while the next is dispatched
        try:
            self.depth = max(1, int(os.environ.get("NNS_FUSE_DEPTH", "2")))
        except ValueError:
            self.depth = 2
        self._lock = make_rlock("planner")
        self._heads: List[Pad] = []
        self._plans: Dict[str, Dict] = {}   # head full_name -> plan info
        #: bumped on every invalidate/rescan; tests assert rebuilds happened
        self.epoch = 0

    # -- lifecycle -----------------------------------------------------------
    def install(self) -> None:
        """Compute the head-pad set and arm every head with a lazy compile
        stub.  Called from ``Pipeline.play()``."""
        with self._lock:
            self._heads = self._find_heads()
            for head in self._heads:
                self._install_stub(head)

    def uninstall(self) -> None:
        """Restore interpreted dispatch everywhere (``Pipeline.stop``)."""
        with self._lock:
            pads = self._heads + [plan["_pad"]
                                  for plan in self._plans.values()]
            for pad in pads:
                pad.__dict__.pop("push", None)
                pad.__dict__.pop("push_event", None)
                pad.__dict__.pop("_nns_pending", None)
            self._heads = []
            self._plans.clear()

    def invalidate(self, element: Optional[Element] = None) -> None:
        """Drop the compiled plans ``element``'s state change can affect
        and reconcile the head set; affected heads recompile on their next
        buffer.  Called per element an event traverses (caps
        renegotiation, custom events), SCOPED, so an event delivered late
        on a queue's drain thread does not wipe an upstream segment's
        plan.  ``element=None`` (graph change) drops everything.  The head
        set is recomputed because ``plan_step`` answers are
        state-dependent."""
        with self._lock:
            self.epoch += 1
            for name, plan in list(self._plans.items()):
                if element is not None \
                        and element.name not in plan["elements"] \
                        and plan["tail"] != element.name \
                        and plan["_pad"].element is not element:
                    continue
                plan["_pad"].__dict__.pop("push", None)
                del self._plans[name]
            heads = self._find_heads()
            live = {p["head"] for p in self._plans.values()}
            for old in self._heads:
                if old not in heads and old.full_name not in live:
                    old.__dict__.pop("push", None)
            for head in heads:
                if head.full_name not in live \
                        and "push" not in head.__dict__:
                    self._install_stub(head)
            self._heads = heads

    def rescan(self) -> None:
        """The graph changed (request pad linked after play): full drop
        and head-set rebuild."""
        self.invalidate()

    def retrace(self) -> None:
        """A tracer attached (or detached): swap every compiled plan's
        executor in place, KEEPING the cached step list and the fuse-xla
        graphs (a tracer attaching to a warm pipeline captures nothing)."""
        with self._lock:
            for plan in self._plans.values():
                head = plan["_pad"]
                seg = plan.get("_seg")
                if seg is not None:
                    executor = self._make_xla_executor(
                        head, plan["_steps"], plan["_tail_pad"],
                        plan["_count"], seg)
                else:
                    executor = self._make_executor(
                        head, plan["_steps"], plan["_tail_pad"],
                        plan["_count"])
                head.push = executor

    def plans(self) -> List[Dict]:
        """Snapshot of the compiled plans: one dict a fused segment with
        ``head``, ``elements`` (fused element names in order), ``tail``
        (the boundary element it pushes into), ``epoch``, ``lowering``
        (``python`` | ``xla``, with ``fallback`` rows when an xla request
        fell back), ``dispatches`` (plan executions; a cross-stream bucket
        counts one) and, for xla plans, ``compiles``/``exec_cache_hits``."""
        with self._lock:
            out = []
            for p in self._plans.values():
                row = {k: v for k, v in p.items() if not k.startswith("_")}
                row["dispatches"] = p["_count"][0]
                seg = p.get("_seg")
                if seg is not None:
                    row["compiles"] = seg.compiles
                    row["exec_cache_hits"] = seg.hits
                out.append(row)
            return out

    # -- graph walk ----------------------------------------------------------
    def _find_heads(self) -> List[Pad]:
        """Every linked src pad whose owner cannot itself be fused as an
        intermediate."""
        heads: List[Pad] = []
        for el in self.pipeline.elements:
            if _is_linear_fusable(el):
                continue
            for pad in el.src_pads:
                if pad.peer is not None:
                    heads.append(pad)
        return heads

    def _walk(self, head: Pad) -> Tuple[List[Tuple[Callable, Element]],
                                        Optional[Pad]]:
        """Collect the maximal fusable run downstream of ``head``.
        Returns (steps, tail sink pad); empty steps = nothing to fuse."""
        steps: List[Tuple[Callable, Element]] = []
        pad = head.peer
        limit = len(self.pipeline.elements)   # cycle guard
        while pad is not None and len(steps) < limit:
            el = pad.element
            if len(el.sink_pads) != 1 or len(el.src_pads) != 1:
                break
            fn = el.plan_step()
            if fn is None:
                break
            steps.append((fn, el))
            pad = el.src_pads[0].peer
        return steps, pad

    # -- lowering ------------------------------------------------------------
    @staticmethod
    def _lower_segment(steps) -> Tuple[Optional[SegmentExec], List[Dict]]:
        """Lower every step of a segment into one :class:`SegmentExec`,
        or return the fallback rows (element + reason a non-lowerable
        step): the whole segment then runs fuse-python.  A host ``post``
        is only legal on the tail element."""
        fallback: List[Dict] = []
        lowered: List[LoweredStep] = []
        for i, (_, el) in enumerate(steps):
            try:
                ls = el.lower_step()
            except Exception as exc:  # noqa: BLE001 — element-specific
                fallback.append({"element": el.name,
                                 "reason": f"lower_step raised {exc!r}"})
                continue
            if ls is None:
                fallback.append({
                    "element": el.name,
                    "reason": el.lower_reason() or "lower_step "
                                                  "returned None"})
                continue
            if ls.post is not None and i != len(steps) - 1:
                fallback.append({
                    "element": el.name,
                    "reason": "host post-finisher only allowed on the "
                              "segment tail"})
                continue
            lowered.append(ls)
        if fallback:
            return None, fallback
        return SegmentExec(lowered), []

    # -- compilation ---------------------------------------------------------
    @staticmethod
    def _flush_pending(head: Pad) -> None:
        """Push out any frames a DROPPED xla plan left held, before a
        non-xla executor takes over the head: each entry carries its own
        tail binding, so the frames reach their tail in order."""
        _push_held(head.__dict__.get("_nns_pending") or [])

    def _install_stub(self, head: Pad) -> None:
        def compile_and_push(buf, _head=head):
            return self._compile(_head)(buf)

        head.push = compile_and_push

    def _compile(self, head: Pad) -> Callable:
        """Build (and install) the executor for ``head``.  Runs on the
        segment's own streaming thread, serialized against invalidation by
        the planner lock."""
        with self._lock:
            steps, tail_pad = self._walk(head)
            if not steps or tail_pad is None:
                # nothing fusable downstream: interpreted dispatch for this
                # head (an invalidate re-arms the stub)
                self._flush_pending(head)
                head.__dict__.pop("push", None)
                return lambda buf, _h=head: Pad.push(_h, buf)
            count = [0]
            plan = {
                "head": head.full_name,
                "elements": [el.name for _, el in steps],
                "tail": tail_pad.element.name,
                "epoch": self.epoch,
                "lowering": "python",
                "_pad": head,           # stripped from plans() snapshots
                "_count": count,        # plan executions (mutable cell)
                "_steps": steps,        # cached: retrace() reuses
                "_tail_pad": tail_pad,
            }
            seg = None
            if self.tier == "xla":
                seg, fallback = self._lower_segment(steps)
                if seg is not None:
                    plan["lowering"] = "xla"
                    plan["_seg"] = seg
                else:
                    plan["fallback"] = fallback
            if seg is not None:
                executor = self._make_xla_executor(head, steps, tail_pad,
                                                   count, seg)
                if self.depth > 1:
                    self._install_event_flush(head)
            else:
                self._flush_pending(head)
                executor = self._make_executor(head, steps, tail_pad,
                                               count)
            head.push = executor
            self._plans[head.full_name] = plan
            return executor

    def _make_executor(self, head: Pad, steps, tail_pad: Pad,
                       count: List[int]) -> Callable:
        pipeline = self.pipeline
        tracer = pipeline.tracer
        tail_entry = tail_pad.element._chain_entry
        plan = tuple(steps)
        OK, EOS, ERROR = FlowReturn.OK, FlowReturn.EOS, FlowReturn.ERROR
        FR = FlowReturn

        if tracer is None:
            def run(buf, _plan=plan, _head=head, _tail=tail_entry,
                    _tp=tail_pad, _n=count):
                if _head.eos:
                    return EOS
                _n[0] += 1
                el = None
                try:
                    for fn, el in _plan:
                        out = fn(buf)
                        if out is None:
                            return OK
                        if out.__class__ is FR:
                            return out
                        buf = out
                except Exception as exc:  # noqa: BLE001 — pipeline error
                    pipeline.post_error(el, exc)
                    return ERROR
                return _tail(_tp, buf)

            return run

        def run_traced(buf, _plan=plan, _head=head, _tail=tail_entry,
                       _tp=tail_pad, _tracer=tracer, _n=count):
            if _head.eos:
                return EOS
            _n[0] += 1
            el = None
            try:
                for fn, el in _plan:
                    _tracer.enter(el.name, buf)
                    try:
                        out = fn(buf)
                    finally:
                        _tracer.exit()
                    if out is None:
                        return OK
                    if out.__class__ is FR:
                        return out
                    buf = out
            except Exception as exc:  # noqa: BLE001 — pipeline error
                pipeline.post_error(el, exc)
                return ERROR
            return _tail(_tp, buf)

        return run_traced

    # -- fuse-xla executors --------------------------------------------------
    @staticmethod
    def _install_event_flush(head: Pad) -> None:
        """Shadow ``push_event`` on a double-buffered head: any in-band
        event flushes the held slot FIRST, so events never overtake data.
        Installed once; survives plan invalidation (the slot may hold a
        frame of the dropped plan; each entry carries its tail)."""
        if "push_event" in head.__dict__:
            return
        pending = head.__dict__.setdefault("_nns_pending", [])

        def push_event_flush(event, _head=head, _pend=pending):
            _push_held(_pend)
            return Pad.push_event(_head, event)

        head.push_event = push_event_flush

    def _make_xla_executor(self, head: Pad, steps, tail_pad: Pad,
                           count: List[int], seg: SegmentExec) -> Callable:
        """The whole-segment executor: one segment dispatch a buffer (a
        stacked bucket through the batched executables), the held slot for
        overlap, and the reference's one escape to the python tier: a
        stacked bucket whose tail carries a host post-finisher."""
        pipeline = self.pipeline
        tracer = pipeline.tracer
        tail_entry = tail_pad.element._chain_entry
        OK, EOS, ERROR = FlowReturn.OK, FlowReturn.EOS, FlowReturn.ERROR
        depth = self.depth
        pending = head.__dict__.setdefault("_nns_pending", [])
        last_el = steps[-1][1]
        py_run = self._make_executor(head, steps, tail_pad, count)
        els = tuple(el for _, el in steps)
        # hold a finished frame ONLY while the head element already has
        # the next in-band item queued: a sparse request/response flow
        # must never strand its reply in the held slot
        more = head.element.has_pending_input

        if tracer is None:
            def run(buf, _head=head, _seg=seg, _tail=tail_entry,
                    _tp=tail_pad, _n=count, _pend=pending, _depth=depth,
                    _py=py_run, _last=last_el, _more=more):
                if _head.eos:
                    return EOS
                xb = buf.extra.get("nns_xbatch")
                if xb is not None and _seg.post is not None:
                    # a host post-finisher is per frame (label lookup); it
                    # cannot run over a stacked bucket: python tier
                    _push_held(_pend)
                    return _py(buf)
                _n[0] += 1
                try:
                    if xb is not None:
                        outs = _seg.run_stacked(buf.tensors, xb.n,
                                                xb.capacity)
                    else:
                        outs = _seg.run(buf.tensors)
                    out = buf.with_tensors(outs)
                    if _seg.post is not None:
                        out = _seg.post(out)
                except Exception as exc:  # noqa: BLE001 — pipeline error
                    pipeline.post_error(_last, exc)
                    return ERROR
                if _depth > 1:
                    _pend.append((_tail, _tp, out, 0))
                    keep = _depth - 1 if _more() else 0
                    ret = OK
                    while len(_pend) > keep:
                        entry, tp, held, _t = _pend.pop(0)
                        ret = entry(tp, held)
                    return ret
                return _tail(_tp, out)

            return run

        from .tracing import annotate

        def run_traced(buf, _head=head, _seg=seg, _tail=tail_entry,
                       _tp=tail_pad, _tracer=tracer, _n=count,
                       _pend=pending, _depth=depth, _py=py_run,
                       _last=last_el, _els=els, _annotate=annotate,
                       _more=more, _now=time.monotonic_ns):
            if _head.eos:
                return EOS
            xb = buf.extra.get("nns_xbatch")
            if xb is not None and _seg.post is not None:
                _push_held(_pend)
                return _py(buf)
            _n[0] += 1
            try:
                # the tail-most fused element's span covers the shared
                # dispatch; the state annotation nests inside it
                _tracer.enter(_last.name, buf)
                try:
                    before = _seg.compiles
                    t0 = _now()
                    if xb is not None:
                        outs = _seg.run_stacked(buf.tensors, xb.n,
                                                xb.capacity)
                    else:
                        outs = _seg.run(buf.tensors)
                    t1 = _now()
                    _annotate("device-compile" if _seg.compiles > before
                              else "device-invoke", t0, t1)
                finally:
                    _tracer.exit()
                # zero-duration marks keep the other fused elements'
                # buffers counters truthful (their work ran jointly)
                for el in _els:
                    if el is not _last:
                        _tracer.enter(el.name, buf)
                        _tracer.exit()
                out = buf.with_tensors(outs)
                if _seg.post is not None:
                    out = _seg.post(out)
            except Exception as exc:  # noqa: BLE001 — pipeline error
                pipeline.post_error(_last, exc)
                return ERROR
            if _depth > 1:
                _pend.append((_tail, _tp, out, _now()))
                keep = _depth - 1 if _more() else 0
                ret = OK
                while len(_pend) > keep:
                    entry, tp, held, t_held = _pend.pop(0)
                    if t_held:
                        # the held slot's residency is deliberate
                        # pipelining: attribute it as queue-wait
                        ctx = held.extra.get("nns_trace")
                        _tracer.annotate_span(
                            "queue-wait", t_held, _now(),
                            seq=held.extra.get("nns_seq", -1),
                            trace_id=(ctx.trace_id if ctx is not None
                                      and ctx.trace_id else 0))
                    ret = entry(tp, held)
                return ret
            return _tail(_tp, out)

        return run_traced
