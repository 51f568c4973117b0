"""Pipeline container, sources, queues, tee: the scheduling substrate.

Supplies the GStreamer-pipeline role (reference L0, SURVEY.md §1): element
ownership, state changes, streaming threads, EOS aggregation, error posting.
Scheduling model: each :class:`Source` owns one streaming thread; dataflow is
synchronous downstream of it.  A :class:`Queue` introduces a thread
boundary with a bounded buffer (backpressure); events travel through it
in band.  While playing, a :class:`~nnstreamer_tpu_torch.pipeline.
schedule.SegmentPlanner` fuses the linear runs between those boundaries
(``Pipeline(fuse=…)``, the JAX package's tiers).
"""

from __future__ import annotations

import threading
import time
import queue as _queue
from typing import Dict, List, Optional

from ..analysis.sanitizer import make_condition
from ..tensor.buffer import TensorBuffer
from .caps import Caps
from .element import CapsEvent, Element, EOSEvent, Event, FlowReturn, Pad
from .registry import register_element


class PipelineError(RuntimeError):
    def __init__(self, element: Element, cause: BaseException):
        super().__init__(f"element {element.name}: {cause!r}")
        self.element = element
        self.cause = cause


class Pipeline:
    """Owns elements, drives state, aggregates EOS/errors.

    Usage::

        p = Pipeline()
        src, conv, filt, sink = p.add(VideoTestSrc(...), TensorConverter(),
                                      TensorFilter(...), TensorSink())
        p.link(src, conv, filt, sink)
        p.run()          # play + wait EOS + stop
    """

    def __init__(self, name: str = "pipeline", fuse=None):
        self.name = name
        self.tracer = None          # set by enable_tracing()
        #: lowering tier of the segment compiler (schedule.py):
        #: ``interpret`` (no fusion), ``python`` (flat plan_step loops,
        #: the default) or ``xla`` (one CUDA graph a lowerable segment).
        #: ``fuse`` takes a boolean, a tier name, or None = the NNS_FUSE
        #: env ("0" | "1" | "xla"); ``self.fuse`` is the boolean view.
        from .schedule import resolve_tier

        self.fuse_tier = resolve_tier(fuse)
        self.fuse = self.fuse_tier != "interpret"
        self.planner = None         # SegmentPlanner while playing
        self.elements: List[Element] = []
        self._by_name: Dict[str, Element] = {}
        self._error: Optional[PipelineError] = None
        self._eos_sinks: set = set()
        self._cv = make_condition("pipeline.state")
        self._playing = False
        #: readiness lifecycle: starting -> serving -> draining
        self._lifecycle = "starting"

    # -- construction --------------------------------------------------------
    def add(self, *elements: Element):
        for el in elements:
            if el.name in self._by_name:
                raise ValueError(f"duplicate element name {el.name!r}")
            el.pipeline = self
            self.elements.append(el)
            self._by_name[el.name] = el
        return elements if len(elements) > 1 else elements[0]

    def get(self, name: str) -> Element:
        return self._by_name[name]

    def link(self, *elements: Element) -> None:
        """Link a chain src→sink, creating request pads as needed."""
        for a, b in zip(elements, elements[1:]):
            src = self._pick_src_pad(a)
            sink = self._pick_sink_pad(b)
            src.link(sink)

    def link_pads(self, a: Element, src_pad: Optional[str],
                  b: Element, sink_pad: Optional[str]) -> None:
        """Link with explicitly named pads (gst-launch ``mux.sink_1``
        syntax); ``None`` falls back to first-free/request.  Named pads
        resolve FIRST so a bad name fails before any free pad is
        requested."""
        src = sink = None
        if src_pad:
            src = self._named_pad(a, src_pad, a.src_pads,
                                  a.request_src_pad)
        if sink_pad:
            sink = self._named_pad(b, sink_pad, b.sink_pads,
                                   b.request_sink_pad)
        if src is None:
            src = self._pick_src_pad(a)
        if sink is None:
            sink = self._pick_sink_pad(b)
        src.link(sink)

    @staticmethod
    def _named_pad(el: Element, name: str, pads, request) -> Pad:
        import re

        for p in pads:
            if p.name == name:
                if p.peer is not None:
                    raise ValueError(f"{el.name}.{name} is already linked")
                return p
        # request pads are created on demand in sequence (sink_0, sink_1,
        # …): only request up to the asked-for index, and only when the
        # name fits the scheme — a typo must not spray orphan pads
        m = re.fullmatch(r"(?:sink|src)_(\d+)", name)
        if m is None:
            raise ValueError(f"{el.name}: no pad named {name!r}")
        want = int(m.group(1))
        try:
            while len(pads) <= want:
                p = request()
                if p.name == name:
                    return p
        except NotImplementedError:
            pass  # static-pad element: fall through to the ValueError
        raise ValueError(f"{el.name}: no pad named {name!r}")

    @staticmethod
    def _pick_src_pad(el: Element) -> Pad:
        for p in el.src_pads:
            if p.peer is None:
                return p
        return el.request_src_pad()

    @staticmethod
    def _pick_sink_pad(el: Element) -> Pad:
        for p in el.sink_pads:
            if p.peer is None:
                return p
        return el.request_sink_pad()

    # -- state ---------------------------------------------------------------
    @property
    def sinks(self) -> List[Element]:
        return [e for e in self.elements if not e.src_pads]

    def play(self) -> None:
        self._check_links()
        for el in self.elements:
            try:
                el.start()
            except Exception as exc:  # noqa: BLE001
                raise PipelineError(el, exc) from exc
            el._started = True
        self._playing = True
        if self.fuse:
            from .schedule import SegmentPlanner

            self.planner = SegmentPlanner(self)
            self.planner.install()
        #: running-time origin: sinks with sync=true render buffer PTS
        #: against this (GStreamer base-time role)
        self.base_time_ns = time.monotonic_ns()
        self._lifecycle = "serving"
        for el in self.elements:
            if isinstance(el, Source):
                try:
                    el._spawn()
                except Exception as exc:  # noqa: BLE001
                    # SYNC_NEGOTIATE sources negotiate HERE: a caps
                    # failure surfaces as the same PipelineError start()
                    # failures do, not as a raw ValueError
                    raise PipelineError(el, exc) from exc

    def health_state(self) -> str:
        """Readiness state: the lifecycle phase, demoted to ``degraded``
        while any element reports it (a ``tensor_query_client`` whose
        endpoint breakers are open) and to ``draining`` while a serving
        element refuses new work."""
        if self._lifecycle == "serving":
            if self._error is not None:
                return "degraded"
            worst = "serving"
            for el in self.elements:
                state = el.health_state()
                if state == "draining":
                    return "draining"
                if state == "degraded":
                    worst = "degraded"
            return worst
        return self._lifecycle

    def enable_tracing(self, spans: bool = False):
        """Attach a dataflow tracer (proctime/framerate per element, the
        GstShark tracer role).  Returns the
        :class:`~nnstreamer_tpu_torch.pipeline.tracing.Tracer`; call
        ``tracer.report()`` after the run.  ``spans=True`` additionally
        records per-buffer timeline spans (``tracer.export_chrome``), the
        ones a query server sends its clients after each reply."""
        from .tracing import Tracer

        self.tracer = Tracer(spans=spans)
        if self.planner is not None:
            # compiled executors bind the tracer when built: swap them in
            # place, keeping the step lists and warm fuse-xla graphs
            self.planner.retrace()
        return self.tracer

    def _check_links(self) -> None:
        for el in self.elements:
            for p in el.sink_pads + el.src_pads:
                if p.peer is None:
                    raise RuntimeError(
                        f"unlinked pad {p.full_name} (request pads are "
                        "created sequentially: naming sink_N also creates "
                        "sink_0..sink_N-1, which must all be linked)")

    def query_latency(self) -> "tuple[int, Dict[str, int]]":
        """Pipeline LATENCY query (reference: GStreamer latency query with
        tensor_filter injecting its invoke latency, tensor_filter.c:
        1313-1377): returns (total_ns, {element_name: ns}) summing every
        element's reported contribution."""
        per = {el.name: el.report_latency() for el in self.elements}
        per = {k: v for k, v in per.items() if v > 0}
        return sum(per.values()), per

    def post_error(self, element: Element, exc: BaseException) -> None:
        with self._cv:
            if self._error is None:
                self._error = PipelineError(element, exc)
            self._cv.notify_all()

    def _sink_eos(self, element: Element) -> None:
        with self._cv:
            self._eos_sinks.add(element.name)
            self._cv.notify_all()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Wait until every sink reached EOS (or an error was posted)."""
        sink_names = {e.name for e in self.sinks}
        with self._cv:
            ok = self._cv.wait_for(
                lambda: self._error is not None
                or sink_names <= self._eos_sinks, timeout)
        if self._error is not None:
            # raise a FRESH chained copy: re-raising the stored object on a
            # second wait() would keep appending traceback frames to it
            err = PipelineError(self._error.element, self._error.cause)
            raise err from self._error
        if not ok:
            raise TimeoutError(f"pipeline {self.name}: EOS not reached")

    def drain(self, deadline: float = 5.0) -> None:
        """Graceful drain, then stop: elements that front external
        clients refuse new work with explicit retry-after answers and
        finish their in-flight replies (``Element.drain``, e.g.
        ``tensor_query_serversrc`` -> ``QueryServer.drain``), then the
        pipeline is torn down.  The CLI's SIGTERM handler calls this."""
        self._lifecycle = "draining"
        for el in self.elements:
            if el._started:
                try:
                    el.drain(deadline)
                except Exception as exc:   # noqa: BLE001 - one element's
                    # failure must not block the teardown of the rest
                    from ..utils.log import logger

                    logger.warning("%s: drain failed: %r", el.name, exc)
        self.stop()

    def stop(self) -> None:
        self._playing = False
        self._lifecycle = "draining"
        # phase 0: release blocking waits (a sync sink's PTS wait holds
        # the very streaming thread _halt() is about to join)
        for el in self.elements:
            if el._started:
                el.unblock()
        for el in self.elements:
            if isinstance(el, Source):
                el._halt()
        for el in self.elements:
            if el._started:
                el.stop()
                el._started = False
        if self.planner is not None:
            self.planner.uninstall()
            self.planner = None

    def run(self, timeout: Optional[float] = None) -> None:
        try:
            self.play()
            self.wait(timeout)
        finally:
            self.stop()


class Source(Element):
    """Base push source: owns a streaming thread, emits caps then buffers
    then EOS.  Subclasses implement :meth:`negotiate` (return fixed src
    caps) and :meth:`create` (return next buffer or None for EOS) —
    mirroring GstPushSrc's create vfunc (reference datareposrc/srciio use
    this model)."""

    #: sources whose negotiate() is pure (no I/O, no blocking) announce
    #: caps from play()'s thread in _spawn, BEFORE the streaming thread
    #: exists.  An app that calls element.push() right after play()
    #: otherwise races the loop thread's announcement and can reach a
    #: downstream chain() before set_caps() negotiated (seen as a flaky
    #: AttributeError on tensor_filter._in_config under suite load).
    #: Network-backed sources keep the in-thread announce: their
    #: negotiate() may block on a peer and must not stall play().
    SYNC_NEGOTIATE = False

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._thread: Optional[threading.Thread] = None
        self._halted = threading.Event()
        self._caps_announced = False

    def negotiate(self) -> Caps:
        raise NotImplementedError

    def create(self) -> Optional[TensorBuffer]:
        raise NotImplementedError

    def _spawn(self) -> None:
        self._halted.clear()
        self._caps_announced = False
        if self.SYNC_NEGOTIATE:
            self.announce_src_caps(self.negotiate())
            self._caps_announced = True
        self._thread = threading.Thread(target=self._loop,
                                        name=f"src:{self.name}", daemon=True)
        self._thread.start()

    def _halt(self) -> None:
        self._halted.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=10)

    def _loop(self) -> None:
        try:
            if not self._caps_announced:
                caps = self.negotiate()
                self.announce_src_caps(caps)
                self._caps_announced = True
            seq = 0
            while not self._halted.is_set():
                buf = self.create()
                if buf is None:
                    break
                pl = self.pipeline
                if pl is not None and pl.tracer is not None:
                    self._stamp(pl.tracer, buf.extra, seq)
                seq += 1
                ret = self.push(buf)
                if ret in (FlowReturn.ERROR, FlowReturn.EOS):
                    break
            self.src_pad.push_event(EOSEvent())
        except Exception as exc:  # noqa: BLE001
            if self.pipeline is not None:
                self.pipeline.post_error(self, exc)
            else:
                raise

    def _stamp(self, tr, extra: dict, seq: int) -> None:
        """Source stamp under a tracer: seq, birth time (the
        interlatency origin) and the trace context every transport sink
        forwards on the wire.  Seq and birth are overwritten per push (an
        app may reuse one buffer object); a wire-restored trace context
        (the query server's) survives."""
        extra["nns_seq"] = seq
        src_ns = extra["nns_src_ns"] = time.monotonic_ns()
        if "nns_trace" not in extra:
            from ..obs.span import TraceContext

            extra["nns_trace"] = TraceContext(
                tr.trace_id, 0,
                tr.anchor_wall_us + (src_ns - tr.anchor_mono_ns) // 1000)
        if tr.ring is None:
            return
        from ..obs.span import Span

        # zero-duration birth marker: the frame window's left edge
        tid = extra["nns_trace"].trace_id or tr.trace_id
        tr.ring.append(Span("src:" + self.name, threading.get_ident(),
                            src_ns, 0, seq, tid))
        adm = extra.pop("nns_admission_ns", None)
        if adm is not None:
            # a serving source (serversrc) deferred its admission-wait
            # span to here, the one place seq is assigned
            tr.annotate_span("admission-wait", adm[0], adm[1], seq=seq,
                             trace_id=tid)
        for state, s0, s1, stid in extra.pop("nns_xb_spans", ()):
            # a cross-stream bucket's per-frame residency spans, each
            # under its own client's trace id
            tr.annotate_span(state, s0, s1, seq=seq, trace_id=stid or tid)


@register_element
class AppSrc(Source):
    """Programmatic source: caller supplies caps and feeds buffers
    (GStreamer appsrc role; used heavily by tests the way the reference's
    gtest pipelines use appsrc, tests/nnstreamer_plugins/unittest_plugins.cc).
    """

    FACTORY = "appsrc"
    PROPERTIES = {"caps": (None, "fixed caps to announce")}
    #: caps come from a property — negotiation is pure, so it runs in
    #: play() before the app can push() (Source.SYNC_NEGOTIATE contract)
    SYNC_NEGOTIATE = True

    #: in-band wake marker: create() blocks on the fifo with NO timeout
    #: (event-driven, zero idle wakeups); unblock()/_halt() enqueue this
    #: so teardown can interrupt the blocking get
    _WAKE = object()

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        # app-side producer owns the pacing: the prefill-before-play
        # contract (benches queue thousands of frames before the first
        # consumer exists) rules out a blocking bound here
        # nnslint: allow(unbounded-queue)
        self._fifo: _queue.Queue = _queue.Queue()

    def _make_pads(self):
        self.add_src_pad(Caps.any(), "src")

    def push_buffer(self, buf: TensorBuffer) -> None:
        self._fifo.put(buf)

    def has_pending_input(self) -> bool:
        # fuse-xla double-buffer gate: hold a finished frame only while
        # the fifo already carries the next item (buffer OR event: an
        # event flushes the held slot when it drains)
        return not self._fifo.empty()

    def push_event(self, event: Event) -> None:
        """Queue a downstream event IN-BAND: it is delivered from the
        streaming thread in arrival order with the buffers (how GStreamer
        apps send e.g. tensor_filter_update_model through appsrc — the
        serialization guarantees no frame races the event)."""
        self._fifo.put(event)

    def end_of_stream(self) -> None:
        self._fifo.put(None)

    def negotiate(self) -> Caps:
        caps = self.caps
        if isinstance(caps, str):
            caps = Caps.from_string(caps)
        if caps is None:
            raise ValueError("appsrc requires caps property")
        return caps

    def unblock(self):
        self._fifo.put(self._WAKE)

    def _halt(self) -> None:
        # order matters: set the flag BEFORE the wake marker, so a create()
        # that consumes the marker observes halted and exits (the reverse
        # order could consume the wake, see un-halted, and block forever)
        self._halted.set()
        self._fifo.put(self._WAKE)
        super()._halt()

    def create(self) -> Optional[TensorBuffer]:
        while True:
            item = self._fifo.get()
            if item is self._WAKE:
                if self._halted.is_set():
                    return None
                continue            # pre-halt unblock(): spurious, re-wait
            if isinstance(item, Event):
                self.src_pad.push_event(item)
                continue
            return item


@register_element
class Queue(Element):
    """Thread-boundary element with a bounded buffer.

    The GStreamer ``queue`` role (the JAX package's ``Queue``): decouples
    upstream and downstream into separate streaming threads with
    backpressure.  Events travel through the queue in band, so ordering
    is kept.
    """

    FACTORY = "queue"
    PROPERTIES = {"max-size-buffers": (16, "queue capacity")}
    UPSTREAM_TRANSPARENT = True    # buffers pass untouched, one consumer

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")
        self.add_src_pad(Caps.any(), "src")

    def start(self):
        # capacity bounds DATA buffers only (the _used counter); the queue
        # itself is unbounded so control markers (caps/events/EOS) can
        # always be enqueued — a caps announcement arriving from the
        # drain thread of a downstream queue must never block on data
        # capacity (that is a self-deadlock: the would-be consumer is
        # the blocked thread).  DATA admission blocks on the _space
        # condition below, so depth is bounded by construction.
        # nnslint: allow(unbounded-queue)
        self._q: _queue.Queue = _queue.Queue()
        self._cap = max(1, int(self.max_size_buffers))
        self._used = 0
        self._space = make_condition("queue.space")
        self._drain_done = False
        self._worker = threading.Thread(target=self._drain,
                                        name=f"queue:{self.name}", daemon=True)
        self._stop = threading.Event()
        self._worker.start()

    def unblock(self):
        with self._space:
            self._space.notify_all()

    def stop(self):
        self._stop.set()
        with self._space:
            self._space.notify_all()
        # drain so the sentinel always fits even if the worker died with a
        # full queue (upstream error case)
        while True:
            try:
                self._q.get_nowait()
            except _queue.Empty:
                break
        self._q.put(None)
        self._worker.join(timeout=10)

    def get_allowed_caps(self, sink_pad):
        return self.src_pad.peer_allowed_caps()

    def has_pending_input(self) -> bool:
        # fuse-xla double-buffer gate (Element.has_pending_input): the
        # drain thread heads the downstream segment, and _q holds what it
        # processes next
        return not self._q.empty()

    def _enqueue(self, buf) -> FlowReturn:
        """Slot-bounded data put that can't deadlock: purely event-driven
        (no poll) — woken by the drain worker freeing a slot, by stop(),
        or by the worker exiting (EOS drained / downstream error)."""
        with self._space:
            while True:
                if self._stop.is_set():
                    return FlowReturn.EOS
                if self._used < self._cap:
                    break
                if self._drain_done:
                    return FlowReturn.ERROR
                self._space.wait()
            self._used += 1
        self._q.put(("buf", buf))
        return FlowReturn.OK

    def _enqueue_event(self, event) -> None:
        if not self._stop.is_set():
            self._q.put(("event", event))   # unbounded: never blocks

    def chain(self, pad, buf):
        return self._enqueue(buf)

    def set_caps(self, pad, caps):
        self._enqueue_event(CapsEvent(caps))

    def on_event(self, pad, event):
        self._enqueue_event(event)

    def _release_slot(self):
        with self._space:
            self._used -= 1
            self._space.notify()

    def _drain(self):
        try:
            while not self._stop.is_set():
                item = self._q.get()
                if item is None:
                    return
                kind, payload = item
                try:
                    if kind == "buf":
                        try:
                            self.src_pad.push(payload)
                        finally:
                            self._release_slot()
                    else:
                        self.src_pad.push_event(payload)
                        if isinstance(payload, EOSEvent):
                            return
                except Exception as exc:  # noqa: BLE001
                    if self.pipeline is not None:
                        self.pipeline.post_error(self, exc)
                    return
        finally:
            # wake any producer blocked on a full queue: _drain_done is the
            # worker-exited signal _enqueue checks, set under the lock so a
            # waiter can't re-check and sleep between the flag write and
            # the notify
            with self._space:
                self._drain_done = True
                self._space.notify_all()


@register_element
class Tee(Element):
    """1→N branch duplicator (GStreamer ``tee`` role).  Tensor PAYLOADS are
    shared, never copied: each branch gets a fresh :class:`TensorBuffer`
    wrapper (so per-buffer ``extra``/meta mutations stay branch-local)
    holding the same tensor handles, so device tensors stay on the
    device.  Downstream must not mutate tensor data in place.  Each
    branch heads a fused segment of its own (schedule.py)."""

    FACTORY = "tee"

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._done: set = set()     # branch pads that returned EOS

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")

    def request_src_pad(self) -> Pad:
        return self.add_src_pad(Caps.any())

    def start(self):
        self._done = set()

    def get_allowed_caps(self, sink_pad):
        allowed = Caps.any()
        for sp in self.src_pads:
            allowed = allowed.intersect(sp.peer_allowed_caps())
        return allowed

    def chain(self, pad, buf):
        # a branch that answered EOS is done for good: drop it from the
        # fan-out; the LAST live branch gets the original wrapper (no
        # copy), the others a fresh wrapper each
        done = self._done
        live = [sp for sp in self.src_pads if sp not in done]
        if not live:
            return FlowReturn.EOS
        last = len(live) - 1
        for i, sp in enumerate(live):
            ret = sp.push(buf if i == last else buf.copy())
            if ret is FlowReturn.ERROR:
                return ret
            if ret is FlowReturn.EOS:
                done.add(sp)
        return FlowReturn.EOS if len(done) >= len(self.src_pads) \
            else FlowReturn.OK
