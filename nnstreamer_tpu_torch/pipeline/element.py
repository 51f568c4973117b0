"""Pipeline substrate: elements, pads, events.

The reference builds on GStreamer's element/pad/caps machinery (external, L0
in SURVEY.md) — pad push model, caps events, EOS propagation
(gst/nnstreamer/elements/* all subclass GstElement).  This module supplies
that substrate for the PyTorch port, with the JAX package's fused-dispatch
hooks (``plan_step``, ``lower_step``, ``lower_reason``,
``has_pending_input``) that the segment compiler (schedule.py) reads:

- **Push model**: a src :class:`Pad` pushes :class:`TensorBuffer` s into its
  peer sink pad, which dispatches to the owning element's ``chain``.
  Dataflow is synchronous within the source's streaming thread.
- **Negotiation**: upstream decides fixed caps and announces them with a
  :class:`CapsEvent`; each element validates against its sink template,
  computes its out caps, and forwards a new CapsEvent.  Templates are checked
  at link time so impossible graphs fail fast.
- **Events**: CAPS / EOS / SEGMENT / CUSTOM flow downstream in-band, like
  GStreamer serialized events.  Custom events carry dict payloads (used for
  model-update, reference tensor_filter.c:1413-1446).
"""

from __future__ import annotations

import enum
from typing import Any, Dict, List, Optional

from ..analysis.sanitizer import make_rlock
from ..tensor.buffer import TensorBuffer
from .caps import Caps


class FlowReturn(enum.Enum):
    OK = "ok"
    EOS = "eos"
    ERROR = "error"
    #: buffer intentionally dropped (e.g. QoS throttling, tensor_filter.c:609)
    DROPPED = "dropped"


class Event:
    """Base in-band event."""

    def __repr__(self):
        return self.__class__.__name__


class CapsEvent(Event):
    def __init__(self, caps: Caps):
        if not caps.is_fixed():
            raise ValueError(f"CapsEvent requires fixed caps, got {caps}")
        self.caps = caps

    def __repr__(self):
        return f"CapsEvent({self.caps})"


class EOSEvent(Event):
    pass


class SegmentEvent(Event):
    def __init__(self, start_ns: int = 0):
        self.start_ns = start_ns


class CustomEvent(Event):
    def __init__(self, name: str, data: Optional[Dict[str, Any]] = None):
        self.name = name
        self.data = data or {}

    def __repr__(self):
        return f"CustomEvent({self.name})"


class QoSEvent(Event):
    """Upstream QoS feedback (GStreamer GST_EVENT_QOS role): a downstream
    consumer reports it cannot keep up.  ``timestamp`` is the PTS of the
    late buffer, ``jitter_ns`` > 0 how late it ran, ``proportion`` the
    observed slowdown ratio (1.0 = real-time, 2.0 = consuming at half
    speed).  tensor_filter consumes these to throttle-drop (reference
    tensor_filter.c:609,1454-1485); tensor_rate adapts its target rate."""

    def __init__(self, timestamp: Optional[int], jitter_ns: int,
                 proportion: float = 1.0):
        self.timestamp = timestamp
        self.jitter_ns = jitter_ns
        self.proportion = proportion

    def __repr__(self):
        return (f"QoSEvent(ts={self.timestamp} jitter={self.jitter_ns} "
                f"proportion={self.proportion:.2f})")


class LoweredStep:
    """One element's contribution to a whole-segment computation (the
    ``fuse=xla`` lowering tier, pipeline/schedule.py): on the card the
    segment runs as ONE CUDA graph, on the CPU as one eager call.

    ``fn(tensors) -> tensors`` is a plain torch function over a list of
    tensors: no host sync (``.item()``, ``TensorBuffer.np()``,
    ``np.asarray``: a sync inside a capture makes it fail loudly), no
    buffer metadata, no side effects.  A filter's weights are the
    module's own: the graph reads them by address, so a model update
    drops the plan (the custom-event invalidation) and the segment is
    captured anew against the new module on its next buffer.

    ``batched(tensors) -> tensors`` is the same function over a leading
    batch axis, for cross-stream buckets (the filter passes its model's
    batched forward); ``None`` lifts ``fn`` with ``torch.func.vmap``.
    ``device``: where the step's state lives (the filter's device), or
    ``None`` for a stateless step; a segment runs on its steps' device,
    else where its input lies.

    ``post`` (optional) is a cheap host finisher ``post(buf) -> buf`` run
    at SEGMENT EXIT, outside the graph: the escape hatch for decoders
    whose output is not a tensor (a label lookup over a device-reduced
    argmax).  Only the LAST element of a segment may carry one; an
    interior ``post`` makes the segment fall back to fuse-python.
    """

    __slots__ = ("fn", "post", "batched", "device")

    def __init__(self, fn, post=None, batched=None, device=None) -> None:
        self.fn = fn
        self.post = post
        self.batched = batched
        self.device = device


class PadDirection(enum.Enum):
    SRC = "src"
    SINK = "sink"


class Pad:
    """Connection point on an element.

    Mirrors the GstPad role: owns template caps, negotiated current caps, and
    a peer link.  A src pad's :meth:`push` / :meth:`push_event` drive the
    peer element synchronously.
    """

    def __init__(self, element: "Element", name: str,
                 direction: PadDirection, template: Caps):
        self.element = element
        self.name = name
        self.direction = direction
        self.template = template
        self.peer: Optional["Pad"] = None
        self.caps: Optional[Caps] = None  # negotiated, fixed
        self.eos = False

    @property
    def full_name(self) -> str:
        return f"{self.element.name}.{self.name}"

    # -- linking -------------------------------------------------------------
    def link(self, sink: "Pad") -> None:
        if self.direction is not PadDirection.SRC:
            raise ValueError(f"{self.full_name} is not a src pad")
        if sink.direction is not PadDirection.SINK:
            raise ValueError(f"{sink.full_name} is not a sink pad")
        if self.peer is not None or sink.peer is not None:
            raise ValueError(
                f"pad already linked: {self.full_name} / {sink.full_name}")
        if not self.template.can_intersect(sink.template):
            raise ValueError(
                f"cannot link {self.full_name} ({self.template}) to "
                f"{sink.full_name} ({sink.template}): no common caps")
        self.peer = sink
        sink.peer = self
        # request-pad link after play: the fused-dispatch head set changed
        # (a new tee branch is a new head) — rescan (schedule.py)
        for el in (self.element, sink.element):
            pl = getattr(el, "pipeline", None)
            if pl is not None and getattr(pl, "planner", None) is not None:
                pl.planner.rescan()
                break

    # -- dataflow (called on src pads) --------------------------------------
    def push(self, buf: TensorBuffer) -> FlowReturn:
        if self.peer is None:
            raise RuntimeError(f"pushing on unlinked pad {self.full_name}")
        if self.eos:
            return FlowReturn.EOS
        return self.peer.element._chain_entry(self.peer, buf)

    def push_event(self, event: Event) -> None:
        if isinstance(event, CapsEvent):
            self.caps = event.caps
        if isinstance(event, EOSEvent):
            self.eos = True
        if self.peer is not None:
            self.peer.element._event_entry(self.peer, event)

    # -- upstream events (called on sink pads) -------------------------------
    def push_upstream_event(self, event: Event) -> bool:
        """Send an event upstream from a sink pad (the GStreamer
        upstream-event role: QoS, reconfigure).  Delivered synchronously;
        returns True when some upstream element handled it."""
        if self.direction is not PadDirection.SINK or self.peer is None:
            return False
        return self.peer.element._upstream_event_entry(self.peer, event)

    def peer_allowed_caps(self) -> Caps:
        """Downstream CAPS query (GStreamer gst_pad_peer_query_caps role):
        what would the peer accept?  Passthrough elements forward the query
        further downstream, so a source can honor capsfilter constraints."""
        if self.peer is None:
            return Caps.any()
        allowed = self.peer.element.get_allowed_caps(self.peer)
        return allowed.intersect(self.peer.template)


class Element:
    """Base pipeline element.

    Subclasses declare pad templates via :meth:`_make_pads` (or call
    ``add_sink_pad``/``add_src_pad``) and implement:

    - ``chain(pad, buf) -> FlowReturn`` — per-buffer processing
    - ``set_caps(pad, caps) -> None`` — sink caps arrived; element must
      negotiate and announce src caps (helpers provided)
    - optionally ``start()``/``stop()`` lifecycle hooks and ``on_event``.

    Properties use the GObject-property role (the reference's de-facto user
    API, set in launch strings): declared in class attr ``PROPERTIES`` as
    ``{prop_name: (default, doc)}``, settable via :meth:`set_property` with
    automatic ``-``→``_`` normalization.
    """

    #: element type name used in launch strings (override)
    FACTORY: str = ""
    PROPERTIES: Dict[str, Any] = {}
    #: reference G_PARAM_READABLE-only property names: a write raises
    #: ValueError (the reference emits a critical warning), reads go
    #: through get_property as usual.  Entries need not appear in
    #: PROPERTIES (python-property readouts like tensor_filter's
    #: latency/throughput belong here too).
    READONLY_PROPERTIES: "tuple" = ()

    def __init__(self, name: Optional[str] = None, **props):
        self.name = name or f"{self.FACTORY or self.__class__.__name__.lower()}{id(self) & 0xffff}"
        self.sink_pads: List[Pad] = []
        self.src_pads: List[Pad] = []
        self.pipeline = None  # set by Pipeline.add
        self._lock = make_rlock("element")
        self._started = False
        for props_map in (self.UNIVERSAL_PROPERTIES, self.PROPERTIES):
            for key, spec in props_map.items():
                default = spec[0] if isinstance(spec, tuple) else spec
                setattr(self, key.replace("-", "_"), default)
        self._make_pads()
        for k, v in props.items():
            self.set_property(k, v)

    # -- pads ----------------------------------------------------------------
    def _make_pads(self) -> None:
        """Override to create pads (default: none)."""

    def add_sink_pad(self, template: Caps, name: Optional[str] = None) -> Pad:
        pad = Pad(self, name or f"sink_{len(self.sink_pads)}",
                  PadDirection.SINK, template)
        self.sink_pads.append(pad)
        return pad

    def add_src_pad(self, template: Caps, name: Optional[str] = None) -> Pad:
        pad = Pad(self, name or f"src_{len(self.src_pads)}",
                  PadDirection.SRC, template)
        self.src_pads.append(pad)
        return pad

    @property
    def sink_pad(self) -> Pad:
        return self.sink_pads[0]

    @property
    def src_pad(self) -> Pad:
        return self.src_pads[0]

    def request_sink_pad(self) -> Pad:
        """For N-to-1 elements (mux/merge): create a new sink pad on demand
        (GStreamer request-pad role)."""
        raise NotImplementedError(f"{self.FACTORY} has static pads")

    def request_src_pad(self) -> Pad:
        """For 1-to-N elements (demux/split/tee)."""
        raise NotImplementedError(f"{self.FACTORY} has static pads")

    # -- properties ----------------------------------------------------------

    #: properties EVERY reference element accepts (every nnstreamer
    #: element inherits GObject "silent" for verbose-log suppression —
    #: ssat launch lines set it liberally, so rejecting it would break
    #: verbatim reference pipelines)
    UNIVERSAL_PROPERTIES = {
        "silent": (True, "suppress verbose per-element logging"),
        "async": (False, "GstBaseSink async state-change flag, accepted "
                         "for launch-line parity (ssat sinks set "
                         "async=false everywhere; state changes here "
                         "are synchronous regardless)"),
    }

    def set_property(self, key: str, value: Any) -> None:
        attr = key.replace("-", "_")
        if key in self.READONLY_PROPERTIES \
                or attr in self.READONLY_PROPERTIES:
            raise ValueError(f"{self.FACTORY}: property {key!r} is "
                             "read-only")
        if (key not in self.PROPERTIES and attr not in self.PROPERTIES
                and key not in self.UNIVERSAL_PROPERTIES):
            raise AttributeError(f"{self.FACTORY}: no property {key!r}")
        setattr(self, attr, value)

    def get_property(self, key: str) -> Any:
        return getattr(self, key.replace("-", "_"))

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """PLAYING transition hook (reference: GstBaseTransform start, e.g.
        tensor_filter.c:1492 opening the framework)."""

    def stop(self) -> None:
        """NULL transition hook."""

    def unblock(self) -> None:
        """Pre-stop hook: release any blocking waits (sync sinks, etc.)
        so upstream streaming threads can run to completion before the
        teardown joins them."""

    # -- dataflow entries (called by pads) -----------------------------------
    def _chain_entry(self, pad: Pad, buf: TensorBuffer) -> FlowReturn:
        tracer = (self.pipeline.tracer
                  if self.pipeline is not None else None)
        try:
            if tracer is None:
                return self.chain(pad, buf)
            tracer.enter(self.name, buf)
            try:
                return self.chain(pad, buf)
            finally:
                tracer.exit()
        except Exception as exc:  # noqa: BLE001 - becomes pipeline error
            if self.pipeline is not None:
                self.pipeline.post_error(self, exc)
                return FlowReturn.ERROR
            raise

    def _event_entry(self, pad: Pad, event: Event) -> None:
        if isinstance(event, CapsEvent):
            pad.caps = event.caps
            # caps (re)negotiation changes what fused dispatch plans may
            # assume around THIS element: drop the affected plans (and
            # their graphs); the next buffer rebuilds them (schedule.py)
            self._invalidate_plans()
            try:
                self.set_caps(pad, event.caps)
            except Exception as exc:  # noqa: BLE001
                if self.pipeline is not None:
                    self.pipeline.post_error(self, exc)
                    return
                raise
            return
        if isinstance(event, EOSEvent):
            pad.eos = True
        if isinstance(event, CustomEvent):
            # model-update and friends can change an element's fusability
            # and the state a captured segment reads
            self._invalidate_plans()
        self.on_event(pad, event)

    def _invalidate_plans(self) -> None:
        """Drop the fused plans this element takes part in (no-op when
        the pipeline runs interpreted); scoped, so an event crossing a
        queue late never wipes unrelated segments' plans."""
        pl = self.pipeline
        if pl is not None and getattr(pl, "planner", None) is not None:
            pl.planner.invalidate(element=self)

    # -- overridables --------------------------------------------------------
    def chain(self, pad: Pad, buf: TensorBuffer) -> FlowReturn:
        raise NotImplementedError

    def set_caps(self, pad: Pad, caps: Caps) -> None:
        """Default: passthrough caps to all src pads."""
        for sp in self.src_pads:
            sp.push_event(CapsEvent(caps))

    def on_event(self, pad: Pad, event: Event) -> None:
        """Default: forward events (incl. EOS) to all src pads."""
        for sp in self.src_pads:
            sp.push_event(event)

    def _upstream_event_entry(self, src_pad: Pad, event: Event) -> bool:
        try:
            return bool(self.on_upstream_event(src_pad, event))
        except Exception as exc:  # noqa: BLE001
            if self.pipeline is not None:
                self.pipeline.post_error(self, exc)
                return False
            raise

    #: May data-affecting upstream events (nns/device-reduce) pass through
    #: this element?  Only true for elements that forward buffers
    #: untouched to a SINGLE consumer (queue).  A tee/demux must refuse:
    #: fusing one branch's reduction into the producer would corrupt every
    #: other branch.
    UPSTREAM_TRANSPARENT = False

    def on_upstream_event(self, pad: Pad, event: Event) -> bool:
        """Handle an event travelling upstream (arrives on a SRC pad).
        Default: propagate further upstream through every sink pad until
        someone handles it; events that change the data contract only
        cross elements declaring UPSTREAM_TRANSPARENT."""
        if isinstance(event, CustomEvent) \
                and event.name == "nns/device-reduce" \
                and not self.UPSTREAM_TRANSPARENT:
            return False
        for sp in self.sink_pads:
            if sp.push_upstream_event(event):
                return True
        return False

    def has_pending_input(self) -> bool:
        """Is another in-band item (buffer or event) ALREADY queued for
        this element's streaming thread?  The fuse-xla double buffer
        (schedule.py) holds a finished frame only while this answers
        True: the queued item then either pushes (buffer) or flushes
        (event) the held slot, so a quiescent stream never strands a
        frame.  Default False (no hold); boundary elements with a
        visible input queue (appsrc, queue) override."""
        return False

    def plan_step(self):
        """Fused-dispatch hook (schedule.py segment compiler).

        Return a callable ``step(buf) -> TensorBuffer | None | FlowReturn``
        to let this element be flattened into a fused segment plan: the
        steady state then calls ``step`` in a flat loop instead of
        dispatching ``Pad.push → _chain_entry → chain`` per element.  The
        step must NOT push downstream itself; it returns the output
        buffer (``None`` = consumed, a ``FlowReturn`` = terminal, e.g.
        ``DROPPED``).  Return ``None`` from *this method* to opt out (the
        default).  Only 1-sink/1-src elements are ever fused, and the
        answer is re-queried on every plan (re)build, so it may change
        with configuration (tensor_filter with batch>1 opts out)."""
        return None

    def lower_step(self) -> "Optional[LoweredStep]":
        """Lowering hook (schedule.py ``fuse=xla`` tier): return a
        :class:`LoweredStep` whose ``fn`` is a plain torch twin of this
        element's per-buffer work, and the whole fused segment runs as
        ONE CUDA graph on the card.  ``None`` (the default) keeps the
        segment at the ``fuse-python`` tier; :meth:`lower_reason` then
        names why.  Queried at plan-compile time (after negotiation) and
        on every rebuild."""
        return None

    def lower_reason(self) -> "Optional[str]":
        """Why this element cannot join a whole-segment computation: a
        reason string, or ``None`` when it is expected to lower.  Safe to
        call before ``start()`` (a property-level assessment)."""
        return (f"{self.FACTORY or type(self).__name__} has no "
                "lower_step implementation")

    def get_allowed_caps(self, sink_pad: Pad) -> Caps:
        """Answer a downstream caps query on ``sink_pad``.  Default: the pad
        template (transform elements accept their template regardless of what
        they output).  Passthrough elements should forward downstream."""
        return sink_pad.template

    def static_src_caps(self, src_pad: Pad) -> Optional[Caps]:
        """What can this element statically claim to produce on
        ``src_pad``, before negotiation?  Used by the pipeline verifier
        (analysis/verify.py) to find caps dead-ends pre-play.  Default:
        the pad template, narrowed by a ``caps`` property when the
        element declares one (sources with explicit caps, capsfilter's
        constraint).  Return ``None`` when nothing can be known
        statically (the verifier then skips this pad)."""
        caps = None
        if "caps" in self.PROPERTIES:
            caps = self.get_property("caps")
        if caps in (None, ""):
            return src_pad.template
        if isinstance(caps, str):
            caps = Caps.from_string(caps)   # raises on a malformed value
        narrowed = caps.intersect(src_pad.template)
        if not caps.is_empty() and narrowed.is_empty():
            raise ValueError(
                f"{self.name}: caps property {caps} cannot intersect the "
                f"{src_pad.name} pad template {src_pad.template}")
        return narrowed

    def static_check(self) -> "List[tuple]":
        """Pre-play configuration check (verifier hook): return a list
        of ``(severity, message)`` tuples — ``"error"`` for settings the
        element's ``start()``/``set_caps`` would reject, ``"warning"``
        for settings the scheduler will silently override, ``"info"``
        for notable-but-fine structure.  Default: no findings."""
        return []

    def report_latency(self) -> int:
        """This element's contribution to a pipeline LATENCY query, in ns
        (reference: tensor_filter injects its rolling invoke latency when
        latency-report=1, tensor_filter.c:1313-1377).  Default: 0."""
        return 0

    def health_state(self) -> "Optional[str]":
        """Readiness hook: ``"degraded"`` while this element runs in a
        reduced mode (open circuit breakers, lost endpoints, fallback
        serving), ``"draining"`` while it refuses new work ahead of a
        shutdown, else None."""
        return None

    def drain(self, deadline: float = 5.0) -> None:
        """Graceful-drain hook (``Pipeline.drain``): stop accepting new
        work and finish what is in flight, within ``deadline`` seconds.
        Elements that front external clients (tensor_query_serversrc)
        override it; ordinary elements finish when upstream stops."""

    # -- helpers -------------------------------------------------------------
    def announce_src_caps(self, caps: Caps, pad: Optional[Pad] = None) -> None:
        """Fixate-check and send a CAPS event downstream."""
        if not caps.is_fixed():
            caps = caps.fixate()
        (pad or self.src_pad).push_event(CapsEvent(caps))

    def push(self, buf: TensorBuffer, pad: Optional[Pad] = None) -> FlowReturn:
        return (pad or self.src_pad).push(buf)

    def post_eos_reached(self) -> None:
        """Sink elements call this when they observe EOS."""
        if self.pipeline is not None:
            self.pipeline._sink_eos(self)

    def __repr__(self):
        return f"<{self.__class__.__name__} {self.name!r}>"
