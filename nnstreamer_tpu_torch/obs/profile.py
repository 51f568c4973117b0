"""The utilization profiler: one object that answers "where did the
time go" for a playing pipeline.

:class:`Profiler` composes the pieces the rest of the obs layer
provides — a span-recording tracer (pipeline/tracing.py), the
wait-state attribution engine (obs/attrib.py), the metrics registry —
into the profile surfaces:

- a **blame report** (``report()``) attributing every frame's
  end-to-end wall time to the closed state set, with the per-frame
  dominant-edge (critical path) counts, conservation evidence and the
  queueing cross-check (``nns_slo_latency_us`` against
  ``nns_query_service_us``);
- a rendered **blame table** (``blame_table()`` — what
  ``launch.py --profile`` prints);
- a **folded-stacks flamegraph** file (``export_folded()`` —
  flamegraph.pl / speedscope input) and the Chrome trace
  (``export_chrome()``, delegated to the tracer so merged remote
  processes ride along);
- per-element **occupancy gauges** (``nns_element_occupancy`` —
  busy-fraction over a trailing window, computed from the span ring at
  scrape time).

State maps are derived from the live pipeline graph (element factory →
state; sink-pad feeders → gap transit states), so classification is
exact — the heuristic name fallback in attrib.py is only for span sets
with no pipeline at hand (flight-recorder bundles, remote spans).

Cost discipline: constructing a Profiler enables span recording (that
is the point — profiling IS the opt-in); everything else is post-hoc
or scrape-time.  ``close()`` unregisters the gauges; an untraced
pipeline never constructs one and keeps zero obs references in its
compiled plans.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from . import attrib
from .metrics import REGISTRY, Gauge


def pipeline_maps(pipeline) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(element→state, element→gap-transit-state) maps from the graph.

    Span-time states: ``queue`` elements' chain time is queue-wait
    (a blocking put on a full queue IS queueing), ``tensor_query_client``
    is wire (refined by merged server spans), sinks are sink, all other
    elements are element-compute (their annotations carve out
    serialize/device states).  Transit states classify the *uncovered
    gap* a frame spends crossing into an element: an element fed by a
    queue gets its residency gap attributed as queue-wait; every other
    edge is dispatch glue."""
    states: Dict[str, str] = {}
    transit: Dict[str, str] = {}
    for el in pipeline.elements:
        fac = getattr(el, "FACTORY", "") or ""
        if fac == "queue":
            states[el.name] = "queue-wait"
        elif fac == "tensor_query_client":
            states[el.name] = "wire"
        elif not el.src_pads:
            states[el.name] = "sink"
        else:
            states[el.name] = "element-compute"
        if fac == "tensor_filter":
            # worker-pool invoke spans record under "<name>:invoke"
            states[el.name + ":invoke"] = "element-compute"
        for pad in el.sink_pads:
            peer = pad.peer
            if peer is not None and \
                    getattr(peer.element, "FACTORY", "") == "queue":
                transit[el.name] = "queue-wait"
    return states, transit


class Profiler:
    """Attach to a pipeline, run the workload, read the blame.

    Usage::

        p = parse_launch("videotestsrc num-buffers=600 ! ... ! tensor_sink")
        prof = Profiler(p)          # enables span tracing on p
        p.run()
        report = prof.report()
        print(prof.blame_table(report))
        prof.export_folded("flame.folded")
        prof.close()
    """

    def __init__(self, pipeline, tracer=None,
                 occupancy_window_s: float = 5.0,
                 register_gauges: bool = True) -> None:
        self.pipeline = pipeline
        tracer = tracer or pipeline.tracer
        if tracer is None or tracer.ring is None:
            tracer = pipeline.enable_tracing(spans=True)
        self.tracer = tracer
        self.element_states, self.transit = pipeline_maps(pipeline)
        self._gauges: List[Gauge] = []
        self._frames_cache: Optional[List[Any]] = None
        if register_gauges:
            pname = getattr(pipeline, "name", "") or ""
            # one shared ring snapshot per scrape across every gauge —
            # N elements must not mean N full ring copies under the
            # append lock per /metrics pull
            snap_cache = attrib.RingSnapshotCache(tracer)
            for el in pipeline.elements:
                self._gauges.append(REGISTRY.register(Gauge(
                    "nns_element_occupancy",
                    {"element": el.name, "pipeline": pname},
                    fn=attrib.make_occupancy_fn(tracer, el.name,
                                                occupancy_window_s,
                                                cache=snap_cache))))

    def close(self) -> None:
        for g in self._gauges:
            REGISTRY.unregister(g)
        self._gauges = []

    # -- attribution ---------------------------------------------------------
    def _remote_spans(self) -> List[Any]:
        out: List[Any] = []
        for spans in getattr(self.tracer, "_remote", {}).values():
            out.extend(spans)
        return out

    def attributed(self, ambiguous: Optional[List[int]] = None,
                   spans: Optional[List[Any]] = None):
        """Per-frame ``(FrameSpans, {state: ns})`` over the current
        span ring, remote (server) spans carved into the wire windows."""
        if spans is None:
            spans = self.tracer.ring.snapshot()
        return attrib.attribute_frames(
            spans, self.element_states, self.transit,
            remote_spans=self._remote_spans(), ambiguous=ambiguous)

    def report(self, metrics_report: Optional[Dict[str, Any]] = None,
               top_n: int = 8) -> Dict[str, Any]:
        """The profile artifact body: blame + occupancy + device
        accounting + queueing cross-check."""
        ambiguous: List[int] = []
        spans = self.tracer.ring.snapshot()
        attributed = self.attributed(ambiguous=ambiguous, spans=spans)
        # keep the attributed frame set: export_folded reuses it so the
        # committed flame.folded describes the SAME span snapshot as
        # profile.json (and the O(frames x spans) pass runs once)
        self._frames_cache = [fr for fr, _ in attributed]
        out: Dict[str, Any] = {
            "blame": attrib.blame(attributed, top_n=top_n)}
        if ambiguous:
            # multi-source graphs stamp per-source seqs: colliding
            # frames are EXCLUDED from the blame, not blended (see
            # attrib.group_frames) — this is how many were dropped
            out["ambiguous_frames"] = len(ambiguous)
        if self.tracer.ring.dropped:
            # the ring wrapped: the blame covers the TAIL of the run
            out["spans_dropped"] = self.tracer.ring.dropped
        # per-element busy time over the SAME ring snapshot the blame
        # used — the tracer's proctime counters cover the whole run,
        # and mixing windows after a ring wrap would inflate shares
        # past 100%.  occupancy = interval-union busy / the snapshot's
        # wall window: the filter row IS the device-feed idleness.
        elements: Dict[str, Any] = {}
        el_spans = [s for s in spans
                    if not s.name.startswith(attrib.STATE_PREFIX)
                    and not s.name.startswith(attrib.SRC_PREFIX)]
        if el_spans:
            w0 = min(s.start_ns for s in el_spans)
            w1 = max(s.start_ns + s.dur_ns for s in el_spans)
            window_ns = max(1, w1 - w0)
            for name in sorted({s.name for s in el_spans
                                if not s.name.endswith(":invoke")}):
                frac = attrib.busy_fraction(el_spans, name, w1,
                                            window_ns)
                elements[name] = {
                    "busy_ms": round(frac * window_ns / 1e6, 3),
                    "occupancy": round(frac, 4),
                    "buffers": sum(s.name == name for s in el_spans)}
            out["window_ms"] = round(window_ns / 1e6, 3)
        out["elements"] = elements
        if metrics_report is None:
            metrics_report = REGISTRY.report()
        evidence = attrib.queueing_evidence(metrics_report)
        if evidence:
            out["queueing_evidence"] = evidence
        # segment-lowering evidence next to the blame: which elements
        # run fused, at which tier, and whether the fuse-xla executable
        # cache is serving warm (steady-state captures are the
        # recapture-churn smell).  A profile of a
        # fuse-xla pipeline is judged BY this pairing: the collapsed
        # per-element shares in the blame table, the plan rows naming
        # what collapsed them.
        planner = getattr(self.pipeline, "planner", None)
        if planner is not None:
            plans = planner.plans()
            if plans:
                out["plans"] = plans
                out["lowering"] = getattr(self.pipeline, "fuse_tier",
                                          "python")
        # device gauges read RAW (snapshot_state), not through the
        # report's 4-decimal rounding: a streaming MFU of 5e-6 is the
        # entire point of the measurement, not a rounding victim
        device = {}
        for k, row in REGISTRY.snapshot_state(prefix="nns_").items():
            if k.startswith(("nns_mfu", "nns_device_",
                             "nns_element_occupancy")) \
                    and row.get("kind") == "gauge":
                device[k] = float(f"{row['value']:.6g}")
        if device:
            out["device"] = device
        return out

    # -- rendering -----------------------------------------------------------
    def blame_table(self, report: Optional[Dict[str, Any]] = None) -> str:
        report = report or self.report()
        blame = report["blame"]
        lines = [
            f"profile: {blame['frames']} frames, e2e mean "
            f"{blame['e2e_us'].get('mean', 0)} us (p50 "
            f"{blame['e2e_us'].get('p50', 0)}, p95 "
            f"{blame['e2e_us'].get('p95', 0)}), attributed "
            f"{blame['conservation']['attributed_pct']}%",
            f"{'state':<18} {'pct':>7} {'us/frame':>10} "
            f"{'total_ms':>10} {'dominant':>9}"]
        for state, _pct in blame["top"]:
            row = blame["states"][state]
            lines.append(
                f"{state:<18} {row['pct']:>6.2f}% "
                f"{row['per_frame_us']:>10.1f} {row['total_ms']:>10.2f} "
                f"{row['dominant_frames']:>9}")
        ev = report.get("queueing_evidence")
        if ev:
            lines.append(
                f"queueing evidence: slo p99 {ev['slo_latency_p99_us']} "
                f"us vs service p99 {ev['service_p99_us']} us "
                f"(queueing {ev['queueing_p99_us']} us)")
        mfu = next((v for k, v in report.get("device", {}).items()
                    if k.startswith("nns_mfu")), None)
        if mfu is not None:
            lines.append(f"nns_mfu: {mfu}")
        return "\n".join(lines)

    def export_folded(self, path: str) -> None:
        """Folded stacks (``flamegraph.pl`` / speedscope input): one
        ``stack weight_us`` line per distinct nesting path.  Reuses the
        frame set of the last :meth:`report` when one exists, so the
        two artifacts describe one snapshot."""
        frames = self._frames_cache
        if frames is None:
            frames = [fr for fr, _ in self.attributed()]
        folded = attrib.folded_stacks(frames, self.element_states,
                                      self.transit)
        with open(path, "w", encoding="utf-8") as fh:
            for line, us in sorted(folded.items(), key=lambda kv: -kv[1]):
                fh.write(f"{line} {us}\n")

    def export_chrome(self, path: str) -> None:
        self.tracer.export_chrome(path)


def compact_blame(blame: Dict[str, Any]) -> Dict[str, Any]:
    """THE compact attribution-summary shape (``attribution`` blocks in
    soak verdicts and flight-recorder bundles).  One constructor so
    every producer and consumer stays in sync."""
    if not blame.get("frames"):
        return {}
    return {"frames": blame["frames"],
            "e2e_us": blame["e2e_us"],
            "top": blame["top"],
            "states": {s: row["pct"]
                       for s, row in blame["states"].items()},
            "attributed_pct":
                blame["conservation"]["attributed_pct"]}


def attribution_block(tracer, top_n: int = 5) -> Dict[str, Any]:
    """Compact attribution summary from a bare span-recording tracer
    (no pipeline at hand — soak verdicts, flight-recorder bundles):
    heuristic element classification, remote spans merged.  Empty dict
    when the tracer records no spans."""
    if tracer is None or getattr(tracer, "ring", None) is None:
        return {}
    remote: List[Any] = []
    for spans in getattr(tracer, "_remote", {}).values():
        remote.extend(spans)
    report = attrib.blame_from_spans(tracer.ring.snapshot(),
                                     remote_spans=remote, top_n=top_n)
    return compact_blame(report)
