"""Flight recorder: always-on bounded triage ring, dumped at SLO breach.

A failed multi-minute soak must be triaged from an ARTIFACT, not rerun:
by the time a human looks, the tunnel window is gone and the breach is
unreproducible.  So the recorder runs for the whole soak at bounded
cost — a deque of recent per-tick metric snapshots (the evaluator's
``on_tick`` feed) riding next to the serving pipeline's bounded span
ring (``Tracer(spans=True)``, obs/span.py, overwrite-oldest) — and
converts itself into a bundle the moment the evaluator reports a breach
onset (``on_breach``):

``bundle-<n>-<objective>/``
    ``manifest.json``   — breach event, wall/mono stamps, file inventory
    ``trace.json``      — Chrome ``trace_event`` export of the span ring
                          (the breaching window's spans: the ring holds
                          the most recent spans, which at dump time ARE
                          the breach neighborhood) — open in Perfetto
    ``breach.json``     — the triggering evaluation (both windows'
                          burn-rate evidence)
    ``blame.json``      — wait-state attribution summary of the breach
                          window's spans (obs/attrib.py): which states
                          ate the breaching frames' time, without
                          opening the trace
    ``metrics_timeline.jsonl`` — one line per recorded tick: metric
                          snapshot + objective burn rates (the time
                          series leading INTO the breach)
    ``metrics_final.json`` — full registry report at dump time
    ``sessions.json``   — per-session token timelines (llm/tokenobs.py
                          records: admit → first-token → terminal,
                          TTFT/ITL, head-of-line blame partition) when
                          a ``session_obs`` provider is attached; the
                          same sessions also land in ``trace.json`` as
                          one Chrome lane per session, merged onto the
                          span ring's timebase — a breach bundle from
                          an LLM soak shows WHICH sessions sat behind
                          what, next to the server's element spans

Dumps are capped (``max_dumps``) so a flapping objective cannot fill a
disk; every breach past the cap still lands in the evaluator's verdict.
"""

from __future__ import annotations

import json
import os
from collections import deque
from typing import Any, Dict, List, Optional

from ..analysis.sanitizer import make_lock
from ..obs.clock import mono_ns, wall_us
from ..obs.metrics import REGISTRY, MetricsRegistry


class FlightRecorder:
    """Bounded snapshot ring + breach-triggered bundle writer.

    Wire it up with::

        rec = FlightRecorder(out_dir, tracer=server_tracer)
        evaluator.on_tick = rec.record
        evaluator.on_breach = rec.on_breach
    """

    def __init__(self, out_dir: str, tracer: Optional[Any] = None,
                 registry: MetricsRegistry = REGISTRY,
                 capacity: int = 512, max_dumps: int = 3,
                 collector: Optional[Any] = None,
                 session_obs: Optional[Any] = None) -> None:
        self.out_dir = out_dir
        self.tracer = tracer
        self.registry = registry
        #: federation collector (obs/federation.py): when attached,
        #: every recorded tick carries the per-origin federated view,
        #: so a breach bundle from an N-process run shows ALL sides'
        #: timelines, not just the process that happened to breach
        self.collector = collector
        #: token-observability provider (llm/tokenobs.TokenObs): when
        #: attached, bundles grow ``sessions.json`` (the breach
        #: window's per-session timelines + blame) and the sessions'
        #: Chrome lanes merge into ``trace.json`` — both sides share
        #: the mono-ns timebase, so session bars line up under the
        #: server spans that caused them
        self.session_obs = session_obs
        self.max_dumps = int(max_dumps)
        self._lock = make_lock("slo")
        self._ring: "deque[Dict[str, Any]]" = deque(
            maxlen=max(8, int(capacity)))
        self.dumps: List[str] = []

    # -- feed ----------------------------------------------------------------
    def record(self, evaluation: Optional[Dict[str, Any]] = None) -> None:
        """Append one tick to the ring: wall/mono stamps, the registry
        report (cheap: values + histogram summaries, not full bucket
        vectors), and the evaluation's per-objective burn rates."""
        entry: Dict[str, Any] = {"wall_us": wall_us(),
                                 "mono_s": round(mono_ns() / 1e9, 3),
                                 "metrics": self.registry.report()}
        if self.collector is not None:
            # the federated timeline: per-origin flattened metrics
            # (remote workers' pushed state + the local registry under
            # its own origin key), plus origin liveness rows
            entry["origins"] = self.collector.report()
            entry["origin_status"] = self.collector.origins()
        if evaluation is not None:
            entry["burn"] = {
                o["name"]: {"fast": o["fast"]["burn_rate"],
                            "slow": o["slow"]["burn_rate"],
                            "breached": o["breached"]}
                for o in evaluation.get("objectives", ())}
        with self._lock:
            self._ring.append(entry)

    # -- dump ----------------------------------------------------------------
    def on_breach(self, event: Dict[str, Any],
                  evaluation: Dict[str, Any]) -> Optional[str]:
        """Evaluator breach-onset hook: write one bundle (up to
        ``max_dumps``); returns the bundle dir, or None past the cap."""
        with self._lock:
            if len(self.dumps) >= self.max_dumps:
                return None
            n = len(self.dumps)
        path = self.dump(f"{n}-{event.get('objective', 'breach')}",
                         breach={"event": event,
                                 "evaluation": evaluation})
        return path

    def dump(self, tag: str,
             breach: Optional[Dict[str, Any]] = None) -> str:
        """Write a bundle now (breach hook or operator-forced); returns
        the bundle directory path."""
        bundle = os.path.join(self.out_dir, f"bundle-{tag}")
        os.makedirs(bundle, exist_ok=True)
        with self._lock:
            timeline = list(self._ring)
        files = {}

        def _write(name: str, obj: Any) -> None:
            p = os.path.join(bundle, name)
            with open(p, "w", encoding="utf-8") as fh:
                if name.endswith(".jsonl"):
                    for row in obj:
                        fh.write(json.dumps(row) + "\n")
                else:
                    json.dump(obj, fh, indent=2)
            files[name] = os.path.getsize(p)

        if breach is not None:
            _write("breach.json", breach)
        session_events: List[Dict[str, Any]] = []
        if self.session_obs is not None:
            # breach-window session timelines: the tokenobs ring holds
            # the most recently CLOSED sessions plus every live one —
            # at dump time that IS the breach neighborhood
            _write("sessions.json",
                   {"sessions": self.session_obs.records(),
                    "blame": self.session_obs.blame_report()})
            session_events = self.session_obs.chrome_events()
        if self.tracer is not None and \
                getattr(self.tracer, "ring", None) is not None:
            trace = self.tracer.chrome_trace()
            if session_events:
                # merge the session lanes onto the span ring's export:
                # both stamp mono-ns, so the bars line up under the
                # server spans that caused them (re-sort keeps the
                # merged stream globally time-monotonic, M events first)
                events = trace["traceEvents"] + session_events
                events.sort(key=lambda e: (e["ph"] != "M",
                                           e.get("ts", 0.0)))
                trace["traceEvents"] = events
            _write("trace.json", trace)
            from ..obs.profile import attribution_block

            blame = attribution_block(self.tracer)
            if blame:
                # breach-window wait-state blame (obs/attrib.py): the
                # ring holds the breach neighborhood, so this names the
                # states that ate the breaching frames' time without
                # opening the Chrome trace
                _write("blame.json", blame)
        elif session_events:
            # no span tracer attached: the session lanes alone are
            # still a valid Chrome export
            _write("trace.json", {"traceEvents": session_events,
                                  "displayTimeUnit": "ms"})
        _write("metrics_timeline.jsonl", timeline)
        _write("metrics_final.json", self.registry.report())
        manifest = {"tag": tag, "wall_us": wall_us(),
                    "mono_s": round(mono_ns() / 1e9, 3),
                    "recorded_ticks": len(timeline),
                    "files": files}
        if self.collector is not None:
            manifest["origins"] = self.collector.origins()
        if self.tracer is not None and \
                getattr(self.tracer, "ring", None) is not None:
            manifest["span_ring"] = {
                "capacity": self.tracer.ring.capacity,
                "dropped": self.tracer.ring.dropped}
        _write("manifest.json", manifest)
        with self._lock:
            self.dumps.append(bundle)
        return bundle
