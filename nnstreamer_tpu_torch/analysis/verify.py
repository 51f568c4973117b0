"""Static pipeline verifier: reject bad graphs before any buffer flows.

The NNStreamer papers' core pipeline claim is that stream topologies can
be validated BEFORE dataflow starts; this module applies it to the
constructed (not yet playing) pipeline graph:

- **caps compatibility**: for every linked src pad, what the element can
  statically produce (pad template, narrowed by a ``caps`` property /
  capsfilter constraint) must intersect what downstream will accept
  (the existing ``peer_allowed_caps`` query, which walks through
  passthrough elements and capsfilter constraints).  An empty
  intersection is exactly the negotiation failure that would otherwise
  crash the first streaming thread — reported with the element path.
- **deadlock cycles**: the pad graph must be a DAG.  A dataflow cycle
  (e.g. a tee branch feeding back into a mux upstream of the tee)
  deadlocks once the bounded queue on the cycle fills, or recurses
  unboundedly without one.  Recurrent topologies built through
  ``tensor_reposink``/``tensor_reposrc`` slots are detected as LOGICAL
  cycles and reported as info (that is the supported recurrence
  mechanism: the repo slot decouples the cycle with its own thread and
  a dummy priming frame).
- **dead branches**: elements no source can ever feed (warning), and
  unlinked pads (error — mirrors ``Pipeline._check_links``).
- **scheduler misconfigurations**: per-element
  :meth:`~nnstreamer_tpu_torch.pipeline.element.Element.static_check` hooks
  report configurations the scheduler cannot honor (``workers>1`` with
  ``batch>1``, ``inflight``/``batch-timeout-ms`` without batching,
  ``mesh:dp=N`` without micro-batching, demux pick/pad mismatches) —
  the same decisions ``start()`` makes, surfaced before play.
- **thread-boundary structure**: which streaming thread drives which
  segment (``thread_segments``), plus warnings for fan-outs that
  serialize branches on one thread.

Entry points: :func:`verify_pipeline` returns findings;
:func:`preflight` is called by ``Pipeline.play()`` (``NNS_VERIFY=0``
disables) and raises :class:`~nnstreamer_tpu_torch.pipeline.graph.VerifyError`
on error-severity findings; ``launch.py --check`` drives the same walk
from the CLI without playing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Set, Tuple

#: severity order for sorting reports
_SEV_ORDER = {"error": 0, "warning": 1, "info": 2}


@dataclasses.dataclass
class Finding:
    severity: str          # "error" | "warning" | "info"
    rule: str              # "caps-mismatch" | "deadlock-cycle" | ...
    path: str              # element path diagnostic ("a.src -> b -> c")
    message: str
    element: Any = dataclasses.field(default=None, repr=False)

    def __str__(self) -> str:
        return f"{self.severity} [{self.rule}] {self.path}: {self.message}"


def verify_pipeline(pipeline) -> List[Finding]:
    """Run every static check; returns findings sorted errors-first."""
    findings: List[Finding] = []
    _check_links(pipeline, findings)
    _check_cycles(pipeline, findings)
    _check_reachability(pipeline, findings)
    _check_caps(pipeline, findings)
    _check_element_configs(pipeline, findings)
    _check_thread_structure(pipeline, findings)
    _check_lowering(pipeline, findings)
    findings.sort(key=lambda f: _SEV_ORDER.get(f.severity, 3))
    return findings


def preflight(pipeline) -> None:
    """``Pipeline.play()`` hook: verify, log warnings, raise on errors.

    ``NNS_VERIFY=0`` disables (the escape hatch for intentionally
    unusual graphs); anything else runs the walk — it is a pure graph
    traversal, microseconds against a play() that spawns threads."""
    if os.environ.get("NNS_VERIFY", "1") == "0":
        return
    findings = verify_pipeline(pipeline)
    errors = [f for f in findings if f.severity == "error"]
    warnings = [f for f in findings if f.severity == "warning"]
    if warnings:
        from ..utils.log import ml_logw

        for f in warnings:
            ml_logw("verify %s: %s", pipeline.name, f)
    if errors:
        from ..pipeline.graph import VerifyError

        raise VerifyError(errors)


# --------------------------------------------------------------------------
# graph helpers
# --------------------------------------------------------------------------

def _succ(el) -> List[Any]:
    """Downstream peer elements of ``el`` (via linked src pads)."""
    return [p.peer.element for p in el.src_pads if p.peer is not None]


def _chain_path(el, limit: int = 6) -> str:
    """Element-path diagnostic: ``el`` and its linear downstream run."""
    parts = [el.name]
    cur = el
    for _ in range(limit):
        nxt = _succ(cur)
        if len(nxt) != 1:
            break
        cur = nxt[0]
        parts.append(cur.name)
    if _succ(cur):
        parts.append("...")
    return " -> ".join(parts)


def _is_source(el) -> bool:
    from ..pipeline.graph import Source

    return isinstance(el, Source) or not el.sink_pads


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def _check_links(pipeline, findings: List[Finding]) -> None:
    for el in pipeline.elements:
        for p in el.sink_pads + el.src_pads:
            if p.peer is None:
                findings.append(Finding(
                    "error", "unlinked-pad", p.full_name,
                    "pad is not linked (request pads are created "
                    "sequentially: naming sink_N also creates "
                    "sink_0..sink_N-1, which must all be linked)", el))


def _cycle_from(start, adjacency) -> Optional[List[Any]]:
    """Return one cycle reachable from ``start`` as an element list, or
    None.  Iterative DFS with an on-stack set."""
    stack: List[Tuple[Any, int]] = [(start, 0)]
    path: List[Any] = []
    on_path: Set[int] = set()
    visited: Set[int] = set()
    while stack:
        node, idx = stack.pop()
        if idx == 0:
            if id(node) in visited:
                continue
            visited.add(id(node))
            path.append(node)
            on_path.add(id(node))
        succ = adjacency.get(id(node), [])
        if idx < len(succ):
            stack.append((node, idx + 1))
            child = succ[idx]
            if id(child) in on_path:
                return path[path.index(child):] + [child]
            if id(child) not in visited:
                stack.append((child, 0))
        else:
            path.pop()
            on_path.discard(id(node))
    return None


def _check_cycles(pipeline, findings: List[Finding]) -> None:
    adjacency: Dict[int, List[Any]] = {
        id(el): _succ(el) for el in pipeline.elements}
    cycle = None
    for el in pipeline.elements:
        cycle = _cycle_from(el, adjacency)
        if cycle is not None:
            break
    if cycle is not None:
        names = " -> ".join(e.name for e in cycle)
        has_queue = any(e.FACTORY == "queue" for e in cycle)
        how = ("deadlocks once the bounded queue on the cycle fills"
               if has_queue else
               "recurses unboundedly on one streaming thread")
        findings.append(Finding(
            "error", "deadlock-cycle", names,
            f"dataflow cycle in the pad graph ({how}); recurrent "
            "topologies must decouple through tensor_reposink/"
            "tensor_reposrc slots", cycle[0]))
        return
    # logical recurrence via repo slots: reposink slot K feeds reposrc
    # slot K.  Legal (the slot decouples the cycle) — report as info so
    # --check shows the topology is recurrent.
    slots_out: Dict[int, Any] = {}
    for el in pipeline.elements:
        if el.FACTORY == "tensor_reposink":
            slots_out[int(el.get_property("slot-index"))] = el
    if not slots_out:
        return
    for el in pipeline.elements:
        if el.FACTORY == "tensor_reposrc":
            slot = int(el.get_property("slot-index"))
            sink = slots_out.get(slot)
            if sink is not None:
                findings.append(Finding(
                    "info", "recurrent-topology",
                    f"{sink.name} -> [repo slot {slot}] -> {el.name}",
                    "recurrent cycle through the repo slot (decoupled: "
                    "reposrc primes frame 0 with a dummy buffer)", el))


def _check_reachability(pipeline, findings: List[Finding]) -> None:
    sources = [el for el in pipeline.elements if _is_source(el)]
    reached: Set[int] = set()
    frontier = list(sources)
    while frontier:
        el = frontier.pop()
        if id(el) in reached:
            continue
        reached.add(id(el))
        frontier.extend(_succ(el))
    for el in pipeline.elements:
        if id(el) not in reached:
            findings.append(Finding(
                "warning", "dead-branch", _chain_path(el),
                "no source can feed this element (dead branch: it will "
                "never see a buffer or an EOS, so Pipeline.wait() would "
                "block forever on its sink)", el))


def _check_caps(pipeline, findings: List[Finding]) -> None:
    for el in pipeline.elements:
        for pad in el.src_pads:
            if pad.peer is None:
                continue   # reported by unlinked-pad
            try:
                produced = el.static_src_caps(pad)
            except Exception as exc:  # noqa: BLE001 - bad caps property
                findings.append(Finding(
                    "error", "caps-mismatch", _chain_path(el),
                    f"cannot evaluate {el.name}'s output caps: {exc}", el))
                continue
            if produced is None:
                continue   # element cannot know statically: skip
            try:
                allowed = pad.peer_allowed_caps()
            except Exception as exc:  # noqa: BLE001 - bad constraint
                findings.append(Finding(
                    "error", "caps-mismatch", _chain_path(el),
                    f"downstream caps query failed at {pad.full_name}: "
                    f"{exc}", el))
                continue
            if produced.intersect(allowed).is_empty():
                findings.append(Finding(
                    "error", "caps-mismatch", _chain_path(el),
                    f"{pad.full_name} produces {produced} but downstream "
                    f"accepts {allowed}: no common caps — negotiation "
                    "would fail on the first CAPS event", el))


def _check_element_configs(pipeline, findings: List[Finding]) -> None:
    for el in pipeline.elements:
        try:
            checks = el.static_check()
        except Exception as exc:  # noqa: BLE001 - a config so broken the
            #                       check itself failed is an error too
            findings.append(Finding(
                "error", "misconfig", el.name,
                f"static_check failed: {exc!r}", el))
            continue
        for check in checks:
            # two shapes: (severity, message) — the original hook
            # contract, reported under the generic "misconfig" rule —
            # and (severity, rule, message) for elements whose checks
            # are named rules of their own (the llm element's
            # llm-slots-lt-batch / llm-no-max-seq / llm-page-size /
            # llm-prefix-without-pages family), so --check output and
            # tests can address them by name
            if len(check) == 3:
                severity, rule, message = check
            else:
                severity, message = check
                rule = "misconfig"
            findings.append(Finding(
                severity, rule, _chain_path(el), message, el))


def _check_lowering(pipeline, findings: List[Finding]) -> None:
    """``fuse=xla`` requested: warn for every linear element whose
    :meth:`~nnstreamer_tpu_torch.pipeline.element.Element.lower_reason` says
    it cannot join a whole-segment XLA computation — its segment will
    silently run at the fuse-python tier.  Property-level (pre-start)
    assessment, so ``launch.py --check`` reports it without playing;
    the compiled plan's ``fallback`` row is the runtime twin."""
    if getattr(pipeline, "fuse_tier", None) != "xla":
        return
    for el in pipeline.elements:
        if len(el.sink_pads) != 1 or len(el.src_pads) != 1:
            continue
        try:
            # boundary elements (queue etc.) never fuse: no warning.
            # A plan_step that needs started state (tensor_filter) is
            # assumed fusable; lower_reason is property-level.
            if el.plan_step() is None:
                continue
        except Exception:  # noqa: BLE001 — state-dependent plan_step
            pass
        try:
            reason = el.lower_reason()
        except Exception as exc:  # noqa: BLE001 — config so broken the
            #                       assessment itself failed
            reason = f"lower_reason failed: {exc!r}"
        if reason:
            findings.append(Finding(
                "warning", "xla-fallback", _chain_path(el),
                f"fuse=xla requested but {el.name} cannot lower: "
                f"{reason} — its segment will run fuse-python", el))


def _check_thread_structure(pipeline, findings: List[Finding]) -> None:
    from ..pipeline.graph import Queue, Tee

    for el in pipeline.elements:
        if isinstance(el, Tee):
            branches = [p for p in el.src_pads if p.peer is not None]
            if len(branches) < 2:
                continue
            queued = sum(1 for p in branches
                         if isinstance(p.peer.element, Queue))
            if queued < len(branches) - 1:
                findings.append(Finding(
                    "info", "thread-structure", _chain_path(el),
                    f"{len(branches) - queued} of {len(branches)} tee "
                    "branches run serialized on the upstream streaming "
                    "thread (insert a queue per branch for parallelism)",
                    el))


# --------------------------------------------------------------------------
# fleet configs (reported by --check on a .json argument)
# --------------------------------------------------------------------------

def verify_fleet_config(config) -> List[Finding]:
    """Static findings for a fleet config document
    (:class:`~nnstreamer_tpu_torch.fleet.config.FleetConfig` or a dict/path
    it loads from).  The fleet tier's structural failure modes are
    graph-shaped — a router fronting zero workers, inverted autoscaler
    bounds, a drain grace that cuts resident cross-stream buckets —
    so they get the pipeline verifier's treatment: named errors BEFORE
    anything spawns (``launch.py --check fleet.json``)."""
    from ..fleet.config import load_fleet_config

    try:
        cfg = load_fleet_config(config)
    except (OSError, ValueError, TypeError) as exc:
        return [Finding("error", "fleet-config", str(config),
                        f"cannot load fleet config: {exc}")]
    findings = [Finding(sev, rule, "fleet", message)
                for sev, rule, message in cfg.validate()]
    findings.sort(key=lambda f: _SEV_ORDER.get(f.severity, 3))
    return findings


# --------------------------------------------------------------------------
# thread-boundary structure (reported by --check)
# --------------------------------------------------------------------------

def thread_segments(pipeline) -> List[Dict[str, Any]]:
    """The pipeline's streaming-thread structure: one entry per thread
    owner (every Source and every Queue owns a thread), with the
    elements that run synchronously downstream of it up to the next
    boundary."""
    from ..pipeline.graph import Queue, Source

    segments: List[Dict[str, Any]] = []
    for el in pipeline.elements:
        if not isinstance(el, (Source, Queue)):
            continue
        members: List[str] = []
        frontier = list(_succ(el))
        seen: Set[int] = set()
        while frontier:
            nxt = frontier.pop()
            if id(nxt) in seen or isinstance(nxt, Queue):
                continue
            seen.add(id(nxt))
            members.append(nxt.name)
            frontier.extend(_succ(nxt))
        segments.append({
            "thread": ("src:" if isinstance(el, Source) else "queue:")
            + el.name,
            "elements": members,
        })
    return segments
