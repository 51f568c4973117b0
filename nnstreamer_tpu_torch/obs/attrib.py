"""Wait-state attribution: where every nanosecond of a frame went.

The port of ``nnstreamer_tpu/obs/attrib.py``.  The span layer records
per-element proctime but cannot say where a frame's idle time goes; this
module decomposes a traced frame's end-to-end wall time into a CLOSED
set of states, so the blame table of a streaming run names the states a
batching change must shrink.

**The state set** (closed — every elementary interval of a frame's
lifetime maps to exactly one):

========================  ==================================================
``source-pacing``         birth stamp → first element span (source thread
                          handoff, rate-limiter sleep, appsrc starvation)
``element-compute``       inside a non-device element's ``chain()``
``serialize``             wire framing / tensor decode (protocol.py
                          annotations)
``queue-wait``            inside a ``queue`` element's chain (full-queue
                          backpressure), the residency gap crossing a
                          queue thread boundary, a frame's residency
                          in a COLLECTING batch bucket (tensor_filter
                          micro-batch collect→dispatch, and the
                          cross-stream bucket behind a batching
                          tensor_query_serversrc — query/server.py),
                          or the fuse-xla double-buffer residency (a
                          finished frame held one slot so downstream's
                          D2H overlaps the next frame's compute —
                          pipeline/schedule.py)
``admission-wait``        server side: frame sat in the bounded incoming
                          queue before the serving pipeline picked it up
``wire``                  inside ``tensor_query_client``'s round trip,
                          minus everything the server's merged timeline
                          accounts for (transfer + protocol time)
``device-invoke``         a forward's dispatch (the torch-exec backend's
                          annotation): on the card a CUDA graph replay,
                          asynchronous, so the span ends at the launch;
                          the device time itself lands at the
                          materialization sync (``TensorBuffer.np``).
                          Under cross-stream batching the window is
                          SHARED: every frame of a bucket annotates the
                          same dispatch+materialization interval —
                          per-frame wall-clock truth, not a 1/n share.
                          Under fuse-xla the window covers the WHOLE
                          segment's single CUDA graph
``device-compile``        a signature's first dispatch (the eager run and
                          the graph capture; split from invoke)
``reorder-wait``          a finished result holding for stream order
                          (filter worker pool's strict-seq pusher)
``llm-prefill``           KV-cache prompt prefill: the full-prompt
                          forward that seeds a session's cache slot
                          (``llm`` decode engine;
                          annotated under the REQUEST's trace id, so a
                          client timeline shows its prompt's one-time
                          cost apart from the per-token stream)
``llm-prefill-chunk``     one BOUNDED prefill chunk interleaved into the
                          decode loop (paged pool, ``prefill-chunk``
                          > 0): a long prompt's one-time cost shows as
                          many small slices time-sharing the decode
                          thread instead of one monolithic
                          ``llm-prefill`` stall — the interleave proof
                          the PhaseClock's share mirrors
``llm-decode``            one continuous-batching decode step's shared
                          window — like the cross-stream
                          ``device-invoke``, every resident sequence of
                          the step annotates the SAME interval under
                          its own trace id (per-token wall-clock truth,
                          not a 1/n share)
``sink``                  inside the sink element's chain
``dispatch``              inter-element scheduling glue (gaps not
                          explained by any state above)
``unattributed``          conservation residue (clock-resolution noise;
                          ~0 by construction)
========================  ==================================================

**Conservation is the correctness spine**: a frame's window
``[birth, last-span-end]`` is partitioned into elementary intervals,
each assigned exactly one state ("innermost span wins" — spans nest
because dataflow is synchronous within a streaming thread), so the
state durations sum to the end-to-end wall time exactly.  Tests pin
this on the interpreted and fused executors, locally and across a
query round trip.

**Cross-process refinement**: a ``tensor_query_client`` element span
covers send → reply.  Remote spans harvested over the T_TRACE piggyback
(re-based onto the local clock, pipeline/tracing.py) are matched into
the covering client span by containment and carve the server's states
out of it — what remains of the client span is genuine ``wire`` time.

**Device accounting**: :func:`estimate_jit_cost` counts a filter
forward's per-frame FLOPs and bytes once per input signature, on the
``meta`` device (shapes only: no kernel launches, no CUDA graph
capture, nothing on the card); together with :func:`device_peaks` it
feeds the live ``nns_mfu`` / ``nns_device_bytes_per_s`` /
``nns_device_mem_bytes`` gauges ``tensor_filter`` registers for the
torch-exec backend family.  The peak table holds the H100 SXM5 only:
any other device makes no MFU claim.

Nothing here runs on the dataflow hot path: attribution is a post-hoc
pass over a span ring, the gauges are lazy callables evaluated at
scrape time, and the cost analysis is computed once, lazily, at the
first scrape that wants it.
"""

from __future__ import annotations

import os
from bisect import bisect_left
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

#: the closed wait-state set (order = display order in blame tables)
STATES = (
    "source-pacing", "element-compute", "serialize", "queue-wait",
    "admission-wait", "wire", "device-invoke", "device-compile",
    "reorder-wait", "llm-prefill", "llm-prefill-chunk", "llm-decode",
    "sink", "dispatch", "unattributed",
)

#: span-name prefix for explicit state annotations
#: (``pipeline/tracing.py annotate()``)
STATE_PREFIX = "state:"
#: span-name prefix for the zero-duration birth marker a traced Source
#: appends per frame (the frame window's left edge)
SRC_PREFIX = "src:"

# -- device peaks ------------------------------------------------------------
#: dense bf16 peak FLOP/s per device, keyed by a substring of the
#: lower-cased, space-free name ``torch.cuda.get_device_name`` gives.
#: NVIDIA's H100 SXM5 datasheet: 989.4 TFLOP/s dense (the 1,979 figure
#: assumes 2:4 sparsity).  Any other device makes no MFU claim (0.0).
PEAK_FLOPS: Dict[str, float] = {"nvidiah10080gbhbm3": 989.4e12}
#: HBM bandwidth (bytes/s) per device: H100 SXM5, 3.35 TB/s HBM3
PEAK_BW: Dict[str, float] = {"nvidiah10080gbhbm3": 3.35e12}


def device_name(device) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device, "" for any other
    device; a string that names no device type is taken as the name
    itself (``device_peaks("NVIDIA H100 80GB HBM3")``)."""
    import torch

    if device is None:
        return ""
    if isinstance(device, str):
        try:
            device = torch.device(device)
        except RuntimeError:
            return device
    if device.type != "cuda":
        return ""
    return torch.cuda.get_device_name(device)


def _peak_lookup(device, table: Dict[str, float]) -> float:
    kind = device_name(device).lower().replace(" ", "")
    for key, peak in table.items():
        if key in kind:
            return peak
    return 0.0


def device_peaks(device) -> Tuple[float, float]:
    """(peak FLOP/s, peak HBM bytes/s) for ``device``, the MFU
    denominators.  ``NNS_PEAK_FLOPS`` / ``NNS_PEAK_BW`` override (an
    *assumed-device* MFU on a host without the card; the override is an
    explicit assumption, surfaced by callers)."""
    env_f = os.environ.get("NNS_PEAK_FLOPS")
    env_b = os.environ.get("NNS_PEAK_BW")
    flops = float(env_f) if env_f else _peak_lookup(device, PEAK_FLOPS)
    bw = float(env_b) if env_b else _peak_lookup(device, PEAK_BW)
    return flops, bw


def _byte_counter():
    """A dispatch mode summing the bytes each dispatched op reads and
    writes (its tensor inputs plus its outputs).  Views and in-place
    view changes move nothing; an uninitialized allocation writes
    nothing.  An op given a tensor on a device other than the meta one
    or the host raises: counting never runs anything on the card."""
    import torch

    aten = torch.ops.aten
    _NO_TRAFFIC = (aten.empty, aten.empty_like, aten.empty_strided,
                   aten.new_empty, aten.new_empty_strided)
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class _Bytes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for t in tree_leaves((args, kwargs)):
                if isinstance(t, torch.Tensor) \
                        and t.device.type not in ("meta", "cpu"):
                    # a count must never run work on a device
                    raise RuntimeError(f"cost count: {func} got a tensor "
                                       f"on {t.device}")
            out = func(*args, **(kwargs or {}))
            if not (func.is_view or torch.Tag.inplace_view in func.tags
                    or func.overloadpacket in _NO_TRAFFIC):
                # the forward's tensors; host scalars are bookkeeping
                self.nbytes += sum(
                    t.numel() * t.element_size()
                    for t in tree_leaves((args, kwargs, out))
                    if isinstance(t, torch.Tensor)
                    and t.device.type == "meta")
            return out

    return _Bytes()


def count_cost(fn, *args) -> Tuple[float, float]:
    """(FLOPs, bytes) of one call ``fn(*args)``: FLOPs are
    ``torch.utils.flop_counter``'s (2 x MACs of convolutions, matmuls
    and attention; elementwise ops count 0), bytes the inputs plus
    outputs of every dispatched op.  Pass meta tensors to count without
    running anything: the kernel wrappers then take their shape-only
    stand-ins (``_cuda.shape_only``)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .. import _cuda

    flops = FlopCounterMode(display=False)
    nbytes = _byte_counter()
    with flops, nbytes, torch.no_grad(), _cuda.shape_only():
        fn(*args)
    return float(flops.get_total_flops()), float(nbytes.nbytes)


#: module_cost results by the module's structure and input signature:
#: every filter of one model shares one count
_COSTS: Dict[Any, Tuple[float, float]] = {}


def _held(module):
    """Everything ``module`` and its submodules hold: registered
    parameters and buffers, and every other attribute's leaves (a model
    may keep its weights as a plain tree of tensors)."""
    from torch.utils._pytree import tree_leaves

    for m in module.modules():
        for key, value in vars(m).items():
            if key != "_modules":
                yield from tree_leaves(value)


def _structure(module, in_info) -> Any:
    """What a forward's count depends on: the module's class, the shape
    and type of every tensor it holds, its other attribute values (a
    dtype, a kernel switch, a config), and the input signature."""
    import torch

    def describe(leaf):
        if isinstance(leaf, torch.Tensor):
            return ("tensor", tuple(leaf.shape), str(leaf.dtype))
        if leaf is None or isinstance(leaf, (bool, int, float, str)):
            return leaf
        return repr(leaf)

    return (type(module).__module__, type(module).__qualname__,
            tuple(describe(leaf) for leaf in _held(module)),
            tuple((tuple(i.np_shape), str(i.np_dtype)) for i in in_info))


def module_cost(module, in_info) -> Tuple[float, float]:
    """(FLOPs, bytes) of ``module``'s forward over one frame of
    ``in_info``, counted on the meta device: a copy of the module whose
    every tensor is a shape-only stand-in runs on meta inputs, so
    nothing launches on the card, no CUDA graph capture can be
    disturbed, and the live module (which another thread may be
    running) is never touched.  Counted once a structure
    (:func:`_structure`) and process."""
    key = _structure(module, in_info)
    cost = _COSTS.get(key)
    if cost is None:
        cost = _COSTS[key] = _count_module(module, in_info)
    return cost


def _count_module(module, in_info) -> Tuple[float, float]:
    import copy

    import numpy as np
    import torch

    memo = {}
    for t in _held(module):
        if isinstance(t, torch.Tensor) and id(t) not in memo:
            meta = torch.empty_like(t, device="meta")
            memo[id(t)] = (torch.nn.Parameter(meta, t.requires_grad)
                           if isinstance(t, torch.nn.Parameter) else meta)
    shadow = copy.deepcopy(module, memo)
    inputs = [torch.empty(
        i.np_shape, device="meta",
        dtype=torch.from_numpy(np.zeros(0, i.np_dtype)).dtype)
        for i in in_info]
    return count_cost(shadow, *inputs)


def estimate_jit_cost(fw) -> Tuple[float, float]:
    """Per-frame (flops, bytes_accessed) of a torch-exec backend's
    forward over the negotiated input shapes (:func:`module_cost`).
    Counted ONCE per input signature (cached on the backend instance)
    and only when something asks (a gauge scrape, a profile report) —
    never on the dataflow path, never a forward on the card.  (0.0,
    0.0) when the backend serves no module or the count fails: no MFU
    claim."""
    if fw is None:   # element already stopped (fw attr cleared)
        return (0.0, 0.0)
    module = getattr(getattr(fw, "_model", None), "module", None)
    if module is None:
        return (0.0, 0.0)
    try:
        in_info, _ = fw.get_model_info()
        sig = tuple((tuple(i.np_shape), str(i.np_dtype)) for i in in_info)
    except Exception:   # noqa: BLE001 — closed backend, no claim
        return (0.0, 0.0)
    cache = getattr(fw, "_nns_cost_cache", None)
    if cache is None:
        cache = fw._nns_cost_cache = {}
    if sig not in cache:
        try:
            cache[sig] = module_cost(module, in_info)
        except Exception:   # noqa: BLE001 — no cost model, no claim
            cache[sig] = (0.0, 0.0)
    return cache[sig]


# -- span classification -----------------------------------------------------

def guess_element_state(name: str) -> str:
    """Heuristic element-name → state map, for span sets with no
    pipeline at hand (flight-recorder bundles, remote serving-pipeline
    spans piggybacked over the wire).  A live :class:`Profiler` passes
    an exact factory-derived map instead."""
    low = name.lower()
    if "queue" in low:
        return "queue-wait"
    if "query_client" in low or "query_cli" in low:
        return "wire"
    if "sink" in low:
        return "sink"
    return "element-compute"


def classify_span(name: str,
                  element_states: Optional[Dict[str, str]] = None) -> str:
    """State of one span: explicit ``state:*`` annotations win, then the
    exact element map, then the name heuristic."""
    if name.startswith(STATE_PREFIX):
        state = name[len(STATE_PREFIX):]
        return state if state in STATES else "element-compute"
    if element_states is not None:
        state = element_states.get(name)
        if state is not None:
            return state
    return guess_element_state(name)


# -- frame grouping ----------------------------------------------------------

class FrameSpans:
    """One frame's raw material: ``(name, start_ns, end_ns)`` triples
    plus the window ``[t0, t1]`` they will be attributed over."""

    __slots__ = ("seq", "t0", "t1", "spans")

    def __init__(self, seq: int) -> None:
        self.seq = seq
        self.t0: Optional[int] = None     # birth (src: marker), else min
        self.t1 = 0
        self.spans: List[Tuple[str, int, int]] = []


def group_frames(spans: Iterable[Any],
                 ambiguous: Optional[List[int]] = None
                 ) -> List[FrameSpans]:
    """Group local spans by buffer seq.  Spans with ``seq < 0``
    (annotations recorded off-frame, e.g. server admission-wait before
    the serving source stamped a seq) are matched afterwards by
    interval containment.  ``src:`` markers set the frame's left edge
    (birth); without one the first span's start is the edge
    (source-pacing then reads 0).

    Seqs are per-SOURCE: in a multi-source graph (mux/join) two
    sources both stamp seq 0, 1, 2… under one tracer, and their spans
    cannot be told apart by seq alone.  A seq that carries more than
    one ``src:`` birth marker is therefore AMBIGUOUS and dropped —
    loudly (appended to ``ambiguous`` when given, surfaced as
    ``ambiguous_frames`` in profile reports) rather than silently
    blending two unrelated frames into one corrupted window."""
    frames: Dict[int, FrameSpans] = {}
    loose: List[Tuple[str, int, int]] = []
    markers: Dict[int, int] = {}
    for s in spans:
        name, start, end = s.name, s.start_ns, s.start_ns + s.dur_ns
        if s.seq < 0:
            loose.append((name, start, end))
            continue
        fr = frames.get(s.seq)
        if fr is None:
            fr = frames[s.seq] = FrameSpans(s.seq)
        if name.startswith(SRC_PREFIX):
            markers[s.seq] = markers.get(s.seq, 0) + 1
            fr.t0 = start
        else:
            fr.spans.append((name, start, end))
        fr.t1 = max(fr.t1, end)
    for seq, n in markers.items():
        if n > 1:
            frames.pop(seq, None)
            if ambiguous is not None:
                ambiguous.append(seq)
    out = []
    for fr in frames.values():
        if not fr.spans:
            continue
        earliest = min(st for _, st, _ in fr.spans)
        if fr.t0 is None:
            fr.t0 = earliest
        else:
            # a span can START before the birth marker: a serving
            # pipeline's admission-wait covers arrival → dequeue, and
            # the serversrc only stamps birth after the dequeue.  The
            # frame's server-side lifetime begins at arrival.
            fr.t0 = min(fr.t0, earliest)
        out.append(fr)
    out.sort(key=lambda f: f.t0)
    if loose:
        loose.sort(key=lambda s: s[1])
        starts = [s[1] for s in loose]
        for fr in out:
            # loose spans whose start falls inside the frame window
            # belong to it (admission-wait starts at enqueue, which may
            # precede the window; clipped during attribution)
            for i in range(bisect_left(starts, fr.t0 - 5_000_000),
                           len(loose)):
                name, st, en = loose[i]
                if st >= fr.t1:
                    break
                if en > fr.t0 and st < fr.t1:
                    fr.spans.append((name, st, en))
    return out


def match_remote(frame: FrameSpans, wire_windows: List[Tuple[int, int]],
                 remote_sorted: List[Tuple[str, int, int]],
                 remote_starts: List[int]) -> None:
    """Carve a frame's wire windows with the server's re-based spans:
    a remote span whose midpoint falls inside a client round-trip span
    is that frame's server work (offset-estimation error stays below
    rtt/2, so midpoint containment is robust; spans are clipped to the
    window so conservation survives residual skew)."""
    for ws, we in wire_windows:
        lo = bisect_left(remote_starts, ws - (we - ws))
        for i in range(lo, len(remote_sorted)):
            name, st, en = remote_sorted[i]
            if st >= we:
                break
            mid = (st + en) // 2
            if ws <= mid < we:
                frame.spans.append((name, max(st, ws), min(en, we)))


# -- the attribution engine --------------------------------------------------

def _frame_sweep(frame: FrameSpans):
    """The ONE elementary-interval sweep both the blame attribution and
    the folded-stacks export consume (a second copy would let the two
    artifacts disagree about the same snapshot): yields ``(a, b,
    covering)`` per elementary interval, ``covering`` sorted outermost →
    innermost (empty = gap), plus the gap-classification inputs."""
    t0, t1 = frame.t0, frame.t1
    if t1 <= t0:
        return [], [], t1
    spans = [(name, max(st, t0), min(en, t1))
             for name, st, en in frame.spans if min(en, t1) > max(st, t0)]
    bounds = {t0, t1}
    for _, st, en in spans:
        bounds.add(st)
        bounds.add(en)
    edges = sorted(bounds)
    starts_sorted = sorted(spans, key=lambda s: s[1])
    first_start = starts_sorted[0][1] if spans else t1
    intervals = []
    for a, b in zip(edges, edges[1:]):
        covering = sorted((s for s in spans if s[1] <= a and s[2] >= b),
                          key=lambda s: (s[1], -s[2]))
        intervals.append((a, b, covering))
    return intervals, starts_sorted, first_start


def _gap_state(b: int, starts_sorted, first_start: int,
               transit: Optional[Dict[str, str]]) -> str:
    """State of an uncovered gap ending at ``b``: before the first span
    = source-pacing; otherwise the transit state of the edge being
    crossed (the next-starting span's element — queue-wait for elements
    fed by a queue), ``dispatch`` by default; a trailing gap past the
    last span (possible only through clock skew) = unattributed."""
    if b <= first_start:
        return "source-pacing"
    for name, st, _ in starts_sorted:
        if st >= b:
            if transit is not None:
                return transit.get(name, "dispatch")
            return "dispatch"
    return "unattributed"


def attribute_frame(frame: FrameSpans,
                    element_states: Optional[Dict[str, str]] = None,
                    transit: Optional[Dict[str, str]] = None
                    ) -> Dict[str, int]:
    """Partition ``[t0, t1]`` into per-state nanoseconds.

    Elementary intervals between span boundaries are assigned the state
    of the INNERMOST covering span (latest start wins — synchronous
    dataflow nests an element's span inside its caller's).  Uncovered
    gaps classify structurally via :func:`_gap_state`.  The partition
    is exact: state sums equal ``t1 - t0``."""
    out: Dict[str, int] = {}
    intervals, starts_sorted, first_start = _frame_sweep(frame)
    for a, b, covering in intervals:
        if covering:
            state = classify_span(covering[-1][0], element_states)
        else:
            state = _gap_state(b, starts_sorted, first_start, transit)
        out[state] = out.get(state, 0) + (b - a)
    return out


def attribute_frames(spans: Iterable[Any],
                     element_states: Optional[Dict[str, str]] = None,
                     transit: Optional[Dict[str, str]] = None,
                     remote_spans: Optional[Iterable[Any]] = None,
                     ambiguous: Optional[List[int]] = None
                     ) -> List[Tuple[FrameSpans, Dict[str, int]]]:
    """Group → (optionally) merge remote → attribute, per frame."""
    frames = group_frames(spans, ambiguous=ambiguous)
    if remote_spans:
        remote = sorted(((s.name, s.start_ns, s.start_ns + s.dur_ns)
                         for s in remote_spans), key=lambda s: s[1])
        rstarts = [s[1] for s in remote]
        for fr in frames:
            wire = [(st, en) for name, st, en in fr.spans
                    if classify_span(name, element_states) == "wire"
                    and not name.startswith(STATE_PREFIX)]
            if wire:
                match_remote(fr, wire, remote, rstarts)
    return [(fr, attribute_frame(fr, element_states, transit))
            for fr in frames]


# -- aggregation: the blame report -------------------------------------------

def _quantile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[i]


def blame(attributed: List[Tuple[FrameSpans, Dict[str, int]]],
          top_n: int = 6) -> Dict[str, Any]:
    """Aggregate per-frame attributions into the blame report:

    - ``states``: per-state totals, share of summed e2e, mean per
      frame, and ``dominant_frames`` — the critical-path count (frames
      whose single largest state this is: the per-frame dominant edge);
    - ``top``: the top-N states by share — the rows a perf PR must
      shrink;
    - ``conservation``: attributed share of e2e (≈ 100 % by
      construction; the correctness spine the tests pin);
    - ``e2e_us``: end-to-end wall-time distribution over frames.
    """
    n = len(attributed)
    if n == 0:
        return {"frames": 0, "states": {}, "top": [],
                "conservation": {"attributed_pct": 0.0}, "e2e_us": {}}
    e2e = sorted((fr.t1 - fr.t0) / 1e3 for fr, _ in attributed)
    total_e2e_ns = sum(fr.t1 - fr.t0 for fr, _ in attributed)
    totals: Dict[str, int] = {}
    dominant: Dict[str, int] = {}
    for _, states in attributed:
        for state, ns in states.items():
            totals[state] = totals.get(state, 0) + ns
        if states:
            top = max(states.items(), key=lambda kv: kv[1])[0]
            dominant[top] = dominant.get(top, 0) + 1
    states_out = {}
    for state in STATES:
        ns = totals.get(state, 0)
        if ns == 0 and state not in dominant:
            continue
        states_out[state] = {
            "total_ms": round(ns / 1e6, 3),
            "pct": round(100.0 * ns / max(1, total_e2e_ns), 2),
            "per_frame_us": round(ns / 1e3 / n, 2),
            "dominant_frames": dominant.get(state, 0),
        }
    ranked = sorted(states_out.items(), key=lambda kv: -kv[1]["pct"])
    attributed_ns = sum(ns for s, ns in totals.items()
                        if s != "unattributed")
    return {
        "frames": n,
        "e2e_us": {"mean": round(sum(e2e) / n, 1),
                   "p50": round(_quantile(e2e, 0.50), 1),
                   "p95": round(_quantile(e2e, 0.95), 1),
                   "max": round(e2e[-1], 1)},
        "states": states_out,
        "top": [[s, row["pct"]] for s, row in ranked[:top_n]],
        "conservation": {
            "attributed_pct": round(
                100.0 * attributed_ns / max(1, total_e2e_ns), 2),
            "unattributed_pct": round(
                100.0 * totals.get("unattributed", 0)
                / max(1, total_e2e_ns), 2)},
    }


def blame_from_spans(spans: Iterable[Any],
                     element_states: Optional[Dict[str, str]] = None,
                     transit: Optional[Dict[str, str]] = None,
                     remote_spans: Optional[Iterable[Any]] = None,
                     top_n: int = 6) -> Dict[str, Any]:
    """One-call convenience over raw span iterables (flight-recorder
    bundles, soak verdicts): heuristic classification unless exact maps
    are supplied."""
    return blame(attribute_frames(spans, element_states, transit,
                                  remote_spans), top_n=top_n)


def queueing_evidence(metrics_report: Dict[str, Any]) -> Dict[str, Any]:
    """Cross-check against the coordinated-omission split: the
    divergence of ``nns_slo_latency_us`` (scheduled-arrival latency)
    from ``nns_query_service_us`` (send→reply) IS queueing.  Returns
    the two p99s and their gap when both histograms are present in a
    registry report — the blame table's ``queue-wait``/``wire`` rows
    should explain this gap."""
    slo = service = None
    for key, row in metrics_report.items():
        if not isinstance(row, dict):
            continue
        if key.startswith("nns_slo_latency_us") and row.get("count"):
            slo = row
        elif key.startswith("nns_query_service_us") and row.get("count"):
            service = row
    if slo is None or service is None:
        return {}
    return {"slo_latency_p99_us": slo.get("p99"),
            "service_p99_us": service.get("p99"),
            "queueing_p99_us": round(
                (slo.get("p99") or 0.0) - (service.get("p99") or 0.0), 2)}


def folded_stacks(frames: List[FrameSpans],
                  element_states: Optional[Dict[str, str]] = None,
                  transit: Optional[Dict[str, str]] = None
                  ) -> Dict[str, int]:
    """Folded-stack lines (``a;b;leaf weight_us`` semantics, the
    flamegraph.pl / speedscope input format): each elementary interval
    contributes its covering-span nesting path, leaf-annotated with the
    attributed state; gaps contribute their wait state as a root frame.
    Returns ``{stack_line: total_us}``."""
    out: Dict[str, int] = {}
    for fr in frames:
        intervals, starts_sorted, first_start = _frame_sweep(fr)
        for a, b, covering in intervals:
            if covering:
                parts = [name for name, _, _ in covering]
                state = classify_span(parts[-1], element_states)
                if not parts[-1].startswith(STATE_PREFIX):
                    parts.append(state)
            else:
                parts = [_gap_state(b, starts_sorted, first_start,
                                    transit)]
            line = ";".join(parts)
            out[line] = out.get(line, 0) + (b - a) // 1000
    return {k: v for k, v in out.items() if v > 0}


# -- occupancy ---------------------------------------------------------------

def busy_fraction(spans: Iterable[Any], name: str, now_ns: int,
                  window_ns: int) -> float:
    """Fraction of ``[now - window, now]`` during which element
    ``name`` had a span active (interval union, so nested or
    overlapping spans never exceed 1.0) — the per-element occupancy
    gauge's math.  A device feeding at 0.001 occupancy on the filter
    row is the measured idle-gap evidence.

    A filter running worker or micro-batch mode records its real work
    under ``<name>:invoke`` spans on worker threads — ``chain()`` only
    covers the submit — so those count as the element's busy time too;
    without them the async configurations the profiler targets would
    read near-zero occupancy while saturated."""
    lo = now_ns - window_ns
    names = (name, name + ":invoke")
    ivs = sorted((max(s.start_ns, lo), min(s.start_ns + s.dur_ns, now_ns))
                 for s in spans if s.name in names
                 and s.start_ns + s.dur_ns > lo and s.start_ns < now_ns)
    busy = 0
    cur_s = cur_e = None
    for s, e in ivs:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        elif e > cur_e:
            cur_e = e
    if cur_e is not None:
        busy += cur_e - cur_s
    return min(1.0, busy / max(1, window_ns))


class RingSnapshotCache:
    """Short-TTL shared snapshot of a span ring, so one /metrics scrape
    evaluating N occupancy gauges copies the (up to 65536-entry) ring
    ONCE under the ring lock instead of N times — N full copies per
    scrape would inject periodic append stalls into the very streaming
    threads being profiled."""

    __slots__ = ("tracer", "ttl_ns", "_at_ns", "_spans")

    def __init__(self, tracer, ttl_s: float = 0.25) -> None:
        self.tracer = tracer
        self.ttl_ns = int(ttl_s * 1e9)
        self._at_ns = 0
        self._spans: List[Any] = []

    def get(self, now_ns: int) -> List[Any]:
        if now_ns - self._at_ns > self.ttl_ns:
            ring = self.tracer.ring
            self._spans = ring.snapshot() if ring is not None else []
            self._at_ns = now_ns
        return self._spans


def make_occupancy_fn(tracer, name: str, window_s: float = 5.0,
                      cache: Optional[RingSnapshotCache] = None
                      ) -> Callable[[], float]:
    """Lazy-gauge provider: busy fraction of element ``name`` over the
    trailing window, computed from the tracer's span ring AT SCRAPE
    TIME (obs/metrics.py pull contract — zero per-buffer cost).  Pass
    one shared :class:`RingSnapshotCache` for a pipeline's whole gauge
    set so a scrape snapshots the ring once."""
    window_ns = int(window_s * 1e9)

    def _fn() -> float:
        import time as _t

        now = _t.monotonic_ns()
        if cache is not None:
            spans = cache.get(now)
        else:
            ring = tracer.ring
            if ring is None:
                return 0.0
            spans = ring.snapshot()
        return busy_fraction(spans, name, now, window_ns)

    return _fn
