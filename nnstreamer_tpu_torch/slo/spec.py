"""SLO specification: objectives + multi-window burn-rate parameters.

A spec declares what "healthy" means for a serving pipeline under
sustained load, in the error-budget vocabulary of SRE practice:

- every objective has a **target** success fraction (e.g. 0.99);
  the complement ``1 - target`` is the **error budget**;
- an evaluation window's **burn rate** is the fraction of requests that
  were bad in that window divided by the budget — burn 1.0 means the
  budget is being consumed exactly as fast as the objective allows,
  burn 10 means the budget would be gone in a tenth of the period;
- a **breach** requires the burn rate to exceed the threshold in BOTH
  the fast and the slow window (the classic multi-window alert: the
  fast window gives detection latency, the slow window suppresses
  blips that self-heal — a single recovered disconnect must not page).

Objective kinds (``slo/evaluator.py`` computes each from the
metrics registry via the snapshot/diff API, no bespoke plumbing):

``latency``
    Requests slower than ``threshold_us`` are bad.  Counted from the
    bucket vector of the latency histogram, so the windowed p99 rides
    along as evidence.
``error_rate``
    Failed requests (transport errors, timeouts, dead endpoints) are
    bad.
``availability``
    Same accounting as ``error_rate`` but conventionally a looser
    target — "did the service answer at all" vs "did it answer
    correctly/fast"; kept a distinct kind so verdicts name the right
    contract.
``ttft`` / ``itl``
    Token-latency kinds for the LLM serving tier: first tokens slower
    than ``threshold_us`` since their *scheduled* arrival (``ttft``),
    or inter-token gaps longer than ``threshold_us`` (``itl``), are
    bad.  Same histogram accounting as ``latency`` over the
    ``nns_slo_ttft_us`` / ``nns_slo_itl_us`` families the token
    loadgen writes — or, via ``metric``, the server-side
    ``nns_llm_ttft_us`` / ``nns_llm_itl_us`` the ``tensor_llm``
    element observes; kept distinct kinds so verdicts name the token
    contract they gate.

Specs serialize as plain JSON (``to_dict``/``from_dict``,
``load``/``dump``) — the ``launch.py --slo spec.json`` format and
the machine half of every verdict artifact.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

KINDS = ("latency", "error_rate", "availability", "ttft", "itl")
#: kinds whose accounting is histogram-threshold (bucket vector math)
HIST_KINDS = ("latency", "ttft", "itl")

#: metric families the evaluator reads; the loadgen writes them and any
#: other client may too (one shared contract, obs/metrics.py registry)
REQUESTS_TOTAL = "nns_slo_requests_total"
ERRORS_TOTAL = "nns_slo_errors_total"
LATENCY_US = "nns_slo_latency_us"
#: token-latency families (schedule-anchored, client-side — the
#: coordinated-omission-free halves of the TTFT/ITL contract)
TTFT_US = "nns_slo_ttft_us"
ITL_US = "nns_slo_itl_us"
#: default histogram family per histogram-threshold kind
HIST_FAMILY = {"latency": LATENCY_US, "ttft": TTFT_US, "itl": ITL_US}


@dataclasses.dataclass(frozen=True)
class Objective:
    """One service-level objective.

    ``request_class`` restricts accounting to requests tagged with that
    class (``buf.extra["nns_class"]``, query/client.py); empty matches
    every class (sums across labels).

    ``metric`` (histogram kinds: latency/ttft/itl) overrides the
    histogram family the objective reads — e.g.
    ``nns_element_proctime_us`` gates a pipeline's own per-element
    latency instead of the loadgen's request latency, and
    ``nns_llm_ttft_us`` gates the server-observed first-token latency;
    ``match`` further restricts to metric keys containing the
    substring (e.g. ``element="filter"``).
    """

    name: str
    kind: str                      # one of KINDS
    target: float                  # success fraction in (0, 1)
    threshold_us: float = 0.0      # histogram kinds: slower-than = bad
    request_class: str = ""
    metric: str = ""               # latency kind: histogram family
    match: str = ""                # raw key-substring label filter

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"objective {self.name!r}: kind "
                             f"{self.kind!r} (want one of {KINDS})")
        if not 0.0 < self.target < 1.0:
            raise ValueError(f"objective {self.name!r}: target "
                             f"{self.target} must be in (0, 1)")
        if self.kind in HIST_KINDS and self.threshold_us <= 0:
            raise ValueError(f"objective {self.name!r}: {self.kind} "
                             "kind requires threshold_us > 0")

    @property
    def budget(self) -> float:
        """Error budget: the bad-request fraction the target allows."""
        return 1.0 - self.target

    def to_dict(self) -> Dict[str, Any]:
        out = {"name": self.name, "kind": self.kind,
               "target": self.target}
        for field in ("threshold_us", "request_class", "metric",
                      "match"):
            value = getattr(self, field)
            if value:
                out[field] = value
        return out

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Objective":
        return cls(name=str(d["name"]), kind=str(d["kind"]),
                   target=float(d["target"]),
                   threshold_us=float(d.get("threshold_us", 0.0)),
                   request_class=str(d.get("request_class", "")),
                   metric=str(d.get("metric", "")),
                   match=str(d.get("match", "")))


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Objectives + the shared multi-window burn-rate parameters."""

    name: str
    objectives: Tuple[Objective, ...]
    window_fast_s: float = 60.0
    window_slow_s: float = 600.0
    #: burn rate BOTH windows must exceed to breach.  2.0 = "the budget
    #: is burning at twice the sustainable rate" — a deliberate default
    #: between instant paging (1.0 would alert on exactly-at-budget)
    #: and the classic 14.4 paging threshold sized for 30-day budgets.
    burn_threshold: float = 2.0
    tick_s: float = 1.0

    def __post_init__(self) -> None:
        if not self.objectives:
            raise ValueError(f"spec {self.name!r}: no objectives")
        if not 0 < self.window_fast_s < self.window_slow_s:
            raise ValueError(
                f"spec {self.name!r}: want 0 < window_fast_s "
                f"({self.window_fast_s}) < window_slow_s "
                f"({self.window_slow_s})")
        if self.burn_threshold <= 0:
            raise ValueError(f"spec {self.name!r}: burn_threshold must "
                             "be > 0")
        if self.tick_s <= 0 or self.tick_s > self.window_fast_s:
            raise ValueError(f"spec {self.name!r}: tick_s must be in "
                             f"(0, window_fast_s]")

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name,
                "window_fast_s": self.window_fast_s,
                "window_slow_s": self.window_slow_s,
                "burn_threshold": self.burn_threshold,
                "tick_s": self.tick_s,
                "objectives": [o.to_dict() for o in self.objectives]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SLOSpec":
        return cls(name=str(d.get("name", "slo")),
                   objectives=tuple(Objective.from_dict(o)
                                    for o in d.get("objectives", ())),
                   window_fast_s=float(d.get("window_fast_s", 60.0)),
                   window_slow_s=float(d.get("window_slow_s", 600.0)),
                   burn_threshold=float(d.get("burn_threshold", 2.0)),
                   tick_s=float(d.get("tick_s", 1.0)))

    @classmethod
    def load(cls, path: str) -> "SLOSpec":
        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))

    def dump(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_dict(), fh, indent=2)


def demo_spec(duration_s: float = 60.0,
              p99_threshold_us: float = 250_000.0) -> SLOSpec:
    """The soak-demo spec: windows scaled to the soak's duration (a
    60 s demo cannot carry a literal 10-minute slow window — fast/slow
    keep their 1:10 ratio at ``duration/6`` / ``duration*10/6``, i.e.
    10 s / 100 s for the 60 s demo), targets sized so a single
    recovered fault passes and a dead server fails."""
    fast = max(2.0, duration_s / 6.0)
    return SLOSpec(
        name="soak-demo",
        window_fast_s=fast,
        window_slow_s=fast * 10.0,
        burn_threshold=2.0,
        tick_s=max(0.25, fast / 10.0),
        objectives=(
            Objective("availability", "availability", target=0.95),
            Objective("error_rate", "error_rate", target=0.90),
            Objective("p99_latency", "latency", target=0.90,
                      threshold_us=p99_threshold_us),
        ))


def load_spec(path: Optional[str], duration_s: float = 60.0) -> SLOSpec:
    """``--slo`` resolution: a path loads that spec, None the demo."""
    return SLOSpec.load(path) if path else demo_spec(duration_s)
