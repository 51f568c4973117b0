"""Fleet configuration: one JSON document describing router + pool +
autoscaler, with static validation (the ``launch.py --check`` hook).

The fleet tier has exactly the failure mode the pipeline verifier exists to
prevent for pipelines: a config that parses, starts, and then
misbehaves structurally (a router fronting zero workers sheds every
request forever; an autoscaler with ``min > max`` can never converge; a
drain grace shorter than the worker's bucket fill window cuts resident
cross-stream buckets mid-collect on every scale-down).  Those are
graph-shaped errors, so they get the same treatment: named findings
BEFORE anything spawns — ``python -m nnstreamer_tpu_torch.launch --check
fleet.json`` (analysis/verify.py routes ``.json`` arguments here).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Tuple

#: (severity, rule, message) — the shape analysis/verify.py wraps into
#: its Finding rows
ConfigFinding = Tuple[str, str, str]


@dataclasses.dataclass
class AutoscalerConfig:
    """Closed-loop scaling policy knobs (fleet/autoscaler.py)."""

    #: sustained bucket-occupancy threshold that spawns (frames resident
    #: in the cross-stream bucket, fleet-max over workers; 0 disables)
    occupancy_high: float = 6.0
    #: queue-depth fraction of the bound that spawns (0 disables)
    queue_high_frac: float = 0.75
    #: fleet-wide admitted requests/s that spawns (0 disables)
    rate_high_rps: float = 0.0
    #: fleet-wide admitted requests/s at-or-under which the fleet is
    #: idle and a worker drains (<= comparisons: 0 is a valid idle bar)
    rate_low_rps: float = 0.5
    #: seconds a condition must hold before it fires (the sustained-signal arming)
    hold_s: float = 5.0
    #: idle must hold longer than load: scaling down is the cheap
    #: decision to get wrong slowly and the expensive one to flap
    idle_hold_s: float = 15.0
    #: cooldowns between actions (hysteresis in time, not just value)
    spawn_cooldown_s: float = 20.0
    drain_cooldown_s: float = 30.0
    #: no drain may follow a spawn within this guard (flap killer: the
    #: spawn's own capacity dip must not read as idleness)
    post_spawn_guard_s: float = 30.0


@dataclasses.dataclass
class FleetConfig:
    """The whole fleet document.  ``worker_launch`` is a launch-string
    template with a ``{port}`` placeholder — every worker is an
    ordinary ``launch.py`` serving process."""

    worker_launch: str = ""
    min_workers: int = 1
    max_workers: int = 4
    router_host: str = "127.0.0.1"
    router_port: int = 0
    #: ring replica set size per model key (0 = spread over all workers)
    replicas: int = 2
    #: SIGTERM drain budget handed to workers (launch.py --drain-grace)
    drain_grace_s: float = 10.0
    #: the worker's cross-stream bucket fill window, when batching
    #: (informs the drain-grace check; 0 = per-frame workers)
    worker_batch_timeout_ms: float = 0.0
    restart_backoff_s: float = 1.0
    restart_backoff_max_s: float = 30.0
    #: federation staleness horizon before a silent worker is presumed
    #: wedged and restarted
    stale_kill_s: float = 20.0
    autoscaler: AutoscalerConfig = dataclasses.field(
        default_factory=AutoscalerConfig)

    @classmethod
    def from_dict(cls, raw: Dict[str, Any]) -> "FleetConfig":
        raw = dict(raw)
        asc = raw.pop("autoscaler", None) or {}
        known = {f.name for f in dataclasses.fields(cls)} - {"autoscaler"}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"unknown fleet config keys: {sorted(unknown)}")
        asc_known = {f.name for f in dataclasses.fields(AutoscalerConfig)}
        asc_unknown = set(asc) - asc_known
        if asc_unknown:
            raise ValueError(
                f"unknown autoscaler config keys: {sorted(asc_unknown)}")
        return cls(autoscaler=AutoscalerConfig(**asc), **raw)

    @classmethod
    def load(cls, path: str) -> "FleetConfig":
        with open(path, encoding="utf-8") as fh:
            return cls.from_dict(json.load(fh))

    # -- static validation ---------------------------------------------------
    def validate(self) -> List[ConfigFinding]:
        """Named findings, errors first — the ``--check`` surface.  The
        same rules gate ``WorkerPool``/``Autoscaler`` construction, so
        a config that passes ``--check`` cannot fail at start for a
        structural reason."""
        out: List[ConfigFinding] = []
        asc = self.autoscaler
        if self.min_workers < 1:
            out.append((
                "error", "fleet-zero-workers",
                f"min_workers={self.min_workers}: a router fronting "
                "zero workers answers every request with a shed — the "
                "fleet serves nothing while looking alive"))
        if self.max_workers < self.min_workers:
            out.append((
                "error", "fleet-minmax",
                f"autoscaler bounds inverted: min_workers="
                f"{self.min_workers} > max_workers={self.max_workers} "
                "— no worker count satisfies both, so every tick wants "
                "to scale in both directions"))
        if not str(self.worker_launch).strip():
            out.append((
                "error", "fleet-no-launch",
                "worker_launch is empty: the pool has no pipeline to "
                "spawn"))
        elif "{port}" not in str(self.worker_launch):
            out.append((
                "error", "fleet-no-launch",
                "worker_launch has no {port} placeholder: every worker "
                "would bind the same port and all but the first would "
                "crash-loop"))
        if self.worker_batch_timeout_ms > 0 and \
                self.drain_grace_s * 1000.0 <= self.worker_batch_timeout_ms:
            out.append((
                "error", "fleet-drain-grace",
                f"drain_grace_s={self.drain_grace_s:g}s is not longer "
                f"than the worker bucket fill window "
                f"({self.worker_batch_timeout_ms:g} ms): a draining "
                "worker's resident cross-stream bucket could not flush "
                "before the grace cuts it, dropping admitted frames on "
                "every scale-down"))
        if self.replicas < 0:
            out.append((
                "error", "fleet-replicas",
                f"replicas={self.replicas} (want 0 = spread over all "
                "workers, or a positive replica-set size)"))
        if asc.spawn_cooldown_s < 0 or asc.drain_cooldown_s < 0:
            # parity with Autoscaler.__init__'s guard: validate() must
            # reject everything construction would crash on, or a
            # --check-passing config could still fail at start
            out.append((
                "error", "fleet-cooldown",
                f"negative autoscaler cooldown (spawn="
                f"{asc.spawn_cooldown_s:g}, drain="
                f"{asc.drain_cooldown_s:g}): cooldowns must be >= 0"))
        if asc.spawn_cooldown_s == 0:
            out.append((
                "warning", "fleet-cooldown",
                "spawn_cooldown_s=0: a still-FIRED load signal "
                "re-actuates every maintenance tick, so the fleet "
                "jumps to max_workers in seconds under any sustained "
                "load — the cooldown IS the step pacing"))
        if asc.idle_hold_s < asc.hold_s:
            out.append((
                "warning", "fleet-idle-hold",
                f"idle_hold_s={asc.idle_hold_s:g} < hold_s="
                f"{asc.hold_s:g}: the fleet gives capacity back faster "
                "than it grants it, which amplifies load oscillation"))
        if self.replicas and self.replicas > self.max_workers:
            out.append((
                "info", "fleet-replicas",
                f"replicas={self.replicas} exceeds max_workers="
                f"{self.max_workers}: every model spreads over the "
                "whole fleet (equivalent to replicas=0)"))
        return out

    def raise_on_errors(self) -> None:
        errors = [m for sev, _r, m in self.validate() if sev == "error"]
        if errors:
            raise ValueError("invalid fleet config: " + "; ".join(errors))


def load_fleet_config(path_or_dict) -> FleetConfig:
    if isinstance(path_or_dict, FleetConfig):
        return path_or_dict
    if isinstance(path_or_dict, dict):
        return FleetConfig.from_dict(path_or_dict)
    return FleetConfig.load(str(path_or_dict))
