"""Signal-driven autoscaler: the closed loop from telemetry to
membership.

The federation tier built the sensing half — :class:`SustainedSignal` over a
:class:`TimeSeriesRing` running on the federation collector, "the hook
the future fleet autoscaler consumes".  This module is that consumer:

- **scale-up signals** (any one firing spawns a worker): sustained
  cross-stream bucket occupancy (the device is seeing full tiles
  fleet-wide and still can't keep up), sustained queue depth above
  watermark (backlog is structural), and an optional fleet-wide
  admitted-rate watermark (capacity planning by request volume);
- **scale-down signal**: fleet admitted rate at-or-under an idle bar,
  sustained ``direction="below"`` — held much longer than the up
  signals, because giving capacity back is the decision to make
  slowly.

Every arming decision lives in the SIGNALS (the SLO tier's philosophy: threshold
x min-hold x disarm hysteresis — a blip can never flap the fleet); the
autoscaler adds the *actuation* discipline on top: spawn/drain
cooldowns, a post-spawn guard (the dip while a new worker warms up must
not read as idleness), and the pool's min/max clamps.  A FIRED signal
that stays fired keeps requesting capacity once per cooldown — the loop
converges to max under truly sustained load instead of stopping at one
step.

Decisions are evaluated on an injectable clock (``tick(now)``), so the
tier-1 tests pin spawn-on-sustained-occupancy and drain-on-idle with
synthetic ring captures and zero wall-clock dependence.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Optional

from ..analysis.sanitizer import make_lock
from ..obs.clock import mono_ns
from ..obs.timeseries import SIGNAL_FIRED, SustainedSignal, TimeSeriesRing
from ..utils.log import logger
from .config import AutoscalerConfig


def _mono_s() -> float:
    return mono_ns() / 1e9


def default_autoscaler_signals(ring: TimeSeriesRing,
                               cfg: AutoscalerConfig,
                               queue_depth: int = 256
                               ) -> Dict[str, List[SustainedSignal]]:
    """The standard signal set, registered on ``ring`` and returned as
    ``{"up": [...], "down": [...]}`` for :class:`Autoscaler`.  Any
    threshold of 0 disables that signal (a fleet without cross-stream
    batching has no occupancy gauge to watch)."""
    up: List[SustainedSignal] = []
    if cfg.occupancy_high > 0:
        up.append(ring.add_signal(SustainedSignal(
            "fleet_occupancy", "nns_xbatch_occupancy",
            threshold=cfg.occupancy_high, min_hold_s=cfg.hold_s,
            kind="gauge", agg="max", window_s=10.0)))
    if cfg.queue_high_frac > 0:
        up.append(ring.add_signal(SustainedSignal(
            "fleet_queue", "nns_query_server_queue_depth",
            threshold=max(1.0, cfg.queue_high_frac * queue_depth),
            min_hold_s=cfg.hold_s, kind="gauge", agg="max",
            window_s=10.0)))
    if cfg.rate_high_rps > 0:
        up.append(ring.add_signal(SustainedSignal(
            "fleet_load", "nns_query_server_admitted_total",
            threshold=cfg.rate_high_rps, min_hold_s=cfg.hold_s,
            kind="rate", window_s=5.0)))
    down = [ring.add_signal(SustainedSignal(
        "fleet_idle", "nns_query_server_admitted_total",
        threshold=cfg.rate_low_rps, min_hold_s=cfg.idle_hold_s,
        kind="rate", window_s=5.0, direction="below",
        disarm_above=max(cfg.rate_low_rps * 2.0, 1.0)))]
    return {"up": up, "down": down}


class Autoscaler:
    """Actuates a :class:`~nnstreamer_tpu_torch.fleet.pool.WorkerPool` from
    sustained-signal states.

    Drive it two ways (both used in production, both injectable in
    tests): :meth:`attach` subscribes to the ring's
    :class:`~nnstreamer_tpu_torch.obs.timeseries.SignalBus` so a ``fired``
    transition acts immediately, and :meth:`tick` (the FleetLoop path)
    re-checks still-fired signals each pass so sustained load keeps
    stepping toward ``max_workers`` once per cooldown.
    """

    def __init__(self, pool, up_signals: List[SustainedSignal],
                 down_signals: List[SustainedSignal],
                 cfg: Optional[AutoscalerConfig] = None,
                 clock=_mono_s) -> None:
        self.pool = pool
        self.cfg = cfg or AutoscalerConfig()
        if self.cfg.spawn_cooldown_s < 0 or self.cfg.drain_cooldown_s < 0:
            raise ValueError("autoscaler cooldowns must be >= 0")
        self.up_signals = list(up_signals)
        self.down_signals = list(down_signals)
        self.clock = clock
        self._lock = make_lock("fleet.autoscaler")
        self._no_spawn_until = 0.0
        self._no_drain_until = 0.0      # drain cooldown
        self._guard_until = 0.0         # post-spawn guard (separate so
        #                                 the decision log names which
        #                                 bound actually blocked)
        self.spawns = 0
        self.drains = 0
        #: bounded decision log (soak verdict / test surface)
        self.decisions: "deque[Dict[str, Any]]" = deque(maxlen=128)
        self._unsubscribe = None

    # -- wiring --------------------------------------------------------------
    def attach(self, ring: TimeSeriesRing) -> "Autoscaler":
        """Subscribe to the ring's signal bus: ``fired`` transitions
        actuate without waiting for the next maintenance tick."""
        self._unsubscribe = ring.bus.subscribe(self._on_event)
        return self

    def detach(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None

    def _on_event(self, event: Dict[str, Any]) -> None:
        if event.get("state") != "fired":
            return
        name = event.get("signal")
        if any(s.name == name for s in self.up_signals):
            self.maybe_spawn(reason=name)
        elif any(s.name == name for s in self.down_signals):
            self.maybe_drain(reason=name)

    def tick(self, now: Optional[float] = None) -> None:
        """Re-actuate on still-FIRED signals (latched sustained load
        keeps requesting capacity once per cooldown)."""
        for s in self.up_signals:
            if s.state == SIGNAL_FIRED:
                self.maybe_spawn(now, reason=s.name)
                break
        for s in self.down_signals:
            if s.state == SIGNAL_FIRED:
                self.maybe_drain(now, reason=s.name)
                break

    # -- actuation -----------------------------------------------------------
    def _decide(self, action: str, outcome: str, now: float,
                reason: str, **extra) -> None:
        row = {"t": round(now, 3), "action": action,
               "outcome": outcome, "reason": reason, **extra}
        self.decisions.append(row)
        if outcome not in ("cooldown", "guard"):
            logger.info("fleet autoscaler: %s (%s) -> %s",
                        action, reason, outcome)

    def maybe_spawn(self, now: Optional[float] = None,
                    reason: str = "") -> bool:
        if now is None:
            now = self.clock()
        with self._lock:
            if now < self._no_spawn_until:
                self._decide("spawn", "cooldown", now, reason)
                return False
            wid = self.pool.scale_up(now)
            if wid is None:
                self._decide("spawn", "at-max", now, reason,
                             target=self.pool.target)
                return False
            self._no_spawn_until = now + self.cfg.spawn_cooldown_s
            # the new worker's warm-up dip must not read as idleness
            self._guard_until = max(
                self._guard_until, now + self.cfg.post_spawn_guard_s)
            self.spawns += 1
            self._decide("spawn", "spawned", now, reason, wid=wid,
                         target=self.pool.target)
            return True

    def maybe_drain(self, now: Optional[float] = None,
                    reason: str = "") -> bool:
        if now is None:
            now = self.clock()
        with self._lock:
            if now < self._no_drain_until or now < self._guard_until:
                self._decide("drain",
                             "guard" if now < self._guard_until
                             else "cooldown", now, reason)
                return False
            wid = self.pool.scale_down(now)
            if wid is None:
                self._decide("drain", "at-min", now, reason,
                             target=self.pool.target)
                return False
            self._no_drain_until = now + self.cfg.drain_cooldown_s
            self.drains += 1
            self._decide("drain", "drained", now, reason, wid=wid,
                         target=self.pool.target)
            return True

    def report(self) -> Dict[str, Any]:
        return {"spawns": self.spawns, "drains": self.drains,
                "target": self.pool.target,
                "signals": {"up": [s.report() for s in self.up_signals],
                            "down": [s.report()
                                     for s in self.down_signals]},
                "decisions": list(self.decisions)}
