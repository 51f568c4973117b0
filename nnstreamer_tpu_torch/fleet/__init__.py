"""Horizontal serving fleet: router + managed worker pool + autoscaler.

The port of ``nnstreamer_tpu/fleet``, module for module:

- :mod:`fleet.ring` — seeded consistent-hash placement (model identity
  → stable worker replica set; membership changes move ~1/N of keys);
- :mod:`fleet.router` — one client endpoint fanning connections across
  :class:`~nnstreamer_tpu_torch.query.server.QueryServer` workers over
  :class:`~nnstreamer_tpu_torch.query.client.FailoverConnection`
  backend legs (hot ``dest-hosts`` updates = storm-free rebalance;
  T_SHED/QoS pass through untouched);
- :mod:`fleet.pool` — spawns ``python -m nnstreamer_tpu_torch.launch``
  workers federating into a collector, restarts crashes with backoff,
  scales down via the SIGTERM drain (route-away first);
- :mod:`fleet.autoscaler` — sustained time-series signals closed into a
  control loop with cooldowns and hysteresis;
- :mod:`fleet.config` — the JSON config document +
  ``launch.py --check fleet.json`` static validation.

Gated end to end by ``python -m nnstreamer_tpu_torch.fleet.soak``
(multi-process soak: worker kill mid-run with zero client errors,
autoscale up on sustained load, drain on idle).
"""

from .autoscaler import Autoscaler, default_autoscaler_signals
from .config import AutoscalerConfig, FleetConfig, load_fleet_config
from .pool import (FleetLoop, ManagedWorker, WorkerPool, free_port,
                   launch_spawn_fn)
from .ring import ConsistentHashRing
from .router import TensorQueryRouter

__all__ = [
    "Autoscaler", "AutoscalerConfig", "ConsistentHashRing",
    "FleetConfig", "FleetLoop", "ManagedWorker", "TensorQueryRouter",
    "WorkerPool", "default_autoscaler_signals", "free_port",
    "launch_spawn_fn", "load_fleet_config",
]
