"""Serving fleet: the fleet config document and its static validation.

The port of ``nnstreamer_tpu/fleet``.  Only :mod:`.config` is ported so
far (``launch.py --check fleet.json`` validates a fleet document before
anything spawns); the ring, router, worker pool and autoscaler are not.
"""

from .config import AutoscalerConfig, FleetConfig, load_fleet_config

__all__ = ["AutoscalerConfig", "FleetConfig", "load_fleet_config"]
