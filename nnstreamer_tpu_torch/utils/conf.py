"""Configuration helpers.

The port keeps only the truthy-token rule of the JAX package's layered
configuration (``nnstreamer_tpu/utils/conf.py``): the ini/env layers
serve backends and tools this package does not have yet.
"""

from __future__ import annotations


def parse_bool(value) -> bool:
    """The ONE truthy-token rule for conf values and custom properties
    (divergent per-backend parses accepted different token sets)."""
    return str(value).strip().lower() in ("1", "true", "yes", "on")
