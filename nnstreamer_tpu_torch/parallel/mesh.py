"""Device mesh over torch devices.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/mesh.py``: a named
grid of devices with the axes

- ``dp`` — data parallel (batch)
- ``sp`` — sequence/context parallel (ring attention rides this axis)
- ``tp`` — tensor/model parallel (megatron-style sharded matmuls)
- ``ep`` — expert parallel (MoE)

with the same factorization and the same errors.  The port trains on one
card: the mesh is bookkeeping that the train steps read, and a mesh with
any axis of size > 1 is refused by :func:`require_single_card` — multi-card
training over ``torch.distributed`` is not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DEFAULT_AXES = ("dp", "sp", "tp", "ep")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: an object array of torch devices shaped by the axis
    sizes, in ``axis_names`` order (``jax.sharding.Mesh``'s two fields)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))


def factorize(n: int, num_axes: int) -> Tuple[int, ...]:
    """Greedy power-of-two-ish factorization of ``n`` across axes,
    biased toward dp first (dp gets the largest factor)."""
    sizes = [1] * num_axes
    i = 0
    remaining = n
    # assign factors round-robin, largest prime factors first
    factors: List[int] = []
    d = 2
    while d * d <= remaining:
        while remaining % d == 0:
            factors.append(d)
            remaining //= d
        d += 1
    if remaining > 1:
        factors.append(remaining)
    for f in sorted(factors, reverse=True):
        sizes[i % num_axes] *= f
        i += 1
    return tuple(sizes)


def _card_devices() -> List[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None,
              axis_sizes: Optional[Dict[str, int]] = None,
              axes: Sequence[str] = DEFAULT_AXES,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh over ``devices`` (default: every CUDA device).

    - ``axis_sizes``: explicit {axis: size}; missing axes get size 1;
      product must equal the device count.
    - otherwise sizes are auto-factorized over ``axes`` with unused axes
      collapsed to 1: for n=8 → dp=2, sp=2, tp=2, ep=1.
    """
    devs = [torch.device(d) for d in
            (devices if devices is not None else _card_devices())]
    if n_devices is not None:
        devs = devs[:n_devices]
    n = len(devs)
    if axis_sizes:
        sizes = tuple(int(axis_sizes.get(a, 1)) for a in axes)
        prod = int(np.prod(sizes))
        if prod != n:
            raise ValueError(f"axis sizes {dict(zip(axes, sizes))} "
                             f"multiply to {prod}, have {n} devices")
    else:
        # auto: spread over dp/sp/tp, keep ep=1 unless explicitly requested
        auto_axes = [a for a in axes if a != "ep"] or list(axes)
        auto = factorize(n, len(auto_axes))
        lookup = dict(zip(auto_axes, auto))
        sizes = tuple(lookup.get(a, 1) for a in axes)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(sizes), tuple(axes))


def mesh_info(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def require_single_card(mesh: Mesh) -> torch.device:
    """The one device a train step runs on; a mesh with any axis > 1
    raises — the port never trains on one card while claiming several."""
    wide = {a: s for a, s in mesh_info(mesh).items() if s > 1}
    if wide or mesh.devices.size != 1:
        raise NotImplementedError(
            f"multi-card training is not yet ported (mesh {mesh_info(mesh)}"
            "): every mesh axis must have size 1")
    return mesh.devices.flat[0]
