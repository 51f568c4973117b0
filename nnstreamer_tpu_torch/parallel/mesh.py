"""Device mesh over torch devices, or over a process group.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/mesh.py``: a named
grid with the axes

- ``dp`` — data parallel (batch)
- ``sp`` — sequence/context parallel (ring attention rides this axis)
- ``tp`` — tensor/model parallel (megatron-style sharded matmuls)
- ``ep`` — expert parallel (MoE)

with the same factorization and the same errors.  Two kinds:

- a **process mesh**, when a ``torch.distributed`` group of the mesh's
  size is up (:mod:`.multihost`): its grid holds the group's ranks,
  row-major over the axes, as the JAX package reshapes its global device
  list; each process is one rank, computes on its own device and knows
  its coordinates, and each set of axes has its subgroups (the
  collectives of :mod:`.collectives` run over them);
- a **local mesh** of this process's devices otherwise.  A train step
  runs on its one device: a local mesh wider than one device is refused
  by :func:`require_single_card` — the port never trains on one device
  while claiming several.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

DEFAULT_AXES = ("dp", "sp", "tp", "ep")

Axes = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """This process's place in a process mesh: its ``rank``, the
    ``device`` it computes on, its ``coords`` along each axis, and
    ``groups``: for each set of axes (sorted by mesh order, axes of size 1
    left out) the subgroup of the ranks that differ from this one only
    along those axes, in coordinate order."""

    rank: int
    device: torch.device
    coords: Dict[str, int]
    groups: Dict[Tuple[str, ...], Any]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: an object array shaped by the axis sizes, in
    ``axis_names`` order (``jax.sharding.Mesh``'s two fields) — torch
    devices for a local mesh, the group's ranks for a process mesh
    (``procs`` set)."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]
    procs: Optional[ProcessMesh] = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def _axes(self, axes: Axes) -> Tuple[str, ...]:
        """``axes`` in mesh order, without those of size 1 or absent (the
        JAX package's collectives over them are identities)."""
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        shape = self.shape
        return tuple(a for a in self.axis_names
                     if a in names and shape[a] > 1)

    def axis_size(self, axes: Axes) -> int:
        """The product of the sizes of ``axes`` (1 for an absent axis)."""
        shape = self.shape
        names = (axes,) if isinstance(axes, str) else tuple(axes)
        return int(np.prod([shape.get(a, 1) for a in names]))

    def axis_index(self, axis: str) -> int:
        """This process's coordinate along ``axis`` (0 on a local mesh,
        whose steps run as member 0 of every axis)."""
        if self.procs is None:
            return 0
        return self.procs.coords.get(axis, 0)

    def group(self, axes: Axes):
        """The subgroup along ``axes``, or ``None`` where they span one
        rank (a collective over them is an identity)."""
        key = self._axes(axes)
        if not key or self.procs is None:
            return None
        return self.procs.groups[key]


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


def _sizes(n: int, axis_sizes: Optional[Dict[str, int]],
           axes: Sequence[str]) -> Tuple[int, ...]:
    if axis_sizes:
        sizes = tuple(int(axis_sizes.get(a, 1)) for a in axes)
        prod = int(np.prod(sizes))
        if prod != n:
            raise ValueError(f"axis sizes {dict(zip(axes, sizes))} "
                             f"multiply to {prod}, have {n} devices")
        return sizes
    # auto: spread over dp/sp/tp, keep ep=1 unless explicitly requested
    auto_axes = [a for a in axes if a != "ep"] or list(axes)
    auto = factorize(n, len(auto_axes))
    lookup = dict(zip(auto_axes, auto))
    return tuple(lookup.get(a, 1) for a in axes)


def world_size() -> int:
    """The size of the process group this process is in (1: none)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_mesh(n_devices: Optional[int] = None,
              axis_sizes: Optional[Dict[str, int]] = None,
              axes: Sequence[str] = DEFAULT_AXES,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a Mesh.

    - ``axis_sizes``: explicit {axis: size}; missing axes get size 1;
      product must equal the device count.
    - otherwise sizes are auto-factorized over ``axes`` with unused axes
      collapsed to 1: for n=8 → dp=2, sp=2, tp=2, ep=1.

    When a process group of more than one rank is up and the mesh asks
    for as many devices as it has ranks (``axis_sizes``' product, else
    ``n_devices``, else the devices given, else the world), the mesh is a
    process mesh over the group, and ``devices`` (at most one) names this
    process's device (default: card ``rank % cards``, else the CPU).
    Otherwise it is a local mesh over ``devices`` (default: every CUDA
    device)."""
    world = world_size()
    want = (int(np.prod([int(v) for v in axis_sizes.values()]))
            if axis_sizes else n_devices if n_devices is not None
            else len(devices) if devices is not None else world)
    if world > 1 and want == world and (devices is None
                                        or len(devices) == 1):
        return _process_mesh(_sizes(world, axis_sizes, axes), tuple(axes),
                             devices[0] if devices else None)
    devs = [torch.device(d) for d in
            (devices if devices is not None else _card_devices())]
    if n_devices is not None:
        devs = devs[:n_devices]
    sizes = _sizes(len(devs), axis_sizes, axes)
    grid = np.empty(len(devs), dtype=object)
    grid[:] = devs
    return Mesh(grid.reshape(sizes), tuple(axes))


def _process_mesh(sizes: Tuple[int, ...], axes: Tuple[str, ...],
                  device) -> Mesh:
    """The process mesh over the current group: ranks row-major over
    ``axes``, and a subgroup for every set of axes wider than one rank.
    Every rank creates every subgroup, in one order (``new_group`` is
    collective)."""
    import torch.distributed as dist

    rank, world = dist.get_rank(), dist.get_world_size()
    if device is None:
        cards = torch.cuda.device_count()
        device = (torch.device("cuda", rank % cards) if cards
                  else torch.device("cpu"))
    ranks = np.arange(world).reshape(sizes)
    coords = dict(zip(axes, (int(c) for c in
                             np.unravel_index(rank, sizes))))
    wide = [i for i, n in enumerate(sizes) if n > 1]
    groups: Dict[Tuple[str, ...], Any] = {}
    for r in range(1, len(wide) + 1):
        for sub in itertools.combinations(wide, r):
            rest = [i for i in range(len(sizes)) if i not in sub]
            # each row: the ranks that share the coordinates of the other
            # axes, in row-major order of the sub-axes' coordinates
            rows = np.transpose(ranks, rest + list(sub)).reshape(
                -1, int(np.prod([sizes[i] for i in sub])))
            for row in rows:
                g = dist.new_group(ranks=[int(x) for x in row])
                if rank in row:
                    groups[tuple(axes[i] for i in sub)] = g
    grid = np.empty(world, dtype=object)
    grid[:] = list(range(world))
    procs = ProcessMesh(rank=rank, device=torch.device(device),
                        coords=coords, groups=groups)
    return Mesh(grid.reshape(sizes), axes, procs)


def mesh_info(mesh: Mesh) -> Dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def require_single_card(mesh: Mesh) -> torch.device:
    """The one device of a local mesh; one with any axis > 1 raises — the
    port never trains on one device while claiming several (a multi-card
    mesh is a process mesh: one process a rank, :mod:`.multihost`)."""
    wide = {a: s for a, s in mesh_info(mesh).items() if s > 1}
    if wide or mesh.devices.size != 1:
        raise NotImplementedError(
            f"multi-card training needs a process group of the mesh's "
            f"size (mesh {mesh_info(mesh)}; parallel.multihost."
            "initialize): without one every mesh axis must have size 1")
    return mesh.devices.flat[0]


def local_device(mesh: Mesh) -> torch.device:
    """The device this process's share of a step runs on: its rank's on a
    process mesh, else the local mesh's one device
    (:func:`require_single_card`)."""
    if mesh.procs is not None:
        return mesh.procs.device
    return require_single_card(mesh)


def shard(x, mesh: Mesh, spec: Sequence[Optional[Axes]]):
    """This process's block of the global ``x`` (a tensor or numpy
    array) under the partition ``spec`` (one entry a dimension: an axis,
    a tuple of axes, or ``None``; missing trailing entries are ``None``),
    as a ``NamedSharding`` places it: dimension ``i`` splits evenly over
    ``spec[i]``'s axes, the first one outermost."""
    for dim, part in enumerate(spec):
        if not part:
            continue
        names = (part,) if isinstance(part, str) else tuple(part)
        n = mesh.axis_size(names)
        if n == 1:
            continue
        idx = 0
        for a in names:
            idx = idx * mesh.shape.get(a, 1) + mesh.axis_index(a)
        size = x.shape[dim]
        if size % n:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                             f"not split over {names} ({n})")
        step = size // n
        index = [slice(None)] * x.ndim
        index[dim] = slice(idx * step, (idx + 1) * step)
        x = x[tuple(index)]
    return x
