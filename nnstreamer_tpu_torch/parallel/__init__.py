"""Parallel layer: mesh, sequence-parallel attention, training.

The JAX package's exports over ``torch.distributed``: :mod:`.multihost`
joins the processes (one a rank) into a process group, the mesh lays its
ranks out over dp/sp/tp/ep (or pp), and the StreamFormer, pipeline and
vision train steps run each rank's share with the JAX package's
collectives and their gradients (:mod:`.collectives`).  Sequence
parallelism is the ring (``ring_attention``) or Ulysses
(``ulysses_attention``), through the flash kernels on the card.  Without
a process group the mesh is this process's device and a step runs on it
as one CUDA graph per batch signature.
"""

from . import multihost
from .mesh import DEFAULT_AXES, factorize, make_mesh, mesh_info
from .ring_attention import local_attention, ring_attention
from .train_step import (StreamFormerConfig, init_params, make_data_sharding,
                         make_train_step)
from .ulysses import ulysses_attention

__all__ = [
    "make_mesh", "mesh_info", "factorize", "DEFAULT_AXES",
    "ring_attention", "local_attention", "ulysses_attention",
    "StreamFormerConfig", "init_params", "make_train_step",
    "make_data_sharding", "multihost",
]
