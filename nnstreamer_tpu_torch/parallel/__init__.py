"""Parallel layer: mesh, sequence-parallel attention, training.

The JAX package's exports, on one card: the mesh is bookkeeping whose
axes must all have size 1 to train, ``ring_attention`` is a ring of one
member (plain scan or the flash kernels with the lse merge), and the
StreamFormer and vision train steps run on the mesh's device, on the card
as one CUDA graph per batch signature.
``ulysses_attention``, ``pipeline_parallel`` and ``multihost`` wait for
multi-card training over ``torch.distributed`` (ROADMAP).
"""

from .mesh import DEFAULT_AXES, factorize, make_mesh, mesh_info
from .ring_attention import local_attention, ring_attention
from .train_step import (StreamFormerConfig, init_params, make_data_sharding,
                         make_train_step)

__all__ = [
    "make_mesh", "mesh_info", "factorize", "DEFAULT_AXES",
    "ring_attention", "local_attention",
    "StreamFormerConfig", "init_params", "make_train_step",
    "make_data_sharding",
]
