"""TorchScript support names for the ``pytorch`` filter backend.

The port of ``nnstreamer_tpu/filter/torchscript.py``.  The JAX package
lowers a frozen TorchScript graph to jax/lax node by node; the port runs
TorchScript natively on the filter's device
(:mod:`nnstreamer_tpu_torch.filter.backends.pytorch`), so it carries no
lowering table.  What stays is what callers import: the error a graph
the backend cannot serve raises, and the table of torch's serialized
dtype codes.
"""

from __future__ import annotations

import numpy as np


class UnsupportedTorchOp(RuntimeError):
    """A graph node the backend cannot run as asked (in the port: a node
    pinned to another device than the filter's)."""


# torch serialized dtype codes (aten::to's ScalarType argument)
_TORCH_DTYPES = {
    0: np.uint8, 1: np.int8, 2: np.int16, 3: np.int32, 4: np.int64,
    5: np.float16, 6: np.float32, 7: np.float64, 11: np.bool_,
}
