"""Pure-matmul MLP — the batching-efficiency probe model.

The PyTorch counterpart of ``nnstreamer_tpu/models/mlp.py``.  Its FLOPs
are entirely dense matmuls, so the per-row cost of a batched invoke drops
exactly as much as the device's GEMM beats its GEMV — no convolution or
normalization noise in the measurement of cross-stream batching::

    tensor_filter framework=xla model=mlp custom=width:1024,depth:4

- input: ``(in_dim,)`` float32 (default 64);
- ``depth`` hidden layers of ``width``×``width`` matmuls with a relu;
- output: ``(out_dim,)`` float32 logits (default 16).

The parameter tree is the JAX model's, ``{"layers": [{"w": (a, b), "b":
(b,)}, ...]}``, with row-vector products ``h @ w + b``, so a batch ``(B,
in_dim)`` is a plain GEMM.  Weights are deterministic random from
``custom=seed:N``, drawn from a ``torch.Generator``;
:func:`mlp_params_from_jax` carries the JAX model's over.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..tensor.info import TensorInfo, TensorsInfo
from ..tensor.types import TensorType
from .registry import Model, register_model


class MLP(nn.Module):
    """``depth`` relu layers of ``width`` and a linear head."""

    def __init__(self, dims: List[int]) -> None:
        super().__init__()
        self.w = nn.ParameterList(nn.Parameter(torch.zeros(a, b))
                                  for a, b in zip(dims, dims[1:]))
        self.b = nn.ParameterList(nn.Parameter(torch.zeros(b))
                                  for b in dims[1:])

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor]:
        """x: ``([B,] in_dim)`` f32 → ``(logits ([B,] out_dim),)``."""
        h = x
        for w, b in zip(self.w[:-1], self.b[:-1]):
            h = torch.relu(h @ w + b)
        return (h @ self.w[-1] + self.b[-1],)


def mlp_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX model's ``{"layers": [{"w", "b"}, ...]}`` tree (numpy or
    jax leaves) as :class:`MLP` ``state_dict`` entries; the layouts are
    the same."""
    out: Dict[str, torch.Tensor] = {}
    for i, layer in enumerate(params["layers"]):
        out[f"w.{i}"] = torch.tensor(np.asarray(layer["w"], np.float32))
        out[f"b.{i}"] = torch.tensor(np.asarray(layer["b"], np.float32))
    return out


def build_mlp(custom: Dict[str, str], device: DeviceLike = None) -> Model:
    device = resolve_device(device)
    in_dim = int(custom.get("in_dim", 64))
    width = int(custom.get("width", 1024))
    depth = int(custom.get("depth", 4))
    out_dim = int(custom.get("out_dim", 16))
    seed = int(custom.get("seed", 0))
    if min(in_dim, width, depth, out_dim) < 1:
        raise ValueError("mlp: in_dim/width/depth/out_dim must be >= 1")
    module = MLP([in_dim] + [width] * depth + [out_dim])
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for w in module.w:
            w.normal_(0.0, 1.0 / math.sqrt(w.shape[0]), generator=gen)
    module = module.to(device).eval()
    in_info = TensorsInfo([TensorInfo(TensorType.FLOAT32, (in_dim,))])
    out_info = TensorsInfo([TensorInfo(TensorType.FLOAT32, (out_dim,))])
    return Model(name="mlp", module=module, device=device, in_info=in_info,
                 out_info=out_info, batched=module)


register_model("mlp")(build_mlp)
