"""Inputs made from the run's seed: the model's weights, the stream's
frames and the training batches.  The same seed gives the same inputs,
and the benchmark hands the same inputs to the program and to the
reference.

Weights are drawn on the run's device with a ``torch.Generator`` in two
calls (every normal draw, then every uniform one), each tensor a slice
cast to the type it is served in.  Frames are the ``videotestsrc
pattern=random`` frames of the seed: numpy's PCG64 generator seeded with
it, one ``integers(0, 256, (H, W, 3), uint8)`` draw a frame, in order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def weights(spec, seed: int, device, dtype_: torch.dtype
            ) -> Dict[str, torch.Tensor]:
    """The tensors of a reference ``spec`` drawn from ``seed``: floats in
    ``dtype_``, counters as int64 zeros."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, draw in spec:
        if draw[0] in sizes:
            sizes[draw[0]] += math.prod(shape)
    normal = torch.randn(sizes["normal"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device)
    at = {"normal": 0, "uniform": 0}
    out: Dict[str, torch.Tensor] = {}
    for name, shape, draw in spec:
        kind = draw[0]
        if kind == "zeros":
            out[name] = torch.zeros(shape, dtype=torch.int64, device=device)
            continue
        n = math.prod(shape)
        raw = (normal if kind == "normal" else uniform)[at[kind]:at[kind] + n]
        at[kind] += n
        if kind == "normal":
            t = raw * draw[1]
        else:
            t = draw[1] + raw * (draw[2] - draw[1])
        out[name] = t.reshape(shape).to(dtype_)
    return out


def model_weights(cell: dict, seed: int, frames: torch.Tensor, device,
                  dtype_: torch.dtype) -> Dict[str, torch.Tensor]:
    """The cell's weights drawn from ``seed`` (:func:`weights`), and
    calibrated on ``frames`` where the configuration's reference
    calibrates (BatchNorm's statistics, measured as training leaves
    them)."""
    from . import judge
    from . import spec as bench_spec

    cfg = cell["config"]
    ref = bench_spec.reference(cfg)
    out = weights(ref.spec(cfg), seed, device, dtype_)
    if hasattr(ref, "calibrate"):
        with judge.exact_f32():
            ref.calibrate(out, frames, cfg)
    return out


def video_frames(seed: int, count: int, size: int) -> np.ndarray:
    """``count`` uint8 ``(size, size, 3)`` frames of the random pattern."""
    rng = np.random.default_rng(int(seed))
    return np.stack([rng.integers(0, 256, (size, size, 3), dtype=np.uint8)
                     for _ in range(count)])


def train_batches(seed: int, count: int, batch: int, size: int,
                  classes: int, device) -> List[Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """``count`` host batches of ``batch`` uint8 frames and int32 labels
    in ``[0, classes)``, every row different, drawn on ``device`` and
    moved to host memory once (the stream arrives from the host)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    frames = torch.randint(0, 256, (count, batch, size, size, 3),
                           generator=gen, device=device,
                           dtype=torch.uint8).cpu()
    labels = torch.randint(0, classes, (count, batch), generator=gen,
                           device=device, dtype=torch.int32).cpu()
    return [(frames[i], labels[i]) for i in range(count)]
