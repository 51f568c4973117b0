"""MobileNetV2's training form (``get_model("mobilenet_v2",
trainable=True)``) against the JAX package's ``make_vision_train_step`` on
the CPU.

The JAX model's variables (their BatchNorm statistics moved off identity,
so freezing them matters) are carried into the training form with
``load_flax``; the same uint8 batches (K1's plain version normalizes them
on the port's side, ``use_pallas:1``) go through three Adam steps on both.
Losses within 1e-5 rel; parameters within 2e-4 abs (Adam turns f32
rounding of a gradient near 0 into an update of up to ``lr``, 1e-3);
BatchNorm's running statistics unchanged on both sides, exactly.
"""

import math

import jax
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu.parallel import make_mesh as jax_make_mesh
from nnstreamer_tpu.parallel.vision_train import \
    make_vision_train_step as jax_vision_step
from nnstreamer_tpu_torch.models.mobilenet_v2 import (load_flax,
                                                      params_from_flax)
from nnstreamer_tpu_torch.models.registry import get_model
from nnstreamer_tpu_torch.parallel import make_mesh
from nnstreamer_tpu_torch.parallel.vision_train import make_vision_train_step

PROPS = {"input_size": "32", "num_classes": "4", "dtype": "float32"}
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stats_off_identity(variables, seed=0):
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "var":
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            else:
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
        return out

    return {**variables, "batch_stats": walk(variables["batch_stats"])}


def _batches(steps=3, b=4, size=32, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (b, size, size, 3), dtype=np.uint8),
             rng.integers(0, 4, b).astype(np.int32)) for _ in range(steps)]


def test_training_step_matches_jax(jax_cpu_devices):
    jmodel = jax_get_model("mobilenet_v2", PROPS)
    start = _stats_off_identity(jax.tree.map(np.asarray, jmodel.params))
    jmodel.params = start
    jstep, jparams, jopt, _ = jax_vision_step(
        jax_make_mesh(n_devices=1, axis_sizes={"dp": 1}), jmodel, lr=1e-3)
    model = get_model("mobilenet_v2", {**PROPS, "use_pallas": "1"},
                      device="cpu", trainable=True)
    assert all(p.dtype == torch.float32 for p in model.module.parameters())
    load_flax(model.module, start)
    step, module, opt, _ = make_vision_train_step(make_mesh(devices=[CPU]),
                                                  model, lr=1e-3)
    for frames, labs in _batches():
        jparams, jopt, jloss = jstep(jparams, jopt, frames, labs)
        module, opt, loss = step(module, opt, torch.from_numpy(frames),
                                 torch.from_numpy(labs))
        assert math.isclose(float(loss), float(jloss), rel_tol=1e-5)
    trained = jax.tree.map(np.asarray, jparams)
    for a, b in zip(jax.tree.leaves(trained["batch_stats"]),
                    jax.tree.leaves(start["batch_stats"])):
        np.testing.assert_array_equal(a, b)     # frozen in the JAX step
    want = params_from_flax(trained, module)
    got = module.state_dict()
    for key, w in want.items():
        atol = 0.0 if "running_" in key else 2e-4
        torch.testing.assert_close(got[key], w, atol=atol, rtol=0.0,
                                   msg=key)
