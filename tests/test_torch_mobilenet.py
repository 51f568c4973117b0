"""MobileNetV2: the PyTorch port against the JAX package's flax model.

The JAX model's variables, made from a seed, are carried over with
``params_from_flax``; the same uint8 frames, made with numpy, go through
both forwards (preprocessing included, ``use_pallas`` on both sides) and
the f32 logits are compared on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models.mobilenet_v2 import \
    MobileNetV2 as FlaxMobileNetV2
from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu.ops.preprocess import normalize_frame as jax_normalize
from nnstreamer_tpu_torch.models.mobilenet_v2 import (MobileNetV2, load_flax,
                                                      params_from_flax)
from nnstreamer_tpu_torch.models.registry import get_model


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _to_numpy(variables):
    return jax.tree_util.tree_map(np.asarray, variables)


def _perturb_batchnorm(variables, seed=0):
    """Give every BatchNorm non-trivial stats and affine terms, so a
    mapping that swapped or dropped one of them shows in the logits."""
    rng = np.random.default_rng(seed)

    def walk(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif "BatchNorm_0" in path and k in ("scale", "var"):
                out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif "BatchNorm_0" in path:         # bias, mean
                out[k] = rng.normal(0.0, 0.1, v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(variables)


def _jax_logits(module, variables, frame):
    @jax.jit
    def forward(variables, frame):
        x = jax_normalize(frame, dtype=jnp.float32)
        return module.apply(variables, x[None])[0]

    return np.asarray(forward(variables, jnp.asarray(frame)))


def _torch_logits(model, frame):
    with torch.inference_mode():
        return model(torch.from_numpy(frame))[0].numpy()


def _frame(size, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                                np.uint8)


def test_small_model_matches_jax():
    """Narrow width (every channel count is 8), 32x32 input, 10 classes,
    f32; BatchNorm stats perturbed from the seed."""
    width, size, classes = 0.25, 32, 10
    flax_model = FlaxMobileNetV2(num_classes=classes, width=width,
                                 dtype=jnp.float32)
    variables = _to_numpy(jax.jit(flax_model.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32)))
    variables = _perturb_batchnorm(variables)
    model = MobileNetV2(num_classes=classes, width=width,
                        dtype=torch.float32, use_pallas=True)
    load_flax(model, variables).eval()
    for seed in (1, 2):
        frame = _frame(size, seed)
        np.testing.assert_allclose(_torch_logits(model, frame),
                                   _jax_logits(flax_model, variables, frame),
                                   atol=1e-4, rtol=1e-4)


def test_full_width_model_matches_jax():
    """MobileNetV2 1.0 at 224x224, 1001 classes, f32, through both
    registries.  ``atol=1e-3``: the two frameworks sum the convolutions
    in different orders in f32."""
    custom = {"input_size": "224", "dtype": "float32", "use_pallas": "1",
              "seed": "3"}
    jax_model = jax_get_model("mobilenet_v2", custom)
    port = get_model("mobilenet_v2", custom, device="cpu")
    load_flax(port.module, _to_numpy(jax_model.params))
    frame = _frame(224)
    want = np.asarray(jax.jit(jax_model.forward)(jax_model.params,
                                                 jnp.asarray(frame))[0])
    got = _torch_logits(port.module, frame)
    assert got.shape == (1001,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)
    assert int(np.argmax(got)) == int(np.argmax(want))
    assert port.in_info.is_equal(_port_info(jax_model.in_info))
    assert port.out_info.is_equal(_port_info(jax_model.out_info))


def _port_info(jax_info):
    from nnstreamer_tpu_torch.tensor.info import TensorsInfo

    return TensorsInfo.from_strings(jax_info.dims_string(),
                                    jax_info.types_string())


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.mark.parametrize("width", [0.25, 1.0])
def test_weight_mapping_uses_every_leaf_once(width):
    """Every flax leaf maps to exactly one torch tensor, and every float
    tensor of the torch model is filled: a leaf left over, or one
    missing, raises."""
    flax_model = FlaxMobileNetV2(num_classes=10, width=width,
                                 dtype=jnp.float32)
    shapes = jax.eval_shape(flax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 32, 32, 3), jnp.float32))
    variables = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, s.dtype), shapes)
    model = MobileNetV2(num_classes=10, width=width)
    state = params_from_flax(variables, model)
    floats = [k for k, v in model.state_dict().items()
              if v.is_floating_point()]
    assert len(state) == len(_leaves(variables)) == len(floats)
    for key, tensor in state.items():
        assert tuple(tensor.shape) == tuple(model.state_dict()[key].shape)

    extra = dict(variables, params=dict(variables["params"],
                                        Stray_0={"kernel": np.zeros(1)}))
    with pytest.raises(ValueError, match="unmapped"):
        params_from_flax(extra, model)
    short = dict(variables, params={k: v for k, v in
                                    variables["params"].items()
                                    if k != "Dense_0"})
    with pytest.raises(KeyError, match="Dense_0"):
        params_from_flax(short, model)
