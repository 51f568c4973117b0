"""The vision zoo — SSD-MobileNetV2, DeepLabV3, PoseNet — against the JAX
package's flax models.

The JAX models' variables, made from a seed with numpy (their BatchNorm
statistics and affine terms away from the identity, so a swapped or
dropped leaf shows), are carried over with ``load_flax``; the same uint8
frames, made with numpy, go through both forwards on the CPU in f32, per
frame and as a batch.
The input sizes are odd (75, 65, 33), so the stride-2 SAME pads are
mixed symmetric and asymmetric along the way, as at the real 300 and 257.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu_torch.models import deeplab_v3, posenet, ssd
from nnstreamer_tpu_torch.models.mobilenet_v2 import (load_flax,
                                                      params_from_flax)
from nnstreamer_tpu_torch.models.registry import get_model
from nnstreamer_tpu_torch.tensor.info import TensorsInfo

#: |port - JAX| <= ATOL + RTOL * |JAX| in f32: the two frameworks sum the
#: convolutions in different orders
ATOL = 1e-5
RTOL = 1e-4

MODELS = {
    "ssd_mobilenet_v2": ssd.SSDMobileNetV2,
    "deeplab_v3": deeplab_v3.DeepLabV3,
    "posenet": posenet.PoseNet,
}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


#: the JAX package's module of each zoo model
JAX_MODULES = {"ssd_mobilenet_v2": "ssd", "deeplab_v3": "deeplab_v3",
               "posenet": "posenet"}


def random_variables(shapes, seed=0):
    """numpy variables of the given flax shapes: LeCun-normal kernels,
    small random biases, and BatchNorm statistics and affine terms away
    from the identity, so a swapped or dropped leaf shows."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        names = [str(getattr(p, "key", p)) for p in path]
        if names[-1] == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0.0, fan_in ** -0.5, s.shape).astype(np.float32)
        if "BatchNorm_0" in names and names[-1] in ("scale", "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return rng.normal(0.0, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_zoo_model(name, custom, seed=0):
    """The JAX package's registry model ``name`` with
    :func:`random_variables` for its params.  Its builder's own flax init
    is traced for shapes only (``host_init`` patched to ``eval_shape``):
    the init's compile would cost ~10 s a model."""
    import dataclasses
    import importlib

    module = importlib.import_module(
        f"nnstreamer_tpu.models.{JAX_MODULES[name]}")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "host_init", jax.eval_shape)
        model = jax_get_model(name, custom)
    return dataclasses.replace(model,
                               params=random_variables(model.params, seed))


def port_zoo_model(name, custom, variables):
    """The port's registry model ``name`` on the CPU, carrying
    ``variables``."""
    model = get_model(name, custom, device="cpu")
    load_flax(model.module, variables)
    return model


def _frames(size, n=2, seed=1):
    return np.random.default_rng(seed).integers(0, 256, (n, size, size, 3),
                                                np.uint8)


class _Pair:
    """One model in both packages at one size, the port carrying the JAX
    model's variables."""

    def __init__(self, name, size):
        custom = {"input_size": str(size), "dtype": "float32"}
        self.jax = jax_zoo_model(name, custom, seed=size)
        self.port = port_zoo_model(name, custom, self.jax.params)
        self.size = size

    def jax_outputs(self, frames):
        fwd = jax.jit(self.jax.forward)
        return [[np.asarray(o) for o in fwd(self.jax.params, jnp.asarray(f))]
                for f in frames]


CASES = [("ssd_mobilenet_v2", 75), ("ssd_mobilenet_v2", 33),
         ("deeplab_v3", 65), ("posenet", 65), ("posenet", 33)]


@pytest.fixture(scope="module")
def pairs():
    return {case: _Pair(*case) for case in CASES}


def _close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_forward_matches_jax(pairs, case):
    """Per frame: every output within ATOL + RTOL·|JAX| of the JAX
    model's; the info of both registries agrees."""
    pair = pairs[case]
    frames = _frames(pair.size)
    want = pair.jax_outputs(frames)
    with torch.inference_mode():
        for frame, ref in zip(frames, want):
            got = pair.port.module(torch.from_numpy(frame))
            assert len(got) == len(ref)
            for g, w in zip(got, ref):
                _close(g.numpy(), w)
    assert pair.port.in_info.is_equal(_port_info(pair.jax.in_info))
    assert pair.port.out_info.is_equal(_port_info(pair.jax.out_info))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_batched_forward_matches_jax(pairs, case):
    """``Model.batched`` over a (B, H, W, 3) batch: each row within the
    same bound of the JAX model's per-frame outputs."""
    pair = pairs[case]
    frames = _frames(pair.size, n=3, seed=4)
    want = pair.jax_outputs(frames)
    assert pair.port.batched is pair.port.module
    with torch.inference_mode():
        got = pair.port.batched(torch.from_numpy(frames))
    for i, ref in enumerate(want):
        for g, w in zip(got, ref):
            _close(g[i].numpy(), w)


def _port_info(jax_info):
    return TensorsInfo.from_strings(jax_info.dims_string(),
                                    jax_info.types_string())


@pytest.mark.parametrize("size", [300, 75, 64, 33, 1])
def test_anchor_count_matches_jax(size):
    """The anchor count follows from the input size as JAX's
    ``eval_shape`` derives it (1,887 at 300, not the JAX module's
    nominal 1,917)."""
    module = jax_ssd_module()
    shapes = jax.eval_shape(
        lambda x: module.apply(module.init(jax.random.PRNGKey(0), x), x),
        jax.ShapeDtypeStruct((size, size, 3), jnp.float32))
    assert ssd.anchor_count(size) == shapes[0].shape[0]
    if size == 300:
        assert ssd.anchor_count(size) == 1887


def jax_ssd_module():
    from nnstreamer_tpu.models.ssd import _SSDBackboneHeads

    return _SSDBackboneHeads(dtype=jnp.float32)


def _jax_variable_shapes(name, size):
    from nnstreamer_tpu.models.deeplab_v3 import _DeepLabV3
    from nnstreamer_tpu.models.posenet import _PoseNet

    module = {"ssd_mobilenet_v2": jax_ssd_module(),
              "deeplab_v3": _DeepLabV3(dtype=jnp.float32),
              "posenet": _PoseNet(dtype=jnp.float32)}[name]
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((size, size, 3), jnp.float32))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


@pytest.mark.parametrize("name,size,count", [
    ("ssd_mobilenet_v2", 300, 9_299_563), ("deeplab_v3", 257, 747_349),
    ("posenet", 257, 1_859_635)])
def test_value_counts_and_leaf_mapping(name, size, count):
    """The torch module's parameters plus its BatchNorm running
    statistics hold as many values as the JAX variables (``params`` plus
    ``batch_stats``); every flax leaf maps to exactly one tensor and
    every float tensor of the module is filled; a stray leaf raises."""
    variables = _jax_variable_shapes(name, size)
    leaves = jax.tree_util.tree_leaves(variables)
    assert sum(leaf.size for leaf in leaves) == count
    model = MODELS[name]()
    held = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for key, b in model.named_buffers()
        if key.endswith(("running_mean", "running_var")))
    assert held == count
    state = params_from_flax(variables, model)
    floats = [k for k, v in model.state_dict().items()
              if v.is_floating_point()]
    assert len(state) == len(leaves) == len(floats)
    extra = dict(variables, params=dict(variables["params"],
                                        Conv_9={"kernel": np.zeros(1)}))
    with pytest.raises(ValueError, match="unmapped"):
        params_from_flax(extra, model)


def test_full_size_ssd_matches_jax():
    """SSD-MobileNetV2 at its real 300x300 (1,887 anchors x 91 classes),
    f32, through both registries with the JAX weights carried over."""
    pair = _Pair("ssd_mobilenet_v2", 300)
    frame = _frames(300, n=1)[0]
    (boxes, scores), = pair.jax_outputs([frame])
    with torch.inference_mode():
        got_boxes, got_scores = pair.port.module(torch.from_numpy(frame))
    assert got_boxes.shape == (1887, 4) and got_scores.shape == (1887, 91)
    _close(got_boxes.numpy(), boxes)
    _close(got_scores.numpy(), scores)


def test_posenet_grid_and_deeplab_size():
    """PoseNet's heatmap grid at 257 is 9x9 (five SAME stride-2 stages),
    and DeepLabV3 upsamples back to the input size, HWC."""
    assert posenet.output_hw(257) == (9, 9)
    pose = get_model("posenet", {}, device="cpu")
    assert pose.out_info[0].np_shape == (9, 9, 17)
    assert pose.out_info[1].np_shape == (9, 9, 34)
    seg = get_model("deeplab_v3", {"input_size": "33"}, device="cpu")
    with torch.inference_mode():
        out, = seg.module(torch.zeros(33, 33, 3, dtype=torch.uint8))
    assert out.shape == (33, 33, 21) and out.dtype == torch.float32
