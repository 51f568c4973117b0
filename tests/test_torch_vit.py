"""ViT: the PyTorch port against the JAX package's flax model.

The JAX model's variables, made from a seed, are carried over with
``params_from_flax``; the same uint8 frames, made with numpy, go through
both forwards (preprocessing included) in f32 on the CPU, through both
attention paths.  Tolerance: logits within 1e-4 abs and rel — the two
sum in different orders, nothing else differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu
import nnstreamer_tpu_torch
from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu_torch.device import DeviceError
from nnstreamer_tpu_torch.models import registry as torch_registry
from nnstreamer_tpu_torch.models.registry import get_model, list_models
from nnstreamer_tpu_torch.models.vit import (_LayerNorm, load_flax,
                                             params_from_flax)
from nnstreamer_tpu_torch.ops.preprocess import cast_then_scale

TINY = "input_size:32,patch:16,dim:64,depth:2,heads:2,num_classes:10"
ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _props(spec=TINY, **extra):
    return {**dict(p.split(":") for p in spec.split(",")), **extra}


def _pair(props):
    """(JAX model, port model carrying the JAX model's variables)."""
    jm = jax_get_model("vit", props)
    tm = get_model("vit", props, device="cpu")
    load_flax(tm.module, jax.tree_util.tree_map(np.asarray, jm.params))
    return jm, tm


def _frame(seed, size=32):
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3),
                                                dtype=np.uint8)


def test_registered():
    assert "vit" in list_models()


@pytest.mark.parametrize("size", [32, 64], ids=["5tok", "17tok"])
@pytest.mark.parametrize("attn", ["flash", "naive"])
def test_logits_match_jax(attn, size):
    jm, tm = _pair(_props(dtype="float32", attn=attn, input_size=str(size)))
    forward = jax.jit(jm.forward)
    for seed in range(2):
        frame = _frame(seed, size)
        want, = forward(jm.params, frame)
        with torch.inference_mode():
            got, = tm.module(torch.from_numpy(frame))
        assert got.dtype == torch.float32 and got.shape == (10,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=RTOL)


def test_default_attention_on_cpu_is_plain():
    """With no ``attn`` prop the gate picks plain attention off the card,
    which matches the JAX model's naive path."""
    jm, tm = _pair(_props(dtype="float32", attn="naive"))
    default = get_model("vit", _props(dtype="float32"), device="cpu")
    default.module.load_state_dict(tm.module.state_dict())
    frame = _frame(3)
    with torch.inference_mode():
        a, = default.module(torch.from_numpy(frame))
        b, = tm.module(torch.from_numpy(frame))
    assert torch.equal(a, b)
    assert default.module.blocks[0].attn.flash is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_preprocessing_matches_jax_bit_for_bit(dtype):
    """Cast first, then scale and shift in the compute dtype, as the
    JAX model's jitted forward does (XLA contracts the f32 multiply-add
    into one FMA)."""
    frame = np.arange(256, dtype=np.uint8).reshape(16, 16)
    want = jax.jit(lambda x: x.astype(jnp.dtype(dtype)) * (1.0 / 127.5)
                   - 1.0)(jnp.asarray(frame))
    got = cast_then_scale(torch.from_numpy(frame), getattr(torch, dtype))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_flax(dtype):
    """Statistics in f32 and eps 1e-6: at a variance of ~1e-5 torch's
    default eps (1e-5) would be off by ~30 %."""
    import flax.linen as fnn

    rng = np.random.default_rng(0)
    x = (rng.standard_normal((7, 64)) * 3e-3).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jd = jnp.dtype(dtype)
    want = fnn.LayerNorm(dtype=jd).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x, jd))
    ln = _LayerNorm(64)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x).to(getattr(torch, dtype)))
    tol = 1e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def test_param_map_is_one_to_one():
    jm = jax_get_model("vit", _props())
    variables = jax.tree_util.tree_map(np.asarray, jm.params)
    model = get_model("vit", _props(), device="cpu").module
    state = params_from_flax(variables, model)
    assert set(state) == set(model.state_dict())
    # qkv: Dense (in, out) → Linear (out, in)
    np.testing.assert_array_equal(
        state["blocks.0.attn.qkv.weight"].numpy(),
        variables["params"]["_Block_0"]["_Attention_0"]["qkv"]["kernel"].T)
    extra = {"params": {**variables["params"], "stray": {"kernel": 0}}}
    with pytest.raises(ValueError, match="unmapped"):
        params_from_flax(extra, model)
    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "head"}}
    with pytest.raises(KeyError, match="head"):
        params_from_flax(missing, model)


def test_model_info_and_layernorm_params_stay_f32():
    m = get_model("vit", _props(dtype="bfloat16"), device="cpu")
    assert m.in_info[0].np_shape == (32, 32, 3)
    assert m.out_info[0].np_shape == (10,)
    assert m.module.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    assert m.module.blocks[0].ln1.weight.dtype == torch.float32


def test_builder_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        get_model("vit", _props())


def _launch(accelerator=""):
    return ("videotestsrc num-buffers=6 pattern=random seed=5 ! "
            "video/x-raw,format=RGB,width=32,height=32,framerate=30/1 ! "
            "tensor_converter ! "
            f"tensor_filter framework=xla model=vit {accelerator}"
            f"custom={TINY},dtype:float32 ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")


def test_launch_string_labels_match_jax(monkeypatch):
    """The ViT launch string through both packages' ``parse_launch``, the
    port on the CPU with the JAX model's variables: labels frame for
    frame."""
    props = _props(dtype="float32")
    variables = jax.tree_util.tree_map(
        np.asarray, jax_get_model("vit", props).params)
    build = torch_registry._MODELS["vit"]

    def build_from_jax(custom_props, device=None):
        model = build(custom_props, device)
        load_flax(model.module, variables)
        return model

    monkeypatch.setitem(torch_registry._MODELS, "vit", build_from_jax)
    jp = nnstreamer_tpu.parse_launch(_launch())
    jp.run(timeout=120)
    want = [b.extra["index"] for b in jp.get("out").results]
    tp = nnstreamer_tpu_torch.parse_launch(_launch("accelerator=true:cpu "))
    tp.run(timeout=120)
    got = [b.extra["index"] for b in tp.get("out").results]
    assert len(want) == 6 and got == want
