"""StreamFormer LM serving: the PyTorch port against the JAX package.

The JAX package's parameter tree, made from a seed, is carried over with
``params_from_jax`` (a dtype and device move, no re-layout); the same
tokens go through both packages' forward, prefill and decode functions
in f32 on the CPU.  The JAX side attends with its plain path (its tests
pin the Pallas kernel to it, and tests/test_torch_flash_attention.py pins
the port's kernel semantics to the Pallas kernel); the port runs both of
its paths.  Tolerance: logits and K/V within 1e-4 abs and rel — the two
sum in different orders, nothing else differs; greedy token streams
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu
import nnstreamer_tpu_torch
from nnstreamer_tpu.models import streamformer_lm as J
from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu.parallel import train_step as JT
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.models import registry as torch_registry
from nnstreamer_tpu_torch.models import streamformer_lm as T
from nnstreamer_tpu_torch.parallel import train_step as TT
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

ATOL = RTOL = 1e-4
SIZES = dict(vocab=61, dim=32, heads=4, head_dim=8, mlp=64, layers=2,
             experts=2, max_seq=48)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(seed=0, **kw):
    """(JAX cfg, JAX params, port cfg, port params carrying them)."""
    sizes = {**SIZES, **kw}
    jc = JT.StreamFormerConfig(**sizes, dtype=jnp.float32)
    tc = TT.StreamFormerConfig(**sizes, dtype=torch.float32)
    jp = JT.init_params(jc, seed)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                          device="cpu")
    return jc, jp, tc, tp


def _toks(n, seed=0, vocab=61):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("t", [5, 37])
def test_forward_logits_match_jax(t, flash):
    jc, jp, tc, tp = _pair(seed=1)
    toks = _toks(t, seed=t)
    want = jax.jit(lambda p, x: J.forward_logits(p, x, jc, flash=False))(
        jp, jnp.asarray(toks))
    got = T.forward_logits(tp, torch.from_numpy(toks), tc, flash=flash)
    assert got.dtype == torch.float32 and got.shape == (t, 61)
    _close(got, want)


@pytest.mark.parametrize("head_dim", [8, 16])
def test_prefill_kv_matches_jax(head_dim):
    jc, jp, tc, tp = _pair(seed=2, head_dim=head_dim)
    toks = _toks(11, seed=3)
    wl, wk, wv = jax.jit(lambda p, x: J.prefill_kv(p, x, jc, flash=False))(
        jp, jnp.asarray(toks))
    gl, gk, gv = T.prefill_kv(tp, torch.from_numpy(toks), tc, flash=True)
    assert gk.shape == (2, 11, 4, head_dim) == gv.shape
    for got, want in ((gl, wl), (gk, wk), (gv, wv)):
        _close(got, want)


def test_decode_step_pooled_matches_jax():
    """Three lanes at different positions of a pool seeded with random
    history, one padding lane on the scratch slot."""
    jc, jp, tc, tp = _pair(seed=4)
    shape = (4, 2, 48, 4, 8)
    hist = np.random.default_rng(5).standard_normal((2,) + shape)
    hist = hist.astype(np.float32)
    toks = np.asarray([5, 17, 42, 0], np.int32)
    pos = np.asarray([0, 7, 30, 0], np.int32)
    slots = np.asarray([0, 1, 2, 3], np.int32)
    wl, wk, wv = jax.jit(lambda *a: J.decode_step_pooled(*a, jc))(
        jp, jnp.asarray(hist[0]), jnp.asarray(hist[1]), jnp.asarray(toks),
        jnp.asarray(pos), jnp.asarray(slots))
    kp, vp = torch.from_numpy(hist[0].copy()), torch.from_numpy(hist[1].copy())
    gl, gk, gv = T.decode_step_pooled(tp, kp, vp, torch.from_numpy(toks),
                                      torch.from_numpy(pos),
                                      torch.from_numpy(slots), tc)
    assert gk is kp and gv is vp             # updated in place
    for got, want in ((gl, wl), (gk, wk), (gv, wv)):
        _close(got, want)


def test_padding_lane_writes_only_scratch():
    _, _, tc, tp = _pair(seed=6)
    kp = torch.ones(3, 2, 48, 4, 8)
    vp = torch.ones(3, 2, 48, 4, 8)
    before = kp[1].clone()
    T.decode_step_pooled(tp, kp, vp, torch.tensor([3, 0]),
                         torch.tensor([0, 0]), torch.tensor([0, 2]), tc)
    assert torch.equal(kp[1], before)
    assert not torch.equal(kp[2, :, 0], torch.ones(2, 4, 8))


def test_decode_step_matches_jax_and_full_forward():
    """Token-by-token through the single cache: the JAX package's
    decode_step at every position, and the full forward's logits."""
    jc, jp, tc, tp = _pair(seed=7)
    toks = _toks(9, seed=8)
    full = T.forward_logits(tp, torch.from_numpy(toks), tc, flash=False)
    jcache, tcache = J.init_cache(jc), T.init_cache(tc, device="cpu")
    jax_step = jax.jit(lambda p, c, t: J.decode_step(p, c, t, jc))
    for i, tok in enumerate(toks):
        wl, jcache = jax_step(jp, jcache, jnp.int32(tok))
        gl, tcache = T.decode_step(tp, tcache, torch.tensor(int(tok)), tc)
        _close(gl, wl)
        _close(gl, full[i])
    assert int(tcache["pos"]) == 9
    _close(tcache["k"], jcache["k"])


@pytest.mark.parametrize("seed", [0, 1])
def test_generate_matches_jax(seed):
    jc, jp, tc, tp = _pair(seed=seed)
    prompt = _toks(5, seed=seed + 10)
    want = J.generate(jp, jc, prompt, 12)
    got = T.generate(tp, tc, prompt, 12)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_generate_refuses_overlength():
    _, _, tc, tp = _pair()
    with pytest.raises(ValueError, match="max_seq"):
        T.generate(tp, tc, _toks(40), 9)


def test_ln_matches_jax():
    x = np.random.default_rng(9).standard_normal((5, 32)).astype(np.float32)
    s = np.random.default_rng(10).standard_normal(32).astype(np.float32)
    _close(TT._ln(torch.from_numpy(x), torch.from_numpy(s)),
           JT._ln(jnp.asarray(x), jnp.asarray(s)))


def test_init_params_tree_matches_jax():
    tc = TT.StreamFormerConfig(**SIZES)
    jc = JT.StreamFormerConfig(**SIZES)
    got = TT.init_params(tc, 3)
    want = JT.init_params(jc, 3)
    shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), want)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), got) == shapes
    again = TT.init_params(tc, 3)
    assert torch.equal(got["layers"][1]["we2"], again["layers"][1]["we2"])
    assert not torch.equal(got["embed"], TT.init_params(tc, 4)["embed"])


def test_params_keep_f32_where_jax_computes_in_f32():
    tc = TT.StreamFormerConfig(**SIZES, dtype=torch.bfloat16)
    p = T.place_params(TT.init_params(tc, 0), tc, device="cpu")
    assert p["head"].dtype == p["embed"].dtype == torch.float32
    assert p["layers"][0]["gate"].dtype == torch.float32
    assert p["layers"][0]["wqkv"].dtype == torch.bfloat16


@pytest.mark.parametrize("custom", [
    {"width": "64", "layers": "3", "heads": "2", "head_dim": "8",
     "max_seq": "128"},
    {"seq": "100", "vocab": "99"},
    {},
])
def test_config_grammar_matches_jax(custom):
    want = J.config_from_custom(custom)
    got = T.config_from_custom(custom)
    for field in ("vocab", "dim", "heads", "head_dim", "mlp", "layers",
                  "experts", "max_seq"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.dtype == torch.bfloat16
    assert T.config_from_custom(custom, device="cpu").dtype == torch.float32


@pytest.mark.parametrize("custom,match", [
    ({"dim": "64", "width": "128"}, "alias"),
    ({"seq": "128", "max_seq": "64"}, "max_seq"),
    ({"layers": "0"}, ">= 1"),
])
def test_config_grammar_errors(custom, match):
    for mod in (J, T):
        with pytest.raises(ValueError, match=match):
            mod.config_from_custom(custom)


CUSTOM = "seq:16,vocab:61,dim:32,dtype:float32"
CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=16,"
        "types=int32,framerate=0/1")


def _run_launch(pkg, buffer_cls, toks, accelerator=""):
    got = []
    p = pkg.parse_launch(
        f"appsrc name=src caps={CAPS} ! tensor_filter framework=xla "
        f"model=streamformer_lm {accelerator}custom={CUSTOM} ! "
        "tensor_sink name=out")
    p.get("out").connect("new-data", lambda b: got.append(b.np(0).copy()))
    p.play()
    for t in toks:
        p.get("src").push_buffer(buffer_cls(tensors=[t]))
    p.get("src").end_of_stream()
    p.wait(timeout=120)
    p.stop()
    return got


def test_launch_string_matches_jax(monkeypatch):
    """The LM filter's launch string through both packages, the port on
    the CPU with the JAX model's parameters: (T, vocab) logits per frame."""
    props = dict(kv.split(":") for kv in CUSTOM.split(","))
    jparams = jax.tree_util.tree_map(
        np.asarray, jax_get_model("streamformer_lm", props).params)
    build = torch_registry._MODELS["streamformer_lm"]

    def build_from_jax(custom_props, device=None):
        model = build(custom_props, device)
        model.module.params = T.params_from_jax(jparams, model.module.cfg,
                                                model.device)
        return model

    monkeypatch.setitem(torch_registry._MODELS, "streamformer_lm",
                        build_from_jax)
    toks = [_toks(16, seed=s) for s in range(2)]
    want = _run_launch(nnstreamer_tpu, JaxBuffer, toks)
    got = _run_launch(nnstreamer_tpu_torch, TensorBuffer, toks,
                      "accelerator=true:cpu ")
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == (16, 61) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL)
