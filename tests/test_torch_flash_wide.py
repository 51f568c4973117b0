"""Flash attention at every head dim, and the wide-head StreamFormer LM:
the port against the JAX package on the CPU.

The JAX package's ``flash_attention`` takes any head dim D, forward and
backward.  The same q/k/v and cotangents, made with numpy from a seed, go
through it (Pallas in interpret mode, its custom VJP launching the two
backward kernels, as its own tests run it on the CPU) and through the
port's ``flash_attention`` on CPU tensors, which take the kernels' plain
versions (the card holds its kernels to those: tests/test_torch_cuda.py,
chip_smoke.py).  D = 136 (past 128), 256 (the tensor cores' widest, and
the head width of Gemma's 2B and 7B configs) and 320 (on the card the
forward's piece kernel, two pieces of 256 columns, and the backward's
piece kernels, pieces of 128 columns with a last one of 64).

The wide-head LM is StreamFormer with its attention laid out as 2 heads of
256, at a small depth and width: the JAX package's parameters are carried
over, the same tokens go through both packages' logits, a launch string
through both packages' filters, and one Adam step (the port through its
flash route) against the JAX step.

Tolerances: f32 out, lse and gradients within 2e-5 abs and rel, the
existing class of tests/test_torch_flash_backward.py (the two sum in
different orders, nothing else differs; a sum over 320 products keeps
well inside it); bf16 within 2e-2 (both round q, k, v and the gradients
once); the LM's logits and loss within 1e-4 and its parameters after a
step within tests/test_torch_train_step.py's 2e-4.  Rows that see no key
give exactly 0 and -inf.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu
import nnstreamer_tpu_torch
from nnstreamer_tpu.models import streamformer_lm as J
from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu.ops.flash_attention import flash_attention as jax_flash
from nnstreamer_tpu.parallel import mesh as jax_mesh
from nnstreamer_tpu.parallel import train_step as JT
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch.models import registry as torch_registry
from nnstreamer_tpu_torch.models import streamformer_lm as T
from nnstreamer_tpu_torch.ops.flash_attention import flash_attention
from nnstreamer_tpu_torch.parallel import mesh as pt_mesh
from nnstreamer_tpu_torch.parallel import train_step as TT
from nnstreamer_tpu_torch.parallel.ring_attention import ring_attention
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

ATOL = RTOL = 2e-5
BF16_TOL = 2e-2
LM_TOL = 1e-4
PARAM_ATOL = 2e-4
WIDE_DIMS = [136, 256, 320]
#: the wide-head LM at a small depth and width: 2 heads x 256
LM_SIZES = dict(vocab=61, dim=32, heads=2, head_dim=256, mlp=64, layers=2,
                experts=2, max_seq=48)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _case(tq, h, d, tkv=None, seed=0, batch=()):
    """q, k, v and an out cotangent."""
    tkv = tkv or tq
    return _arrays([batch + (tq, h, d), batch + (tkv, h, d),
                    batch + (tkv, h, d), batch + (tq, h, d)], seed)


def _jax(q, k, v, g, g_lse, batched=False, dtype=jnp.float32, **kw):
    """((out, lse), (dq, dk, dv)) of the JAX kernel, as f32 numpy."""
    def f(q, k, v):
        return jax_flash(q, k, v, interpret=True, return_lse=True, **kw)

    if batched:
        f = jax.vmap(f)
    (out, lse), vjp = jax.vjp(f, *(jnp.asarray(x, dtype) for x in (q, k, v)))
    grads = vjp((jnp.asarray(g, dtype), jnp.asarray(g_lse, jnp.float32)))
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return (f32(out), f32(lse)), tuple(f32(x) for x in grads)


def _torch(q, k, v, g, g_lse, dtype=torch.float32, **kw):
    """The same through the port: out and lse both used."""
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention(*ts, return_lse=True, **kw)
    grads = torch.autograd.grad(
        (out, lse), ts, (torch.from_numpy(g).to(dtype),
                         torch.from_numpy(g_lse)))
    f32 = lambda x: x.detach().float().numpy()  # noqa: E731
    return (f32(out), f32(lse)), tuple(f32(x) for x in grads)


def _assert_match(want, got, atol=ATOL, rtol=RTOL):
    (w_out, w_lse), w_grads = want
    (g_out, g_lse), g_grads = got
    np.testing.assert_allclose(g_out, w_out, atol=atol, rtol=rtol)
    dead = np.isneginf(w_lse)
    np.testing.assert_array_equal(np.isneginf(g_lse), dead)
    np.testing.assert_allclose(g_lse[~dead], w_lse[~dead], atol=atol,
                               rtol=rtol)
    for name, w, t in zip(("dq", "dk", "dv"), w_grads, g_grads):
        assert t.shape == w.shape, name
        np.testing.assert_allclose(t, w, atol=atol, rtol=rtol, err_msg=name)
    return dead


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_head_matches_jax(d, causal):
    """Out, lse, and the gradients of both (a random lse cotangent folds
    into delta), at a ragged length that pads to the JAX kernel's tiles."""
    q, k, v, g = _case(40, 2, d, seed=d)
    g_lse = _arrays([(2, 40)], d + 1)[0]
    _assert_match(_jax(q, k, v, g, g_lse, causal=causal),
                  _torch(q, k, v, g, g_lse, causal=causal))


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_wide_head_offsets_and_dead_rows_match_jax(d):
    """Global-position causality with keys 20 positions after the queries:
    rows 0..19 see no key (out 0, lse -inf, dq 0, though they carry an
    lse cotangent); cross lengths."""
    q, k, v, g = _case(32, 2, d, tkv=48, seed=d + 2)
    g_lse = _arrays([(2, 32)], d + 3)[0]
    kw = dict(causal=True, q_offset=5, k_offset=25)
    got = _torch(q, k, v, g, g_lse, **kw)
    dead = _assert_match(_jax(q, k, v, g, g_lse, **kw), got)
    assert dead[:, :20].all() and not dead[:, 20:].any()
    (out, _), (dq, _, _) = got
    assert np.all(out[:20] == 0) and np.all(dq[:20] == 0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_wide_head_batch_axis_matches_jax_vmap(causal):
    """(B, T, H, D) at D = 256: the batch the kernels' grid axis, against
    jax.vmap of the kernel."""
    q, k, v, g = _case(19, 2, 256, seed=30, batch=(3,))
    g_lse = _arrays([(3, 2, 19)], 31)[0]
    _assert_match(_jax(q, k, v, g, g_lse, batched=True, causal=causal),
                  _torch(q, k, v, g, g_lse, causal=causal))


@pytest.mark.parametrize("d", [256, 320])
def test_wide_head_bf16_matches_jax(d):
    q, k, v, g = _case(37, 2, d, seed=d + 4)
    g_lse = np.zeros((2, 37), np.float32)
    _assert_match(_jax(q, k, v, g, g_lse, dtype=jnp.bfloat16, causal=True),
                  _torch(q, k, v, g, g_lse, dtype=torch.bfloat16,
                         causal=True),
                  atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_wide_head_ring_attention_matches_jax(causal):
    """The ring's flash route takes wide heads through the same entry
    point: a one-member ring at D = 256, forward and gradients, against
    the JAX package's ring inside shard_map."""
    from jax.sharding import PartitionSpec as P

    from nnstreamer_tpu.parallel.compat import shard_map
    from nnstreamer_tpu.parallel.ring_attention import \
        ring_attention as jax_ring

    q, k, v, g = _arrays([(16, 2, 256)] * 4, 41)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("sp",))

    def jax_fn(q, k, v):
        return shard_map(lambda a, b, c: jax_ring(a, b, c, "sp",
                                                  causal=causal, flash=True),
                         mesh=mesh, in_specs=(P(),) * 3, out_specs=P(),
                         check_vma=False)(q, k, v)

    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = ring_attention(*ts, "sp", causal=causal, flash=True)
    got_grads = torch.autograd.grad(got, ts, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)
    for a, b in zip(got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# the wide-head StreamFormer LM
# ---------------------------------------------------------------------------

def _lm_pair(seed=0):
    """(JAX cfg, JAX params, port cfg, port params carrying them)."""
    jc = JT.StreamFormerConfig(**LM_SIZES, dtype=jnp.float32)
    tc = TT.StreamFormerConfig(**LM_SIZES, dtype=torch.float32)
    jp = JT.init_params(jc, seed)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                          device="cpu")
    return jc, jp, tc, tp


def _toks(n, seed=0, vocab=61):
    return np.random.default_rng(seed).integers(0, vocab, n).astype(np.int32)


@pytest.mark.parametrize("t", [5, 37])
def test_wide_lm_logits_match_jax(t):
    """Logits of the 2 x 256-head LM through the port's flash route (K2's
    plain version here) against the JAX package's forward."""
    jc, jp, tc, tp = _lm_pair(seed=1)
    toks = _toks(t, seed=t)
    want = jax.jit(lambda p, x: J.forward_logits(p, x, jc, flash=False))(
        jp, jnp.asarray(toks))
    got = T.forward_logits(tp, torch.from_numpy(toks), tc, flash=True)
    assert got.shape == (t, 61)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=LM_TOL,
                               rtol=LM_TOL)


def test_wide_lm_generate_matches_jax():
    """Prefill through the flash route, then the plain decode step, as
    ``tensor_llm`` serves the wide LM: greedy tokens equal the JAX
    package's."""
    jc, jp, tc, tp = _lm_pair(seed=2)
    prompt = _toks(9, seed=3)
    np.testing.assert_array_equal(T.generate(tp, tc, prompt, 12),
                                  J.generate(jp, jc, prompt, 12))


WIDE_CUSTOM = ("seq:16,vocab:61,dim:32,heads:2,head_dim:256,mlp:64,"
               "layers:2,experts:2,dtype:float32")
WIDE_CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=16,"
             "types=int32,framerate=0/1")


def _run_launch(pkg, buffer_cls, toks, accelerator=""):
    got = []
    p = pkg.parse_launch(
        f"appsrc name=src caps={WIDE_CAPS} ! tensor_filter framework=xla "
        f"model=streamformer_lm {accelerator}custom={WIDE_CUSTOM} ! "
        "tensor_sink name=out")
    p.get("out").connect("new-data", lambda b: got.append(b.np(0).copy()))
    p.play()
    for t in toks:
        p.get("src").push_buffer(buffer_cls(tensors=[t]))
    p.get("src").end_of_stream()
    p.wait(timeout=120)
    p.stop()
    return got


def test_wide_lm_launch_string_matches_jax(monkeypatch):
    """``tensor_filter model=streamformer_lm custom=...,heads:2,
    head_dim:256`` through both packages, the port on the CPU with the
    JAX model's parameters: (T, vocab) logits per frame."""
    props = dict(kv.split(":") for kv in WIDE_CUSTOM.split(","))
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
        np.testing.assert_allclose(g, w, atol=LM_TOL, rtol=LM_TOL)


def test_wide_lm_train_step_matches_jax():
    """One Adam step of the wide LM: the port's step through its flash
    route (the custom backward's plain versions at D = 256) against the
    JAX package's step from the same parameters and tokens: the loss, and
    every parameter after the step."""
    jc = JT.StreamFormerConfig(**LM_SIZES, lr=1e-3, dtype=jnp.float32)
    tc = TT.StreamFormerConfig(**LM_SIZES, lr=1e-3, dtype=torch.float32)
    jstep, jparams, jopt, _ = JT.make_train_step(
        jax_mesh.make_mesh(n_devices=1), jc, seed=4)
    start = jax.tree.map(lambda x: np.array(x, dtype=np.float32), jparams)
    step, params, opt, _ = TT.make_train_step(
        pt_mesh.make_mesh(devices=[torch.device("cpu")]), tc, params=start,
        flash=True)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, 61, (2, 16)).astype(np.int32)
    labs = np.roll(toks, -1, axis=1).astype(np.int32)
    jparams, jopt, jloss = jstep(jparams, jopt, toks, labs)
    params, opt, loss = step(params, opt, toks, labs)
    assert math.isclose(float(loss), float(jloss), rel_tol=LM_TOL)
    want = jax.tree.map(lambda x: np.array(x, dtype=np.float32), jparams)
    for name in ("embed", "pos", "head", "ln_f"):
        np.testing.assert_allclose(params[name].numpy(), want[name],
                                   atol=PARAM_ATOL, err_msg=name)
    for i, lyr in enumerate(want["layers"]):
        for name, w in lyr.items():
            np.testing.assert_allclose(params["layers"][i][name].numpy(), w,
                                       atol=PARAM_ATOL,
                                       err_msg=f"layers.{i}.{name}")


def test_chip_smoke_holds_the_wide_rows():
    """chip_smoke.py holds K2, K3 and K4 to their plain versions at the
    wide-head LM's layers and past 256 (f32 past 128 in the backward),
    under the same tolerances as every other row, and times K2's
    tensor-core versions at the LM's two wide shapes."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    want = {"lm_wide": (None, 2048, 2048, 2, 256, True, "bfloat16"),
            "lm_wide_train": (4, 2048, 2048, 2, 256, True, "bfloat16"),
            "wide_f32": (2, 512, 512, 2, 256, True, "float32"),
            "wide_320": (2, 512, 512, 2, 320, True, "bfloat16")}
    fwd = {r[0]: r[1:8] for r in smoke.FLASH_ROWS}
    bwd = {r[0]: r[1:8] for r in smoke.BWD_ROWS}
    for name, row in want.items():
        assert fwd[name] == row and bwd[name] == row, name
    assert {"lm_wide", "lm_wide_train"} <= set(smoke.K2_PATH_ROWS)
    assert smoke.FLASH_TOL["bfloat16"] == (3e-2, 1e-2)
    assert smoke.BWD_TOL["bfloat16"] == 2e-2 and smoke.LSE_ATOL == 1e-3
