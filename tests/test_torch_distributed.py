"""Multi-rank training over ``torch.distributed`` (gloo, on the CPU): the
port against the JAX package on its 8 virtual CPU devices.

Two worlds, of 2 and 4 ranks, are spawned once for the module
(``multihost.LocalWorld``); every case's port side is submitted to them
up front (``tests/torch_dist_tasks.py``), so the ranks work while this
process runs the JAX package's side of each case under ``jax.jit``.

- each collective (psum, all_to_all both ways, ppermute as a ring and as
  one hop): forward and input gradient, the gradient the JAX package's
  ``shard_map(..., check_vma=False)`` transpose gives;
- ring (plain and flash-plain, causal and full) and Ulysses attention
  over ``sp``: output and q/k/v gradients;
- the StreamFormer step at dp2, sp2, tp2, ep2 and dp2×sp2, and the pp2
  GPipe step: losses of three Adam steps and every parameter after them;
- ``mesh-vision`` dp2 (a tiny ViT against the JAX step; MobileNetV2's
  training form against the port's one-rank step on the same global
  batch), the ``tensor_trainer`` element at dp=2 against dp=1 (only rank
  0 writes the checkpoint), and the multihost seam.

Tolerances (f32): outputs and gradients within 1e-5 abs + 1e-4 rel (sums
in another order); losses within 1e-5 rel; parameters after the Adam
steps within 2e-4 abs — Adam's ``m/sqrt(v)`` turns an f32 rounding
difference of a gradient near 0 into an update of up to ``lr`` (1e-3) —
and the ViT key bias, whose true gradient is 0, within 3·lr (as in
``tests/test_torch_trainer.py``).
"""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu.parallel import make_mesh as jax_make_mesh
from nnstreamer_tpu.parallel import pipeline_parallel as jax_pp
from nnstreamer_tpu.parallel import train_step as jax_ts
from nnstreamer_tpu.parallel.compat import shard_map
from nnstreamer_tpu.parallel.ring_attention import \
    ring_attention as jax_ring
from nnstreamer_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from nnstreamer_tpu.parallel.vision_train import \
    make_vision_train_step as jax_vision_step
from nnstreamer_tpu_torch.models.registry import get_model, restore_params
from nnstreamer_tpu_torch.models.vit import params_from_flax
from nnstreamer_tpu_torch.parallel import make_mesh, multihost
from nnstreamer_tpu_torch.parallel.vision_train import make_vision_train_step

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_tasks as tasks  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-4
CPU = torch.device("cpu")
VIT = {"input_size": "16", "patch": "8", "dim": "16", "depth": "2",
       "heads": "2", "num_classes": "4", "dtype": "float32",
       "attn": "naive"}
LM = dict(vocab=32, dim=16, heads=4, head_dim=4, mlp=32, layers=2,
          experts=2, max_seq=32, lr=1e-3)
#: capacity_factor = experts: no expert drops a token on a member's
#: half or on the whole batch (the capacity counts the member's own
#: tokens), so one device and two route alike
NO_DROP = {**LM, "capacity_factor": 2.0}
VIT_CAPS = ("other/tensors,format=static,num_tensors=2,"
            "dimensions=3:16:16:8.8,types=uint8.int32,framerate=0/1")

COLLECTIVES = ("psum", "psum_sq", "a2a", "a2a_swap", "ring", "one")
ATTENTION = [  # (world, kind, causal, flash)
    (2, "ring", True, False), (2, "ring", True, True),
    (2, "ring", False, True), (4, "ring", True, True),
    (2, "ulysses", True, False), (2, "ulysses", False, True),
    (4, "ulysses", True, True)]
LM_MESHES = [{"dp": 2}, {"sp": 2}, {"tp": 2}, {"ep": 2},
             {"dp": 2, "sp": 2}]


def _jcfg(**kw):
    return jax_ts.StreamFormerConfig(dtype=jnp.float32, **{**LM, **kw})


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _flat(tree):
    out = {n: tree[n] for n in ("embed", "pos", "head", "ln_f")}
    for i, lyr in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in lyr.items()})
    return out


def _lm_batches(b=4, t=16, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        toks = rng.integers(0, LM["vocab"], (b, t)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1).astype(np.int32)))
    return out


def _band_batches(steps=2, b=8, size=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        labs = rng.integers(0, 4, b).astype(np.int32)
        frames = (np.repeat((labs * 64 + 32)[:, None], size * size * 3, 1)
                  .reshape(b, size, size, 3)
                  + rng.integers(-16, 16, (b, size, size, 3)))
        out.append((frames.clip(0, 255).astype(np.uint8), labs))
    return out


def _coll_inputs(n):
    rng = np.random.default_rng(n)
    xs = rng.standard_normal((n, 2 * n, 2 * n)).astype(np.float32)
    shapes = {"psum": (2 * n, 2 * n), "psum_sq": (2 * n, 2 * n),
              "a2a": (2, 2 * n * n), "a2a_swap": (2 * n * n, 2),
              "ring": (2 * n, 2 * n), "one": (2 * n, 2 * n)}
    gs = {k: rng.standard_normal((n,) + s).astype(np.float32)
          for k, s in shapes.items()}
    return xs, gs


def _attn_inputs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, 8 * n, 4, 8)).astype(np.float32)
            for _ in range(4)]


@pytest.fixture(scope="module")
def port():
    """Both worlds, with every case's port side submitted: name → call."""
    torch.set_num_threads(2)
    w2 = multihost.LocalWorld(2, timeout_s=240)
    w4 = multihost.LocalWorld(4, timeout_s=240)
    worlds = {2: w2, 4: w4}
    calls = {}
    try:
        for n in (2, 4):
            calls[("coll", n)] = worlds[n].submit(tasks.collectives,
                                                  *_coll_inputs(n))
        for i, (n, kind, causal, flash) in enumerate(ATTENTION):
            q, k, v, g = _attn_inputs(n, i)
            calls[("attn", i)] = worlds[n].submit(
                tasks.attention, kind, q, k, v, g, causal, flash)
        for sizes in LM_MESHES:
            n = int(np.prod(list(sizes.values())))
            init = _np_tree(jax_ts.init_params(_jcfg(), seed=0))
            calls[("lm", str(sizes))] = worlds[n].submit(
                tasks.lm_steps, sizes, LM, init, _lm_batches())
        init = _np_tree(jax_ts.init_params(_jcfg(), seed=0))
        toks, labs = _lm_batches(steps=1)[0]
        calls["grads"] = w2.submit(tasks.lm_grads, {"dp": 2}, NO_DROP,
                                   init, toks, labs)
        init = _np_tree(jax_pp.init_stacked_params(_jcfg(), seed=0))
        calls["pp"] = w2.submit(tasks.lm_steps,
                                {"dp": 1, "sp": 1, "tp": 1, "pp": 2}, LM,
                                init, _lm_batches(), pipeline=True)
        variables = jax.tree.map(np.asarray, jax_get_model("vit", VIT).params)
        calls["vit"] = w2.submit(tasks.vision_steps, "vit", VIT, variables,
                                 _band_batches())
        calls["mobilenet"] = w2.submit(
            tasks.vision_steps, "mobilenet_v2",
            {"input_size": "32", "num_classes": "4", "use_pallas": "1"},
            None, _band_batches(steps=2, size=32))
        yield calls
    finally:
        w2.close()
        w4.close()


@pytest.fixture(scope="module")
def trainer_world(port, tmp_path_factory):
    """The trainer element at dp=2 on the 2-rank world (after the other
    cases: one process group runs one thing at a time)."""
    path = str(tmp_path_factory.mktemp("ckpt") / "vit_dp2.pt")
    w2 = None
    for call in port.values():
        w2 = call._world if call._world.n == 2 else w2
    frames = _band_batches(steps=4)
    custom = ("model:vit,input_size:16,patch:8,dim:16,depth:1,heads:2,"
              "num_classes:4,dtype:float32,lr:0.001,attn:naive,dp:2,"
              "device:cpu")
    return w2.run(tasks.trainer_pipeline, "mesh-vision", custom, VIT_CAPS,
                  frames, path), path, frames, custom


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _jax_collective(name, n, xs, gs):
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("dp",))
    perm_ring = [(i, (i + 1) % n) for i in range(n)]
    fns = {
        "psum": lambda x: jax.lax.psum(x, "dp"),
        "psum_sq": lambda x: jax.lax.psum(x * x, "dp"),
        "a2a": lambda x: jax.lax.all_to_all(x, "dp", 0, 1, tiled=True),
        "a2a_swap": lambda x: jax.lax.all_to_all(x, "dp", 1, 0, tiled=True),
        "ring": lambda x: jax.lax.ppermute(x, "dp", perm_ring),
        "one": lambda x: jax.lax.ppermute(x, "dp", [(0, n - 1)]),
    }

    def body(x, g):
        y, vjp = jax.vjp(fns[name], x[0])
        return y[None], vjp(g[0])[0][None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                          out_specs=(P("dp"), P("dp")), check_vma=False))
    y, dx = f(jnp.asarray(xs), jnp.asarray(gs[name]))
    return np.asarray(y), np.asarray(dx)


@pytest.mark.parametrize("name", COLLECTIVES)
@pytest.mark.parametrize("n", [2, 4])
def test_collective_matches_jax(port, n, name):
    xs, gs = _coll_inputs(n)
    want_y, want_dx = _jax_collective(name, n, xs, gs)
    got = port[("coll", n)].result()
    for r in range(n):
        y, dx = got[r][name]
        np.testing.assert_allclose(y, want_y[r], atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(dx, want_dx[r], atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# sequence parallelism: ring and Ulysses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize(
    "i", range(len(ATTENTION)),
    ids=[f"{k}-{n}-{'causal' if c else 'full'}-{'flash' if f else 'plain'}"
         for n, k, c, f in ATTENTION])
def test_sequence_attention_matches_jax(port, i):
    n, kind, causal, flash = ATTENTION[i]
    q, k, v, g = _attn_inputs(n, i)
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("sp",))
    fn = jax_ring if kind == "ring" else jax_ulysses

    def attn(q, k, v):
        body = jax.vmap(lambda a, b, c: fn(a, b, c, "sp", causal=causal,
                                           flash=flash))
        return shard_map(body, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
                         out_specs=P(None, "sp"), check_vma=False)(q, k, v)

    def both(q, k, v, g):
        out, vjp = jax.vjp(attn, q, k, v)
        return (out,) + vjp(g)

    want = jax.jit(both)(*map(jnp.asarray, (q, k, v, g)))
    got = port[("attn", i)].result()
    for j, w in enumerate(want):
        whole = np.concatenate([r[j] for r in got], axis=1)
        np.testing.assert_allclose(whole, np.asarray(w), atol=ATOL,
                                   rtol=RTOL, err_msg=f"output {j}")


def test_ulysses_uneven_heads_raise_as_jax():
    from nnstreamer_tpu_torch.parallel.mesh import Mesh as PortMesh
    from nnstreamer_tpu_torch.parallel import ulysses_attention

    mesh = JaxMesh(np.array(jax.devices()[:4]), ("sp",))
    q = jnp.zeros((8, 6, 4))
    with pytest.raises(ValueError) as want:
        shard_map(lambda a: jax_ulysses(a, a, a, "sp"), mesh=mesh,
                  in_specs=P("sp"), out_specs=P("sp"), check_vma=False)(q)
    grid = np.empty(4, dtype=object)
    grid[:] = [0, 1, 2, 3]
    fake = PortMesh(grid, ("sp",))          # the sizes are all it reads
    t = torch.zeros(2, 6, 4)
    with pytest.raises(ValueError) as got:
        ulysses_attention(t, t, t, "sp", mesh=fake)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the StreamFormer step over dp/sp/tp/ep, and pp
# ---------------------------------------------------------------------------

def _assert_params(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], np.asarray(w),
                                   atol=PARAM_ATOL, rtol=0.0, err_msg=name)


@pytest.mark.parametrize("sizes", LM_MESHES,
                         ids=["dp2", "sp2", "tp2", "ep2", "dp2xsp2"])
def test_lm_step_matches_jax(port, sizes):
    n = int(np.prod(list(sizes.values())))
    mesh = jax_make_mesh(n, axis_sizes=sizes)
    step, params, opt, _ = jax_ts.make_train_step(mesh, _jcfg(), seed=0)
    want_losses = []
    for toks, labs in _lm_batches():
        params, opt, loss = step(params, opt, toks, labs)
        want_losses.append(float(loss))
    losses, got, shape = port[("lm", str(sizes))].result()[0]
    assert shape == {**{"dp": 1, "sp": 1, "tp": 1, "ep": 1}, **sizes}
    for a, b in zip(losses, want_losses):
        assert math.isclose(a, b, rel_tol=LOSS_RTOL), (losses, want_losses)
    _assert_params(got, _flat(_np_tree(params)))


def _jax_grads(n, sizes, toks, labs):
    cfg = _jcfg(capacity_factor=2.0)
    mesh = jax_make_mesh(n, axis_sizes=sizes)
    specs = jax_ts._param_specs(cfg)

    def body(p, t, l):
        # the step's value_and_grad and its sync (every leaf here is
        # replicated over dp and sp; tp and ep have size 1)
        loss, g = jax.value_and_grad(
            lambda pp: jax_ts._loss_local(pp, t, l, cfg))(p)
        return loss, jax.tree.map(lambda x: jax.lax.psum(x, ("dp", "sp")),
                                  g)

    f = shard_map(body, mesh=mesh,
                  in_specs=(specs, P("dp", "sp"), P("dp", "sp")),
                  out_specs=(P(), specs), check_vma=False)
    loss, grads = jax.jit(f)(jax_ts.init_params(cfg, seed=0), toks, labs)
    return float(loss), _flat(_np_tree(grads))


def test_sharded_gradient_scale_is_the_jax_packages(port):
    """A reference fault the port follows: under ``shard_map(...,
    check_vma=False)`` the loss psum over (dp, sp) transposes to a psum,
    so the JAX package's dp=2 gradient is twice its one-device gradient
    (Adam's update does not see the scale).  The port's dp=2 gradient is
    the JAX package's dp=2 gradient, and twice the port's one-device
    gradient.  No expert drops a token here (``NO_DROP``), so the scale
    is the only difference."""
    from nnstreamer_tpu_torch.parallel import train_step as ts

    toks, labs = _lm_batches(steps=1)[0]
    loss1, one = _jax_grads(1, {"dp": 1}, toks, labs)
    loss2, two = _jax_grads(2, {"dp": 2}, toks, labs)
    assert math.isclose(loss1, loss2, rel_tol=LOSS_RTOL)
    for name in one:
        np.testing.assert_allclose(two[name], 2 * one[name], atol=ATOL,
                                   rtol=RTOL, err_msg=name)
    got_loss, got = port["grads"].result()[0]
    assert math.isclose(got_loss, loss2, rel_tol=LOSS_RTOL)
    cfg = ts.StreamFormerConfig(dtype=torch.float32, **NO_DROP)
    _, params, _, _ = ts.make_train_step(
        make_mesh(devices=[CPU]), cfg,
        params=_np_tree(jax_ts.init_params(_jcfg(), seed=0)))
    _, local = ts.value_and_grad(params, torch.from_numpy(toks),
                                 torch.from_numpy(labs), cfg)
    for name, w in two.items():
        np.testing.assert_allclose(got[name], w, atol=ATOL, rtol=RTOL,
                                   err_msg=name)
        np.testing.assert_allclose(got[name], 2 * local[name].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_pp_step_matches_jax(port):
    mesh = jax_make_mesh(2, axis_sizes={"dp": 1, "sp": 1, "tp": 1, "pp": 2},
                         axes=("dp", "sp", "tp", "pp"))
    step, params, opt, _ = jax_pp.make_pp_train_step(mesh, _jcfg(), seed=0)
    want_losses = []
    for toks, labs in _lm_batches():
        params, opt, loss = step(params, opt, toks, labs)
        want_losses.append(float(loss))
    losses, got, shape = port["pp"].result()[0]
    assert shape == {"dp": 1, "sp": 1, "tp": 1, "pp": 2}
    for a, b in zip(losses, want_losses):
        assert math.isclose(a, b, rel_tol=LOSS_RTOL), (losses, want_losses)
    _assert_params(got, _np_tree(params))


def test_pp_layers_must_divide_stages():
    from nnstreamer_tpu_torch.parallel import pipeline_parallel as pp
    from nnstreamer_tpu_torch.parallel import train_step as ts

    mesh = make_mesh(2, axis_sizes={"pp": 2}, axes=pp.PP_AXES,
                     devices=[CPU] * 2)
    with pytest.raises(ValueError) as want:
        jax_pp.make_pp_train_step(
            jax_make_mesh(2, axis_sizes={"pp": 2}, axes=pp.PP_AXES),
            _jcfg(layers=3))
    with pytest.raises(ValueError) as got:
        pp.make_pp_train_step(mesh, ts.StreamFormerConfig(
            dtype=torch.float32, **{**LM, "layers": 3}))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# mesh-vision over dp, and the trainer element
# ---------------------------------------------------------------------------

def test_vision_dp2_matches_jax(port):
    jmodel = jax_get_model("vit", VIT)
    step, params, opt, _ = jax_vision_step(
        jax_make_mesh(n_devices=2, axis_sizes={"dp": 2}), jmodel, lr=1e-3)
    want_losses = []
    for frames, labs in _band_batches():
        params, opt, loss = step(params, opt, frames, labs)
        want_losses.append(float(loss))
    got = port["vit"].result()
    for losses, state in got:
        for a, b in zip(losses, want_losses):
            assert math.isclose(a, b, rel_tol=LOSS_RTOL)
        template = get_model("vit", VIT, device="cpu", trainable=True)
        want = params_from_flax(jax.tree.map(np.asarray, params),
                                template.module)
        dim = int(VIT["dim"])
        for key, w in want.items():
            g = torch.from_numpy(state[key]).clone()
            if key.endswith("attn.qkv.bias"):
                kb = slice(dim, 2 * dim)   # the key bias: see the docstring
                torch.testing.assert_close(g[kb], w[kb], atol=3e-3,
                                           rtol=0.0, msg=key)
                g[kb] = w[kb]
            torch.testing.assert_close(g, w, atol=PARAM_ATOL, rtol=0.0,
                                       msg=key)


def test_mobilenet_dp2_equals_one_rank_on_the_global_batch(port):
    props = {"input_size": "32", "num_classes": "4", "use_pallas": "1"}
    model = get_model("mobilenet_v2", props, device="cpu", trainable=True)
    step, module, opt, _ = make_vision_train_step(
        make_mesh(devices=[CPU]), model)
    want_losses = []
    for frames, labs in _band_batches(steps=2, size=32):
        _, _, loss = step(module, opt, torch.from_numpy(frames),
                          torch.from_numpy(labs))
        want_losses.append(float(loss))
    want = module.state_dict()
    got = port["mobilenet"].result()
    for losses, state in got:
        for a, b in zip(losses, want_losses):
            assert math.isclose(a, b, rel_tol=LOSS_RTOL)
        for key, w in want.items():
            torch.testing.assert_close(torch.from_numpy(state[key]), w,
                                       atol=PARAM_ATOL, rtol=0.0, msg=key)
    # the two ranks hold the same replicated state, bit for bit
    for key in want:
        np.testing.assert_array_equal(got[0][1][key], got[1][1][key])


def test_trainer_dp2_equals_dp1(trainer_world):
    from nnstreamer_tpu_torch.elements.trainer import TensorTrainer

    results, path, frames, custom = trainer_world
    (s0, l0, w0, st0, n0), (s1, l1, w1, st1, n1) = results
    assert s0["mesh"]["dp"] == 2 and s0["samples"] == 4
    assert (w0, w1) == (1, 0)             # only rank 0 writes
    assert n0 == n1 == 4                  # every frame passes through
    assert l0 == l1
    # the one-rank trainer on the same stream
    el = TensorTrainer("tr", framework="mesh-vision", **{
        "custom": custom.replace("dp:2", "dp:1")})
    _run_local(el, frames)
    for a, b in zip(l0, el.trainer.losses):
        assert math.isclose(a, b, rel_tol=LOSS_RTOL)
    local = el.trainer.state_tensors()
    dim = 16
    for key, w in st0.items():
        g = torch.from_numpy(w).clone()
        want = local[key].detach().cpu().clone()
        if key == "params.blocks.0.attn.qkv.bias":
            kb = slice(dim, 2 * dim)   # the key bias: 4 steps of up to lr
            torch.testing.assert_close(g[kb], want[kb], atol=4e-3,
                                       rtol=0.0, msg=key)
            g[kb] = want[kb]
        torch.testing.assert_close(g, want, atol=PARAM_ATOL, rtol=0.0,
                                   msg=key)
    # the checkpoint holds rank 0's trained module, bit for bit
    template = get_model("vit", {**VIT, "depth": "1"}, device="cpu",
                         trainable=True)
    restore_params(template, path)
    for key, t in template.module.state_dict().items():
        np.testing.assert_array_equal(t.numpy(), st0[f"params.{key}"])


def _run_local(el, frames):
    from nnstreamer_tpu_torch.elements.sink import TensorSink
    from nnstreamer_tpu_torch.pipeline import AppSrc, Pipeline
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    pl = Pipeline()
    src = AppSrc("src", caps=VIT_CAPS)
    sink = TensorSink("out")
    pl.add(src, el, sink)
    pl.link(src, el, sink)
    for i, tensors in enumerate(frames):
        src.push_buffer(TensorBuffer(tensors=list(tensors), pts=i))
    src.end_of_stream()
    pl.run(timeout=300)


# ---------------------------------------------------------------------------
# multihost
# ---------------------------------------------------------------------------

def test_initialize_arg_plumbing_via_backend_seam():
    """The JAX package's seam (``_backend``): the coordinator, world size
    and rank reach ``init_process_group`` as its TCP store, world and rank;
    a second call is a no-op."""
    calls = []
    old = multihost._initialized
    multihost._initialized = False
    try:
        multihost.initialize(coordinator="10.0.0.1:8476", num_processes=4,
                             process_id=2, backend="gloo",
                             _backend=lambda **kw: calls.append(kw))
        assert calls == [{"backend": "gloo",
                          "init_method": "tcp://10.0.0.1:8476",
                          "world_size": 4, "rank": 2}]
        assert multihost.is_initialized()
        multihost.initialize(_backend=lambda **kw: calls.append(kw))
        assert len(calls) == 1
    finally:
        multihost._initialized = old


def test_initialize_defaults_to_the_environment_and_the_device():
    calls = []
    old = multihost._initialized
    multihost._initialized = False
    try:
        multihost.initialize(_backend=lambda **kw: calls.append(kw))
        # torch's env:// (torchrun) stands for the JAX package's
        # auto-detection; no card here, so gloo
        assert calls == [{"backend": "gloo"}]
    finally:
        multihost._initialized = old


def test_process_mesh_coordinates(port):
    w4 = None
    for call in port.values():
        w4 = call._world if call._world.n == 4 else w4
    got = w4.run(tasks.info)
    for r, (info, shape, coords, n) in enumerate(got):
        assert info == {"process_index": r, "process_count": 4,
                        "local_devices": 1, "global_devices": 4}
        # auto-factorized as the JAX package's make_mesh over 4 devices
        assert shape == {"dp": 2, "sp": 2, "tp": 1, "ep": 1}
        assert coords == dict(zip(("dp", "sp", "tp", "ep"),
                                  np.unravel_index(r, (2, 2, 1, 1))))
