"""StreamFormer training (parallel/train_step.py, ring_attention.py,
mesh.py): the port against the JAX package on the CPU.

The JAX step runs shard_mapped over a one-device mesh; the port's step
runs on one CPU device.  The JAX package's parameters are carried over
(``make_train_step(..., params=)``), tokens come from a numpy seed.

Tolerances (f32): loss within 1e-5 rel and gradients within 2e-5 abs +
1e-4 rel — the two frameworks sum in different orders, nothing else
differs.  Parameters after three Adam steps within 2e-4 abs: Adam's
``m/sqrt(v)`` divides a gradient by its own size, so on gradients near
zero an f32 rounding difference of the gradient moves the update by up to
``lr``; 2e-4 is a fifth of ``lr`` (1e-3).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from nnstreamer_tpu.parallel import mesh as jax_mesh
from nnstreamer_tpu.parallel import train_step as jax_ts
from nnstreamer_tpu.parallel.compat import shard_map
from nnstreamer_tpu.parallel.ring_attention import \
    ring_attention as jax_ring_attention
from nnstreamer_tpu_torch.parallel import mesh as pt_mesh
from nnstreamer_tpu_torch.parallel import train_step as pt_ts
from nnstreamer_tpu_torch.parallel.ring_attention import ring_attention

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
PARAM_ATOL = 2e-4

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    base = dict(vocab=32, dim=16, heads=2, head_dim=8, mlp=32, layers=2,
                experts=2, max_seq=32, lr=1e-3)
    base.update(kw)
    return (jax_ts.StreamFormerConfig(dtype=jnp.float32, **base),
            pt_ts.StreamFormerConfig(dtype=torch.float32, **base))


def _data(cfg, b=2, t=16, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1).astype(np.int32)


def _jax_mesh():
    return jax_mesh.make_mesh(n_devices=1)


def _pt_mesh():
    return pt_mesh.make_mesh(devices=[CPU])


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _jax_value_and_grad(mesh, cfg, params, toks, labs):
    specs = jax_ts._param_specs(cfg)
    f = shard_map(
        lambda p, t, l: jax.value_and_grad(
            lambda pp: jax_ts._loss_local(pp, t, l, cfg))(p),
        mesh=mesh, in_specs=(specs, P("dp", "sp"), P("dp", "sp")),
        out_specs=(P(), specs), check_vma=False)
    loss, grads = jax.jit(f)(params, toks, labs)
    return float(loss), _np_tree(grads)


def _flat(tree):
    """{path: array} with the port's leaf paths."""
    out = {n: tree[n] for n in ("embed", "pos", "head", "ln_f")}
    for i, lyr in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in lyr.items()})
    return out


def _assert_tree_close(got, want, atol, rtol=0.0):
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(np.asarray(got[name]), want[name],
                                   atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("capacity_factor,experts", [(1.25, 2), (0.5, 4)],
                         ids=["no-drop", "drops"])
def test_loss_and_grads_match_jax(capacity_factor, experts):
    """One step's loss (NLL + aux) and every gradient, with and without
    tokens over an expert's capacity."""
    jcfg, pcfg = _cfgs(capacity_factor=capacity_factor, experts=experts)
    params = _np_tree(jax_ts.init_params(jcfg, seed=3))
    toks, labs = _data(jcfg, seed=1)
    want_loss, want = _jax_value_and_grad(_jax_mesh(), jcfg, params, toks,
                                          labs)
    step, pparams, _, _ = pt_ts.make_train_step(_pt_mesh(), pcfg,
                                                params=params)
    loss, grads = pt_ts.value_and_grad(pparams, torch.from_numpy(toks),
                                       torch.from_numpy(labs), pcfg)
    assert math.isclose(float(loss), want_loss, rel_tol=LOSS_RTOL)
    got = {n: g.numpy() for n, g in grads.items()}
    for name, w in _flat(want).items():
        np.testing.assert_allclose(got[name], w, atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=name)


def test_moe_drops_and_aux_match_jax():
    """The switch MoE alone: a capacity that drops tokens, its output and
    the aux loss against the JAX package's one-hot dispatch."""
    jcfg, pcfg = _cfgs(capacity_factor=0.5, experts=4)
    params = _np_tree(jax_ts.init_params(jcfg, seed=5))
    lyr = params["layers"][0]
    y = np.random.default_rng(6).standard_normal((2, 16, 16)).astype(
        np.float32)
    mesh = _jax_mesh()
    f = shard_map(lambda yy, l: jax_ts._moe_switch(yy, l, jcfg), mesh=mesh,
                  in_specs=(P(), jax_ts._param_specs(jcfg)["layers"][0]),
                  out_specs=(P(), P()), check_vma=False)
    want_out, want_aux = jax.jit(f)(y, lyr)
    got_out, got_aux = pt_ts._moe_switch(
        torch.from_numpy(y), {k: torch.from_numpy(v) for k, v in lyr.items()},
        pcfg)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out),
                               atol=1e-6, rtol=1e-5)
    assert math.isclose(float(got_aux), float(want_aux), rel_tol=1e-6)
    # cap = ceil(32 / 4 * 0.5) = 4 slots an expert: some tokens dropped
    dropped = np.all(np.asarray(want_out).reshape(32, 16) == 0, axis=1)
    assert dropped.any()
    np.testing.assert_array_equal(
        np.all(got_out.numpy().reshape(32, 16) == 0, axis=1), dropped)


def test_adam_steps_match_jax():
    """Three steps of the JAX package's Adam (eps on the uncorrected
    sqrt(v)): losses and parameters."""
    jcfg, pcfg = _cfgs()
    jstep, jparams, jopt, _ = jax_ts.make_train_step(_jax_mesh(), jcfg,
                                                     seed=2)
    start = _np_tree(jparams)
    step, params, opt, specs = pt_ts.make_train_step(_pt_mesh(), pcfg,
                                                     params=start)
    assert set(specs) == set(jax_ts._param_specs(jcfg))
    toks, labs = _data(jcfg, seed=4)
    for _ in range(3):
        jparams, jopt, jloss = jstep(jparams, jopt, toks, labs)
        params, opt, loss = step(params, opt, toks, labs)
        assert math.isclose(float(loss), float(jloss), rel_tol=LOSS_RTOL)
    assert int(opt["step"]) == int(jopt["step"]) == 3
    _assert_tree_close(params, _np_tree(jparams), PARAM_ATOL)


def test_flash_route_equals_plain_route():
    """The step through the flash route (the kernels' plain versions and
    their custom backward on the CPU) equals the plain scan's, which the
    tests above hold to JAX: loss and gradients within f32 rounding."""
    _, pcfg = _cfgs()
    params = pt_ts.init_params(pcfg, seed=0)
    toks, labs = map(torch.from_numpy, _data(pcfg, seed=7))
    _, p, _, _ = pt_ts.make_train_step(_pt_mesh(), pcfg, params=params)
    l_plain, g_plain = pt_ts.value_and_grad(p, toks, labs, pcfg, flash=False)
    l_flash, g_flash = pt_ts.value_and_grad(p, toks, labs, pcfg, flash=True)
    assert math.isclose(float(l_flash), float(l_plain), rel_tol=1e-6)
    for name, g in g_plain.items():
        torch.testing.assert_close(g_flash[name], g, atol=1e-6, rtol=1e-5,
                                   msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("flash", [False, True], ids=["scan", "flash"])
def test_ring_attention_matches_jax(flash, causal):
    """A one-member ring, both routes, forward and gradients (the flash
    route's lse merge sends an lse cotangent into the backward), against
    the JAX package's ring inside shard_map; the batch axis against
    jax.vmap."""
    rng = np.random.default_rng(8)
    q, k, v, g = (rng.standard_normal((2, 24, 2, 8)).astype(np.float32)
                  for _ in range(4))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("sp",))

    def jax_fn(q, k, v):
        body = jax.vmap(lambda a, b, c: jax_ring_attention(
            a, b, c, "sp", causal=causal, flash=flash))
        return shard_map(body, mesh=mesh, in_specs=(P(),) * 3,
                         out_specs=P(), check_vma=False)(q, k, v)

    want, vjp = jax.vjp(jax_fn, *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = ring_attention(*ts, "sp", causal=causal, flash=flash)
    got_grads = torch.autograd.grad(got, ts, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    for a, b in zip(got_grads, want_grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("q_offset,k_offset", [(0, 8), (8, 16), (0, 9)],
                         ids=["next", "far", "one-past"])
def test_future_block_sees_no_key(q_offset, k_offset):
    """A ring step whose key block lies wholly after its query block: the
    flash forward (K2's plain version here) gives out 0 and lse -inf, not
    NaN, and its backward, fed the merge's zero cotangents, gives zero
    gradients — so every member can run every step of the ring."""
    from nnstreamer_tpu_torch.ops.flash_attention import flash_attention

    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((8, 2, 8))
                                .astype(np.float32)).requires_grad_()
               for _ in range(3))
    out, lse = flash_attention(q, k, v, causal=True, q_offset=q_offset,
                               k_offset=k_offset, return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert torch.isneginf(lse).all()
    m = torch.zeros_like(lse)
    w = torch.where(torch.isfinite(lse), torch.exp(lse - m),
                    torch.zeros_like(lse))
    merged = out * w.transpose(-1, -2)[..., None]
    grads = torch.autograd.grad(merged.sum() + w.sum(), (q, k, v))
    for g in grads:
        assert torch.equal(g, torch.zeros_like(g))


# ---------------------------------------------------------------------------
# the mesh: pure bookkeeping, the JAX package's factorization and errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,axes", [(8, 3), (6, 2), (1, 4), (12, 3), (7, 2),
                                    (16, 4)])
def test_factorize_matches_jax(n, axes):
    assert pt_mesh.factorize(n, axes) == jax_mesh.factorize(n, axes)


@pytest.mark.parametrize("n,sizes", [
    (8, None), (4, None), (1, None),
    (8, {"dp": 2, "sp": 2, "tp": 2, "ep": 1}),
    (8, {"dp": 8}), (4, {"tp": 2, "ep": 2}), (1, {"dp": 1})])
def test_make_mesh_matches_jax(jax_cpu_devices, n, sizes):
    want = jax_mesh.make_mesh(n, axis_sizes=sizes)
    got = pt_mesh.make_mesh(n, axis_sizes=sizes, devices=[CPU] * 8)
    assert pt_mesh.mesh_info(got) == jax_mesh.mesh_info(want)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape


@pytest.mark.parametrize("n,sizes", [(8, {"dp": 3}), (4, {"dp": 2}),
                                     (2, {"dp": 2, "sp": 2})])
def test_make_mesh_errors_match_jax(jax_cpu_devices, n, sizes):
    with pytest.raises(ValueError) as want:
        jax_mesh.make_mesh(n, axis_sizes=sizes)
    with pytest.raises(ValueError) as got:
        pt_mesh.make_mesh(n, axis_sizes=sizes, devices=[CPU] * 8)
    assert str(got.value) == str(want.value)


def test_make_mesh_defaults_to_the_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    mesh = pt_mesh.make_mesh()
    assert mesh.devices.flat[0] == torch.device("cuda", 0)
    assert pt_mesh.mesh_info(mesh) == {"dp": 1, "sp": 1, "tp": 1, "ep": 1}


def test_multi_card_mesh_refuses_to_train():
    """A mesh wider than one card is refused by the train step: it never
    trains on one card while claiming several."""
    mesh = pt_mesh.make_mesh(axis_sizes={"dp": 2}, devices=[CPU] * 2)
    _, pcfg = _cfgs()
    with pytest.raises(NotImplementedError, match="multi-card"):
        pt_ts.make_train_step(mesh, pcfg)
    with pytest.raises(NotImplementedError, match="multi-card"):
        pt_ts.make_data_sharding(mesh)
    assert pt_ts.make_data_sharding(_pt_mesh()) == CPU


def test_experts_must_divide_ep():
    _, pcfg = _cfgs(experts=3)
    mesh = pt_mesh.make_mesh(axis_sizes={"ep": 2}, devices=[CPU] * 2)
    with pytest.raises(ValueError, match="experts must divide"):
        pt_ts.make_train_step(mesh, pcfg)
