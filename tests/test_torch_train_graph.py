"""The graph-ready training steps on the CPU, against the JAX package.

On the card every ``tensor_trainer`` step replays one CUDA graph per batch
signature (``_cuda.GraphedStep``): Adam's step count is a device tensor
incremented inside the step, each batch is copied into static buffers, and
one callable serves every call.  Here the same forms run eagerly on the
CPU (the card's tests are in ``tests/test_torch_cuda.py``):

- N >= 3 steps of the StreamFormer LM step, the ViT step (2 layers, narrow)
  and the MLP trainer, fed host batches through their static buffers,
  against the JAX package's N jitted steps.  Tolerances as in the parity
  tests of ``test_torch_train_step.py`` and ``test_torch_trainer.py``:
  losses within 1e-5 rel; parameters within 2e-4 abs (a fifth of lr: Adam
  turns rounding noise on a near-zero gradient into an update of up to
  lr), but ViT's key bias, whose true gradient is 0, within N·lr; Adam's
  first moments within the gradients' 2e-5 abs + 1e-4 rel;
- a step callable called again and again on the same static tensors
  advances Adam's bias correction each call (a step count baked in as a
  host int would correct every replay as step 1).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nnstreamer_tpu.elements.trainer import JaxTrainer as JaxJaxTrainer
from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu.parallel import make_mesh as jax_make_mesh
from nnstreamer_tpu.parallel import train_step as jax_ts
from nnstreamer_tpu.parallel.vision_train import \
    make_vision_train_step as jax_vision_step
from nnstreamer_tpu_torch._cuda import GraphedStep
from nnstreamer_tpu_torch.elements.trainer import JaxTrainer
from nnstreamer_tpu_torch.models.registry import get_model
from nnstreamer_tpu_torch.models.vit import load_flax, params_from_flax
from nnstreamer_tpu_torch.obs.span import PROCESS_SPANS
from nnstreamer_tpu_torch.parallel import make_mesh
from nnstreamer_tpu_torch.parallel import train_step as pt_ts
from nnstreamer_tpu_torch.parallel.train_step import adam_update
from nnstreamer_tpu_torch.parallel.vision_train import make_vision_train_step

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-4
GRAD_ATOL, GRAD_RTOL = 2e-5, 1e-4
STEPS = 4
LR = 1e-3

CPU = torch.device("cpu")
VIT = {"input_size": "16", "patch": "8", "dim": "16", "depth": "2",
       "heads": "2", "num_classes": "4", "dtype": "float32",
       "attn": "flash"}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(lambda x: np.array(x, dtype=np.float32), tree)


def _flat(tree):
    out = {n: tree[n] for n in ("embed", "pos", "head", "ln_f")}
    for i, lyr in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in lyr.items()})
    return out


def _assert_one_buffer_set(graphed, buffers):
    """One signature, one set of static buffers, the same tensors as after
    the first call; nothing captured on the CPU."""
    assert len(graphed.statics) == 1
    (statics,) = graphed.statics.values()
    assert [s.data_ptr() for s in statics] == buffers
    assert all(s.device == CPU for s in statics)
    assert graphed.graphs == {}


def test_lm_step_form_matches_jax():
    base = dict(vocab=32, dim=16, heads=2, head_dim=8, mlp=32, layers=2,
                experts=2, max_seq=32, lr=LR)
    jcfg = jax_ts.StreamFormerConfig(dtype=jnp.float32, **base)
    pcfg = pt_ts.StreamFormerConfig(dtype=torch.float32, **base)
    jstep, jparams, jopt, _ = jax_ts.make_train_step(
        jax_make_mesh(n_devices=1), jcfg, seed=2)
    step, params, opt, _ = pt_ts.make_train_step(
        make_mesh(devices=[CPU]), pcfg, params=_np(jparams))
    assert opt["step"].shape == () and opt["step"].dtype == torch.int32
    rng = np.random.default_rng(4)
    buffers = None
    for i in range(STEPS):
        toks = rng.integers(0, 32, (2, 16)).astype(np.int32)
        labs = np.roll(toks, -1, axis=1)
        jparams, jopt, jloss = jstep(jparams, jopt, toks, labs)
        got_params, got_opt, loss = step(params, opt, toks, labs)
        assert got_params is params and got_opt is opt
        assert math.isclose(float(loss), float(jloss), rel_tol=LOSS_RTOL)
        assert int(opt["step"]) == int(jopt["step"]) == i + 1
        if buffers is None:
            buffers = [s.data_ptr()
                       for s in next(iter(step.graphed.statics.values()))]
    _assert_one_buffer_set(step.graphed, buffers)
    for got, want, atol, rtol in (
            (params, jparams, PARAM_ATOL, 0.0),
            (opt["m"], jopt["m"], GRAD_ATOL, GRAD_RTOL)):
        want = _flat(_np(want))
        for name, w in want.items():
            np.testing.assert_allclose(_flat(got)[name].numpy(), w,
                                       atol=atol, rtol=rtol, err_msg=name)


def test_vit_step_form_matches_jax(jax_cpu_devices):
    jmodel = jax_get_model("vit", VIT)
    jstep, jparams, jopt, _ = jax_vision_step(
        jax_make_mesh(n_devices=1, axis_sizes={"dp": 1}), jmodel, lr=LR)
    model = get_model("vit", VIT, device="cpu", trainable=True)
    load_flax(model.module, jax.tree.map(np.asarray, jmodel.params))
    step, module, opt, _ = make_vision_train_step(
        make_mesh(devices=[CPU]), model, lr=LR)
    rng = np.random.default_rng(0)
    buffers = None
    for _ in range(STEPS):
        labs = rng.integers(0, 4, 8).astype(np.int32)
        frames = np.clip(labs[:, None, None, None] * 64 + 32
                         + rng.integers(-16, 16, (8, 16, 16, 3)), 0,
                         255).astype(np.uint8)
        jparams, jopt, jloss = jstep(jparams, jopt, frames, labs)
        _, _, loss = step(module, opt, frames, labs)
        assert math.isclose(float(loss), float(jloss), rel_tol=LOSS_RTOL)
        if buffers is None:
            buffers = [s.data_ptr()
                       for s in next(iter(step.graphed.statics.values()))]
    _assert_one_buffer_set(step.graphed, buffers)
    assert all(int(s["step"]) == STEPS for s in opt.state.values())
    got = module.state_dict()
    want = params_from_flax(jax.tree.map(np.asarray, jparams), module)
    dim = int(VIT["dim"])
    for key, w in want.items():
        if key.endswith("attn.qkv.bias"):
            # the key bias's true gradient is 0: Adam turns rounding noise
            # on it into steps of up to lr each
            k_bias = slice(dim, 2 * dim)
            torch.testing.assert_close(got[key][k_bias], w[k_bias],
                                       atol=STEPS * LR, rtol=0.0, msg=key)
            got[key][k_bias] = w[k_bias]
        torch.testing.assert_close(got[key], w, atol=PARAM_ATOL, rtol=0.0,
                                   msg=key)


def _mlp_samples(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        y = np.zeros(4, np.float32)
        y[i % 4] = 1
        out.append(([rng.standard_normal(8).astype(np.float32)], [y]))
    return out


def _mlp_pair(props):
    """The JAX package's MLP trainer and the port's (on the CPU), from the
    JAX trainer's initial weights."""
    want = JaxJaxTrainer()
    want.create(props)
    want._build(8, 4)
    got = JaxTrainer()
    got.create({**props, "device": "cpu"})
    got.load_params(jax.tree.map(np.asarray, want._state[0]))
    return want, got


def test_mlp_trainer_step_form_matches_jax():
    """Two epochs of three batches: six steps through one static buffer
    set, each recording its ``trainer.step`` span under the profiler;
    losses, parameters and first moments against the JAX trainer."""
    want, got = _mlp_pair({"batch-size": 4, "num-epochs": 2, "lr": LR})
    for t in (want, got):
        for s in _mlp_samples(12):
            t.push_data(*s)
    want.finish()
    _, cursor = PROCESS_SPANS.snapshot_since(0)
    with profile(activities=[ProfilerActivity.CPU]):
        got.finish()
    assert len(got.losses) == len(want.losses) == 6
    assert [s.seq for s in PROCESS_SPANS.snapshot_since(cursor)[0]
            if s.name == "trainer.step"] == list(range(6))
    np.testing.assert_allclose(got.losses, want.losses, rtol=LOSS_RTOL)
    (jparams, jopt), (params, opt) = want._state, got._state
    assert int(opt["t"]) == int(jopt["t"]) == 6
    assert len(got.graphed.statics) == 1
    for k in jparams:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   atol=PARAM_ATOL, err_msg=k)
        np.testing.assert_allclose(opt["m"][k].numpy(),
                                   np.asarray(jopt["m"][k]), atol=GRAD_ATOL,
                                   rtol=GRAD_RTOL, err_msg=k)


def test_step_on_the_same_static_tensors_advances_bias_correction():
    """A constant gradient g: Adam's step t moves each parameter by
    ``lr·sqrt(1−β₂ᵗ)·g / (sqrt(1−β₂ᵗ)·|g| + eps)`` (≈ lr·sign(g)).  The
    callable, called on its own static buffer again and again, must take
    step t's correction on call t; step 1's, baked in, would move it by
    ~1.34·lr on call 2."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    p, m, v = (torch.zeros(3) for _ in range(3))
    t = torch.zeros((), dtype=torch.int32)

    def body(g):
        t.add_(1)
        adam_update([p], [m], [v], [g], t, LR)
        return p.clone()

    step = GraphedStep(body, CPU)
    g = np.array([1.0, -2.0, 0.5], np.float32)
    before = step(g)
    (static,) = next(iter(step.statics.values()))
    for n in range(2, 7):
        after = step(static)
        assert int(t) == n
        corr = math.sqrt(1 - b2 ** n)
        want = -LR * corr * g / (corr * np.abs(g) + eps)
        np.testing.assert_allclose((after - before).numpy(), want,
                                   rtol=1e-4, atol=0)
        before = after


def test_mlp_step_called_on_its_static_batch_matches_jax():
    """The MLP trainer's step callable, called three times on the same
    static batch, against three of the JAX trainer's jitted steps on that
    batch: each call takes its own bias correction."""
    want, got = _mlp_pair({"batch-size": 4, "lr": LR})
    x, y = JaxTrainer._stack(_mlp_samples(4))
    got._build(8, 4)
    jparams, jopt = want._state
    loss = got.graphed(x, y)
    statics = next(iter(got.graphed.statics.values()))
    for i in range(3):
        jparams, jopt, jloss = want._step_fn(jparams, jopt, x, y)
        if i:
            loss = got.graphed(*statics)
        assert math.isclose(float(loss), float(jloss), rel_tol=LOSS_RTOL)
    params, opt = got._state
    assert int(opt["t"]) == 3
    for k in jparams:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(jparams[k]),
                                   atol=PARAM_ATOL, err_msg=k)


def test_graphed_step_keeps_one_buffer_set_per_signature():
    """Two batch signatures in turns: two sets of static buffers, each
    reused by its signature's calls, each call computing on its own
    batch."""
    step = GraphedStep(lambda x: x.sum(), CPU)
    rng = np.random.default_rng(0)
    ptrs = {}
    for _ in range(3):
        for shape in ((4, 3), (2, 3)):
            x = rng.standard_normal(shape).astype(np.float32)
            assert torch.equal(step(x), torch.from_numpy(x).sum())
            key = ((shape, torch.float32),)
            ptrs.setdefault(key, step.statics[key][0].data_ptr())
            assert step.statics[key][0].data_ptr() == ptrs[key]
    assert len(step.statics) == 2 and step.graphs == {}


def test_graphed_step_refuses_inference_mode():
    step = GraphedStep(lambda x: x, CPU)
    with torch.inference_mode():
        with pytest.raises(RuntimeError, match="autograd"):
            step(np.zeros(2, np.float32))


def test_steps_are_bound_to_their_state():
    """A step updates the state it was built with in place; handed other
    trees, it raises instead of training them."""
    cfg = pt_ts.StreamFormerConfig(vocab=32, dim=16, heads=2, head_dim=8,
                                   mlp=32, layers=1, experts=1, max_seq=16,
                                   dtype=torch.float32)
    mesh = make_mesh(devices=[CPU])
    step, params, opt, _ = pt_ts.make_train_step(mesh, cfg)
    _, other, other_opt, _ = pt_ts.make_train_step(mesh, cfg)
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(ValueError, match="in place"):
        step(other, opt, toks, toks)
    with pytest.raises(ValueError, match="in place"):
        step(params, other_opt, toks, toks)
    vstep, module, vopt, _ = make_vision_train_step(
        mesh, get_model("vit", VIT, device="cpu", trainable=True))
    other_model = get_model("vit", VIT, device="cpu", trainable=True)
    frames = np.zeros((2, 16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="in place"):
        vstep(other_model.module, vopt, frames, np.zeros(2, np.int32))
    assert int(opt["step"]) == 0 and not vopt.state


def _lm_samples(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 32, (2, 16)).astype(np.int32)
        out.append(([toks], [np.roll(toks, -1, axis=1)]))
    return out


def _vit_samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return [([rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8)],
             [rng.integers(0, 4, 4).astype(np.int32)]) for _ in range(n)]


#: framework -> (custom props, samples, names every state must hold)
TRAINERS = {
    "jax": ({"batch-size": 4}, _mlp_samples(8), ("t", "params.w1", "m.b2",
                                                 "v.w2")),
    "mesh": ({"vocab": "32", "dim": "16", "heads": "2", "head_dim": "8",
              "mlp": "32", "layers": "1", "experts": "1", "max_seq": "16"},
             _lm_samples(2), ("step", "params.embed", "m.layers.0.wqkv",
                              "v.head")),
    "mesh-vision": ({k: v for k, v in VIT.items() if k != "dtype"},
                    _vit_samples(2), ("params.head.weight",
                                      "exp_avg.head.weight",
                                      "exp_avg_sq.cls", "step.cls")),
}


@pytest.mark.parametrize("framework", list(TRAINERS))
def test_trainer_state_tensors_name_every_tensor(framework):
    """Each framework's ``state_tensors`` names every parameter and
    optimizer tensor, the live ones (the next step updates them), with
    the step count on the trainer's device."""
    from nnstreamer_tpu_torch.elements.trainer import find_trainer

    props, samples, names = TRAINERS[framework]
    trainer = find_trainer(framework)()
    trainer.create({**props, "device": "cpu", "num-epochs": 2,
                    "lr": LR})
    for s in samples:
        trainer.push_data(*s)
    trainer.finish()
    state = trainer.state_tensors()
    assert set(names) <= set(state)
    count = [v for k, v in state.items() if k in ("t", "step")
             or k.startswith("step.")]
    assert count and all(int(c) == len(trainer.losses) == 4
                         for c in count)
    before = {k: v.clone() for k, v in state.items()}
    trainer._run_step(*trainer._batches()[0])
    assert all(not torch.equal(state[k], before[k]) for k in names)
