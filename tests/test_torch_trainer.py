"""tensor_trainer and the vision train step: the port against the JAX
package on the CPU.

- ``make_vision_train_step`` on a tiny f32 ViT (``attn:flash``: the JAX
  side runs Pallas in interpret mode, the port the kernels' plain versions
  and their custom backward), with the JAX model's variables carried over:
  losses of three Adam steps within 1e-5 rel, parameters within 2e-4 abs
  — but the key bias, whose true gradient is 0, within 3·lr: Adam
  divides each gradient by its own size, so rounding noise on a zero
  gradient becomes an update of up to ``lr`` (1e-3) a step.
- the ``jax`` MLP trainer from the JAX trainer's own initial weights:
  per-step losses within 1e-5 rel.
- ``tensor_trainer`` with each framework as a CPU pipeline: the loss
  falls, as the JAX package's tests require; the validation split
  (``model-save-path``: ``tests/test_torch_checkpoint.py``).
- SSD, DeepLabV3 and PoseNet have no training form, as the JAX step
  cannot train them.
"""

import math

import jax
import numpy as np
import pytest
import torch

from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu.parallel import make_mesh as jax_make_mesh
from nnstreamer_tpu.parallel.vision_train import (
    _param_labels as jax_param_labels,
    make_vision_train_step as jax_vision_step,
    pad_to_multiple as jax_pad)
from nnstreamer_tpu_torch.elements.trainer import (
    JaxTrainer, TensorTrainer, find_trainer, mlp_params_from_jax)
from nnstreamer_tpu_torch.models.registry import get_model
from nnstreamer_tpu_torch.models.vit import load_flax, params_from_flax
from nnstreamer_tpu_torch.parallel import make_mesh
from nnstreamer_tpu_torch.parallel.vision_train import (
    _param_labels, make_vision_train_step, pad_to_multiple)
from nnstreamer_tpu_torch.pipeline import AppSrc, Pipeline
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

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


def _band_batch(rng, b=8, size=16, noise=True):
    """Learnable task: class = brightness band of the frame."""
    labs = rng.integers(0, 4, b).astype(np.int32)
    frames = np.repeat((labs * 64 + 32).astype(np.uint8)[:, None, None,
                                                            None],
                       size * size * 3, axis=1).reshape(b, size, size, 3)
    if noise:
        frames = (frames.astype(np.int32)
                  + rng.integers(-16, 16, frames.shape)).clip(0, 255)
    return frames.astype(np.uint8), labs


# ---------------------------------------------------------------------------
# the vision train step
# ---------------------------------------------------------------------------

def test_vision_train_step_matches_jax(jax_cpu_devices):
    jmodel = jax_get_model("vit", VIT)
    jstep, jparams, jopt, _ = jax_vision_step(
        jax_make_mesh(n_devices=1, axis_sizes={"dp": 1}), jmodel, lr=1e-3)
    start = jax.tree.map(np.asarray, jmodel.params)
    model = get_model("vit", VIT, device="cpu", trainable=True)
    load_flax(model.module, start)
    step, module, opt, device = make_vision_train_step(
        make_mesh(devices=[CPU]), model, lr=1e-3)
    assert device == CPU and module is model.module
    rng = np.random.default_rng(0)
    for _ in range(3):
        frames, labs = _band_batch(rng)
        jparams, jopt, jloss = jstep(jparams, jopt, frames, labs)
        module, opt, loss = step(module, opt, torch.from_numpy(frames),
                                 torch.from_numpy(labs))
        assert math.isclose(float(loss), float(jloss), rel_tol=1e-5)
    got = model.module.state_dict()
    trained = params_from_flax(jax.tree.map(np.asarray, jparams),
                               model.module)
    dim = int(VIT["dim"])
    for key, w in trained.items():
        if key.endswith("attn.qkv.bias"):
            # the key bias shifts every score of a row alike: its true
            # gradient is 0, so Adam turns rounding noise into steps of up
            # to lr each — three steps may move it by 3 * lr
            k_bias = slice(dim, 2 * dim)
            torch.testing.assert_close(got[key][k_bias], w[k_bias],
                                       atol=3e-3, rtol=0.0, msg=key)
            got[key][k_bias] = w[k_bias]
        torch.testing.assert_close(got[key], w, atol=2e-4, rtol=0.0,
                                   msg=key)


def test_vision_train_step_needs_the_training_form():
    model = get_model("vit", {**VIT, "dtype": "bfloat16"}, device="cpu")
    with pytest.raises(ValueError, match="trainable"):
        make_vision_train_step(make_mesh(devices=[CPU]), model)


@pytest.mark.parametrize("name", ["ssd_mobilenet_v2", "deeplab_v3",
                                  "posenet"])
def test_models_without_a_training_form_refuse(jax_cpu_devices, name):
    """SSD, DeepLabV3 and PoseNet: the JAX vision step's loss (log_softmax
    of the first output at one label a frame) does not fit their outputs,
    and the JAX package raises on them (a reference limit); the port
    refuses them with the reason, at build."""
    jmodel = jax_get_model(name, {"input_size": "33", "dtype": "float32"})
    jstep, jparams, jopt, _ = jax_vision_step(
        jax_make_mesh(n_devices=1, axis_sizes={"dp": 1}), jmodel)
    with pytest.raises(ValueError, match="same number of dimensions"):
        jstep(jparams, jopt, np.zeros((2, 33, 33, 3), np.uint8),
              np.zeros((2,), np.int32))
    with pytest.raises(ValueError, match="no training form: the vision "
                                         "train step's loss needs"):
        get_model(name, {"input_size": "33"}, device="cpu", trainable=True)


def test_batched_vit_logits_equal_per_frame():
    """The batched forward (one kernel launch a layer on the card) equals
    the per-frame serving forward, frame by frame."""
    model = get_model("vit", VIT, device="cpu").module
    frames, _ = _band_batch(np.random.default_rng(1), b=3)
    x = torch.from_numpy(frames)
    with torch.no_grad():
        batched = model(x)[0]
        assert batched.shape == (3, 4)
        for i in range(3):
            torch.testing.assert_close(batched[i], model(x[i])[0],
                                       atol=1e-5, rtol=1e-5)


def test_trainable_form_keeps_f32_params_and_serving_logits():
    """The training form holds f32 parameters; in f32 compute its logits
    equal the serving form's."""
    serve = get_model("vit", VIT, device="cpu").module
    train = get_model("vit", VIT, device="cpu", trainable=True).module
    assert all(p.dtype == torch.float32 for p in train.parameters())
    frames, _ = _band_batch(np.random.default_rng(2), b=2)
    with torch.no_grad():
        torch.testing.assert_close(train(torch.from_numpy(frames))[0],
                                   serve(torch.from_numpy(frames))[0])


def test_bf16_training_form_computes_in_bf16():
    """bf16 compute over f32 parameters: the products run in bf16 (the
    logits match a bf16 cast of the weights), the gradients land in f32."""
    props = {**VIT, "dtype": "bfloat16", "attn": "naive"}
    train = get_model("vit", props, device="cpu", trainable=True).module
    serve = get_model("vit", props, device="cpu").module
    frames, labs = _band_batch(np.random.default_rng(3), b=2)
    x = torch.from_numpy(frames)
    with torch.no_grad():
        torch.testing.assert_close(train(x)[0], serve(x)[0])
    train(x)[0].sum().backward()
    assert all(p.grad.dtype == torch.float32 for p in train.parameters())


@pytest.mark.parametrize("tree", [
    {"params": {"a": 1, "b": {"c": 2}}, "batch_stats": {"m": 3}},
    {"params": {"x": [1, 2]}}, [1, 2]])
def test_param_labels_match_jax(tree):
    assert _param_labels(tree) == jax_param_labels(tree)


@pytest.mark.parametrize("b,m", [(3, 8), (8, 8), (5, 2), (1, 4), (6, 4)])
def test_pad_to_multiple_matches_jax(b, m):
    x = np.arange(b * 2).reshape(b, 2)
    np.testing.assert_array_equal(pad_to_multiple(x, m), jax_pad(x, m))


# ---------------------------------------------------------------------------
# the jax (MLP) trainer
# ---------------------------------------------------------------------------

def test_mlp_trainer_matches_jax():
    from nnstreamer_tpu.elements.trainer import JaxTrainer as JaxJaxTrainer

    props = {"batch-size": 4, "num-epochs": 2, "lr": 0.01}
    rng = np.random.default_rng(0)
    samples = []
    for i in range(12):
        y = np.zeros(4, np.float32)
        y[i % 4] = 1
        samples.append(([rng.standard_normal(8).astype(np.float32)], [y]))
    want = JaxJaxTrainer()
    want.create(props)
    want._build(8, 4)
    start = jax.tree.map(np.asarray, want._state[0])
    got = JaxTrainer()
    got.create({**props, "device": "cpu"})
    got.load_params(start)
    for t in (want, got):
        for s in samples:
            t.push_data(*s)
        t.finish()
    assert len(got.losses) == len(want.losses) == 6
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    assert math.isclose(got.evaluate(samples[:4]), want.evaluate(samples[:4]),
                        rel_tol=1e-5)


def test_mlp_tree_carries_over():
    tree = {"w1": np.ones((3, 5)), "b1": np.zeros(5), "w2": np.ones((5, 2)),
            "b2": np.zeros(2)}
    got = mlp_params_from_jax(tree, device="cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        "w1": (3, 5), "b1": (5,), "w2": (5, 2), "b2": (2,)}
    assert all(v.dtype == torch.float32 for v in got.values())


# ---------------------------------------------------------------------------
# the element, each framework as a CPU pipeline
# ---------------------------------------------------------------------------

def _run(trainer, caps, frames, timeout=300):
    p = Pipeline()
    src = AppSrc("src", caps=caps)
    sink = TensorSink("out")
    p.add(src, trainer, sink)
    p.link(src, trainer, sink)
    for i, tensors in enumerate(frames):
        src.push_buffer(TensorBuffer(tensors=list(tensors), pts=i))
    src.end_of_stream()
    p.run(timeout=timeout)
    return sink


def _mlp_frames(n):
    rng = np.random.default_rng(0)
    for i in range(n):
        y = np.zeros(4, np.float32)
        y[i % 4] = 1
        yield rng.standard_normal(8).astype(np.float32), y


MLP_CAPS = ("other/tensors,format=static,num_tensors=2,dimensions=8.4,"
            "types=float32.float32,framerate=0/1")


def test_jax_trainer_pipeline_learns():
    trainer = TensorTrainer("tr", **{"num-epochs": 3, "batch-size": 4,
                                     "lr": 0.01, "custom": "device:cpu"})
    sink = _run(trainer, MLP_CAPS, _mlp_frames(16))
    assert trainer.summary["samples"] == 16
    assert len(sink.results) == 16                 # frames pass through
    losses = trainer.trainer.losses
    assert losses[-1] < losses[0]


def test_validation_split():
    trainer = TensorTrainer("tr", **{
        "num-epochs": 2, "batch-size": 4, "lr": 0.01,
        "num-training-samples": 12, "num-validation-samples": 4,
        "custom": "device:cpu"})
    _run(trainer, MLP_CAPS, _mlp_frames(20))       # 12 train, 4 valid, 4 not
    s = trainer.summary
    assert s["samples"] == 12
    assert s["validation_samples"] == 4
    assert np.isfinite(s["validation_loss"])


def test_validation_without_training_split_is_loud():
    el = TensorTrainer("t", **{"num-validation-samples": 4,
                               "custom": "device:cpu"})
    with pytest.raises(ValueError, match="num-training-samples"):
        el.start()


def test_trainers_need_a_card_unless_asked(monkeypatch):
    from nnstreamer_tpu_torch.device import DeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("jax", "mesh", "mesh-vision"):
        with pytest.raises(DeviceError):
            find_trainer(name)().create({})


def test_mesh_trainer_refuses_multi_card():
    with pytest.raises(NotImplementedError, match="multi-card"):
        find_trainer("mesh")().create({"dp": "2", "device": "cpu"})
    with pytest.raises(NotImplementedError, match="multi-card"):
        find_trainer("mesh-vision")().create({"dp": "4", "device": "cpu"})


def test_mesh_trainer_pipeline_learns():
    """The stream trains the StreamFormer: every frame is one step; the
    loss falls on the shift task (as the JAX package's test asks)."""
    seq = 16
    trainer = TensorTrainer("tr", framework="mesh", **{
        "num-epochs": 4,
        "custom": ("dp:1,sp:1,tp:1,ep:1,vocab:32,dim:16,heads:4,"
                   "head_dim:4,mlp:32,layers:1,experts:1,"
                   f"max_seq:{seq},device:cpu")})
    rng = np.random.default_rng(0)
    frames = []
    for _ in range(6):
        toks = rng.integers(0, 32, (4, seq)).astype(np.int32)
        frames.append((toks, np.roll(toks, -1, axis=1).astype(np.int32)))
    _run(trainer, (f"other/tensors,format=static,num_tensors=2,"
                   f"dimensions={seq}:4.{seq}:4,types=int32.int32,"
                   "framerate=0/1"), frames)
    assert trainer.summary["samples"] == 6
    assert trainer.summary["mesh"] == {"dp": 1, "sp": 1, "tp": 1, "ep": 1}
    losses = trainer.trainer.losses
    assert len(losses) == 24 and losses[-1] < losses[0]


@pytest.mark.parametrize("attn", ["flash", "naive"])
def test_mesh_vision_trainer_pipeline_learns(attn):
    """The stream trains a tiny ViT (attention through the flash route or
    plain attention); the loss falls on the brightness-band task."""
    trainer = TensorTrainer("tr", framework="mesh-vision", **{
        "num-epochs": 6,
        "custom": ("model:vit,input_size:16,patch:8,dim:16,depth:1,"
                   f"heads:2,num_classes:4,dtype:float32,lr:0.01,"
                   f"attn:{attn},device:cpu")})
    rng = np.random.default_rng(0)
    frames = [_band_batch(rng, noise=False) for _ in range(4)]
    _run(trainer, ("other/tensors,format=static,num_tensors=2,"
                   "dimensions=3:16:16:8.8,types=uint8.int32,"
                   "framerate=0/1"), frames)
    assert trainer.summary["samples"] == 4
    assert trainer.summary["model"] == "vit"
    assert trainer.summary["mesh"]["dp"] == 1
    losses = trainer.trainer.losses
    assert losses[-1] < losses[0]
