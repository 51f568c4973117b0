"""Checkpoints from trainer to filter: the port's own format
(``models.registry.save_checkpoint``/``restore_params``), the trainers'
``model-save-path``, and ``tensor_filter framework=xla
custom=checkpoint:<path>`` at open and on ``RELOAD_MODEL``.

- a round trip restores every tensor bit for bit (BatchNorm statistics
  and the LM's tree included); a template whose names or shapes differ
  raises, naming the first mismatch; a training form's f32 checkpoint
  loads into its serving form, cast per tensor;
- each trainer framework writes at EOS what it trained (and nothing when
  no sample came); the LM's checkpoint loads into the registry LM;
- the filter serves a checkpoint's weights at open, and a reload
  mid-stream answers the frames after it with the new weights and those
  before it with the old ones, exactly;
- the port's ``mesh-vision`` trainer, started from the JAX package's
  initial variables, trains to the parameters in the JAX package's orbax
  checkpoint of the same stream (read with its ``restore_params``,
  carried with ``params_from_flax``): within 2e-4 abs after 4 Adam steps
  (the tolerance of ``tests/test_torch_trainer.py``), the key bias — whose
  true gradient is 0 — within 4·lr.
"""

import os

import jax
import numpy as np
import pytest
import torch

from nnstreamer_tpu.elements.trainer import TensorTrainer as JaxTrainerEl
from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu.models.registry import restore_params as jax_restore
from nnstreamer_tpu.pipeline import AppSrc as JaxAppSrc
from nnstreamer_tpu.pipeline import Pipeline as JaxPipeline
from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.pipeline.element import CustomEvent
from nnstreamer_tpu_torch.elements.sink import TensorSink
from nnstreamer_tpu_torch.elements.trainer import TensorTrainer
from nnstreamer_tpu_torch.models.registry import (get_model, named_tensors,
                                                  restore_params,
                                                  save_checkpoint)
from nnstreamer_tpu_torch.models.vit import params_from_flax
from nnstreamer_tpu_torch.pipeline import AppSrc, Pipeline
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

MOBILE = {"input_size": "32", "num_classes": "4"}
VIT = {"input_size": "16", "patch": "8", "dim": "16", "depth": "1",
       "heads": "2", "num_classes": "4", "dtype": "float32",
       "attn": "naive"}
LM = {"vocab": "32", "dim": "16", "heads": "4", "head_dim": "4",
      "mlp": "32", "layers": "1", "experts": "1", "max_seq": "16",
      "seq": "16"}
FRAME_CAPS = ("other/tensors,format=static,num_tensors=1,"
              "dimensions=3:32:32,types=uint8,framerate=0/1")


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _perturb(model, seed):
    """Every float tensor (BatchNorm statistics too) moved off its init,
    so a round trip that dropped one shows."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in named_tensors(model).values():
            if t.is_floating_point():
                t.add_(torch.rand(t.shape, generator=gen).to(t.dtype))
    return model


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,props", [
    ("mobilenet_v2", MOBILE), ("vit", VIT), ("streamformer_lm", LM)],
    ids=["mobilenet_v2", "vit", "streamformer_lm"])
def test_round_trip_is_bit_exact(tmp_path, name, props):
    src = _perturb(get_model(name, props, device="cpu"), 1)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(src, path)
    dst = get_model(name, {**props, "seed": "5"}, device="cpu")
    assert restore_params(dst, path) is dst
    want, got = named_tensors(src), named_tensors(dst)
    assert sorted(got) == sorted(want)
    if name == "mobilenet_v2":
        assert "blocks.3.project_bn.running_var" in got
    for key, t in want.items():
        assert torch.equal(got[key], t), key


def test_round_trip_of_a_tree(tmp_path):
    """A parameter tree (the trainers' LM and MLP) restores as a new tree
    of the template's structure."""
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(3, 4, generator=gen),
            "layers": [{"a": torch.randn(2, generator=gen)},
                       {"a": torch.randn(2, generator=gen)}]}
    path = str(tmp_path / "tree.pt")
    save_checkpoint(tree, path)
    template = {"w": torch.zeros(3, 4),
                "layers": [{"a": torch.zeros(2)}, {"a": torch.zeros(2)}]}
    got = restore_params(template, path)
    assert torch.equal(got["w"], tree["w"])
    assert torch.equal(got["layers"][1]["a"], tree["layers"][1]["a"])
    assert torch.equal(template["w"], torch.zeros(3, 4))   # not in place


@pytest.mark.parametrize("other,match", [
    ({"num_classes": "5"}, r"'classifier.bias' has shape \(4,\), "
                           r"the template \(5,\)"),
    ("vit", r"the checkpoint lacks 'blocks.0.attn.proj.bias'"),
], ids=["shape", "names"])
def test_template_mismatch_raises(tmp_path, other, match):
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(get_model("mobilenet_v2", MOBILE, device="cpu"), path)
    if other == "vit":
        template = get_model("vit", VIT, device="cpu")
    else:
        template = get_model("mobilenet_v2", {**MOBILE, **other},
                             device="cpu")
    with pytest.raises(ValueError, match=match):
        restore_params(template, path)


@pytest.mark.parametrize("name,props", [("mobilenet_v2", MOBILE),
                                        ("vit", VIT)])
def test_training_form_loads_into_the_serving_form(tmp_path, name, props):
    train = _perturb(get_model(name, props, device="cpu", trainable=True), 2)
    path = str(tmp_path / "ckpt.pt")
    save_checkpoint(train, path)
    serve = get_model(name, {**props, "dtype": "bfloat16"}, device="cpu")
    dtypes = {k: t.dtype for k, t in named_tensors(serve).items()}
    assert torch.bfloat16 in dtypes.values()
    restore_params(serve, path)
    want = named_tensors(train)
    for key, t in named_tensors(serve).items():
        assert t.dtype == dtypes[key], key
        assert torch.equal(t, want[key].to(t.dtype)), key


# ---------------------------------------------------------------------------
# model-save-path
# ---------------------------------------------------------------------------

def _train(framework, custom, caps, frames, path, **props):
    el = TensorTrainer("tr", framework=framework, **{
        "custom": custom, "model-save-path": path, **props})
    p = Pipeline()
    src = AppSrc("src", caps=caps)
    sink = TensorSink("out")
    p.add(src, el, sink)
    p.link(src, el, sink)
    for i, tensors in enumerate(frames):
        src.push_buffer(TensorBuffer(tensors=list(tensors), pts=i))
    src.end_of_stream()
    p.run(timeout=300)
    return el


def _mlp_frames(n):
    rng = np.random.default_rng(0)
    for i in range(n):
        y = np.zeros(4, np.float32)
        y[i % 4] = 1
        yield rng.standard_normal(8).astype(np.float32), y


def _band(n, b=8, size=16, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        labs = rng.integers(0, 4, b).astype(np.int32)
        frames = (np.repeat((labs * 64 + 32)[:, None], size * size * 3, 1)
                  .reshape(b, size, size, 3)
                  + rng.integers(-16, 16, (b, size, size, 3)))
        out.append((frames.clip(0, 255).astype(np.uint8), labs))
    return out


def _tokens(n, seq=16):
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 32, (4, seq)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1).astype(np.int32)))
    return out


SAVE_CASES = {
    "jax": ("device:cpu,hidden:16",
            "other/tensors,format=static,num_tensors=2,dimensions=8.4,"
            "types=float32.float32,framerate=0/1",
            lambda: list(_mlp_frames(8)), {"batch-size": 4}),
    "mesh": (",".join(f"{k}:{v}" for k, v in LM.items() if k != "seq")
             + ",device:cpu",
             "other/tensors,format=static,num_tensors=2,dimensions=16:4.16:4,"
             "types=int32.int32,framerate=0/1", lambda: _tokens(2), {}),
    "mesh-vision": ("model:vit,input_size:16,patch:8,dim:16,depth:1,"
                    "heads:2,num_classes:4,dtype:float32,attn:naive,"
                    "device:cpu",
                    "other/tensors,format=static,num_tensors=2,"
                    "dimensions=3:16:16:8.8,types=uint8.int32,"
                    "framerate=0/1", lambda: _band(2), {}),
}


@pytest.mark.parametrize("framework", ["jax", "mesh", "mesh-vision"])
def test_model_save_path_writes_what_was_trained(framework, tmp_path):
    """At EOS the trainer writes its trained parameters; the checkpoint
    restores into a template of the same model bit for bit (the LM's into
    the registry LM the filter serves)."""
    custom, caps, frames, props = SAVE_CASES[framework]
    path = str(tmp_path / "ckpt.pt")
    el = _train(framework, custom, caps, frames(), path, **props)
    assert os.path.exists(path)
    state = el.trainer.state_tensors()
    trained = {k[len("params."):]: v for k, v in state.items()
               if k.startswith("params.")}
    saved = torch.load(path, weights_only=True)
    assert sorted(saved) == sorted(trained)
    for key, t in trained.items():
        assert torch.equal(saved[key], t.detach().cpu()), key
    if framework == "mesh":
        lm = get_model("streamformer_lm", {**LM, "dtype": "float32"},
                       device="cpu")
        restore_params(lm, path)
        for key, t in named_tensors(lm).items():
            assert torch.equal(t, trained[key]), key


@pytest.mark.parametrize("framework", ["jax", "mesh", "mesh-vision"])
def test_a_trainer_without_samples_writes_nothing(framework, tmp_path):
    custom, caps, _, props = SAVE_CASES[framework]
    path = str(tmp_path / "ckpt.pt")
    el = _train(framework, custom, caps, [], path, **props)
    assert el.summary["samples"] == 0
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# custom=checkpoint: in the filter
# ---------------------------------------------------------------------------

def _frames(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
            for _ in range(n)]


def _reference_logits(path, frames):
    model = get_model("mobilenet_v2", MOBILE, device="cpu")
    restore_params(model, path)
    with torch.no_grad():
        return [model.module(torch.from_numpy(f))[0].numpy()
                for f in frames]


def _serve(custom, frames, reload_at=None, reload_data=None):
    p = parse_launch(
        f"appsrc name=in caps={FRAME_CAPS} ! tensor_filter framework=xla "
        f"model=mobilenet_v2 custom={custom} accelerator=true:cpu "
        "is-updatable=true ! tensor_sink name=out")
    got = []
    p.get("out").connect("new-data", lambda b: got.append(b.np(0).copy()))
    p.play()
    src = p.get("in")
    for i, f in enumerate(frames):
        if i == reload_at:
            src.push_event(CustomEvent("tensor_filter_update_model",
                                       reload_data))
        src.push_buffer(TensorBuffer(tensors=[f], pts=i))
    src.end_of_stream()
    p.wait(timeout=120)
    p.stop()
    return got


def test_filter_serves_a_checkpoint_at_open(tmp_path):
    path = str(tmp_path / "a.pt")
    save_checkpoint(_perturb(get_model("mobilenet_v2", MOBILE,
                                       device="cpu"), 3), path)
    frames = _frames(3)
    got = _serve(f"input_size:32,num_classes:4,checkpoint:{path}", frames)
    want = _reference_logits(path, frames)
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    seeded = _serve("input_size:32,num_classes:4", frames[:1])
    assert not np.array_equal(seeded[0], want[0])


def test_filter_reload_swaps_the_checkpoint_mid_stream(tmp_path):
    a, b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    for path, seed in ((a, 3), (b, 4)):
        save_checkpoint(_perturb(get_model("mobilenet_v2", MOBILE,
                                           device="cpu"), seed), path)
    frames = _frames(5, seed=1)
    got = _serve(f"input_size:32,num_classes:4,checkpoint:{a}", frames,
                 reload_at=2, reload_data={"checkpoint": b})
    want_a, want_b = _reference_logits(a, frames), _reference_logits(b,
                                                                     frames)
    assert len(got) == 5
    for i in range(5):
        np.testing.assert_array_equal(got[i], (want_a if i < 2
                                               else want_b)[i])


def test_filter_refuses_a_checkpoint_of_another_model(tmp_path):
    from nnstreamer_tpu_torch.pipeline.graph import PipelineError

    path = str(tmp_path / "vit.pt")
    save_checkpoint(get_model("vit", VIT, device="cpu"), path)
    with pytest.raises((PipelineError, RuntimeError),
                       match="checkpoint"):
        _serve(f"input_size:32,num_classes:4,checkpoint:{path}",
               _frames(1))


# ---------------------------------------------------------------------------
# against the JAX package's orbax checkpoint of the same stream
# ---------------------------------------------------------------------------

def test_trained_parameters_match_the_jax_checkpoint(tmp_path,
                                                     jax_cpu_devices):
    custom = ("model:vit,input_size:16,patch:8,dim:16,depth:1,heads:2,"
              "num_classes:4,dtype:float32,attn:naive,dp:1,lr:0.001")
    caps = SAVE_CASES["mesh-vision"][1]
    frames = _band(4, seed=3)
    jax_path = str(tmp_path / "orbax")
    jel = JaxTrainerEl("tr", framework="mesh-vision", **{
        "custom": custom, "model-save-path": jax_path})
    jp = JaxPipeline()
    jsrc, jsink = JaxAppSrc("src", caps=caps), JaxSink("out")
    jp.add(jsrc, jel, jsink)
    jp.link(jsrc, jel, jsink)
    for i, tensors in enumerate(frames):
        jsrc.push_buffer(JaxBuffer(tensors=list(tensors), pts=i))
    jsrc.end_of_stream()
    jp.run(timeout=300)

    jmodel = jax_get_model("vit", VIT)      # the JAX trainer's init
    path = str(tmp_path / "port.pt")
    el = TensorTrainer("tr", framework="mesh-vision", **{
        "custom": custom + ",device:cpu", "model-save-path": path})
    p = Pipeline()
    src, sink = AppSrc("src", caps=caps), TensorSink("out")
    p.add(src, el, sink)
    p.link(src, el, sink)
    p.play()
    el.trainer.load_params(jax.tree.map(np.asarray, jmodel.params))
    for i, tensors in enumerate(frames):
        src.push_buffer(TensorBuffer(tensors=list(tensors), pts=i))
    src.end_of_stream()
    p.wait(timeout=300)
    p.stop()
    np.testing.assert_allclose(el.trainer.losses, jel.trainer.losses,
                               rtol=1e-5)

    trained = jax_restore(jmodel.params, jax_path)
    template = get_model("vit", VIT, device="cpu", trainable=True)
    want = params_from_flax(jax.tree.map(np.asarray, trained),
                            template.module)
    restore_params(template, path)
    got = template.module.state_dict()
    for key, w in want.items():
        g = got[key].clone()
        if key.endswith("attn.qkv.bias"):
            kb = slice(16, 32)      # the key bias: 4 steps of up to lr
            torch.testing.assert_close(g[kb], w[kb], atol=4e-3, rtol=0.0,
                                       msg=key)
            g[kb] = w[kb]
        torch.testing.assert_close(g, w, atol=2e-4, rtol=0.0, msg=key)
