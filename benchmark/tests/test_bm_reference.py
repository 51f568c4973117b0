"""The plain reference models against the program at a tiny size on the
CPU: the same weights (the benchmark's, drawn from a seed and handed to
both) and frames give the same logits, and one training step the same
loss and update."""

from __future__ import annotations

import ast
import os

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark import spec as bench_spec


def _program(cell, weights, trainable=False):
    from nnstreamer_tpu_torch.models.registry import get_model, named_tensors

    custom = bench_spec.parse_custom(cell["config"]["program"]["custom"])
    model = get_model(cell["config"]["program"]["model"],
                      {**custom, "dtype": "float32"}, device="cpu",
                      trainable=trainable)
    live = named_tensors(model)
    assert set(live) == set(weights)
    with torch.no_grad():
        for n, t in live.items():
            t.copy_(weights[n])
    return model


@pytest.mark.parametrize("name", ["mnv2-tiny", "vit-tiny"])
def test_reference_logits_equal_the_programs(tiny, name):
    cell = tiny.cell(name)
    cfg = cell["config"]
    ref = bench_spec.reference(cfg)
    w = inputs.weights(ref.spec(cfg), 2 ** 31 + 5, "cpu", torch.float32)
    frames = torch.from_numpy(inputs.video_frames(3, 4, cfg["image_size"]))
    model = _program(cell, w)
    with torch.no_grad():
        got = model.batched(frames)[0]
        want = ref.forward(w, frames, cfg)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def test_reference_training_step_equals_the_programs(tiny):
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.vision_train import \
        make_vision_train_step

    cell = tiny.cell("vit-tiny-train")
    cfg = cell["config"]
    ref = bench_spec.reference(cfg)
    adam = bench_spec.load_module(os.path.join(cfg["base"], "reference",
                                               "adam.py"))
    w = inputs.weights(ref.spec(cfg), 11, "cpu", torch.float32)
    batch = inputs.train_batches(11, 1, 8, cfg["image_size"],
                                 cfg["num_classes"], "cpu")
    model = _program(cell, w, trainable=True)
    step, module, opt, _ = make_vision_train_step(
        make_mesh(n_devices=1, axis_sizes={"dp": 1},
                  devices=[torch.device("cpu")]), model, lr=1e-3)
    loss = float(step(module, opt, *batch[0])[2])
    losses, first, after = adam.train(ref.forward, w, cfg, batch,
                                      bench_spec.trainable, 1e-3,
                                      (0.9, 0.999), 1e-8)
    assert loss == pytest.approx(losses[0], rel=1e-5)
    for n, p in module.named_parameters():
        g = opt.state[p]["exp_avg"] / 0.1
        assert torch.allclose(g, first[n], rtol=1e-3, atol=1e-6 * float(
            first[n].abs().max())), n
        assert float((p.detach() - w[n]).norm()) == pytest.approx(
            float((after[n] - w[n]).norm()), rel=1e-2, abs=1e-9), n


def test_video_frames_are_the_sources_random_pattern():
    from nnstreamer_tpu_torch import parse_launch

    p = parse_launch("videotestsrc num-buffers=3 pattern=random seed=99 ! "
                     "video/x-raw,format=RGB,width=8,height=8,"
                     "framerate=30/1 ! tensor_converter ! "
                     "tensor_sink name=out")
    p.run(timeout=60)
    got = np.stack([b.np(0).reshape(8, 8, 3) for b in p.get("out").results])
    assert np.array_equal(got, inputs.video_frames(99, 3, 8))


def test_references_import_nothing_of_the_program():
    base = os.path.join(bench_spec.HERE, "reference")
    for fname in os.listdir(base):
        if not fname.endswith(".py"):
            continue
        with open(os.path.join(base, fname)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "math", "typing",
                                           "__future__"), (fname, n)
