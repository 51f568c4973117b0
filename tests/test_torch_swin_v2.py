"""SwinV2 (``models/swin_v2.py``) and the biased flash attention it runs,
on the CPU: the program against the benchmark's plain reference
(``benchmark/reference/swin_v2.py``) at a tiny size where the shift and the
region mask both occur, the flash twin's bias and mask against the plain
softmax and autograd, the region labels against the codebase's
``img_mask``, and the reference's FLOP count against an analytic one."""

from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark import flops, inputs, judge
from benchmark import spec as bench_spec
from nnstreamer_tpu_torch.models import swin_v2
from nnstreamer_tpu_torch.ops.flash_attention import (
    REGION_MASK, flash_attention, flash_attention_backward_reference,
    flash_attention_reference, region_mask)

#: SwinV2 at a tiny size: an 8 x 8 map after patches of 4, stage 1 in
#: windows of 4 (its second block rolled by 2), stage 2 a 4 x 4 map (one
#: window, nothing rolled)
TINY = {"embed_dim": 32, "depths": [2, 2], "num_heads": [2, 4],
        "window_size": 4, "image_size": 32, "num_classes": 10}
CUSTOM = ("dim:32,depths:2-2,heads:2-4,window:4,patch:4,input_size:32,"
          "num_classes:10")


def _cfg(**over):
    with open(os.path.join(bench_spec.HERE, "configs",
                           "swinv2-b-w16-256.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, **over)
    cfg["base"] = bench_spec.HERE
    return cfg


def _program(cfg, weights=None):
    from nnstreamer_tpu_torch.models.registry import get_model, named_tensors

    model = get_model("swin_v2", {**bench_spec.parse_custom(CUSTOM),
                                  "dtype": "float32"}, device="cpu",
                      trainable=True)
    if weights is not None:
        live = named_tensors(model)
        assert set(live) == set(weights)
        with torch.no_grad():
            for n, t in live.items():
                t.copy_(weights[n])
    return model


def test_published_size_has_the_references_weights():
    """SwinV2-B at window 16 and 256: the program's parameters are the
    reference's, name for name and shape for shape, 87,918,816 of them
    (the codebase's model reports 87.9 M)."""
    cfg = _cfg(embed_dim=128, depths=[2, 2, 18, 2], num_heads=[4, 8, 16, 32],
               window_size=16, image_size=256, num_classes=1000)
    with torch.device("meta"):
        module = swin_v2.SwinV2()
    ref = bench_spec.reference(cfg)
    want = {n: tuple(s) for n, s, _ in ref.spec(cfg)}
    got = {n: tuple(p.shape) for n, p in module.named_parameters()}
    assert got == want
    assert sum(math.prod(s) for s in got.values()) == 87_918_816


def test_logits_equal_the_references():
    """f32 on the CPU: the same weights and frames give the reference's
    logits within 1e-5 of their largest (LayerNorm's one-pass variance and
    the flash twin's row semantics differ from the reference's in
    rounding only)."""
    cfg = _cfg()
    ref = bench_spec.reference(cfg)
    w = inputs.weights(ref.spec(cfg), 2 ** 31 + 5, "cpu", torch.float32)
    frames = torch.from_numpy(inputs.video_frames(3, 4, 32))
    model = _program(cfg, w)
    with torch.no_grad():
        got = model.batched(frames)[0]
        one = model.module(frames[1])[0]
        want = ref.forward(w, frames, cfg)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert torch.allclose(one, got[1], atol=1e-6 * scale, rtol=0)
    assert torch.equal(got.argmax(-1), want.argmax(-1))


def _train_through_the_element(w0, batches):
    """Three Adam steps of ``tensor_trainer framework=mesh-vision`` on the
    CPU from ``w0``: (losses, first gradient as Adam holds it, parameters
    after the last step)."""
    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    n, size = batches[0][0].shape[:2]
    p = parse_launch(
        f"appsrc name=src caps=other/tensors,format=static,num_tensors=2,"
        f"dimensions=3:{size}:{size}:{n}.{n},types=uint8.int32,"
        f"framerate=0/1 ! tensor_trainer name=trainer framework=mesh-vision "
        f"num-epochs=1 lr=0.001 custom=model:swin_v2,dp:1,{CUSTOM},"
        f"device:cpu,dtype:float32 ! tensor_sink name=out collect=false")
    p.play()
    trainer = p.get("trainer").trainer
    step, seen = trainer._run_step, {}

    def params():
        return {k[len("params."):]: v for k, v in
                trainer.state_tensors().items() if k.startswith("params.")}

    def run(*batch):
        if not trainer.losses:
            with torch.no_grad():
                for k, v in params().items():
                    v.copy_(w0[k])
        step(*batch)
        if len(trainer.losses) == 1:
            state = trainer.state_tensors()
            seen["first"] = {k: state[f"exp_avg.{k}"].clone() / 0.1
                             for k in params()}

    trainer._run_step = run
    src = p.get("src")
    try:
        for i, (frames, labels) in enumerate(batches):
            src.push_buffer(TensorBuffer(
                tensors=[frames.numpy(), labels.numpy()], pts=i))
        src.end_of_stream()
        p.wait(timeout=300)
    finally:
        p.stop()
    return (list(trainer.losses), seen["first"],
            {k: v.clone() for k, v in params().items()})


def test_three_adam_steps_through_the_trainer_equal_the_references():
    """Through ``parse_launch`` and the trainer element, f32: every loss
    within 1e-5 of the reference's, the first gradient within 1e-4 of it
    by the worst leaf's norm of the difference (``grad_diff``), the change
    over three steps within 1e-3 by the gap of norms (``change_gap``):
    Adam moves an element whose gradient rounds to either sign by ±lr, so
    the change is held by norms, as the benchmark holds it."""
    cfg = _cfg()
    ref = bench_spec.reference(cfg)
    adam = bench_spec.load_module(os.path.join(bench_spec.HERE, "reference",
                                               "adam.py"))
    w0 = inputs.weights(ref.spec(cfg), 7, "cpu", torch.float32)
    batches = inputs.train_batches(7, 3, 4, 32, 10, "cpu")
    losses, first, after = _train_through_the_element(w0, batches)
    ref_losses, ref_first, ref_after = adam.train(
        ref.forward, w0, cfg, batches, bench_spec.trainable, 1e-3,
        (0.9, 0.999), 1e-8)
    assert judge.loss_gap(losses, ref_losses) <= 1e-5
    split = ref.leaves
    change = split({k: after[k] - w0[k] for k in after})
    ref_change = split({k: ref_after[k] - w0[k] for k in ref_after})
    numbers, _ = judge.leaf_numbers(split(first), change, split(ref_first),
                                    ref_change)
    assert numbers["grad_diff"] <= 1e-4
    assert numbers["change_gap"] <= 1e-3


def test_flash_twin_with_bias_and_regions_matches_softmax_and_autograd():
    """The CPU twin of the biased kernels: out against softmax(q kᵀ s + B
    + M) v, and dq, dk, dv and dbias against autograd of that expression
    (the backward reference's ``dbias`` is ds before the scale, summed
    over the batch); f32, within its rounding."""
    torch.manual_seed(0)
    b, t, h, d = 6, 16, 2, 8
    q, k, v = (torch.randn(b, t, h, d, requires_grad=True)
               for _ in range(3))
    bias = (8 * torch.rand(h, t, t)).requires_grad_()
    regions = torch.randint(0, 3, (4, t), dtype=torch.int32)
    out, lse = flash_attention(q, k, v, scale=0.5, bias=bias,
                               regions=regions, return_lse=True)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.5 + bias
    lab = regions[torch.arange(b) % 4]
    s = s + REGION_MASK * (lab[:, :, None] != lab[:, None, :])[:, None]
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v)
    assert torch.allclose(out, want, atol=1e-5)
    assert torch.allclose(lse, torch.logsumexp(s, -1), atol=1e-5)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v, bias), g)
    ref = torch.autograd.grad(want, (q, k, v, bias), g)
    for a, r in zip(got, ref):
        assert torch.allclose(a, r, atol=1e-5)
    delta = (g * out).sum(-1).transpose(-1, -2)
    *_, dbias = flash_attention_backward_reference(
        q.detach(), k.detach(), v.detach(), g, lse.detach(), delta.detach(),
        scale=0.5, bias=bias.detach(), regions=regions)
    assert torch.allclose(dbias, ref[3], atol=1e-5)


def test_flash_twin_takes_one_frame_and_the_bias_alone():
    """A (T, H, D) call is batch row 0; without regions only the bias is
    added."""
    torch.manual_seed(1)
    q, k, v = (torch.randn(9, 2, 4) for _ in range(3))
    bias = torch.randn(2, 9, 9)
    got = flash_attention(q, k, v, bias=bias)
    s = torch.einsum("qhd,khd->hqk", q, k) / 2.0 + bias
    want = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1), v)
    assert torch.allclose(got, want, atol=1e-6)
    out = flash_attention_reference(q, k, v, bias=bias,
                                    regions=torch.zeros(1, 9, dtype=torch.int32))
    assert torch.allclose(out, want, atol=1e-6)


def test_flash_twin_refuses_what_it_does_not_take():
    q = torch.zeros(2, 8, 2, 4)
    with pytest.raises(ValueError, match="bias must be"):
        flash_attention(q, q, q, bias=torch.zeros(2, 8, 7))
    with pytest.raises(ValueError, match="regions must be"):
        flash_attention(q, q, q, bias=torch.zeros(2, 8, 8),
                        regions=torch.zeros(1, 7, dtype=torch.int32))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, q, q, causal=True, bias=torch.zeros(2, 8, 8))
    with pytest.raises(ValueError, match="need a bias"):
        flash_attention(q, q, q, regions=torch.zeros(1, 8, dtype=torch.int32))


@pytest.mark.parametrize("side,window,shift", [(8, 4, 2), (64, 16, 8),
                                               (32, 16, 8), (56, 7, 3)])
def test_region_labels_give_the_codebases_mask(side, window, shift):
    """The program's labels (one int a token of a window) make exactly the
    codebase's ``attn_mask`` (built from ``img_mask``'s nine regions)."""
    ref = bench_spec.reference(_cfg())
    labels = swin_v2.shift_regions(side, side, window, shift)
    assert labels.shape == ((side // window) ** 2, window * window)
    got = region_mask(labels, labels.shape[0])
    assert torch.equal(got, ref.attn_mask(side, window, shift))


@pytest.mark.parametrize("window", [4, 8, 16])
def test_position_tables_equal_the_codebases(window):
    ref = bench_spec.reference(_cfg())
    table, index = ref.coords_and_index(window)
    assert torch.allclose(swin_v2.relative_coords_table(window), table,
                          atol=1e-6)
    assert torch.equal(swin_v2.relative_position_index(window), index)


def test_windows_partition_and_reverse_as_the_codebase():
    ref = bench_spec.reference(_cfg())
    x = torch.randn(2, 8, 8, 3)
    win = swin_v2.window_partition(x, 4)
    assert torch.equal(win, ref.window_partition(x, 4).reshape(-1, 16, 3))
    assert torch.equal(swin_v2.window_reverse(win, 4, 8, 8), x)


def _analytic_flops(cfg, batch):
    """(forward, forward and backward) FLOPs a frame: twice the
    multiply-adds of every convolution, dense layer and attention product
    (what ``torch.utils.flop_counter`` counts), the backward twice the
    forward but for the products whose input needs no gradient (the patch
    convolution's frames, the position MLP's coordinates)."""
    p, c = cfg["patch_size"], cfg["embed_dim"]
    side = cfg["image_size"] // p
    conv = 2 * c * 3 * p * p * side * side
    fwd, no_input_grad = conv, conv
    for i, (depth, heads) in enumerate(zip(cfg["depths"], cfg["num_heads"])):
        s, d = side >> i, c << i
        w = min(cfg["window_size"], s)
        tokens, n = s * s, w * w
        cpb_in = 2 * (2 * w - 1) ** 2 * 2 * cfg["cpb_hidden"] / batch
        cpb = cpb_in + 2 * (2 * w - 1) ** 2 * cfg["cpb_hidden"] * heads / batch
        block = (2 * tokens * d * 3 * d          # qkv
                 + 2 * 2 * tokens * n * d        # q kᵀ and p v
                 + 2 * tokens * d * d            # proj
                 + 2 * 2 * tokens * d * 4 * d    # fc1, fc2
                 + cpb)
        fwd += depth * block
        no_input_grad += depth * cpb_in
        if i < len(cfg["depths"]) - 1:
            fwd += 2 * (tokens // 4) * 4 * d * 2 * d
    fwd += 2 * (c << (len(cfg["depths"]) - 1)) * cfg["num_classes"]
    return fwd, 3 * fwd - no_input_grad


@pytest.mark.parametrize("batch", [1, 4])
def test_flop_count_of_the_tiny_configuration_is_analytic(batch):
    cfg = _cfg()
    fwd, train = _analytic_flops(cfg, batch)
    assert flops.count(cfg, batch, train=False) == pytest.approx(fwd,
                                                                 rel=1e-9)
    assert flops.count(cfg, batch, train=True) == pytest.approx(train,
                                                                rel=1e-9)


def test_the_trainer_passes_swin_keys_and_refuses_a_carry_it_cannot_load():
    """``depths``, ``heads`` (dash lists) and ``window`` reach the model; a
    carried JAX tree for a model without a loader is refused at the build,
    naming the model."""
    from nnstreamer_tpu_torch.elements.trainer import MeshVisionTrainer

    trainer = MeshVisionTrainer()
    trainer.create({**bench_spec.parse_custom(CUSTOM), "model": "swin_v2",
                    "device": "cpu", "dtype": "float32"})
    trainer._build()
    module = trainer._model.module
    assert [len(s.blocks) for s in module.layers] == [2, 2]
    assert module.layers[0].blocks[1].shift == 2
    assert module.layers[1].blocks[0].attn.heads == 4
    carried = MeshVisionTrainer()
    carried.create({"model": "swin_v2", **bench_spec.parse_custom(CUSTOM),
                    "device": "cpu"})
    carried.load_params({"params": {}})
    with pytest.raises(ValueError, match="'swin_v2' has no such loader"):
        carried._build()


def test_a_model_the_program_does_not_know_fails_the_stream_promptly():
    """A trainer whose model the registry lacks fails at its build, at the
    end of the stream, and the failure reaches ``Pipeline.wait`` at
    once."""
    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    p = parse_launch(
        "appsrc name=src caps=other/tensors,format=static,num_tensors=2,"
        "dimensions=3:8:8:2.2,types=uint8.int32,framerate=0/1 ! "
        "tensor_trainer framework=mesh-vision custom=model:no_such_model,"
        "dp:1,device:cpu ! tensor_sink collect=false")
    p.play()
    src = p.get("src")
    t0 = time.monotonic()
    try:
        src.push_buffer(TensorBuffer(tensors=[
            np.zeros((2, 8, 8, 3), np.uint8), np.zeros(2, np.int32)], pts=0))
        src.end_of_stream()
        with pytest.raises(Exception, match="no_such_model"):
            p.wait(timeout=120)
    finally:
        p.stop()
    assert time.monotonic() - t0 < 30


def test_cpb_mlp_and_logit_scale_train():
    """The position-bias MLP and the per-head scale get gradients through
    the flash twin's dbias (the bias is made every step)."""
    model = _program(_cfg())
    frames = torch.randint(0, 256, (2, 32, 32, 3), dtype=torch.uint8)
    loss = F.cross_entropy(model.module(frames)[0], torch.tensor([1, 2]))
    loss.backward()
    attn = model.module.layers[0].blocks[1].attn
    for p in (attn.cpb_mlp[0].weight, attn.cpb_mlp[2].weight,
              attn.logit_scale, attn.q_bias, attn.v_bias):
        assert p.grad is not None and float(p.grad.abs().sum()) > 0
    assert np.isfinite(float(loss.detach()))
