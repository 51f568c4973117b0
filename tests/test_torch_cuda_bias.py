"""The biased flash-attention kernels (``csrc/flash_attention_bias.cu``)
against the plain expression, on the card.

Needs an NVIDIA GPU and ``nvcc``; without them every test here skips.
The file imports nothing of JAX, so on a host without JAX it runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda_bias.py
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch import _cuda
from nnstreamer_tpu_torch.ops.flash_attention import (flash_attention,
                                                      region_mask)

pytestmark = pytest.mark.cuda

#: SwinV2-B's four stages at batch 2: (windows, tokens, heads, head dim,
#: shifted); the shifted stages carry region labels
STAGES = [(32, 256, 4, 32, True), (8, 256, 8, 32, True),
          (2, 256, 16, 32, False), (2, 64, 32, 32, False)]
#: ragged and odd shapes: (batch, tq, tkv, heads, head dim)
RAGGED = [(3, 49, 49, 2, 32), (2, 100, 100, 3, 16), (2, 37, 130, 2, 64),
          (5, 65, 65, 1, 128), (1, 256, 256, 2, 32), (2, 7, 7, 2, 6),
          (7, 130, 200, 2, 32)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _labels(windows, t, seed):
    """Region labels as SwinV2's shifted map gives them: up to 9 regions a
    window, each window's row different."""
    rng = np.random.default_rng(seed)
    side = int(round(t ** 0.5))
    out = np.zeros((windows, t), np.int32)
    for w in range(windows):
        cut_r, cut_c = rng.integers(0, side, 2)
        rows = np.arange(t) // side
        cols = np.arange(t) % side
        out[w] = 3 * (rows >= cut_r) + (cols >= cut_c) + 9 * (w % 2)
    return out


def _operands(card, b, tq, tkv, h, d, dtype, shifted, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(card)
    q, k, v = mk(b, tq, h, d), mk(b, tkv, h, d), mk(b, tkv, h, d)
    # SwinV2's scores: unit q and k times a scale near 10, a bias in (0, 16)
    q = torch.nn.functional.normalize(q, dim=-1) * 10.0
    k = torch.nn.functional.normalize(k, dim=-1)
    bias = 16 * torch.sigmoid(mk(h, tq, tkv))
    regions = (torch.from_numpy(_labels(4, tq, seed)).to(card)
               if shifted else None)
    return q.to(dtype), k.to(dtype), v.to(dtype), bias, regions


def _plain(q, k, v, bias, regions):
    """softmax(q kᵀ + B + M) v in f32, differentiable in q, k, v and B."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) + bias
    if regions is not None:
        s = s + region_mask(regions, q.shape[0])[:, None]
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v.float())


def _gap(got, want):
    """|got - want| at its largest, over the largest |want| (at least 1)."""
    got, want = got.detach().float(), want.detach().float()
    return float((got - want).abs().max()
                 / max(float(want.abs().max()), 1.0))


#: bf16 and f16 round p and ds before their products and the outputs
#: once; the tolerance is the unbiased kernels' (GRAD_TOL of
#: test_torch_cuda.py), scaled by the outputs' size
TOL = 3e-2


def _check(card, b, tq, tkv, h, d, dtype, shifted, seed=0):
    q, k, v, bias, regions = _operands(card, b, tq, tkv, h, d, dtype,
                                       shifted, seed)
    ts = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    tb = bias.clone().requires_grad_()
    before = dict(_cuda.launches)
    out = flash_attention(*ts, scale=1.0, bias=tb, regions=regions)
    g = torch.randn(out.shape, device=card,
                    generator=torch.Generator(card).manual_seed(seed))
    got = torch.autograd.grad(out, ts + [tb], g.to(dtype))
    torch.cuda.synchronize()
    for name in ("flash_attention_bias", "flash_attention_bias_bwd_dq",
                 "flash_attention_bias_bwd_dkv",
                 "flash_attention_bias_dbias_sum"):
        assert _cuda.launches[name] == before.get(name, 0) + 1, name
    ps = [x.detach().float().requires_grad_() for x in (q, k, v)]
    pb = bias.clone().requires_grad_()
    want = _plain(*ps, pb, regions)
    want_g = torch.autograd.grad(want, ps + [pb], g.to(dtype).float())
    assert out.dtype == dtype and out.shape == q.shape
    assert _gap(out, want) <= TOL
    for name, a, w in zip(("dq", "dk", "dv", "dbias"), got, want_g):
        assert a.shape == w.shape, name
        assert _gap(a, w) <= TOL, (name, _gap(a, w))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
@pytest.mark.parametrize("b,t,h,d,shifted", STAGES, ids=str)
def test_biased_kernels_match_plain_at_swin_stages(card, b, t, h, d, shifted,
                                                   dtype):
    _check(card, b, t, t, h, d, dtype, shifted)


@pytest.mark.parametrize("b,t,h,d,shifted", STAGES[:2], ids=str)
def test_biased_kernels_without_the_mask(card, b, t, h, d, shifted):
    _check(card, b, t, t, h, d, torch.bfloat16, False, seed=3)


@pytest.mark.parametrize("b,tq,tkv,h,d", RAGGED, ids=str)
def test_biased_kernels_ragged_shapes(card, b, tq, tkv, h, d):
    _check(card, b, tq, tkv, h, d, torch.bfloat16, tq == tkv, seed=5)


def test_biased_kernels_read_strided_views(card):
    """q, k and v as views of one fused (B, T, 3, H, D) projection."""
    rng = np.random.default_rng(2)
    qkv = torch.from_numpy(rng.standard_normal((4, 64, 3, 4, 32)).astype(
        np.float32)).to(card, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    bias = torch.rand(4, 64, 64, device=card) * 4
    regions = torch.from_numpy(_labels(2, 64, 2)).to(card)
    got = flash_attention(q, k, v, scale=0.2, bias=bias, regions=regions)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * 0.2 + bias
    s = s + region_mask(regions, 4)[:, None]
    want = torch.einsum("bhqk,bkhd->bqhd", s.softmax(-1), v.float())
    assert _gap(got, want) <= TOL


def test_biased_graph_replay_equals_eager(card):
    """The biased forward and backward captured in a CUDA graph replay to
    the eager run's bits."""
    q, k, v, bias, regions = _operands(card, 8, 64, 64, 4, 32,
                                       torch.bfloat16, True, seed=7)
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    tb = bias.clone().requires_grad_()

    def step(_):
        out = flash_attention(*ts, scale=1.0, bias=tb, regions=regions)
        return (out, *torch.autograd.grad(out.float().square().sum(),
                                          ts + [tb]))

    # the capture's warm-up is the eager run (on its side stream, where
    # the leaves' gradient nodes then live)
    graph = _cuda.CapturedGraph(step, [q], _cuda.graph_memory(card))
    eager = [x.clone() for x in graph.first]
    got = graph.replay()
    torch.cuda.synchronize()
    assert graph.launched["flash_attention_bias"] == 1
    assert graph.covered["flash_attention_bias"] == 8
    for a, b in zip(got, eager):
        assert torch.equal(a, b)


def test_biased_kernels_refuse_what_they_do_not_take(card):
    q, k, v, bias, _ = _operands(card, 2, 64, 64, 2, 32, torch.bfloat16,
                                 False)
    with pytest.raises(TypeError, match="float16 and bfloat16"):
        flash_attention(q.float(), k.float(), v.float(), bias=bias)
    with pytest.raises(ValueError, match="bias must be"):
        flash_attention(q, k, v, bias=bias[:1])
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=True, bias=bias)
    wide = torch.zeros(1, 300, 1, 32, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="256 queries and keys"):
        flash_attention(wide, wide, wide,
                        bias=torch.zeros(1, 300, 300, device=card))
    deep = torch.zeros(1, 64, 1, 136, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims up to 128"):
        flash_attention(deep, deep, deep,
                        bias=torch.zeros(1, 64, 64, device=card))


# ---------------------------------------------------------------------------
# the training steps that launch them
# ---------------------------------------------------------------------------

#: a small SwinV2: stage 1 a 16 x 16 map in windows of 8 (its second block
#: rolled), stage 2 an 8 x 8 map (one window, nothing rolled)
SWIN = {"dim": "64", "depths": "2-2", "heads": "2-4", "window": "8",
        "patch": "4", "input_size": "64", "num_classes": "10", "seed": "0"}
BIASED = ("flash_attention_bias", "flash_attention_bias_bwd_dq",
          "flash_attention_bias_bwd_dkv", "flash_attention_bias_dbias_sum")


def _train(card, model, props, steps, batch=4):
    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.vision_train import \
        make_vision_train_step

    m = get_model(model, props, device=card, trainable=True)
    step, module, opt, _ = make_vision_train_step(make_mesh(devices=[card]),
                                                  m)
    rng = np.random.default_rng(4)
    size = int(props["input_size"])
    losses = []
    for _ in range(steps):
        frames = rng.integers(0, 256, (batch, size, size, 3), dtype=np.uint8)
        labels = rng.integers(0, 10, batch).astype(np.int32)
        losses.append(float(step(module, opt, frames, labels)[2]))
    torch.cuda.synchronize()
    (graph,) = step.graphed.graphs.values()
    return losses, graph, module


def test_swin_train_step_launches_the_biased_kernels_each_layer(card):
    """Each of the 4 attention layers launches the biased forward, K3, the
    partials' sum and K4 once a step (captured once, a replay a later
    step), no bias-free flash kernel; the windows they cover and the
    launches are published at the capture."""
    from nnstreamer_tpu_torch.obs.metrics import REGISTRY

    _cuda.reset_launches()
    losses, graph, _ = _train(card, "swin_v2", SWIN, 3)
    assert all(np.isfinite(losses))
    assert {k: graph.launched[k] for k in BIASED} == dict.fromkeys(BIASED, 4)
    assert not any(k.startswith("flash_attention") and k not in BIASED
                   for k in graph.launched)
    # 4 images: 4 windows each in stage 1, 1 in stage 2
    windows = 2 * 4 * 4 + 2 * 4
    assert graph.covered["flash_attention_bias"] == windows
    assert {k: _cuda.launches[k] for k in BIASED} == dict.fromkeys(BIASED,
                                                                   12)
    assert REGISTRY.gauge("nns_train_step_launches",
                          kernel="flash_attention_bias").value == 4
    assert REGISTRY.gauge("nns_train_step_rows",
                          kernel="flash_attention_bias_bwd_dq"
                          ).value == windows


def test_vit_train_step_launches_only_the_bias_free_kernels(card):
    """ViT's step launches the bias-free K2, K3 and K4 once a layer, under
    their names (flash_forward_tc_kernel, flash_bwd_dq_tc_kernel,
    flash_bwd_dkv_tc_kernel; traced in an eager forward and backward),
    and no biased kernel."""
    from torch.profiler import ProfilerActivity, profile

    props = {"seed": "0", "input_size": "64", "num_classes": "10",
             "depth": "2"}
    _, graph, module = _train(card, "vit", props, 2)
    kernels = ("flash_attention", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv")
    assert {k: graph.launched[k] for k in kernels} == dict.fromkeys(
        kernels, 2)
    assert not any("bias" in k for k in graph.launched)
    frames = torch.zeros((4, 64, 64, 3), dtype=torch.uint8, device=card)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        module(frames)[0].sum().backward()
        torch.cuda.synchronize()
    names = {e.name for e in prof.events() if "flash" in e.name}
    assert names and not any("flash_biased" in n for n in names)
    assert all(any(k in n for k in ("flash_forward_tc_kernel",
                                    "flash_bwd_dq_tc_kernel",
                                    "flash_bwd_dkv_tc_kernel"))
               for n in names), names
