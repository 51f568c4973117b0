"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU and ``nvcc``; without them every test here skips.
The file imports nothing of JAX, so on a host without JAX it runs alone:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch import _cuda
from nnstreamer_tpu_torch.ops.flash_attention import (
    FORWARD_VERSIONS, flash_attention, flash_attention_backward_reference,
    flash_attention_reference, flash_attention_version)
from nnstreamer_tpu_torch.ops.preprocess import (normalize_frame,
                                                 normalize_frame_reference)

pytestmark = pytest.mark.cuda

#: the main path's frame, odd and ragged sizes, a 1080p frame
SHAPES = [(224, 224, 3), (1,), (7, 13, 3), (1025,), (3, 1000),
          (1080, 1920, 3)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_normalize_frame_is_bit_exact(card, shape, dtype):
    frame = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, shape, np.uint8)).to(card)
    before = _cuda.launches["normalize_frame"]
    got = normalize_frame(frame, 1.0 / 127.5, -1.0, dtype)
    torch.cuda.synchronize()
    assert _cuda.launches["normalize_frame"] == before + 1
    want = normalize_frame_reference(frame, 1.0 / 127.5, -1.0, dtype)
    assert got.dtype == dtype and got.shape == frame.shape
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16
                                 else torch.int32))


def test_normalize_frame_unaligned_input(card):
    """A view that starts one byte into its storage takes the scalar
    path and still matches."""
    base = torch.arange(1 + 4096, dtype=torch.int64).to(torch.uint8).to(card)
    frame = base[1:]
    got = normalize_frame(frame, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    want = normalize_frame_reference(frame, dtype=torch.bfloat16)
    assert torch.equal(got.float(), want.float())


def test_normalize_frame_refuses_what_it_does_not_take(card):
    with pytest.raises(TypeError, match="uint8"):
        normalize_frame(torch.zeros(8, device=card))
    with pytest.raises(TypeError, match="output dtype"):
        normalize_frame(torch.zeros(8, dtype=torch.uint8, device=card),
                        dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        normalize_frame(torch.zeros(8, 8, dtype=torch.uint8,
                                    device=card).t())


# ---------------------------------------------------------------------------
# flash attention (K2) against its plain version
# ---------------------------------------------------------------------------

#: out tolerance by dtype, |got - want| <= atol + rtol * |want|: f32 differs
#: only in summation order; bf16/f16 round the output once, like the plain
#: version, but from a differently ordered f32 sum
OUT_TOL = {torch.float32: (1e-4, 0.0), torch.float16: (3e-2, 1e-2),
           torch.bfloat16: (3e-2, 1e-2)}
#: lse is f32 in both; the tolerance covers exp/log of a long sum
LSE_ATOL = 1e-3


def _qkv(card, tq, h, d, dtype, tkv=None, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda t: torch.from_numpy(  # noqa: E731
        rng.standard_normal((t, h, d)).astype(np.float32)).to(card, dtype)
    return mk(tq), mk(tkv or tq), mk(tkv or tq)


def _check_flash(q, k, v, **kw):
    before = _cuda.launches["flash_attention"]
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert _cuda.launches["flash_attention"] == before + 1
    want, want_lse = flash_attention_reference(q, k, v, return_lse=True,
                                               **kw)
    assert out.dtype == q.dtype and out.shape == q.shape
    atol, rtol = OUT_TOL[q.dtype]
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    dead = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), dead)
    torch.testing.assert_close(lse[~dead], want_lse[~dead], atol=LSE_ATOL,
                               rtol=0.0)
    # rows that see no key: exactly 0 and -inf
    assert torch.all(out.float().transpose(-3, -2)[dead] == 0)
    return out, lse


FLASH_CASES = [
    # (tq, h, d, tkv, causal, dtype): the main paths' shapes first
    (197, 6, 64, None, False, torch.bfloat16),     # ViT-S/16 layer
    (2048, 8, 64, None, True, torch.bfloat16),     # LM prefill layer
    (64, 8, 16, None, True, torch.bfloat16),       # StreamFormer default
    (197, 6, 64, None, False, torch.float32),
    (197, 6, 64, None, False, torch.float16),
    (5, 2, 16, 37, False, torch.float32),          # Tq != Tkv, ragged
    (37, 2, 16, 5, False, torch.float32),
    (37, 3, 64, None, True, torch.float32),
    (130, 2, 8, None, True, torch.float32),        # D below every width
    (70, 2, 40, None, False, torch.float32),       # D between widths
    (100, 2, 128, None, True, torch.bfloat16),
    (65, 2, 256, None, True, torch.float32),       # widest D
    (50, 3, 6, None, True, torch.bfloat16),        # D of no whole vector
]


@pytest.mark.parametrize("tq,h,d,tkv,causal,dtype", FLASH_CASES, ids=str)
def test_flash_attention_matches_plain(card, tq, h, d, tkv, causal, dtype):
    _check_flash(*_qkv(card, tq, h, d, dtype, tkv), causal=causal)


@pytest.mark.parametrize("q_offset,k_offset", [(0, 32), (64, 0), (10, 40)])
def test_flash_attention_offsets(card, q_offset, k_offset):
    """Global-position causality: a later key block leaves the first
    rows fully masked (0, -inf); a past block is unmasked."""
    q, k, v = _qkv(card, 64, 4, 32, torch.float32, tkv=96, seed=3)
    _, lse = _check_flash(q, k, v, causal=True, q_offset=q_offset,
                          k_offset=k_offset)
    if k_offset > q_offset:
        assert torch.isinf(lse[:, :k_offset - q_offset]).all()


def test_flash_attention_strided_views(card):
    """q/k/v as views of one fused (T, 3, H, D) projection are read in
    place."""
    qkv = torch.randn(197, 3, 6, 64, device=card, dtype=torch.bfloat16)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]
    assert not q.is_contiguous()
    _check_flash(q, k, v)


def test_flash_attention_strided_causal_lm_shape(card):
    """The LM layer's q/k/v: views of a (2048, 3, 8, 64) projection."""
    qkv = torch.randn(2048, 3, 8, 64, device=card, dtype=torch.bfloat16)
    _check_flash(qkv[:, 0], qkv[:, 1], qkv[:, 2], causal=True)


def test_flash_attention_unaligned_rows(card):
    """Rows that do not start on 16 bytes take the scalar loads."""
    buf = torch.randn(1 + 3 * 37 * 2 * 16, device=card)
    q, k, v = buf[1:].reshape(3, 37, 2, 16).unbind(0)
    assert q.data_ptr() % 16
    _check_flash(q, k, v, causal=True)


def test_flash_attention_refuses_what_it_does_not_take(card):
    q = torch.zeros(8, 2, 16, device=card)
    with pytest.raises(ValueError, match="head dim"):
        z = torch.zeros(8, 2, 300, device=card)
        flash_attention(z, z, z)
    with pytest.raises(TypeError, match="share"):
        flash_attention(q, q.half(), q)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(8, 2, 16, device=card).transpose(0, 2)
        flash_attention(t, t, t)


def test_flash_attention_batch_axis(card):
    """(B, T, H, D): one launch with the batch in the grid, equal to the
    plain version and to each item's own unbatched launch."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 77, 4, 64))
                                .astype(np.float32)).to(card, torch.bfloat16)
               for _ in range(3))
    out, lse = _check_flash(q, k, v, causal=True)
    assert lse.shape == (3, 4, 77)
    for i in range(3):
        o_i, l_i = flash_attention(q[i], k[i], v[i], causal=True,
                                   return_lse=True)
        assert torch.equal(out[i], o_i) and torch.equal(lse[i], l_i)


#: the f16/bf16 tensor-core route (D <= 128) at its edges: blocks of 128
#: query rows (two warpgroups) with ragged ends and idle warpgroups, padded
#: widths 16/32/64/128 and D between them, the batch axis
TC_FLASH_CASES = [
    # (shape of q, tkv, causal)
    ((5, 2, 64), 37, False),          # Tq < Tkv: one warpgroup has no rows
    ((37, 2, 64), 5, True),           # Tq > Tkv
    ((200, 3, 64), 77, False),        # ragged Tq across blocks
    ((77, 3, 64), 200, True),         # ragged Tkv, causal
    ((130, 2, 8), None, True),        # D = 8, below every width
    ((70, 2, 40), None, False),       # D = 40, between widths
    ((300, 2, 16), None, True),       # D = 16
    ((150, 4, 32), 97, False),        # D = 32
    ((260, 2, 128), None, True),      # D = 128
    ((3, 77, 4, 64), None, True),     # the batch axis
    ((2, 129, 3, 128), 65, False),    # batched, D = 128, ragged
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
@pytest.mark.parametrize("shape,tkv,causal", TC_FLASH_CASES, ids=str)
def test_flash_attention_tensor_core_route(card, shape, tkv, causal, dtype):
    rng = np.random.default_rng(7)
    kshape = shape[:-3] + ((tkv or shape[-3]),) + shape[-2:]
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(card, dtype) for s in (shape, kshape, kshape))
    _check_flash(q, k, v, causal=causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
@pytest.mark.parametrize("q_offset,k_offset", [(0, 100), (64, 0), (10, 140),
                                               (0, 130)])
def test_flash_attention_tensor_core_offsets(card, q_offset, k_offset,
                                             dtype):
    """Keys after the queries leave whole rows with no key (0 and -inf),
    whole warpgroups' and blocks' worth of them at (0, 130)."""
    q, k, v = _qkv(card, 200, 3, 64, dtype, tkv=150, seed=8)
    _, lse = _check_flash(q, k, v, causal=True, q_offset=q_offset,
                          k_offset=k_offset)
    dead = max(0, k_offset - q_offset)
    assert torch.isinf(lse[:, :dead]).all()
    assert torch.isfinite(lse[:, dead:]).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_attention_tensor_core_fused_qkv(card, causal, dtype):
    """Batched q/k/v as views of one fused (B, T, 3, H, D) projection."""
    qkv = torch.randn(2, 197, 3, 6, 64, device=card, dtype=dtype)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    _check_flash(q, k, v, causal=causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
def test_flash_attention_tensor_core_unaligned_rows(card, dtype):
    """16-bit rows that do not start on 16 bytes take the scalar loader
    into the same swizzled tiles."""
    buf = torch.randn(1 + 3 * 130 * 2 * 64, device=card).to(dtype)
    q, k, v = buf[1:].reshape(3, 130, 2, 64).unbind(0)
    assert q.data_ptr() % 16
    _check_flash(q, k, v, causal=True)


@pytest.mark.parametrize("version", sorted(FORWARD_VERSIONS))
@pytest.mark.parametrize("shape,causal", [((200, 3, 64), True),
                                          ((2, 197, 6, 64), False),
                                          ((130, 2, 32), True),
                                          ((2, 77, 2, 128), False)],
                         ids=str)
def test_flash_attention_versions_match_plain(card, version, shape, causal):
    """Every tensor-core version chip_smoke.py times computes the same
    function, within the same tolerance."""
    rng = np.random.default_rng(9)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(card, torch.bfloat16) for _ in range(3))
    out, lse = flash_attention_version(q, k, v, version, causal=causal)
    want, want_lse = flash_attention_reference(q, k, v, causal=causal,
                                               return_lse=True)
    torch.cuda.synchronize()
    atol, rtol = OUT_TOL[torch.bfloat16]
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)
    torch.testing.assert_close(lse, want_lse, atol=LSE_ATOL, rtol=0.0)


def test_flash_attention_picks_its_version_by_grid(card):
    """flash_attention launches version 1 (two warpgroups a block) where
    blocks of 128 query rows fill every SM twice over, and version 2 (one
    warpgroup, 128 keys a stage) where they do not: its output is the
    chosen version's, bit for bit."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    rng = np.random.default_rng(10)
    for b, version in ((2 * sms, 1), (1, 2)):   # b blocks of 128 rows
        q, k, v = (torch.from_numpy(rng.standard_normal(
            (b, 128, 1, 64)).astype(np.float32)).to(card, torch.bfloat16)
            for _ in range(3))
        out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        want, want_lse = flash_attention_version(q, k, v, version,
                                                 causal=True)
        torch.cuda.synchronize()
        assert torch.equal(out, want) and torch.equal(lse, want_lse)


# ---------------------------------------------------------------------------
# flash attention backward (K3 dq, K4 dk/dv) against the plain backward
# ---------------------------------------------------------------------------

#: gradient tolerance by dtype, |got - want| <= atol + rtol * |want|: f32
#: differs only in summation order; bf16/f16 round each gradient once from
#: differently ordered f32 sums (scaled by the gradients' size below)
GRAD_TOL = {torch.float32: (1e-4, 1e-4), torch.float16: (2e-2, 2e-2),
            torch.bfloat16: (2e-2, 2e-2)}


def _check_backward(q, k, v, causal=False, q_offset=0, k_offset=0,
                    lse_cot=False, seed=0):
    """K3/K4 through the autograd Function against the plain backward on
    the same saved (out, lse), one launch of each per backward."""
    gen = torch.Generator(device=q.device).manual_seed(seed)
    kw = dict(causal=causal, q_offset=q_offset, k_offset=k_offset)
    ts = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention(*ts, return_lse=True, **kw)
    g = torch.randn(out.shape, generator=gen, device=q.device).to(q.dtype)
    g_lse = (torch.randn(lse.shape, generator=gen, device=q.device)
             if lse_cot else None)
    outs, cots = ([out, lse], [g, g_lse]) if lse_cot else ([out], [g])
    before = dict(_cuda.launches)
    got = torch.autograd.grad(outs, ts, cots)
    torch.cuda.synchronize()
    for name in ("flash_attention_bwd_dq", "flash_attention_bwd_dkv"):
        assert _cuda.launches[name] == before.get(name, 0) + 1
    delta = (g.float() * out.detach().float()).sum(-1).transpose(-1, -2)
    if lse_cot:
        delta = delta - g_lse
    want = flash_attention_backward_reference(q, k, v, g, lse.detach(),
                                              delta, **kw)
    atol, rtol = GRAD_TOL[q.dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == q.dtype and a.shape == b.shape, name
        scale = max(b.float().abs().max().item(), 1.0)
        torch.testing.assert_close(a.float(), b.float(), atol=atol * scale,
                                   rtol=rtol, msg=name)
    return got, lse


BWD_CASES = [
    # (shape of q, tkv, causal, dtype): the paths' shapes first
    ((32, 197, 6, 64), None, False, torch.bfloat16),   # ViT-S/16, batch 32
    ((4, 2048, 8, 64), None, True, torch.bfloat16),    # the LM layer, batch 4
    ((197, 6, 64), None, False, torch.float32),
    ((197, 6, 64), None, False, torch.float16),
    ((5, 2, 16), 37, False, torch.float32),            # Tq != Tkv, ragged
    ((37, 2, 16), 5, True, torch.float32),
    ((130, 2, 8), None, True, torch.float32),
    ((70, 2, 4), None, False, torch.float32),          # D of one f32 vector
    ((50, 3, 6), None, True, torch.bfloat16),          # D of no whole vector
    ((100, 2, 128), None, True, torch.bfloat16),       # widest backward D
    ((2, 65, 2, 40), None, False, torch.float32),      # D between widths
    ((2, 256, 8, 16), None, True, torch.bfloat16),     # StreamFormer's D 16
    ((100, 3, 32), None, False, torch.bfloat16),       # D 32
    ((4, 2048, 8, 64), None, True, torch.float16),     # the LM layer in f16
    ((3, 130, 2, 64), 77, False, torch.bfloat16),      # ragged Tq and Tkv
]


@pytest.mark.parametrize("shape,tkv,causal,dtype", BWD_CASES, ids=str)
def test_flash_backward_matches_plain(card, shape, tkv, causal, dtype):
    rng = np.random.default_rng(1)
    kshape = shape[:-3] + ((tkv or shape[-3]),) + shape[-2:]
    mk = lambda s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32)).to(card, dtype)
    _check_backward(mk(shape), mk(kshape), mk(kshape), causal=causal)


@pytest.mark.parametrize("q_offset,k_offset", [(0, 40), (64, 0), (10, 75)])
def test_flash_backward_offsets_and_lse_cotangent(card, q_offset, k_offset):
    """Offsets, ragged lengths, rows that see no key (their dq exactly 0)
    and a nonzero lse cotangent."""
    q, k, v = _qkv(card, 100, 3, 64, torch.float32, tkv=150, seed=4)
    (dq, _, _), lse = _check_backward(q, k, v, causal=True,
                                      q_offset=q_offset, k_offset=k_offset,
                                      lse_cot=True)
    dead = torch.isinf(lse).all(0)
    assert int(dead.sum()) == max(0, k_offset - q_offset)
    assert torch.all(dq[dead] == 0)


def test_flash_backward_strided_views(card):
    """q/k/v as views of one fused (B, T, 3, H, D) projection."""
    qkv = torch.randn(2, 197, 3, 6, 64, device=card, dtype=torch.bfloat16)
    _check_backward(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])


def test_flash_backward_refuses_wide_head_dim(card):
    w = torch.zeros(8, 2, 136, device=card, requires_grad=True)
    with pytest.raises(ValueError, match="backward"):
        flash_attention(w, w, w)


# ---------------------------------------------------------------------------
# one training step with the kernels against the same step with plain
# attention (f32, TF32 off: they differ in summation order only)
# ---------------------------------------------------------------------------

@pytest.fixture
def no_tf32(card):
    matmul, conv = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield card
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = conv


def _assert_grads_close(got, want):
    """Loss within 1e-5 rel; every gradient within 1e-4 relative L2."""
    for name, w in want.items():
        gap = (got[name] - w).norm() / w.norm().clamp_min(1e-30)
        assert gap.item() <= 1e-4, name


def test_lm_train_step_kernels_match_plain(no_tf32):
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.train_step import (
        StreamFormerConfig, make_train_step, value_and_grad)

    cfg = StreamFormerConfig(vocab=256, dim=128, heads=4, head_dim=32,
                             mlp=256, layers=2, experts=2, max_seq=256,
                             dtype=torch.float32)
    _, params, _, _ = make_train_step(make_mesh(devices=[no_tf32]), cfg)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, 256, (2, 200))).to(no_tf32)
    labs = toks.roll(-1, dims=1)
    before = dict(_cuda.launches)
    loss_k, g_k = value_and_grad(params, toks, labs, cfg, flash=True)
    torch.cuda.synchronize()
    for name in ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv"):
        assert _cuda.launches[name] == before.get(name, 0) + cfg.layers
    loss_p, g_p = value_and_grad(params, toks, labs, cfg, flash=False)
    assert abs(loss_k.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    _assert_grads_close(g_k, g_p)


def test_vit_train_step_kernels_match_plain(no_tf32):
    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.parallel.vision_train import _nll

    props = {"input_size": "64", "depth": "2", "num_classes": "10",
             "dtype": "float32"}
    rng = np.random.default_rng(1)
    frames = torch.from_numpy(rng.integers(0, 256, (4, 64, 64, 3),
                                           dtype=np.uint8)).to(no_tf32)
    labels = torch.from_numpy(rng.integers(0, 10, 4)).to(no_tf32)
    out = {}
    for attn in ("flash", "naive"):
        module = get_model("vit", {**props, "attn": attn}, device=no_tf32,
                           trainable=True).module
        params = dict(module.named_parameters())
        loss = _nll(module(frames)[0], labels)
        out[attn] = (loss.item(), dict(zip(params, torch.autograd.grad(
            loss, list(params.values())))))
    (loss_k, g_k), (loss_p, g_p) = out["flash"], out["naive"]
    assert abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
    _assert_grads_close(g_k, g_p)


# ---------------------------------------------------------------------------
# the serving paths as CUDA graphs: replays against eager runs of the same
# kernels in the same order, so bit for bit
# ---------------------------------------------------------------------------

#: (model, custom, input shape, input dtype, input high) of each serving
#: path's filter, cut in depth or width where the full size adds nothing
GRAPH_FILTERS = [
    ("mobilenet_v2", "seed:0,use_pallas:1", (224, 224, 3), np.uint8, 256),
    ("vit", "seed:0,depth:2", (224, 224, 3), np.uint8, 256),
    ("streamformer_lm", "seq:256,vocab:512,dim:128,heads:4,head_dim:32,"
     "mlp:256,layers:2,experts:2,seed:0", (256,), np.int32, 512),
]


def _frames(shape, dtype, high, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, high, shape).astype(dtype) for _ in range(n)]


def _open_filter(monkeypatch, model, custom, eager):
    """A started FilterSingle on the card; ``eager`` runs its forward
    without graphs (the reference)."""
    from nnstreamer_tpu_torch.filter import FilterSingle
    from nnstreamer_tpu_torch.filter.backends._torchexec import \
        TorchExecMixin

    single = FilterSingle(framework="xla", model=model, custom=custom)
    with monkeypatch.context() as m:
        m.setattr(TorchExecMixin, "_eager", eager)
        single.start()
    single.fw._eager = eager
    return single


@pytest.mark.parametrize("model,custom,shape,dtype,high", GRAPH_FILTERS,
                         ids=[g[0] for g in GRAPH_FILTERS])
def test_filter_graph_replays_equal_eager(card, monkeypatch, model, custom,
                                          shape, dtype, high):
    """Outputs of successive replays, all held, each equal the eager
    forward of its own frame; the stream after open captures nothing."""
    frames = _frames(shape, dtype, high, 3)
    graph = _open_filter(monkeypatch, model, custom, eager=False)
    eager = _open_filter(monkeypatch, model, custom, eager=True)
    try:
        captures = _cuda.graphs["captures"]
        held = [graph.fw.invoke([f]) for f in frames]
        assert _cuda.graphs["captures"] == captures
        want = [eager.fw.invoke([f]) for f in frames]
        torch.cuda.synchronize()
        for got, ref in zip(held, want):
            for g, r in zip(got, ref):
                assert g.is_cuda and torch.equal(g, r)
    finally:
        graph.stop()
        eager.stop()


def test_filter_graph_launches_are_captured_times_replays(card,
                                                          monkeypatch):
    """K2 counts 2 launches a ViT frame at depth 2: one eager run before
    the open's capture, then 2 a replay; the capture itself counts
    none."""
    _cuda.reset_launches()
    single = _open_filter(monkeypatch, "vit", "seed:0,depth:2,input_size:64",
                          eager=False)
    try:
        assert _cuda.launches["flash_attention"] == 2
        assert dict(_cuda.graphs) == {"captures": 1}
        (graph,) = single.fw._execs.values()
        assert graph.launched == {"flash_attention": 2}
        for f in _frames((64, 64, 3), np.uint8, 256, 3):
            single.fw.invoke([f])
        torch.cuda.synchronize()
        assert _cuda.launches["flash_attention"] == 2 * (1 + 3)
        assert dict(_cuda.graphs) == {"captures": 1, "replays": 3}
    finally:
        single.stop()


def test_filter_capture_failure_raises_without_fallback(card):
    """A forward that syncs with the host cannot be captured: the invoke
    raises FilterError, records no executable and never runs eagerly
    instead; the card stays usable."""
    from nnstreamer_tpu_torch.filter import FilterError
    from nnstreamer_tpu_torch.filter.backends._torchexec import \
        TorchExecMixin

    class Syncing(TorchExecMixin):
        NAME = "syncing"

    def forward(x):
        return (x * x.sum().item(),)

    fw = Syncing()
    fw._setup_exec(forward, card)
    x = torch.ones(8, device=card)
    for _ in range(2):
        with pytest.raises(FilterError, match="capture"):
            fw.invoke([x])
        assert fw._execs == {}
    assert torch.cuda.current_stream(card) == torch.cuda.default_stream(card)
    torch.cuda.synchronize()
    assert (x + 1).sum().item() == 16.0


def test_engine_graphs_equal_eager(card):
    """The decode engine's captured warm set against the same engine run
    eagerly: greedy tokens and every dispatch's logits bit for bit; the
    serving stream after warmup() captures nothing, and the set stays
    within the JAX package's budgets."""
    from nnstreamer_tpu_torch.llm import DecodeEngine, KVCachePool
    from nnstreamer_tpu_torch.models.streamformer_lm import place_params
    from nnstreamer_tpu_torch.parallel.train_step import (
        StreamFormerConfig, init_params)

    cfg = StreamFormerConfig(vocab=512, dim=128, heads=4, head_dim=32,
                             mlp=256, layers=2, experts=2, max_seq=128,
                             dtype=torch.bfloat16)
    params = place_params(init_params(cfg, 0), cfg, card)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 512, n).astype(np.int32)
               for n in (5, 17, 40, 9)]

    def serve(eager):
        pool = KVCachePool(cfg, 4, device=card)
        eng = DecodeEngine(params, cfg, pool, capacity=4)
        eng._eager = eager
        eng.warmup()
        captures = _cuda.graphs["captures"]
        sessions = [pool.acquire(i) for i in range(4)]
        logits, tokens = [], []
        for s, pr in zip(sessions, prompts):
            s.next_token = eng.prefill(s, pr)
            logits.append(eng.last_logits.copy())
            tokens.append(s.next_token)
        for fill in (4, 3, 4, 1, 2, 4):
            for s, tok in zip(sessions[:fill], eng.step(sessions[:fill])):
                s.next_token = tok
                tokens.append(tok)
            logits.append(eng.last_logits.copy())
        assert _cuda.graphs["captures"] == captures
        assert len(eng._step_fns) <= 16 and len(eng._prefill_fns) <= 32
        return tokens, logits

    tokens, logits = serve(eager=False)
    want_tokens, want_logits = serve(eager=True)
    assert tokens == want_tokens
    for got, want in zip(logits, want_logits):
        assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the training steps as CUDA graphs: the warm-up is step 1, every later
# step of a signature a replay; under deterministic algorithms each step's
# loss and the final parameters and Adam moments equal an eager run's
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd_dq",
                 "flash_attention_bwd_dkv")


@pytest.fixture
def deterministic(card):
    """cuDNN's deterministic algorithms and PyTorch's deterministic mode
    (warning, not raising, where an operation has none)."""
    import os

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark,
             torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             os.environ.get("CUBLAS_WORKSPACE_CONFIG"))
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield card
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
     on, warn_only, cublas) = saved
    torch.use_deterministic_algorithms(on, warn_only=warn_only)
    if cublas is None:
        os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas


def _lm_cfg(dtype=torch.bfloat16):
    from nnstreamer_tpu_torch.parallel.train_step import StreamFormerConfig

    return StreamFormerConfig(vocab=512, dim=128, heads=4, head_dim=32,
                              mlp=256, layers=2, experts=2, max_seq=256,
                              dtype=dtype)


def _lm_batches(n, t=256, b=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        toks = rng.integers(0, 512, (b, t)).astype(np.int32)
        out.append((toks, np.roll(toks, -1, axis=1)))
    return out


def _train_lm(card, batches):
    """Steps of the LM through make_train_step; (losses, state tensors,
    the step)."""
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.train_step import (leaves,
                                                          make_train_step)

    step, params, opt, _ = make_train_step(make_mesh(devices=[card]),
                                           _lm_cfg(), seed=0)
    losses = [float(step(params, opt, *b)[2]) for b in batches]
    state = {f"{tree}.{n}": x.clone() for tree, t in
             (("p", params), ("m", opt["m"]), ("v", opt["v"]))
             for n, x in leaves(t)}
    return losses, {**state, "step": opt["step"].clone()}, step


def _train_vit(card, batches):
    from nnstreamer_tpu_torch.models.registry import get_model
    from nnstreamer_tpu_torch.parallel import make_mesh
    from nnstreamer_tpu_torch.parallel.vision_train import \
        make_vision_train_step

    model = get_model("vit", {"seed": "0", "depth": "2", "input_size": "64",
                              "num_classes": "10"}, device=card,
                      trainable=True)
    step, module, opt, _ = make_vision_train_step(
        make_mesh(devices=[card]), model)
    losses = [float(step(module, opt, *b)[2]) for b in batches]
    state = {}
    for n, p in module.named_parameters():
        state[f"p.{n}"] = p.detach().clone()
        for k, x in opt.state[p].items():
            state[f"{k}.{n}"] = x.clone()
    return losses, state, step


def _train_mlp(card, batches):
    from nnstreamer_tpu_torch.elements.trainer import JaxTrainer

    trainer = JaxTrainer()
    trainer.create({"device": str(card), "lr": 1e-3})
    trainer._build(64, 10)
    for b in batches:
        trainer._run_step(*b)
    state = {k: x.clone() for k, x in trainer.state_tensors().items()}
    return trainer.losses, state, trainer.graphed


def _vit_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (4, 64, 64, 3), dtype=np.uint8),
             rng.integers(0, 10, 4).astype(np.int32)) for _ in range(n)]


def _mlp_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((32, 64)).astype(np.float32),
             np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)])
            for _ in range(n)]


TRAIN_FORMS = {"lm": (_train_lm, _lm_batches),
               "vit": (_train_vit, _vit_batches),
               "mlp": (_train_mlp, _mlp_batches)}


@pytest.mark.parametrize("form", list(TRAIN_FORMS))
def test_train_step_graph_equals_eager(deterministic, monkeypatch, form):
    """Four steps captured once and replayed against four eager steps
    from the same start: every loss, parameter and Adam moment bit for
    bit; one capture, a replay a later step."""
    from nnstreamer_tpu_torch._cuda import GraphedStep

    train, batches = TRAIN_FORMS[form]
    batches = batches(4)
    _cuda.reset_launches()
    losses, state, step = train(deterministic, batches)
    assert dict(_cuda.graphs) == {"captures": 1, "replays": 3}
    graphed = getattr(step, "graphed", step)
    assert len(graphed.graphs) == 1
    monkeypatch.setattr(GraphedStep, "_eager", True)
    want_losses, want_state, _ = train(deterministic, batches)
    assert losses == want_losses
    assert sorted(state) == sorted(want_state)
    for name, want in want_state.items():
        assert torch.equal(state[name], want), name


def test_train_graph_launches_are_captured_times_replays(card):
    """K2, K3 and K4 count a launch a layer a step: the warm-up (step 1)
    counts its own, the capture records its launches (K3 and K4 from
    autograd's backward among them) and runs none, each replay adds
    them."""
    _cuda.reset_launches()
    _, _, step = _train_lm(card, _lm_batches(5))
    torch.cuda.synchronize()
    layers = _lm_cfg().layers
    (graph,) = step.graphed.graphs.values()
    assert graph.launched == {k: layers for k in TRAIN_KERNELS}
    assert {k: _cuda.launches[k] for k in TRAIN_KERNELS} == {
        k: 5 * layers for k in TRAIN_KERNELS}
    assert dict(_cuda.graphs) == {"captures": 1, "replays": 4}


def test_train_step_captures_once_per_signature(card):
    """Two sequence lengths in turns: one capture each, on its first
    step; every later step replays."""
    long, short = _lm_batches(3, t=256), _lm_batches(3, t=128, seed=1)
    batches = [b for pair in zip(long, short) for b in pair]
    _cuda.reset_launches()
    losses, _, step = _train_lm(card, batches)
    assert len(step.graphed.graphs) == 2
    assert dict(_cuda.graphs) == {"captures": 2, "replays": 4}
    assert all(np.isfinite(losses))


def test_train_capture_failure_raises_without_fallback(card):
    """A step that syncs with the host cannot be captured: the call
    raises after its warm-up step, records no graph and never runs
    eagerly instead; the card stays usable."""
    from nnstreamer_tpu_torch._cuda import GraphedStep

    w = torch.zeros(4, device=card)

    def body(x):
        w.add_(x * x.sum().item())
        return w.sum()

    step = GraphedStep(body, card)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="capture"):
            step(np.ones(4, np.float32))
        assert step.graphs == {}
    assert torch.cuda.current_stream(card) == torch.cuda.default_stream(card)
    torch.cuda.synchronize()
    assert w.sum().item() == 32.0


# ---------------------------------------------------------------------------
# micro-batched serving
# ---------------------------------------------------------------------------

#: (model, custom, per-frame input, kernel, launches of one batched forward)
BATCHED_MODELS = [
    ("mobilenet_v2", "input_size:32,num_classes:10,use_pallas:1,"
     "dtype:float32", ((32, 32, 3), np.uint8, 256), "normalize_frame", 1),
    ("vit", "input_size:32,dim:64,depth:2,heads:2,num_classes:10,"
     "dtype:float32", ((32, 32, 3), np.uint8, 256), "flash_attention", 2),
    ("streamformer_lm", "seq:64,vocab:61,dim:32,heads:4,head_dim:8,mlp:64,"
     "layers:1,experts:2,dtype:float32", ((64,), np.int32, 61),
     "flash_attention", 1),
]


@pytest.mark.parametrize("model,custom,frame,kernel,per_batch",
                         BATCHED_MODELS, ids=[m[0] for m in BATCHED_MODELS])
def test_batched_models_launch_their_kernels_once_a_batch(
        card, monkeypatch, model, custom, frame, kernel, per_batch):
    """A registry model's batched forward reaches its kernel with the
    batch in one launch, never through torch.func.vmap, and equals its
    per-frame forward (f32, TF32 off: summation order only)."""
    from nnstreamer_tpu_torch.filter.framework import FilterProperties
    from nnstreamer_tpu_torch.models.registry import get_model

    def no_vmap(*args, **kwargs):
        raise AssertionError("torch.func.vmap reached")

    monkeypatch.setattr(torch.func, "vmap", no_vmap)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    m = get_model(model, FilterProperties.parse_custom(custom), card)
    shape, dtype, high = frame
    batch = torch.from_numpy(np.stack(_frames(shape, dtype, high, 4))).to(
        card)
    with torch.inference_mode():
        before = _cuda.launches[kernel]
        got = m.batched(batch)[0]
        torch.cuda.synchronize()
        assert _cuda.launches[kernel] == before + per_batch
        want = torch.stack([m.module(x)[0] for x in batch])
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-4 * scale


def test_batched_filter_graph_equals_eager(card, monkeypatch):
    """A padded batch (3 of 4 frames) through the captured batched graph
    equals the same batch run eagerly, bit for bit; the stream after
    warmup_batched captures nothing."""
    custom = "input_size:32,num_classes:10,use_pallas:1,seed:0"
    frames = [[f] for f in _frames((32, 32, 3), np.uint8, 256, 3)]
    graph = _open_filter(monkeypatch, "mobilenet_v2", custom, eager=False)
    eager = _open_filter(monkeypatch, "mobilenet_v2", custom, eager=True)
    try:
        graph.fw.warmup_batched(4)
        captures = _cuda.graphs["captures"]
        held = [graph.fw.invoke_batched(frames, 4) for _ in range(2)]
        assert _cuda.graphs["captures"] == captures
        want = eager.fw.invoke_batched(frames, 4).wait()
        for handle in held:
            for got, ref in zip(handle.wait(), want):
                np.testing.assert_array_equal(got[0], ref[0])
    finally:
        graph.stop()
        eager.stop()


def _stream_logits(inflight, frames):
    from nnstreamer_tpu_torch import parse_launch
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    p = parse_launch(
        "appsrc name=in caps=other/tensors,format=static,num_tensors=1,"
        "dimensions=3:32:32,types=uint8,framerate=0/1 ! tensor_filter "
        "framework=xla model=mobilenet_v2 custom=input_size:32,"
        f"num_classes:10,use_pallas:1 batch=4 inflight={inflight} ! "
        "queue max-size-buffers=8 ! tensor_sink name=out")
    p.play()
    try:
        captures = _cuda.graphs["captures"]
        for f in frames:
            p.get("in").push_buffer(TensorBuffer(tensors=[f]))
        p.get("in").end_of_stream()
        p.wait(timeout=120)
        assert _cuda.graphs["captures"] == captures
        return [b.np(0) for b in p.get("out").results]
    finally:
        p.stop()


def test_inflight_depth_is_bit_equal(card):
    """inflight=8 keeps eight batches' outputs on the card at once: each
    batch's host copy comes from its own clone, so its logits equal
    inflight=1's bit for bit (30 frames: 7 full batches and a padded
    2-frame one)."""
    frames = _frames((32, 32, 3), np.uint8, 256, 30)
    deep, shallow = _stream_logits(8, frames), _stream_logits(1, frames)
    assert len(deep) == len(shallow) == 30
    for a, b in zip(deep, shallow):
        np.testing.assert_array_equal(a, b)


def test_capture_holds_off_the_garbage_collector(card):
    """A dead cycle that owns a graph must not be collected inside
    another graph's capture (destroying a graph there invalidates the
    capture): the collector is off during the capture, on again after,
    and a capture with such a cycle pending succeeds."""
    import gc

    seen = []

    def fn(x):
        seen.append(gc.isenabled())
        return (x * 2,)

    x = torch.ones(4, device=card)

    class Owner:
        pass

    dead = Owner()
    dead.self = dead
    dead.graph = _cuda.CapturedGraph(fn, [x], _cuda.graph_memory(card))
    del dead                          # a cycle the collector has to find
    graph = _cuda.CapturedGraph(fn, [x], _cuda.graph_memory(card))
    assert seen == [True, False, True, False]
    assert gc.isenabled()
    assert torch.equal(graph.replay()[0], x * 2)
