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
    flash_attention, flash_attention_reference)
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
    assert torch.all(out.float().permute(1, 0, 2)[dead] == 0)
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
