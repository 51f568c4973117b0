"""Flash attention (K2): the port's plain version against the JAX kernel.

The same q/k/v, made with numpy, go through the JAX package's Pallas
kernel in interpret mode and through the port's ``flash_attention`` on
CPU tensors, which takes the kernel's plain version (the CUDA kernel
itself is held to that plain version on the card, tests/test_torch_cuda.py).
Tolerance: f32 ``out`` and ``lse`` within 1e-5 abs and rel — the two sum
in different orders, nothing else differs.  Rows that see no key must be
exactly 0 and -inf in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops.flash_attention import flash_attention as jax_flash
from nnstreamer_tpu.parallel.ring_attention import \
    local_attention as jax_local
from nnstreamer_tpu_torch.ops import flash_attention as fa
from nnstreamer_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference, flash_is_default,
    flash_wins)
from nnstreamer_tpu_torch.parallel.ring_attention import local_attention

ATOL = RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _qkv(tq, h, d, tkv=None, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((t, h, d)).astype(np.float32)
                 for t in (tq, tkv or tq, tkv or tq))


def _both(q, k, v, **kw):
    want, want_lse = jax_flash(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), interpret=True,
                               return_lse=True, **kw)
    got, got_lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), return_lse=True,
                                   **kw)
    return (np.asarray(want), np.asarray(want_lse), got.numpy(),
            got_lse.numpy())


def _assert_match(want, want_lse, got, got_lse):
    assert got.shape == want.shape and got_lse.shape == want_lse.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    dead = np.isneginf(want_lse)
    np.testing.assert_array_equal(np.isneginf(got_lse), dead)
    np.testing.assert_allclose(got_lse[~dead], want_lse[~dead], atol=ATOL,
                               rtol=RTOL)
    assert np.all(got.transpose(1, 0, 2)[dead] == 0)


@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t", [5, 37])
def test_plain_matches_jax_kernel(t, causal, d):
    """Ragged lengths (5 and 37 tokens pad to the JAX kernel's tiles)."""
    _assert_match(*_both(*_qkv(t, 2, d, seed=t), causal=causal))


@pytest.mark.parametrize("tq,tkv", [(5, 37), (37, 5), (16, 40)])
def test_cross_lengths_match_jax_kernel(tq, tkv):
    """Tq != Tkv without a causal mask."""
    _assert_match(*_both(*_qkv(tq, 2, 16, tkv=tkv, seed=1)))


@pytest.mark.parametrize("q_offset,k_offset", [(0, 16), (32, 0), (5, 30)],
                         ids=["future-keys", "past-block", "partial"])
def test_offsets_match_jax_kernel(q_offset, k_offset):
    """Global-position causality: keys after the queries leave whole rows
    with no visible key (out 0, lse -inf, not NaN); a past block is
    unmasked."""
    q, k, v = _qkv(32, 2, 16, tkv=48, seed=3)
    want, want_lse, got, got_lse = _both(q, k, v, causal=True,
                                         q_offset=q_offset,
                                         k_offset=k_offset)
    _assert_match(want, want_lse, got, got_lse)
    dead = max(0, k_offset - q_offset)
    assert np.isneginf(got_lse[:, :dead]).all()
    assert np.isfinite(got_lse[:, dead:]).all()


def test_past_block_is_unmasked_attention():
    """Queries at [t, 2t) over keys [0, t): plain softmax attention."""
    q, k, v = _qkv(32, 2, 16, seed=4)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          q_offset=32)
    want = jax_local(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_return_lse_off_returns_out_only():
    q, k, v = map(torch.from_numpy, _qkv(9, 2, 16))
    out = flash_attention(q, k, v, causal=True)
    assert isinstance(out, torch.Tensor)
    torch.testing.assert_close(
        out, flash_attention_reference(q, k, v, causal=True))


@pytest.mark.parametrize("block", [(None, None), (8, 8), (128, 16)])
def test_block_sizes_never_change_the_result(block):
    q, k, v = map(torch.from_numpy, _qkv(37, 2, 16))
    base = flash_attention(q, k, v, causal=True)
    got = flash_attention(q, k, v, causal=True, block_q=block[0],
                          block_k=block[1])
    assert torch.equal(got, base)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_output_keeps_the_input_dtype(dtype):
    q, k, v = (torch.from_numpy(x).to(dtype) for x in _qkv(12, 2, 16))
    out, lse = flash_attention(q, k, v, causal=True, return_lse=True)
    assert out.dtype == dtype and lse.dtype == torch.float32
    want = flash_attention(q.float(), k.float(), v.float(), causal=True)
    torch.testing.assert_close(out.float(), want, atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_local_attention_matches_jax(causal):
    q, k, v = _qkv(37, 3, 16, seed=5)
    want = jax_local(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=causal)
    got = local_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_needing_a_gradient_raises():
    """The backward is ported: a call that needs a gradient raises only
    past the backward kernels' widest head dim (128), which the forward
    alone takes."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(5, 2, 16))
    out = flash_attention(q, k, v)
    assert out.requires_grad and out.shape == (5, 2, 16)
    wide = torch.zeros(5, 2, 136, requires_grad=True)
    with pytest.raises(ValueError, match="backward"):
        flash_attention(wide, wide, wide)
    with torch.no_grad():
        assert flash_attention(wide, wide, wide).shape == (5, 2, 136)


def test_refuses_what_it_does_not_take():
    z = torch.zeros(4, 2, 16)
    with pytest.raises(ValueError, match="head dim"):
        w = torch.zeros(4, 2, 257)
        flash_attention(w, w, w)
    with pytest.raises(ValueError, match="differ"):
        flash_attention(z, torch.zeros(4, 3, 16), torch.zeros(4, 3, 16))
    with pytest.raises(TypeError, match="share"):
        flash_attention(z, z.double(), z)


class _OnCard:
    """Stands for a tensor on the card: the gate reads only its
    placement."""

    is_cuda = True


def test_gate_keys_off_placement(monkeypatch):
    monkeypatch.delenv("NNS_TPU_FLASH_MIN_T", raising=False)
    assert not flash_is_default(torch.zeros(1))
    assert not flash_wins(4096, torch.zeros(1))
    # no H100 crossover record yet: the kernel at every length
    assert flash_is_default(_OnCard())
    assert flash_wins(1, _OnCard()) and flash_wins(197, _OnCard())


@pytest.mark.parametrize("env,t,want", [("256", 197, False),
                                        ("256", 256, True),
                                        ("bogus", 8, True)])
def test_gate_override(monkeypatch, env, t, want):
    """NNS_TPU_FLASH_MIN_T keeps its meaning: a plain threshold; a
    malformed value warns and is ignored."""
    monkeypatch.setenv("NNS_TPU_FLASH_MIN_T", env)
    if env == "bogus":
        with pytest.warns(UserWarning, match="not an int"):
            assert flash_wins(t, _OnCard()) is want
    else:
        assert flash_wins(t, _OnCard()) is want
    assert not flash_wins(t, torch.zeros(1))


def test_kernel_is_registered_for_the_build():
    """The wrapper's kernel is one of the sources the build compiles."""
    from nnstreamer_tpu_torch import _cuda

    assert _cuda.SOURCES["flash_attention"] == "flash_attention.cu"
    assert fa.MAX_HEAD_DIM == 256
