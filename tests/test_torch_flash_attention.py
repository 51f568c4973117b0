"""Flash attention (K2): the port's plain version against the JAX kernel.

The same q/k/v, made with numpy, go through the JAX package's Pallas
kernel in interpret mode and through the port's ``flash_attention`` on
CPU tensors, which takes the kernel's plain version (the CUDA kernel
itself is held to that plain version on the card, tests/test_torch_cuda.py).
Tolerance: f32 ``out`` and ``lse`` within 1e-5 abs and rel — the two sum
in different orders, nothing else differs.  Rows that see no key must be
exactly 0 and -inf in both.
"""

import math

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


# ---------------------------------------------------------------------------
# the bf16/f16 tensor-core route (csrc/flash_attention.cu) on the CPU
# ---------------------------------------------------------------------------

#: test_torch_cuda.py's bf16 OUT_TOL, which holds the card's K2 to its plain
#: version: |got - want| <= ATOL + RTOL * |want|
CARD_BF16_ATOL, CARD_BF16_RTOL = 3e-2, 1e-2


def _tensor_core_rounding_forward(q, k, v, causal=False):
    """The arithmetic of the bf16/f16 tensor-core K2: f32 scores; per
    64-key tile the running row max m2 in base 2, ``p = exp2(s·scale·log2e
    − m2)`` in f32, the row sum ``l`` adding the unrounded p, and ``o =
    o·exp2(m2_old − m2) + bf16(p)·v`` summed in f32; ``out = o / max(l,
    1e-20)`` rounded once to bf16."""
    qf, kf, vf = (x.float() for x in (q, k, v))
    scale2 = math.log2(math.e) / math.sqrt(q.shape[-1])
    s_all = torch.einsum("...qhd,...khd->...hqk", qf, kf)
    if causal:
        t = torch.arange(q.shape[-3])
        s_all = s_all.masked_fill(t[None, :] > t[:, None], float("-inf"))
    m2 = torch.full(s_all.shape[:-1], float("-inf"))
    lsum = torch.zeros(s_all.shape[:-1])
    o = torch.zeros(s_all.shape[:-1] + (q.shape[-1],))
    for k0 in range(0, k.shape[-3], 64):
        s = s_all[..., k0:k0 + 64]
        m_new = torch.maximum(m2, s.amax(-1) * scale2)
        m_use = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        corr = torch.exp2(m2 - m_use)
        p = torch.exp2(s * scale2 - m_use[..., None])
        lsum = lsum * corr + p.sum(-1)
        o = o * corr[..., None] + torch.einsum(
            "...hqk,...khd->...hqd", p.to(torch.bfloat16).float(),
            vf[..., k0:k0 + 64, :, :])
        m2 = m_new
    out = o / lsum.clamp_min(1e-20)[..., None]
    return out.transpose(-3, -2).to(torch.bfloat16)


@pytest.mark.parametrize("batch,t,h,causal", [((), 2048, 2, True),
                                              ((2,), 197, 6, False)],
                         ids=["lm-layer-heads", "vit-layer"])
def test_tensor_core_rounding_stays_inside_card_tolerance(batch, t, h, causal,
                                                          record_property):
    """Rounding p to bf16 before p·v, with l summed from the f32 p, as the
    card's tensor-core K2 does, keeps out inside the tolerance that holds
    it to the plain version, at the LM layer's per-head shape (T = 2048,
    causal, D = 64) and ViT's (T = 197, 6 heads, batch 2).  The share of
    the tolerance used goes into the report as ``tolerance_share``."""
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.standard_normal(batch + (t, h, 64))
                                .astype(np.float32)).to(torch.bfloat16)
               for _ in range(3))
    got = _tensor_core_rounding_forward(q, k, v, causal=causal).float()
    want = flash_attention_reference(q, k, v, causal=causal).float()
    share = ((got - want).abs()
             / (CARD_BF16_ATOL + CARD_BF16_RTOL * want.abs())).max().item()
    record_property("tolerance_share", share)
    assert share <= 1.0, f"uses {share:.3f} of the card's bf16 tolerance"


def _smoke_module():
    """chip_smoke.py as a module (it imports no torch at the top)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


#: an ``nvcc -Xptxas -v`` report in the form the card's build writes it
#: (argument lists shortened): K2's tensor-core kernel in bf16 at a padded
#: width of 64 that spills, in f16 at 128 that spills, and the CUDA-core
#: kernel in f32 and in bf16 at 256, spilling too
FWD_PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123flash_forward_tc_kernelI13__nv_bfloat16Li64ELi2ELi1EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123flash_forward_tc_kernelI13__nv_bfloat16Li64ELi2ELi1EEEvPKT_
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123flash_forward_tc_kernelI6__halfLi128ELi1ELi2EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123flash_forward_tc_kernelI6__halfLi128ELi1ELi2EEEvPKT_
    16 bytes stack frame, 16 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_forward_kernelIfLi64EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_forward_kernelIfLi64EEEvPKT_
    256 bytes stack frame, 256 bytes spill stores, 256 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_120flash_forward_kernelI13__nv_bfloat16Li256EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_120flash_forward_kernelI13__nv_bfloat16Li256EEEvPKT_
    64 bytes stack frame, 64 bytes spill stores, 64 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_no_spill_check_picks_the_tensor_core_forward(monkeypatch):
    """chip_smoke.py's build check picks K2's tensor-core specialisations
    out of the mangled names by type and padded width, and fails the
    build on one at a width of NO_SPILL_WIDTHS that spills; the CUDA-core
    kernel (f32, and bf16 at 256) and the 128-wide one are not held to
    it."""
    from nnstreamer_tpu_torch import _cuda

    smoke = _smoke_module()
    funcs = _cuda.parse_ptxas(FWD_PTXAS_REPORT)
    groups = [m and m.groups() for m in
              (smoke.TC_KERNEL.search(f["function"]) for f in funcs)]
    assert groups == [("flash_forward_tc_kernel", "__nv_bfloat16", "64"),
                      ("flash_forward_tc_kernel", "__half", "128"),
                      None, None]
    monkeypatch.setattr(_cuda, "ptxas_report",
                        lambda: {"flash_attention": funcs})
    rows, spills = smoke.build_report()
    assert len(rows) == 4
    assert len(spills) == 1 and "16 bytes" in spills[0]
    # the profile counts ViT frames by a name every K2 kernel carries
    assert all(smoke.K2_MARKER in f["function"] for f in funcs)


def test_versions_are_named_and_need_the_card():
    """The tensor-core versions chip_smoke.py times; a CPU tensor has no
    kernel to launch."""
    assert sorted(fa.FORWARD_VERSIONS) == list(
        range(1, len(fa.FORWARD_VERSIONS) + 1))
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16)
               for x in _qkv(8, 2, 64))
    with pytest.raises(ValueError, match="unsupported device"):
        fa.flash_attention_version(q, k, v, 1)
