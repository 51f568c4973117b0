"""Flash-attention backward (K3, K4 and the custom VJP): the port's plain
backward against ``jax.grad`` of the JAX kernel.

The same q/k/v and cotangents, made with numpy, go through the JAX
package's ``flash_attention`` (Pallas in interpret mode, its custom VJP
launching the two backward kernels) and through the port's
``flash_attention`` on CPU tensors that need a gradient, whose
``autograd.Function`` takes the kernels' plain versions (the CUDA kernels
are held to those plain versions on the card, tests/test_torch_cuda.py).

Tolerances: f32 gradients within 2e-5 abs and rel — the two sum in
different orders, nothing else differs; bf16 inputs within 2e-2 abs and rel
— both round q, k, v and the gradients to bf16 once, from f32 sums taken
in different orders.  Rows that see no key give exactly 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops.flash_attention import flash_attention as jax_flash
from nnstreamer_tpu_torch.ops.flash_attention import (
    _FlashFn, flash_attention, flash_attention_backward_reference,
    flash_attention_reference)

ATOL = RTOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _arrays(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _jax_grads(q, k, v, g, g_lse=None, batched=False, dtype=jnp.float32,
               **kw):
    """((out, lse), (dq, dk, dv)) of the JAX kernel, as f32 numpy."""
    def f(q, k, v):
        return jax_flash(q, k, v, interpret=True, return_lse=True, **kw)

    if batched:
        f = jax.vmap(f)
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (out, lse), vjp = jax.vjp(f, *args)
    cot_lse = (jnp.zeros_like(lse) if g_lse is None
               else jnp.asarray(g_lse, jnp.float32))
    grads = vjp((jnp.asarray(g, dtype), cot_lse))
    f32 = lambda x: np.asarray(jnp.asarray(x, jnp.float32))  # noqa: E731
    return (f32(out), f32(lse)), tuple(f32(x) for x in grads)


def _torch_grads(q, k, v, g, g_lse=None, dtype=torch.float32, **kw):
    ts = [torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention(*ts, return_lse=True, **kw)
    outs, cots = [out], [torch.from_numpy(g).to(dtype)]
    if g_lse is not None:
        outs.append(lse)
        cots.append(torch.from_numpy(g_lse))
    grads = torch.autograd.grad(outs, ts, cots)
    f32 = lambda x: x.detach().float().numpy()  # noqa: E731
    return (f32(out), f32(lse)), tuple(f32(x) for x in grads)


def _assert_grads(want, got, atol=ATOL, rtol=RTOL):
    for name, w, t in zip(("dq", "dk", "dv"), want, got):
        assert t.shape == w.shape, name
        np.testing.assert_allclose(t, w, atol=atol, rtol=rtol, err_msg=name)


def _case(tq, h, d, tkv=None, seed=0, batch=()):
    tkv = tkv or tq
    return _arrays([batch + (tq, h, d), batch + (tkv, h, d),
                    batch + (tkv, h, d), batch + (tq, h, d)], seed)


@pytest.mark.parametrize("d", [4, 16, 64])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("t", [5, 37])
def test_grads_match_jax(t, causal, d):
    """Ragged lengths pad to the JAX kernel's tiles; both head dims of the
    paths, and one below every kernel width."""
    q, k, v, g = _case(t, 2, d, seed=t + d)
    want_fwd, want = _jax_grads(q, k, v, g, causal=causal)
    got_fwd, got = _torch_grads(q, k, v, g, causal=causal)
    np.testing.assert_allclose(got_fwd[0], want_fwd[0], atol=ATOL, rtol=RTOL)
    _assert_grads(want, got)


@pytest.mark.parametrize("tq,tkv", [(5, 37), (37, 5), (16, 40)])
def test_cross_length_grads_match_jax(tq, tkv):
    q, k, v, g = _case(tq, 2, 8, tkv=tkv, seed=1)
    _assert_grads(_jax_grads(q, k, v, g)[1], _torch_grads(q, k, v, g)[1])


@pytest.mark.parametrize("q_offset,k_offset", [(0, 16), (32, 0), (5, 30)],
                         ids=["future-keys", "past-block", "partial"])
def test_offset_grads_match_jax(q_offset, k_offset):
    """Global-position causality; with keys after the queries the first
    rows see no key and their dq is exactly 0."""
    q, k, v, g = _case(32, 2, 16, tkv=48, seed=3)
    kw = dict(causal=True, q_offset=q_offset, k_offset=k_offset)
    want = _jax_grads(q, k, v, g, **kw)[1]
    got = _torch_grads(q, k, v, g, **kw)[1]
    _assert_grads(want, got)
    dead = max(0, k_offset - q_offset)
    assert np.all(got[0][:dead] == 0) and np.all(want[0][:dead] == 0)


@pytest.mark.parametrize("causal,k_offset", [(False, 0), (True, 0),
                                             (True, 20)])
def test_lse_cotangent_matches_jax(causal, k_offset):
    """The lse variant with a random lse cotangent: it folds into delta.
    Rows that see no key (k_offset 20) carry a cotangent too and must
    still give exactly 0."""
    q, k, v, g = _case(24, 3, 16, tkv=40, seed=7)
    g_lse = _arrays([(3, 24)], 8)[0]
    kw = dict(causal=causal, k_offset=k_offset)
    want = _jax_grads(q, k, v, g, g_lse, **kw)[1]
    got = _torch_grads(q, k, v, g, g_lse, **kw)[1]
    _assert_grads(want, got)
    assert np.all(got[0][:k_offset] == 0)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_batch_axis_matches_jax_vmap(causal):
    """A leading batch axis (the kernels' grid axis) against jax.vmap of
    the kernel, with an lse cotangent."""
    q, k, v, g = _case(19, 2, 16, seed=9, batch=(3,))
    g_lse = _arrays([(3, 2, 19)], 10)[0]
    want_fwd, want = _jax_grads(q, k, v, g, g_lse, batched=True,
                                causal=causal)
    got_fwd, got = _torch_grads(q, k, v, g, g_lse, causal=causal)
    np.testing.assert_allclose(got_fwd[0], want_fwd[0], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_fwd[1], want_fwd[1], atol=ATOL, rtol=RTOL)
    _assert_grads(want, got)


def test_batch_axis_equals_per_item_calls():
    """Each batch item's gradients equal those of its own unbatched call,
    exactly: the plain versions do the same arithmetic."""
    q, k, v, g = _case(11, 2, 8, seed=11, batch=(2,))
    whole = _torch_grads(q, k, v, g, causal=True)[1]
    for i in range(2):
        item = _torch_grads(q[i], k[i], v[i], g[i], causal=True)[1]
        for a, b in zip(whole, item):
            np.testing.assert_array_equal(a[i], b)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_bf16_grads_match_jax(causal):
    q, k, v, g = _case(37, 2, 16, seed=12)
    want = _jax_grads(q, k, v, g, dtype=jnp.bfloat16, causal=causal)[1]
    got = _torch_grads(q, k, v, g, dtype=torch.bfloat16, causal=causal)[1]
    _assert_grads(want, got, atol=BF16_TOL, rtol=BF16_TOL)


def test_plain_backward_equals_autograd_of_plain_forward():
    """Where every row sees a key, the plain backward is the true gradient
    of the plain forward (its autograd) to f32 rounding."""
    q, k, v, g = (torch.from_numpy(x) for x in _case(21, 2, 16, seed=13))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    with torch.no_grad():
        out, lse = flash_attention_reference(q, k, v, causal=True,
                                             return_lse=True)
    want = torch.autograd.grad(
        flash_attention_reference(*ts, causal=True), ts, g)
    delta = (g * out).sum(-1).t()
    got = flash_attention_backward_reference(q, k, v, g, lse, delta,
                                             causal=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_unused_output_gets_no_cotangent():
    """Only out used: the lse cotangent is absent (None), not zeros — the
    _flash variant's backward."""
    q, k, v, g = _case(9, 2, 16, seed=14)
    want = _jax_grads(q, k, v, g)[1]
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts)
    got = torch.autograd.grad(out, ts, torch.from_numpy(g))
    _assert_grads(want, [x.numpy() for x in got])


def test_needs_grad_goes_through_the_function():
    q, k, v = (torch.zeros(5, 2, 16, requires_grad=True) for _ in range(3))
    out = flash_attention(q, k, v)
    assert out.grad_fn is not None
    assert type(out.grad_fn).__name__ == f"{_FlashFn.__name__}Backward"
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


def test_backward_head_dim_limit():
    """There is no head-dim limit any more: a call needing a gradient at D
    = 136 (past 128, once the backward's widest) goes through the autograd
    Function, and its gradient is the plain backward's on the same saved
    out and lse, on the CPU as on the card (there within the kernels'
    tolerance)."""
    q, k, v, g = (torch.from_numpy(x) for x in _case(12, 2, 136, seed=16))
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention(*ts, causal=True, return_lse=True)
    assert type(out.grad_fn).__name__ == f"{_FlashFn.__name__}Backward"
    got = torch.autograd.grad(out, ts, g)
    delta = (g * out.detach()).sum(-1).t()
    want = flash_attention_backward_reference(q, k, v, g, lse.detach(),
                                              delta, causal=True)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=0.0, rtol=0.0)


#: test_torch_cuda.py's bf16 GRAD_TOL, which holds the card's K3/K4 to the
#: plain backward: |got - want| <= ATOL * max(max |want|, 1) + RTOL * |want|
CARD_BF16_ATOL = CARD_BF16_RTOL = 2e-2


def _tensor_core_rounding_backward(q, k, v, dout, lse, delta, causal=False):
    """The plain backward's arithmetic with the rounding of the bf16/f16
    tensor-core kernels (csrc/flash_attention_bwd.cu): bf16 inputs; s and
    dp in f32; p and ds rounded to bf16 before they enter the three
    accumulating products (dq = ds k, dk = ds^T q, dv = p^T dO), whose sums
    are f32; each gradient rounded once.  At a padded width of 256 K3 takes
    its keys 32 at a time and K4 trades p and ds between two warpgroups in
    f32: the same roundings."""
    qf, kf, vf, of = (x.float() for x in (q, k, v, dout))
    scale = 1.0 / np.sqrt(q.shape[-1])
    s = torch.einsum("...qhd,...khd->...hqk", qf, kf) * scale
    live = torch.isfinite(lse)[..., None]
    if causal:
        t = torch.arange(q.shape[-3])
        live = live & (t[None, :] <= t[:, None])
    p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
    dp = torch.einsum("...qhd,...khd->...hqk", of, vf)
    ds = p * (dp - delta[..., None]) * scale
    p16, ds16 = (x.to(torch.bfloat16).float() for x in (p, ds))
    dq = torch.einsum("...hqk,...khd->...qhd", ds16, kf)
    dk = torch.einsum("...hqk,...qhd->...khd", ds16, qf)
    dv = torch.einsum("...hqk,...qhd->...khd", p16, of)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))


@pytest.mark.parametrize("batch,t,h,causal,d",
                         [((), 2048, 2, True, 64), ((2,), 197, 6, False, 64),
                          ((), 1024, 2, True, 256),
                          ((2,), 130, 2, False, 200),
                          ((2,), 256, 2, True, 320)],
                         ids=["lm-layer-heads", "vit-layer", "lm-wide-heads",
                              "d200-padded-256", "d320-pieces"])
def test_tensor_core_rounding_stays_inside_card_tolerance(batch, t, h,
                                                          causal, d):
    """Rounding p and ds to bf16 before the products, as the card's
    tensor-core kernels do, keeps dq, dk and dv inside the tolerance that
    holds them to the plain backward, at the LM layer's per-head shape
    (T = 2048, causal, D = 64), ViT's (T = 197, 6 heads, batch 2), at
    the padded width of 256 (the wide-head LM's D = 256, causal; D =
    200), and past it (D = 320, causal: the piece kernels, which round p
    and ds as the 256-wide kernels do)."""
    q, k, v, g = (torch.from_numpy(x).to(torch.bfloat16)
                  for x in _case(t, h, d, seed=15, batch=batch))
    out, lse = flash_attention_reference(q, k, v, causal=causal,
                                         return_lse=True)
    delta = (g.float() * out.float()).sum(-1).transpose(-1, -2)
    args = (q, k, v, g, lse, delta)
    got = _tensor_core_rounding_backward(*args, causal=causal)
    want = flash_attention_backward_reference(*args, causal=causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = max(b.float().abs().max().item(), 1.0)
        torch.testing.assert_close(a.float(), b.float(),
                                   atol=CARD_BF16_ATOL * scale,
                                   rtol=CARD_BF16_RTOL, msg=name)


def test_backward_kernels_are_registered_for_the_build(tmp_path,
                                                       monkeypatch):
    """K3/K4's source is one the build compiles, and a library's name
    hashes the shared headers too: an edit to flash_common.cuh or to
    flash_wgmma.cuh (the tile layout, loaders and products every flash
    kernel includes) rebuilds every flash library."""
    import os

    from nnstreamer_tpu_torch import _cuda

    assert _cuda.SOURCES["flash_attention_bwd"] == "flash_attention_bwd.cu"
    for src in ("flash_attention.cu", "flash_attention_bwd.cu"):
        with open(os.path.join(_cuda.CSRC, src)) as f:
            text = f.read()
        assert ('#include "flash_common.cuh"' in text
                and '#include "flash_wgmma.cuh"' in text), src
    for name in ("flash_attention.cu", "flash_attention_bwd.cu",
                 "flash_common.cuh", "flash_wgmma.cuh"):
        (tmp_path / name).write_text("// " + name)
    monkeypatch.setattr(_cuda, "CSRC", str(tmp_path))
    for header in ("flash_common.cuh", "flash_wgmma.cuh"):
        before = {n: _cuda._library_path(n)
                  for n in ("flash_attention", "flash_attention_bwd")}
        (tmp_path / header).write_text("// edited")
        for n, path in before.items():
            assert _cuda._library_path(n) != path, (header, n)


#: an ``nvcc -Xptxas -v`` report in the form the card's build writes it
#: (mangled names shortened): one tensor-core K4 without spills, one f32
#: K3 piece kernel (128 output columns) that spills, with a note ptxas
#: attaches to a function by name, and a kernel that is not a flash one
PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123flash_bwd_dkv_tc_kernelI13__nv_bfloat16Li64EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_123flash_bwd_dkv_tc_kernelI13__nv_bfloat16Li64EEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 191 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_128flash_bwd_dq_tc_piece_kernelIfLi128ELi32ELi0EEEvPKT_' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized in the function '_ZN12_GLOBAL__N_128flash_bwd_dq_tc_piece_kernelIfLi128ELi32ELi0EEEvPKT_'
ptxas info    : Function properties for _ZN12_GLOBAL__N_128flash_bwd_dq_tc_piece_kernelIfLi128ELi32ELi0EEEvPKT_
    192 bytes stack frame, 204 bytes spill stores, 204 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16384 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122normalize_frame_kernelIhEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122normalize_frame_kernelIhEEvPKT_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 24 registers, 400 bytes cmem[0]
"""


def test_ptxas_report_gives_registers_spills_and_notes(monkeypatch):
    """The build keeps nvcc's -Xptxas -v report; the parser gives each
    kernel function's registers, shared memory, spills and notes, and
    chip_smoke.py picks the tensor-core K3/K4 specialisations (type and
    padded width, or a piece kernel's output columns) out of the mangled
    names for its no-spill check, which holds a piece kernel at any
    width."""
    import importlib.util
    import os

    from nnstreamer_tpu_torch import _cuda

    assert ("-Xptxas", "-v") == _cuda.NVCC_FLAGS[-2:]
    tc, f32, other = _cuda.parse_ptxas(PTXAS_REPORT)
    assert (tc["registers"], tc["static_smem_bytes"], tc["spill_store_bytes"],
            tc["spill_load_bytes"], tc["notes"]) == (191, 0, 0, 0, [])
    assert (f32["registers"], f32["static_smem_bytes"], f32["stack_bytes"],
            f32["spill_store_bytes"], f32["spill_load_bytes"]) == (
                255, 16384, 192, 204, 204)
    assert len(f32["notes"]) == 1 and "serialized" in f32["notes"][0]
    assert (other["registers"], other["spill_store_bytes"]) == (24, 0)

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_module", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    m = smoke.TC_KERNEL.search(tc["function"])
    assert m and m.groups() == ("flash_bwd_dkv_tc_kernel", "__nv_bfloat16",
                                "64")
    m = smoke.TC_KERNEL.search(f32["function"])
    assert m and m.groups() == ("flash_bwd_dq_tc_piece_kernel", "f", "128")
    assert smoke.TC_KERNEL.search(other["function"]) is None
    assert 64 in smoke.NO_SPILL_WIDTHS and 128 not in smoke.NO_SPILL_WIDTHS
    monkeypatch.setattr(_cuda, "ptxas_report", lambda: {
        "flash_attention_bwd": [tc, f32], "normalize_frame": [other]})
    rows, spills = smoke.build_report()
    assert len(rows) == 3
    assert len(spills) == 1 and "408 bytes" in spills[0]

