"""The f32 routes of K2, K3 and K4 on the tensor cores, their arithmetic
emulated on the CPU and held to the JAX package.

On the card an f32 ``flash_attention`` runs ``flash_forward_tc_piece_kernel``
(``nnstreamer_tpu_torch/csrc/flash_attention.cu``): every f32 operand x is
split into hi, x with its low 13 mantissa bits cleared (a TF32 value, what
the tensor cores read), and lo = x - hi, and every product a·b is taken as
three TF32 products, hi_a·hi_b + hi_a·lo_b + lo_a·hi_b, summed in f32, for
q·kᵀ and for p·v alike, inside the kernel's streaming softmax over stages
of keys.  The card cannot be asked here, so this file emulates that
arithmetic in torch: TF32 truncation by masking the low 13 bits through an
int32 view (lo's own low bits too, which the tensor cores drop), the split,
the three products and the softmax in base 2 stage by stage.  The same q, k
and v, made with numpy from a seed, go through the JAX package's
``flash_attention`` (Pallas in interpret mode, as its own CPU tests run it)
and the emulation is held to it at the card's f32 tolerance:
``chip_smoke.py``'s ``FLASH_TOL["float32"]`` on out (|err| <= 1e-4) and
``LSE_ATOL`` on lse.  One TF32 product alone misses that tolerance (the
last test), which is why the kernel takes three.

The backward's piece kernels (``csrc/flash_attention_bwd.cu``) take all
five of their products the same way: s = q·kᵀ and dp = dO·vᵀ, then p and
ds split into hi and lo in registers, dq = ds·k, dk = dsᵀ·q and dv = pᵀ·dO.
The emulated backward, on the emulated forward's out and lse, is held to
``jax.vjp`` of the JAX package's ``flash_attention`` (interpret mode) at
``chip_smoke.py``'s ``BWD_TOL["float32"]`` (|err| <= 1e-4 · max(max
|grad|, 1)), the ring's past block with a nonzero lse cotangent among
the cases; one TF32 product a product misses it.  What the emulation
cannot show is the tensor cores' own f32 accumulation, which is not IEEE
round-to-nearest: the card's FLASH_ROWS and BWD_ROWS decide that.
"""

import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.ops.flash_attention import flash_attention as jax_flash


def _smoke():
    """chip_smoke.py as a module (it imports no torch at the top)."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_tf32", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()
ATOL, RTOL = SMOKE.FLASH_TOL["float32"]

BWD_TOL = SMOKE.BWD_TOL["float32"]

#: (batch, t, h, d, causal, q_offset): the sp=2 ring's past block at a small
#: length (every key visible), a padded 256 and a head dim past 256
CASES = [(2, 128, 2, 64, True, 128), (1, 96, 2, 256, False, 0),
         (1, 80, 2, 320, False, 0)]
IDS = ["ring-past-d64", "d256", "d320"]


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x with the low 13 bits of its f32 mantissa cleared: TF32 by
    truncation."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _split(x: torch.Tensor):
    hi = _tf32(x)
    return hi, x - hi


def _product(a: torch.Tensor, b: torch.Tensor, products: int):
    """a @ b as the kernel takes it: three TF32 products (the tensor cores
    drop lo's low bits too), or one."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    if products == 1:
        return ah @ bh
    return ah @ bh + ah @ _tf32(bl) + _tf32(al) @ bh


def _piece_kernel_forward(q, k, v, causal, q_offset, products=3):
    """(out (B, T, H, D), lse (B, H, T)) of the f32 piece kernel's
    arithmetic: scores from TF32 products; per stage of KN keys (64 up to
    a head dim of 64, else 32) the running row max m2 in base 2, ``p =
    exp2(s·scale·log2e − m2)``, ``l`` summed from p, ``o = o·exp2(m2_old −
    m2) + p·v`` from TF32 products; ``out = o / max(l, 1e-20)``, ``lse =
    (m2 + log2 l)·ln 2``."""
    d = q.shape[-1]
    kn = 64 if d <= 64 else 32
    qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
    scale2 = math.log2(math.e) / math.sqrt(d)
    s_all = _product(qh, kh.transpose(-1, -2), products)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1])
        kpos = torch.arange(k.shape[1])
        s_all = s_all.masked_fill(kpos[None, :] > qpos[:, None],
                                  float("-inf"))
    m2 = torch.full(s_all.shape[:-1], float("-inf"))
    lsum = torch.zeros(s_all.shape[:-1])
    o = torch.zeros(s_all.shape[:-1] + (d,))
    for k0 in range(0, k.shape[1], kn):
        s = s_all[..., k0:k0 + kn]
        m_new = torch.maximum(m2, s.amax(-1) * scale2)
        m_use = torch.where(torch.isfinite(m_new), m_new,
                            torch.zeros_like(m_new))
        corr = torch.exp2(m2 - m_use)
        p = torch.exp2(s * scale2 - m_use[..., None])
        lsum = lsum * corr + p.sum(-1)
        o = o * corr[..., None] + _product(p, vh[..., k0:k0 + kn, :],
                                           products)
        m2 = m_new
    out = o / lsum.clamp_min(1e-20)[..., None]
    lse = torch.where(lsum > 0, (m2 + torch.log2(lsum)) * math.log(2.0),
                      torch.full_like(lsum, float("-inf")))
    return out.transpose(1, 2), lse


def _inputs(b, t, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def _jax(q, k, v, causal, q_offset):
    f = jax.vmap(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, q_offset=q_offset, interpret=True,
        return_lse=True))
    out, lse = f(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), np.asarray(lse)


def _errors(case, products, seed=20):
    b, t, h, d, causal, qo = case
    q, k, v = _inputs(b, t, h, d, seed)
    want, want_lse = _jax(q, k, v, causal, qo)
    got, got_lse = _piece_kernel_forward(
        *(torch.from_numpy(x) for x in (q, k, v)), causal, qo, products)
    err = np.abs(got.numpy() - want)
    return err, want, np.abs(got_lse.numpy() - want_lse)


def test_split_is_exact():
    """hi + lo is x bit for bit, hi is a TF32 value, and |lo| < 2^-10 |x|
    (the bound the three products' error rests on)."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy((rng.standard_normal(4096)
                          * np.exp(rng.uniform(-20, 20, 4096)))
                         .astype(np.float32))
    hi, lo = _split(x)
    assert torch.equal(hi + lo, x)
    assert not (hi.view(torch.int32) & 8191).any()
    assert bool((lo.abs() < 2.0 ** -10 * x.abs()).all())


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_three_tf32_products_match_jax(case):
    """out within FLASH_TOL["float32"] and lse within LSE_ATOL of the JAX
    package's kernel, the bounds chip_smoke.py holds the card's f32 K2
    to."""
    err, want, lse_err = _errors(case, products=3)
    assert np.all(err <= ATOL + RTOL * np.abs(want)), err.max()
    assert lse_err.max() <= SMOKE.LSE_ATOL, lse_err.max()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_tf32_product_misses_the_f32_tolerance(case):
    """A single TF32 product (about three decimal digits) does not hold
    to the f32 tolerance at any of these shapes: the second and third
    products are what make the route an f32 one."""
    err, want, _ = _errors(case, products=1)
    assert not np.all(err <= ATOL + RTOL * np.abs(want)), err.max()


def _piece_kernel_backward(q, k, v, g, out, lse, g_lse, causal, q_offset,
                           products=3):
    """(dq, dk, dv), all (B, T, H, D), of the backward piece kernels'
    arithmetic on the forward's saved out and lse: delta = rowsum(dO ∘
    out) less the lse cotangent; s and dp from TF32 products; p =
    exp2(s·scale·log2e − lse·log2e), 0 where masked or lse = −inf; ds =
    p·(dp − delta)·scale; p and ds split in registers, and dq = ds·k, dk
    = dsᵀ·q, dv = pᵀ·dO from TF32 products."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    log2e = math.log2(math.e)
    qh, kh, vh, gh, oh = (x.permute(0, 2, 1, 3) for x in (q, k, v, g, out))
    delta = (gh * oh).sum(-1) - g_lse
    s = _product(qh, kh.transpose(-1, -2), products)
    dp = _product(gh, vh.transpose(-1, -2), products)
    live = torch.isfinite(lse)[..., None].expand(s.shape)
    if causal:
        qpos = q_offset + torch.arange(q.shape[1])
        live = live & (torch.arange(k.shape[1])[None, :] <= qpos[:, None])
    lse2 = torch.where(torch.isfinite(lse), lse * log2e,
                       torch.full_like(lse, float("inf")))
    p = torch.where(live, torch.exp2(s * (scale * log2e) - lse2[..., None]),
                    torch.zeros_like(s))
    ds = p * (dp - delta[..., None]) * scale
    dq = _product(ds, kh, products)
    dk = _product(ds.transpose(-1, -2), qh, products)
    dv = _product(p.transpose(-1, -2), gh, products)
    return tuple(x.transpose(1, 2) for x in (dq, dk, dv))


def _jax_grads(q, k, v, g, g_lse, causal, q_offset):
    f = jax.vmap(lambda q, k, v: jax_flash(
        q, k, v, causal=causal, q_offset=q_offset, interpret=True,
        return_lse=True))
    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return tuple(np.asarray(x) for x in vjp((jnp.asarray(g),
                                             jnp.asarray(g_lse))))


def _bwd_errors(case, products, seed=22):
    """|emulated - JAX| / max(max |JAX|, 1) of dq, dk and dv: the measure
    BWD_TOL bounds on the card."""
    b, t, h, d, causal, qo = case
    q, k, v = _inputs(b, t, h, d, seed)
    rng = np.random.default_rng(seed + 1)
    g = rng.standard_normal((b, t, h, d)).astype(np.float32)
    # the ring's past block carries an lse cotangent (its merge weighs it)
    g_lse = (rng.standard_normal((b, h, t)).astype(np.float32) if qo
             else np.zeros((b, h, t), np.float32))
    want = _jax_grads(q, k, v, g, g_lse, causal, qo)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = _piece_kernel_forward(tq, tk, tv, causal, qo)
    got = _piece_kernel_backward(tq, tk, tv, torch.from_numpy(g), out, lse,
                                 torch.from_numpy(g_lse), causal, qo,
                                 products)
    return [float(np.abs(x.numpy() - w).max() / max(np.abs(w).max(), 1.0))
            for x, w in zip(got, want)]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_three_tf32_products_backward_match_jax(case):
    """dq, dk and dv of the backward piece kernels' arithmetic within
    BWD_TOL["float32"] of jax.vjp of the JAX package's kernel, the bound
    chip_smoke.py holds the card's f32 K3 and K4 to."""
    errs = _bwd_errors(case, products=3)
    assert max(errs) <= BWD_TOL, errs


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_tf32_product_backward_misses_the_f32_tolerance(case):
    """One TF32 product a product misses BWD_TOL["float32"] in some
    gradient at every one of these shapes."""
    errs = _bwd_errors(case, products=1)
    assert max(errs) > BWD_TOL, errs
