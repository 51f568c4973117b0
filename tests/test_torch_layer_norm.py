"""ViT's LayerNorm (ops/layer_norm.py) on the CPU: the backward kernel's
formula against autograd of flax's expression, the CPU path, and what the
kernel wrapper refuses.  The kernels themselves run in
tests/test_torch_cuda.py, on the card."""

import os
import re

import numpy as np
import pytest
import torch

from nnstreamer_tpu_torch import _cuda
from nnstreamer_tpu_torch.models.vit import _LayerNorm
from nnstreamer_tpu_torch.ops import layer_norm as ln_mod
from nnstreamer_tpu_torch.ops.layer_norm import (
    layer_norm, layer_norm_backward_reference, layer_norm_reference)


def _inputs(rows, d, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.from_numpy(rng.standard_normal(s))  # noqa: E731
    x = mk(rows, d) * 2.0 + 0.5
    return (x.to(dtype), (1.0 + 0.2 * mk(d)).to(dtype),
            (0.1 * mk(d)).to(dtype), mk(rows, d).to(dtype))


def _autograd(x, w, b, dy):
    ts = [t.clone().requires_grad_() for t in (x, w, b)]
    return torch.autograd.grad(layer_norm_reference(*ts), ts, dy)


def _clipped(x):
    mu = x.mean(-1, keepdim=True)
    return ((x * x).mean(-1, keepdim=True) - mu * mu < 0)[..., 0]


@pytest.mark.parametrize("rows,d", [(12, 64), (5, 384), (3, 100)])
def test_backward_formula_matches_autograd_in_f64(rows, d):
    x, w, b, dy = _inputs(rows, d)
    for got, want in zip(layer_norm_backward_reference(x, w, dy),
                         _autograd(x, w, b, dy)):
        torch.testing.assert_close(got, want, atol=1e-12, rtol=1e-12)


def test_backward_formula_on_clipped_rows():
    """Rows at a mean of 1e4 with a spread of 1e-5: E[x²] − E[x]² is f64
    rounding noise, below 0 on some rows, where the variance path passes
    no gradient.  The formula agrees with autograd there, and a formula
    that let the gradient through would not."""
    x, w, b, dy = _inputs(24, 64, seed=3)
    x = 1e4 + 1e-5 * x
    clipped = _clipped(x)
    assert 0 < clipped.sum() < len(x)
    dx, dw, db = layer_norm_backward_reference(x, w, dy)
    want = _autograd(x, w, b, dy)
    # autograd takes x·dvar and mu·dvar apart and subtracts them; at a
    # mean 1e9 times the spread that leaves ~1e-11 of dx's largest value
    scale = want[0].abs().max().item()
    torch.testing.assert_close(dx, want[0], atol=1e-10 * scale, rtol=1e-9)
    torch.testing.assert_close(dw, want[1], atol=1e-12, rtol=1e-9)
    torch.testing.assert_close(db, want[2], atol=1e-12, rtol=1e-9)
    # the clip's term on the clipped rows: -r³·Σ(gw·u)·u / D
    mu = x.mean(-1, keepdim=True)
    r = torch.rsqrt(torch.tensor(1e-6, dtype=x.dtype))
    u, gw = x - mu, dy * w
    term = -(r ** 3) * (gw * u).sum(-1, keepdim=True) * u / x.shape[-1]
    rel = term[clipped].abs().max() / want[0][clipped].abs().max()
    assert rel > 1e3 * 1e-10     # a thousand times the tolerance


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_reference_is_the_vit_expression(dtype):
    """The plain version computes what ViT's LayerNorm computed before the
    kernels, bit for bit, in every dtype the program runs."""
    x, w, b, _ = _inputs(7, 384, dtype=torch.float32)
    x = x.to(dtype)
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    mul = torch.rsqrt(var + 1e-6) * w.float()
    want = ((xf - mu) * mul + b.float()).to(x.dtype)
    assert torch.equal(layer_norm_reference(x, w, b, 1e-6), want)


def _no_kernels(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a kernel wrapper ran on the CPU")

    for name in ("_launch_forward", "_launch_backward", "_check"):
        monkeypatch.setattr(ln_mod, name, refuse)
    monkeypatch.setattr(_cuda, "library", refuse)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cpu_layer_norm_never_calls_the_kernels(monkeypatch, dtype):
    """ViT's LayerNorm on a CPU tensor is the plain expression, forward
    and (autograd's) backward, and touches no kernel wrapper."""
    _no_kernels(monkeypatch)
    x, w, b, dy = _inputs(9, 64, dtype=torch.float32)
    ln = _LayerNorm(64)
    with torch.no_grad():
        ln.weight.copy_(w)
        ln.bias.copy_(b)
    xs = x.to(dtype).requires_grad_()
    y = ln(xs)
    assert torch.equal(y, layer_norm_reference(xs.detach(), w, b, 1e-6))
    got = torch.autograd.grad(y, (xs, ln.weight, ln.bias), dy.to(dtype))
    want = _autograd(x.to(dtype), w, b, dy.to(dtype))
    for g, wt in zip(got, want):
        assert torch.equal(g, wt)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("x,w,error,match", [
    (_meta(4, 8, dtype=torch.float64), _meta(8), TypeError, "float64"),
    (_meta(2, 5000), _meta(5000), ValueError, "4096"),
    (_meta(4, 8), _meta(7), ValueError, "weight"),
    (_meta(4, 8), _meta(8), ValueError, "unsupported device"),
], ids=["dtype", "width", "weight", "device"])
def test_wrapper_refuses_without_fallback(monkeypatch, x, w, error, match):
    """Off the CPU the wrapper checks what the kernels take and raises:
    the plain version is never taken instead.  (A meta tensor outside the
    cost counter's pass stands in for a CUDA tensor here: the checks come
    before anything touches the device.)"""
    def refuse(*args, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(ln_mod, "layer_norm_reference", refuse)
    with pytest.raises(error, match=match):
        layer_norm(x, w, w)


def test_cost_counter_pass_takes_the_plain_expression():
    """Under the cost counter's shape-only pass a meta tensor takes the
    plain expression: shapes out, nothing launched."""
    x, w = _meta(2, 17, 64, dtype=torch.bfloat16), _meta(64)
    with _cuda.shape_only():
        y = layer_norm(x, w, w)
    assert y.shape == x.shape and y.dtype == x.dtype


def test_kernel_entry_points_match_the_wrapper():
    """The source is registered for the build, and each C entry point the
    wrapper binds has as many parameters as its ctypes signature."""
    assert _cuda.SOURCES["layer_norm"] == "layer_norm.cu"
    with open(os.path.join(_cuda.CSRC, "layer_norm.cu")) as f:
        src = f.read()
    entries = dict(re.findall(r'extern "C" int (\w+)\(([^)]*)\)', src))
    assert set(ln_mod._ARGTYPES) <= set(entries)
    for name, argtypes in ln_mod._ARGTYPES.items():
        assert len(entries[name].split(",")) == len(argtypes), name


def test_chip_smoke_checks_the_kernels_at_the_paths_shapes():
    """chip_smoke.py holds the kernels to the plain expression at ViT-S's
    training batch and a served frame, and bounds their time by the same
    least bytes as the benchmark's ``ln_roofline_pct.train``, counted here
    by hand at (32 x 197, 384) bf16."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_ln", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert [r[1:] for r in smoke.LN_ROWS] == [(6304, 384, "bfloat16"),
                                              (197, 384, "bfloat16")]
    act = 6304 * 384 * 2
    assert smoke.ln_bytes(6304, 384, 2) == (9_686_016, 14_529_024)
    assert smoke.ln_bytes(6304, 384, 2) == (2 * act + 2 * 384 * 4,
                                            3 * act + 3 * 384 * 4)
