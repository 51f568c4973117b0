"""LayerNorm as flax's ``nn.LayerNorm`` computes it: statistics in f32 in
one pass (the *fast* variance ``E[x²] − E[x]²``, clipped at 0), eps added
inside the square root, the f32 scale and bias applied in f32, the result
cast back to the input's dtype.

No TPU kernel stands behind it: on the TPU, XLA fuses flax's LayerNorm
into the ops around it.  The port ran :func:`layer_norm_reference`, the
expression written as PyTorch ops, whose dozen forward and two dozen
backward kernels each move the whole activation in f32; at ViT's training
shape they took more device time than anything else in the step.  For
tensors on the card the forward and the backward are hand-written CUDA
kernels (``csrc/layer_norm.cu``, built by :mod:`.._cuda`), one pass each
way, bound to autograd by :class:`_LayerNormFn`; the backward's formula is
:func:`layer_norm_backward_reference`.  A CPU tensor takes the plain
expression (and autograd's gradient of it); a CUDA tensor launches the
kernels or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}

#: the widest row the kernels take
MAX_WIDTH = 4096


def _acc(dtype: torch.dtype) -> torch.dtype:
    """The statistics' dtype: f32, or f64 for an f64 input."""
    return torch.promote_types(dtype, torch.float32)


def layer_norm_reference(x: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, eps: float = 1e-6
                         ) -> torch.Tensor:
    """Plain version of the forward kernel: flax's expression over the
    last axis."""
    xf = x.to(_acc(x.dtype))
    mu = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    mul = torch.rsqrt(var + eps) * weight.to(xf.dtype)
    return ((xf - mu) * mul + bias.to(xf.dtype)).to(x.dtype)


def layer_norm_backward_reference(x: torch.Tensor, weight: torch.Tensor,
                                  dy: torch.Tensor, eps: float = 1e-6):
    """Plain version of the backward kernel: ``(dx, dweight, dbias)`` of
    :func:`layer_norm_reference`, dx in x's dtype, the parameters'
    gradients in the statistics' dtype.

    With ``u = x − mu``, ``gw = dy · w`` and ``r = rsqrt(var + eps)``:
    ``dx = r·gw − r·Σgw / D + 2·dvar·u / D`` with ``dvar = −r³·Σ(gw·u) / 2``
    where ``E[x²] − mu² ≥ 0`` and 0 where the variance was clipped (the
    gradient of ``clamp_min``)."""
    acc = _acc(x.dtype)
    xf, g, w = x.to(acc), dy.to(acc), weight.to(acc)
    d = x.shape[-1]
    mu = xf.mean(-1, keepdim=True)
    d2 = (xf * xf).mean(-1, keepdim=True) - mu * mu
    r = torch.rsqrt(d2.clamp_min(0.0) + eps)
    u = xf - mu
    gw = g * w
    dvar = torch.where(d2 >= 0, -0.5 * r ** 3 * (gw * u).sum(-1, keepdim=True),
                       torch.zeros_like(r))
    dx = r * gw - r * gw.sum(-1, keepdim=True) / d + 2.0 * dvar * u / d
    rows = (-1, d)
    return (dx.to(x.dtype), (g * u * r).reshape(rows).sum(0),
            g.reshape(rows).sum(0))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
_ARGTYPES = {
    "nns_layer_norm_fwd": [_P] * 4 + [_LL, _I, _F, _I, _P],
    "nns_layer_norm_bwd_blocks": [_P] * 4 + [_LL, _I, _I,
                                             ctypes.POINTER(_I)],
    "nns_layer_norm_bwd": [_P] * 5 + [_I, _P, _P, _LL, _I, _F, _I, _P],
}


def _fn(symbol: str):
    lib = _cuda.library("layer_norm")
    fn = getattr(lib, symbol)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[symbol]
        fn.restype = ctypes.c_int
    return lib, fn


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor
           ) -> None:
    """What the kernels take: a CUDA tensor of f32, f16 or bf16 whose last
    axis (at most :data:`MAX_WIDTH`) the weight and bias match; the
    device is checked last."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"layer_norm: x must be one of {list(_DTYPES)}, "
                        f"got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if not 1 <= d <= MAX_WIDTH:
        raise ValueError(f"layer_norm: the last axis must have 1 to "
                         f"{MAX_WIDTH} values, got {d}")
    for name, p in (("weight", weight), ("bias", bias)):
        if tuple(p.shape) != (d,) or p.device != x.device:
            raise ValueError(f"layer_norm: {name} must be ({d},) on "
                             f"{x.device}, got {tuple(p.shape)} on "
                             f"{p.device}")
    if not x.is_cuda:
        raise ValueError(f"layer_norm: unsupported device {x.device}")


def _rows(x: torch.Tensor):
    return x.numel() // x.shape[-1], x.shape[-1]


def _launch_forward(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The forward kernel on the current stream (no sync); x contiguous,
    weight and bias contiguous f32."""
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    rows, d = _rows(x)
    lib, fn = _fn("nns_layer_norm_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                  y.data_ptr(), rows, d, eps, _DTYPES[x.dtype], stream)
    _cuda.check(lib, code, "layer_norm")
    _cuda.launches["layer_norm_fwd"] += 1
    return y


def _launch_backward(x: torch.Tensor, weight: torch.Tensor,
                     dy: torch.Tensor, eps: float):
    """The backward kernel and the parameters' partial sum on the current
    stream (no sync): ``(dx, dweight, dbias)``."""
    rows, d = _rows(x)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dw = torch.empty(d, dtype=torch.float32, device=x.device)
    db = torch.empty(d, dtype=torch.float32, device=x.device)
    if dx.numel() == 0:
        return dx, dw.zero_(), db.zero_()
    lib, grid = _fn("nns_layer_norm_bwd_blocks")
    _, fn = _fn("nns_layer_norm_bwd")
    dtype = _DTYPES[x.dtype]
    blocks = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        _cuda.check(lib, grid(x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                              dx.data_ptr(), rows, d, dtype,
                              ctypes.byref(blocks)),
                    "layer_norm backward (grid)")
        partials = torch.empty((blocks.value, 2 * d), dtype=torch.float32,
                               device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), weight.data_ptr(), dy.data_ptr(),
                  dx.data_ptr(), partials.data_ptr(), blocks.value,
                  dw.data_ptr(), db.data_ptr(), rows, d, eps, dtype, stream)
    _cuda.check(lib, code, "layer_norm backward")
    _cuda.launches["layer_norm_bwd"] += 1
    _cuda.launches["layer_norm_param_sum"] += 1
    return dx, dw, db


class _LayerNormFn(torch.autograd.Function):
    """The kernels under autograd: the forward saves x and the weight; the
    backward recomputes the row statistics from x, as the forward did."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _launch_forward(x, weight, bias, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw, db = _launch_backward(x, weight, dy.contiguous(), ctx.eps)
        return dx, dw, db, None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """flax's LayerNorm over the last axis of ``x``, with ``weight`` and
    ``bias`` applied in f32; the result in x's dtype.

    A CPU tensor takes :func:`layer_norm_reference`; a CUDA tensor of f32,
    f16 or bf16 with a last axis of at most :data:`MAX_WIDTH` launches the
    kernels on the current stream (no sync), and any other raises."""
    if x.device.type == "cpu" or (x.device.type == "meta"
                                  and _cuda.shape_only_active()):
        # the meta device: the cost counter's pass (obs/attrib.py), which
        # counts the plain expression's ops
        return layer_norm_reference(x, weight, bias, eps)
    _check(x, weight, bias)
    x = x.contiguous()
    weight, bias = weight.float().contiguous(), bias.float().contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return _LayerNormFn.apply(x, weight, bias, float(eps))
    return _launch_forward(x, weight, bias, float(eps))
