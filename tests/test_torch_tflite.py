"""The port's TFLite lowering against the JAX package's, on the CPU.

- the synthetic quantized graphs of ``tests/test_tflite_quant_native.py``
  (uint8 asymmetric activations, uint8 per-tensor and int8 per-channel
  weights, SAME padding with a non-zero zero-point, strides, bias, fused
  activations, fully-connected, chains, residency, the residual ADD,
  weight-only) through both packages' ``_Lowerer`` in float emulation,
  native int8 and w8: the quantized outputs EQUAL;
- the native products' int32 accumulators bit-equal to the JAX
  package's ``lax`` products (``preferred_element_type=int32``) with the
  same zero-point corrections, through every route (``int_mm`` with row,
  column and depth padding, ``f32``, ``f64``);
- single-op float graphs of the builtins (resize grids, transpose conv,
  strided slices, pads, pools, reductions, shape ops, activations)
  within ``F32_ATOL``, per frame and batched;
- every unsupported op refused with the same message.
"""

import numpy as np
import pytest
import torch

from nnstreamer_tpu.filter.backends import tflite as J
from nnstreamer_tpu.utils import flatbuf as jfb
from nnstreamer_tpu_torch.filter.backends import tflite as P
from nnstreamer_tpu_torch.utils import flatbuf as pfb

F32_ATOL = 1e-5


def _opts(fb, fields):
    if fields is None:
        return None
    b = fb.Builder()
    b.start_table()
    for idx, (typ, val) in fields.items():
        if typ == "int32_vec":
            continue
        b.add_scalar(idx, typ, val)
    vecs = {idx: val for idx, (typ, val) in fields.items()
            if typ == "int32_vec"}
    if vecs:
        # a table with vectors: rebuild with offsets first
        b = fb.Builder()
        offs = {idx: b.scalar_vector("int32", val) for idx, val in
                vecs.items()}
        b.start_table()
        for idx, (typ, val) in fields.items():
            if typ == "int32_vec":
                b.add_offset(idx, offs[idx])
            else:
                b.add_scalar(idx, typ, val)
    return fb.root(b.finish(b.end_table()))


def _graph(mod, fb, tensors, inputs, outputs, ops, buffers):
    """``tensors``: (shape, dtype, buffer, scale, zp, qdim); ``ops``:
    (code, inputs, outputs, option fields or None, custom_code)."""
    specs = []
    for shape, dtype, buffer, scale, zp, qdim in tensors:
        spec = mod._TSpec(shape=tuple(shape), np_dtype=dtype, buffer=buffer,
                          name="")
        if scale is not None:
            spec.scale = np.asarray(scale, np.float32).ravel()
            spec.zero_point = np.asarray(zp, np.int64).ravel()
            spec.qdim = qdim
        specs.append(spec)
    return mod._Graph(
        tensors=specs, inputs=list(inputs), outputs=list(outputs),
        ops=[mod._Op(code=c, custom_code=cc, inputs=list(i),
                     outputs=list(o), options=_opts(fb, f))
             for c, i, o, f, cc in ops],
        buffers=list(buffers))


def _both(spec):
    return (_graph(J, jfb, *spec), _graph(P, pfb, *spec))


def _q(shape, dtype, buffer, scale, zp, qdim=0):
    return (shape, dtype, buffer, scale, zp, qdim)


def _f(shape, buffer=0, dtype=np.float32):
    return (shape, dtype, buffer, None, None, 0)


CONV_OPTS = {1: ("int32", 1), 2: ("int32", 1)}


def _quant_graphs():
    """name -> (spec, input) for the quant-native suite's graphs."""
    out = {}
    rng = np.random.default_rng(0)
    w = rng.integers(0, 256, (5, 3, 3, 4), dtype=np.uint8)
    bias = rng.integers(-400, 400, (5,), dtype=np.int32)
    out["conv_uint8_same_asym"] = ((
        [_q((1, 6, 6, 4), np.uint8, 0, [0.05], [3]),
         _q((5, 3, 3, 4), np.uint8, 1, [0.02], [131]),
         _q((5,), np.int32, 2, [0.001], [0]),
         _q((1, 6, 6, 5), np.uint8, 0, [0.11], [100])],
        [0], [3], [(3, [0, 1, 2], [3], CONV_OPTS, None)],
        [b"", w.tobytes(), bias.tobytes()]),
        rng.integers(0, 256, (1, 6, 6, 4), dtype=np.uint8))
    rng = np.random.default_rng(1)
    w = rng.integers(-128, 128, (6, 3, 3, 4), dtype=np.int8)
    bias = rng.integers(-300, 300, (6,), dtype=np.int32)
    out["conv_int8_per_channel_s2_relu6"] = ((
        [_q((1, 8, 8, 4), np.int8, 0, [0.04], [-5]),
         _q((6, 3, 3, 4), np.int8, 1, 0.01 + 0.01 * np.arange(6), [0] * 6),
         _q((6,), np.int32, 2, 0.04 * (0.01 + 0.01 * np.arange(6)),
            [0] * 6),
         _q((1, 4, 4, 6), np.int8, 0, [0.03], [-128])],
        [0], [3], [(3, [0, 1, 2], [3], {1: ("int32", 2), 2: ("int32", 2),
                                         3: ("int32", 3)}, None)],
        [b"", w.tobytes(), bias.tobytes()]),
        rng.integers(-128, 128, (1, 8, 8, 4), dtype=np.int8))
    rng = np.random.default_rng(2)
    w = rng.integers(0, 256, (1, 3, 3, 4), dtype=np.uint8)
    bias = rng.integers(-200, 200, (4,), dtype=np.int32)
    out["depthwise_uint8_s2"] = ((
        [_q((1, 7, 7, 4), np.uint8, 0, [0.06], [121]),
         _q((1, 3, 3, 4), np.uint8, 1, [0.015], [140], qdim=3),
         _q((4,), np.int32, 2, [0.0009], [0]),
         _q((1, 4, 4, 4), np.uint8, 0, [0.09], [110])],
        [0], [3], [(4, [0, 1, 2], [3], {1: ("int32", 2), 2: ("int32", 2)},
                    None)],
        [b"", w.tobytes(), bias.tobytes()]),
        rng.integers(0, 256, (1, 7, 7, 4), dtype=np.uint8))
    rng = np.random.default_rng(3)
    w = rng.integers(0, 256, (6, 16), dtype=np.uint8)
    bias = rng.integers(-500, 500, (6,), dtype=np.int32)
    out["fully_connected_uint8"] = ((
        [_q((1, 16), np.uint8, 0, [0.05], [7]),
         _q((6, 16), np.uint8, 1, [0.02], [125]),
         _q((6,), np.int32, 2, [0.001], [0]),
         _q((1, 6), np.uint8, 0, [0.2], [128])],
        [0], [3], [(9, [0, 1, 2], [3], {}, None)],
        [b"", w.tobytes(), bias.tobytes()]),
        rng.integers(0, 256, (1, 16), dtype=np.uint8))
    rng = np.random.default_rng(4)
    w1 = rng.integers(0, 256, (4, 3, 3, 3), dtype=np.uint8)
    w2 = rng.integers(0, 256, (1, 3, 3, 4), dtype=np.uint8)
    out["chain_conv_dw"] = ((
        [_q((1, 6, 6, 3), np.uint8, 0, [0.05], [128]),
         _q((4, 3, 3, 3), np.uint8, 1, [0.02], [128]),
         _q((1, 6, 6, 4), np.uint8, 0, [0.1], [128]),
         _q((1, 3, 3, 4), np.uint8, 2, [0.03], [120], qdim=3),
         _q((1, 6, 6, 4), np.uint8, 0, [0.2], [128])],
        [0], [4], [(3, [0, 1, -1], [2], CONV_OPTS, None),
                   (4, [2, 3, -1], [4], CONV_OPTS, None)],
        [b"", w1.tobytes(), w2.tobytes()]),
        rng.integers(0, 256, (1, 6, 6, 3), dtype=np.uint8))
    rng = np.random.default_rng(8)
    w1 = rng.integers(0, 256, (4, 1, 1, 3), dtype=np.uint8)
    w2 = rng.integers(0, 256, (4, 1, 1, 4), dtype=np.uint8)
    w3 = rng.integers(0, 256, (2, 1, 1, 4), dtype=np.uint8)
    out["residual_add"] = ((
        [_q((1, 4, 4, 3), np.uint8, 0, [0.05], [128]),
         _q((4, 1, 1, 3), np.uint8, 1, [0.02], [128]),
         _q((1, 4, 4, 4), np.uint8, 0, [0.1], [128]),
         _q((4, 1, 1, 4), np.uint8, 2, [0.03], [130]),
         _q((1, 4, 4, 4), np.uint8, 0, [0.15], [126]),
         _q((1, 4, 4, 4), np.uint8, 0, [0.2], [127]),
         _q((2, 1, 1, 4), np.uint8, 3, [0.04], [125]),
         _q((1, 4, 4, 2), np.uint8, 0, [0.3], [128])],
        [0], [7], [(3, [0, 1, -1], [2], CONV_OPTS, None),
                   (3, [2, 3, -1], [4], CONV_OPTS, None),
                   (0, [2, 4], [5], {}, None),
                   (3, [5, 6, -1], [7], CONV_OPTS, None)],
        [b"", w1.tobytes(), w2.tobytes(), w3.tobytes()]),
        rng.integers(0, 256, (1, 4, 4, 3), dtype=np.uint8))
    rng = np.random.default_rng(5)
    w1 = rng.integers(0, 256, (4, 3, 3, 3), dtype=np.uint8)
    shape = np.asarray([1, 36, 4], np.int32)
    out["float_consumer_breaks_residency"] = ((
        [_q((1, 6, 6, 3), np.uint8, 0, [0.05], [128]),
         _q((4, 3, 3, 3), np.uint8, 1, [0.02], [128]),
         _q((1, 6, 6, 4), np.uint8, 0, [0.1], [128]),
         _q((1, 36, 4), np.uint8, 0, [0.1], [128]),
         _f((3,), 2, np.int32)],
        [0], [3], [(3, [0, 1, -1], [2], CONV_OPTS, None),
                   (22, [2, 4], [3], None, None)],
        [b"", w1.tobytes(), shape.tobytes()]),
        rng.integers(0, 256, (1, 6, 6, 3), dtype=np.uint8))
    rng = np.random.default_rng(6)
    w1 = rng.integers(0, 256, (4, 3, 3, 3), dtype=np.uint8)
    out["fused_relu_keeps_float_exit"] = ((
        [_q((1, 6, 6, 3), np.uint8, 0, [0.05], [128]),
         _q((4, 3, 3, 3), np.uint8, 1, [0.02], [128]),
         _q((1, 6, 6, 4), np.uint8, 0, [0.1], [0])],
        [0], [2], [(3, [0, 1, -1], [2], {1: ("int32", 1), 2: ("int32", 1),
                                          3: ("int32", 1)}, None)],
        [b"", w1.tobytes()]),
        rng.integers(0, 256, (1, 6, 6, 3), dtype=np.uint8))
    rng = np.random.default_rng(7)
    w = rng.integers(-127, 128, (5, 3, 3, 4), dtype=np.int8)
    bias = rng.integers(-400, 400, (5,), dtype=np.int32)
    out["per_channel_weight_only"] = ((
        [_q((1, 6, 6, 4), np.uint8, 0, [0.05], [3]),
         _q((5, 3, 3, 4), np.int8, 1, [0.02, 0.03, 0.01, 0.04, 0.05],
            [0] * 5),
         _q((5,), np.int32, 2, [0.001], [0]),
         _q((1, 6, 6, 5), np.uint8, 0, [0.11], [100])],
        [0], [3], [(3, [0, 1, 2], [3], CONV_OPTS, None)],
        [b"", w.tobytes(), bias.tobytes()]),
        rng.integers(0, 256, (1, 6, 6, 4), dtype=np.uint8))
    return out


QUANT = _quant_graphs()
MODES = {"emulation": {}, "int8": {"quant_native": True},
         "w8": {"weight_only": True}}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("name", sorted(QUANT))
def test_quant_graphs_equal_jax(name, mode):
    spec, x = QUANT[name]
    gj, gp = _both(spec)
    lj = J._Lowerer(gj, **MODES[mode])
    lp = P._Lowerer(gp, **MODES[mode])
    assert lp._qres == lj._qres
    assert {k["kind"] for k in lp._nq.values()} == \
        {k["kind"] for k in lj._nq.values()}
    want = np.asarray(lj.forward(lj.params, x)[0])
    got = lp.forward(torch.as_tensor(x))[0].numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # a batch of three frames: each row equals its own frame
    xb = np.concatenate([x, 255 - x if x.dtype == np.uint8 else -x - 1, x])
    rows = lp.batched(torch.as_tensor(xb.reshape((3,) + x.shape)))[0]
    np.testing.assert_array_equal(rows[0].numpy(), got)
    np.testing.assert_array_equal(rows[2].numpy(), got)


def test_residency_sets_match_the_suite():
    gj, gp = _both(QUANT["residual_add"][0])
    assert P._Lowerer(gp, quant_native=True)._qres == {0, 2, 4, 5, 7}
    gj, gp = _both(QUANT["chain_conv_dw"][0])
    assert P._Lowerer(gp, quant_native=True)._qres == {0, 2, 4}
    gj, gp = _both(QUANT["float_consumer_breaks_residency"][0])
    lo = P._Lowerer(gp, quant_native=True)
    assert 2 not in lo._qres and 0 in lo._qres


def test_weight_only_keeps_int8_resident():
    spec, x = QUANT["per_channel_weight_only"]
    _, gp = _both(spec)
    lo = P._Lowerer(gp, weight_only=True)
    packed = [v for v in lo.tparams.values() if v.dtype == torch.int8]
    assert lo._wo and packed and packed[0].numel() == 5 * 3 * 3 * 4


# -- accumulators ------------------------------------------------------------

def _jax_accumulator(kind, a, w8, stride, dil, pad_code, a0, b0, colsum,
                     k_acc):
    """The JAX package's native accumulation (``_run_native_quant``):
    lax products with int32 accumulation and the same corrections."""
    import jax.numpy as jnp
    from jax import lax

    if kind == "fc":
        acc = lax.dot_general(jnp.asarray(a), jnp.asarray(w8),
                              (((1,), (1,)), ((), ())),
                              preferred_element_type=jnp.int32)
        winsum = jnp.sum(jnp.asarray(a).astype(jnp.int32), -1,
                         keepdims=True) if b0 else 0
    else:
        kh, kw = w8.shape[1], w8.shape[2]
        ap = J._pad_quant(jnp.asarray(a), pad_code, (kh, kw), stride, dil,
                          a0)
        if kind == "conv":
            rhs, dn, groups = jnp.asarray(w8), ("NHWC", "OHWI", "NHWC"), 1
            ones = jnp.ones((1,) + tuple(w8.shape[1:]), jnp.int8)
        else:
            och = w8.shape[3]
            rhs = jnp.asarray(w8).reshape(kh, kw, 1, och)
            dn, groups = ("NHWC", "HWIO", "NHWC"), a.shape[-1]
            ones = jnp.ones((kh, kw, 1, och), jnp.int8)
        acc = lax.conv_general_dilated(
            ap, rhs, window_strides=stride, padding="VALID",
            rhs_dilation=dil, dimension_numbers=dn,
            feature_group_count=groups, preferred_element_type=jnp.int32)
        winsum = lax.conv_general_dilated(
            ap, ones, window_strides=stride, padding="VALID",
            rhs_dilation=dil, dimension_numbers=dn,
            feature_group_count=groups,
            preferred_element_type=jnp.int32) if b0 else 0
    acc = acc - b0 * winsum - a0 * jnp.asarray(colsum) + a0 * b0 * k_acc
    return np.asarray(acc)


#: (kind, x shape, w shape, stride, pad, route): every route, with the
#: int_mm padding of rows (m <= 16), depth (k % 8) and columns (n % 8)
ACC_CASES = [
    ("conv", (2, 9, 9, 3), (8, 3, 3, 3), (2, 2), 0, "f32"),
    ("conv", (1, 6, 6, 8), (5, 3, 3, 8), (1, 1), 0, "f64"),
    ("conv", (1, 2, 2, 12), (5, 1, 1, 12), (1, 1), 0, "int_mm"),
    ("conv", (3, 8, 8, 16), (24, 1, 1, 16), (2, 2), 0, "int_mm"),
    ("dw", (2, 7, 7, 6), (1, 3, 3, 6), (2, 2), 0, "f32"),
    ("dw", (1, 5, 5, 4), (1, 3, 3, 4), (1, 1), 1, "f32"),
    ("fc", (1, 20), (1001, 20), (1, 1), 1, "int_mm"),
    ("fc", (32, 1280), (16, 1280), (1, 1), 1, "int_mm"),
]


@pytest.mark.parametrize("uint8_w", [False, True])
@pytest.mark.parametrize("case", range(len(ACC_CASES)))
def test_accumulators_bit_equal_jax(case, uint8_w):
    kind, xs, ws, stride, pad, route = ACC_CASES[case]
    rng = np.random.default_rng(case)
    a = rng.integers(-128, 128, xs, dtype=np.int8)
    w_raw = rng.integers(0, 256, ws).astype(np.uint8 if uint8_w
                                            else np.int8) \
        if uint8_w else rng.integers(-128, 128, ws, dtype=np.int8)
    a0 = int(rng.integers(-100, 100))
    shift_w = 128 if uint8_w else 0
    zp_w = 140 if uint8_w else 0
    w8 = (w_raw.astype(np.int32) - shift_w).astype(np.int8)
    b0 = zp_w - shift_w
    if kind == "conv":
        colsum = w8.astype(np.int64).sum(axis=(1, 2, 3)).astype(np.int32)
        k_acc = int(np.prod(w8.shape[1:]))
    elif kind == "dw":
        colsum = w8.astype(np.int64).sum(axis=(0, 1, 2)).astype(np.int32)
        k_acc = int(np.prod(w8.shape[1:3]))
    else:
        colsum = w8.astype(np.int64).sum(axis=1).astype(np.int32)
        k_acc = int(w8.shape[1])
    want = _jax_accumulator(kind, a, w8, stride, (1, 1), pad, a0, b0,
                            colsum, k_acc)
    # one op through the port's lowerer with the same weights
    code = {"conv": 3, "dw": 4, "fc": 9}[kind]
    opts = ({} if kind == "fc" else
            {0: ("int32", pad), 1: ("int32", stride[1]),
             2: ("int32", stride[0])})
    out_shape = (1,) + tuple(want.shape[1:])
    spec = ([_q((1,) + xs[1:], np.int8, 0, [0.1], [a0]),
             _q(ws, w_raw.dtype, 1, [0.02], [zp_w]),
             _q(out_shape, np.int8, 0, [0.5], [0])],
            [0], [2], [(code, [0, 1, -1], [2], opts, None)],
            [b"", w_raw.tobytes()])
    _, gp = _both(spec)
    lo = P._Lowerer(gp, quant_native=True)
    (op,) = gp.ops
    meta = lo._nq[id(op)]
    assert meta["route"] == route
    e = xs[0]
    got = lo._accumulate(op, torch.as_tensor(a).reshape((e, 1) + xs[1:])
                         if kind != "fc" else torch.as_tensor(a)
                         .reshape(e, 1, xs[1]), a0, meta)
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


def test_exact_f32_leaves_the_tf32_flag_as_it_was():
    was = torch.backends.cudnn.allow_tf32
    for x in (torch.zeros(1), torch.zeros(1, dtype=torch.float64)):
        with P._exact_f32(x):
            assert torch.backends.cudnn.allow_tf32 == was
    assert torch.backends.cudnn.allow_tf32 == was


# -- builtins -----------------------------------------------------------------

def _single(code, in_shapes, out_shape, opts=None, consts=(), statics=(),
            out_dtype=np.float32):
    """A one-op float graph: ``in_shapes`` activations, then constant
    operands ``consts`` (arrays), the output last."""
    tensors, buffers, ins = [], [b""], []
    for s in in_shapes:
        tensors.append(_f(s))
        ins.append(len(tensors) - 1)
    for arr in consts:
        if arr is None:
            ins.append(-1)
            continue
        arr = np.asarray(arr)
        buffers.append(arr.tobytes())
        tensors.append(_f(arr.shape, len(buffers) - 1, arr.dtype))
        ins.append(len(tensors) - 1)
    tensors.append(_f(out_shape, 0, out_dtype))
    out = len(tensors) - 1
    order = list(statics) if statics else ins
    return (tensors, list(range(len(in_shapes))), [out],
            [(code, order, [out], opts, None)], buffers)


def _resize_case(method, align, half):
    code = 23 if method == "bilinear" else 97
    ac, hp = (2, 3) if method == "bilinear" else (0, 1)
    opts = {ac: ("bool", align), hp: ("bool", half)}
    opts = {k: v for k, v in opts.items() if v[1]}
    return _single(code, [(1, 5, 7, 2)], (1, 9, 4, 2), opts or None,
                   consts=[np.asarray([9, 4], np.int32)])


BUILTINS = {
    "resize_bilinear_legacy": _resize_case("bilinear", False, False),
    "resize_bilinear_half": _resize_case("bilinear", False, True),
    "resize_bilinear_align": _resize_case("bilinear", True, False),
    "resize_nearest_legacy": _resize_case("nearest", False, False),
    "resize_nearest_half": _resize_case("nearest", False, True),
    "resize_nearest_align_half": _resize_case("nearest", True, True),
    "transpose_conv_same_s2": _single(
        67, [(1, 4, 4, 3)], (1, 8, 8, 5),
        {0: ("int32", 0), 1: ("int32", 2), 2: ("int32", 2)},
        consts=[np.asarray([1, 8, 8, 5], np.int32),
                np.random.default_rng(1).normal(size=(5, 3, 3, 3))
                .astype(np.float32)],
        statics=[1, 2, 0]),
    "transpose_conv_valid_s2": _single(
        67, [(1, 3, 3, 2)], (1, 7, 7, 4),
        {0: ("int32", 1), 1: ("int32", 2), 2: ("int32", 2)},
        consts=[np.asarray([1, 7, 7, 4], np.int32),
                np.random.default_rng(2).normal(size=(4, 3, 3, 2))
                .astype(np.float32)],
        statics=[1, 2, 0]),
    "strided_slice_shrink_negative": _single(
        45, [(2, 6, 5)], (5, 3),
        {4: ("int32", 1)},
        consts=[np.asarray([1, -1, 0], np.int32),
                np.asarray([2, 0, 5], np.int32),
                np.asarray([1, -2, 2], np.int32)]),
    "pad": _single(34, [(1, 3, 3, 2)], (1, 5, 4, 2),
                   consts=[np.asarray([[0, 0], [1, 1], [0, 1], [0, 0]],
                                      np.int32)]),
    "padv2": _single(60, [(1, 3, 3, 2)], (1, 5, 4, 2),
                     consts=[np.asarray([[0, 0], [1, 1], [0, 1], [0, 0]],
                                        np.int32),
                             np.asarray([1.5], np.float32)]),
    "avg_pool_same": _single(1, [(1, 5, 5, 3)], (1, 3, 3, 3),
                             {0: ("int32", 0), 1: ("int32", 2),
                              2: ("int32", 2), 3: ("int32", 3),
                              4: ("int32", 3)}),
    "max_pool_same": _single(17, [(1, 5, 5, 3)], (1, 3, 3, 3),
                             {0: ("int32", 0), 1: ("int32", 2),
                              2: ("int32", 2), 3: ("int32", 2),
                              4: ("int32", 2)}),
    "mean_keep": _single(40, [(1, 4, 4, 3)], (1, 1, 1, 3),
                         {0: ("bool", True)},
                         consts=[np.asarray([1, 2], np.int32)]),
    "sum": _single(74, [(2, 4, 3)], (2, 3),
                   consts=[np.asarray([1], np.int32)]),
    "reduce_max": _single(82, [(2, 4, 3)], (4, 3),
                          consts=[np.asarray([0], np.int32)]),
    "concat": _single(2, [(1, 2, 3), (1, 2, 4)], (1, 2, 7),
                      {0: ("int32", 2)}),
    "gather": _single(36, [(5, 3)], (2, 2, 3), None,
                      consts=[np.asarray([[4, 0], [1, 1]], np.int32)]),
    "split": _single(49, [(2, 6)], (2, 3), {0: ("int32", 2)},
                     consts=[np.asarray([1], np.int32)], statics=[1, 0]),
    "pack": _single(83, [(2, 3), (2, 3)], (2, 2, 3), {0: ("int32", 2),
                                                       1: ("int32", 1)}),
    "space_to_depth": _single(26, [(1, 4, 4, 2)], (1, 2, 2, 8),
                              {0: ("int32", 2)}),
    "depth_to_space": _single(5, [(1, 2, 2, 8)], (1, 4, 4, 2),
                              {0: ("int32", 2)}),
    "hard_swish": _single(117, [(2, 7)], (2, 7)),
    "leaky_relu": _single(98, [(2, 7)], (2, 7), {0: ("float32", 0.2)}),
    "prelu": _single(54, [(2, 7)], (2, 7),
                     consts=[np.full((7,), 0.3, np.float32)]),
    "softmax_beta": _single(25, [(2, 7)], (2, 7), {0: ("float32", 2.0)}),
    "log_softmax": _single(50, [(2, 7)], (2, 7)),
    "squared_difference": _single(99, [(2, 7), (2, 7)], (2, 7)),
    "expand_dims": _single(70, [(2, 7)], (2, 1, 7),
                           consts=[np.asarray([1], np.int32)]),
    "squeeze": _single(43, [(2, 1, 7)], (2, 7),
                       {0: ("int32_vec", [1])}),
    "transpose": _single(39, [(2, 3, 4)], (4, 2, 3),
                         consts=[np.asarray([2, 0, 1], np.int32)]),
    "slice": _single(65, [(4, 5)], (2, 3),
                     consts=[np.asarray([1, 2], np.int32),
                             np.asarray([2, -1], np.int32)]),
    "rsqrt_abs": _single(76, [(2, 7)], (2, 7)),
    "fc_keep_dims": _single(9, [(2, 3, 6)], (2, 3, 4),
                            {2: ("bool", True)},
                            consts=[np.random.default_rng(3).normal(
                                size=(4, 6)).astype(np.float32), None]),
}


def _inputs(spec, seed, batch=None):
    tensors, inputs = spec[0], spec[1]
    rng = np.random.default_rng(seed)
    lead = () if batch is None else (batch,)
    return [(rng.random(lead + tuple(tensors[i][0])) + 0.1)
            .astype(np.float32) for i in inputs]


@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_builtins_match_jax(name):
    spec = BUILTINS[name]
    gj, gp = _both(spec)
    lj, lp = J._Lowerer(gj), P._Lowerer(gp)
    xs = _inputs(spec, 11)
    want = [np.asarray(o) for o in lj.forward(lj.params, *xs)]
    got = [o.numpy() for o in lp.forward(*[torch.as_tensor(x) for x in xs])]
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=F32_ATOL)
    xb = _inputs(spec, 12, batch=3)
    rows = lp.batched(*[torch.as_tensor(x) for x in xb])
    for i in range(3):
        one = lp.forward(*[torch.as_tensor(x[i]) for x in xb])
        for r, o in zip(rows, one):
            np.testing.assert_allclose(r[i].numpy(), o.numpy(),
                                       atol=F32_ATOL)


def test_argmax_int64_and_cast():
    spec = _single(56, [(2, 7)], (2,), {0: ("int32", 4)},
                   consts=[np.asarray([1], np.int32)], out_dtype=np.int64)
    gj, gp = _both(spec)
    x = _inputs(spec, 5)
    want = np.asarray(J._Lowerer(gj).forward(J._Lowerer(gj).params, *x)[0])
    got = P._Lowerer(gp).forward(*[torch.as_tensor(v) for v in x])[0]
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


# -- refusals -----------------------------------------------------------------

def _message(fn):
    with pytest.raises(Exception) as err:
        fn()
    return str(err.value)


@pytest.mark.parametrize("code,custom", [(102, None), (32, "MyCustomOp"),
                                         (150, None)])
def test_unsupported_op_same_message(code, custom):
    spec = ([_f((1, 4)), _f((1, 4))], [0], [1],
            [(code, [0], [1], None, custom)], [b""])
    gj, gp = _both(spec)
    x = np.ones((1, 4), np.float32)
    lj = J._Lowerer(gj)
    want = _message(lambda: lj.forward(lj.params, x))
    lp = P._Lowerer(gp)
    got = _message(lambda: lp.forward(torch.as_tensor(x)))
    assert got == want
    name = custom or f"builtin#{code}"
    assert got == f"tflite: unsupported op {name}"


def test_dynamic_shape_operand_same_message():
    spec = ([_f((1, 4)), _f((2,), 0, np.int32), _f((2, 2))], [0, 1], [2],
            [(22, [0, 1], [2], None, None)], [b""])
    gj, gp = _both(spec)
    x = [np.ones((1, 4), np.float32), np.asarray([2, 2], np.int32)]
    lj = J._Lowerer(gj)
    want = _message(lambda: lj.forward(lj.params, *x))
    lp = P._Lowerer(gp)
    got = _message(lambda: lp.forward(*[torch.as_tensor(v) for v in x]))
    assert got == want
