"""Model-file fixture writers for the port's filter backends.

Imported by the CPU tests (``tests/test_torch_model_files.py``,
``tests/test_torch_tflite.py``, ``tests/test_torch_script_backends.py``)
and by ``chip_smoke.py``'s ``model_files`` phase.  Every file is written
at run time from seeded numpy (or, for TorchScript, from the port's own
seeded MobileNetV2), into a directory the caller names; none is
committed.

- :func:`mobilenet_v2_tflite`: MobileNetV2 as a schema-v3 ``.tflite``
  (written with :class:`nnstreamer_tpu_torch.utils.flatbuf.Builder`), in
  the structure of ``mobilenet_v2_1.0_224_quant.tflite``: per-tensor
  uint8 activations and weights with calibrated scales and zero points,
  ReLU6 clamps encoded in the activation ranges, the residual ``ADD``s,
  ``AVERAGE_POOL_2D`` then a 1x1 ``CONV_2D`` to the classes, ``RESHAPE``
  and ``SOFTMAX``; or the same graph in float32 (fused ReLU6, uint8 input
  cast and scaled in the graph).  ``stages`` cuts the depth.
- :func:`tflite_bytes`: any small graph from tensor/op lists.
- :func:`lenet_graphdef`: a LeNet-5-sized NHWC TensorFlow ``GraphDef``.
- :func:`lenet_caffe2`: the same net as a Caffe2 init/predict pair (NCHW).
- :func:`lenet_mxnet`: the same net as an MXNet ``.json`` + ``.params``.
- :func:`mobilenet_v2_torchscript`: ``torch.jit.trace`` on the CPU of the
  port's ``models/mobilenet_v2.py`` at ``seed``.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# -- tflite -------------------------------------------------------------------

#: tflite TensorType codes
TFL_TYPES = {np.dtype(np.float32): 0, np.dtype(np.int32): 2,
             np.dtype(np.uint8): 3, np.dtype(np.int64): 4,
             np.dtype(np.int8): 9}

#: the gain of the seeded classifier weights (see :func:`mnv2_layers`)
HEAD_GAIN = 8.0


def tflite_bytes(tensors: Sequence[Dict[str, Any]],
                 ops: Sequence[Dict[str, Any]], inputs: Sequence[int],
                 outputs: Sequence[int], buffers: Sequence[bytes]) -> bytes:
    """A schema-v3 model of one subgraph.

    ``tensors``: dicts with ``shape``, ``dtype`` (numpy), ``buffer``
    (index into ``buffers``, 0 = the empty buffer), optional ``name``,
    ``scale``, ``zero_point``, ``qdim``.  ``ops``: dicts with ``code``,
    ``inputs``, ``outputs`` and ``options`` ({vtable field: (kind,
    value)}, every enum written as the int32 the loaders read).
    ``buffers[0]`` must be ``b""``."""
    from nnstreamer_tpu_torch.utils import flatbuf as fb

    b = fb.Builder()
    buf_offs = []
    for raw in buffers:
        data = b.bytes_vector(bytes(raw)) if raw else 0
        b.start_table()
        b.add_offset(0, data)
        buf_offs.append(b.end_table())
    codes = sorted({op["code"] for op in ops})
    code_offs = []
    for code in codes:
        b.start_table()
        b.add_scalar(0, "int8", min(code, 127))
        b.add_scalar(3, "int32", code)
        b.add_scalar(2, "int32", 1)
        code_offs.append(b.end_table())
    t_offs = []
    for t in tensors:
        shape = b.scalar_vector("int32", list(t["shape"]))
        name = b.string(t.get("name", ""))
        quant = 0
        if t.get("scale") is not None:
            scale = b.scalar_vector("float32", [float(v) for v in np.ravel(
                t["scale"])])
            zp = b.scalar_vector("int64", [int(v) for v in np.ravel(
                t.get("zero_point", [0]))])
            b.start_table()
            b.add_offset(2, scale)
            b.add_offset(3, zp)
            b.add_scalar(6, "int32", int(t.get("qdim", 0)))
            quant = b.end_table()
        b.start_table()
        b.add_offset(0, shape)
        b.add_scalar(1, "int8", TFL_TYPES[np.dtype(t["dtype"])])
        b.add_scalar(2, "uint32", int(t.get("buffer", 0)))
        b.add_offset(3, name)
        b.add_offset(4, quant)
        t_offs.append(b.end_table())
    op_offs = []
    for op in ops:
        opts = 0
        if op.get("options"):
            b.start_table()
            for field, (kind, value) in sorted(op["options"].items()):
                b.add_scalar(field, kind, value)
            opts = b.end_table()
        ins = b.scalar_vector("int32", list(op["inputs"]))
        outs = b.scalar_vector("int32", list(op["outputs"]))
        b.start_table()
        b.add_scalar(0, "uint32", codes.index(op["code"]))
        b.add_offset(1, ins)
        b.add_offset(2, outs)
        b.add_offset(4, opts)
        op_offs.append(b.end_table())
    tv = b.offset_vector(t_offs)
    iv = b.scalar_vector("int32", list(inputs))
    ov = b.scalar_vector("int32", list(outputs))
    opv = b.offset_vector(op_offs)
    b.start_table()
    b.add_offset(0, tv)
    b.add_offset(1, iv)
    b.add_offset(2, ov)
    b.add_offset(3, opv)
    sub = b.end_table()
    subs = b.offset_vector([sub])
    codes_v = b.offset_vector(code_offs)
    bufs_v = b.offset_vector(buf_offs)
    desc = b.string("nnstreamer_tpu_torch fixture")
    b.start_table()
    b.add_scalar(0, "uint32", 3)
    b.add_offset(1, codes_v)
    b.add_offset(2, subs)
    b.add_offset(3, desc)
    b.add_offset(4, bufs_v)
    return b.finish(b.end_table(), identifier="TFL3")


def _qparams(lo: float, hi: float) -> Tuple[float, int]:
    """uint8 asymmetric quantization of [lo, hi] (0 always inside)."""
    lo, hi = min(float(lo), 0.0), max(float(hi), 0.0)
    scale = (hi - lo) / 255.0 or 1.0 / 255.0
    zp = int(np.clip(round(-lo / scale), 0, 255))
    return scale, zp


def _quant_w(w: np.ndarray) -> Tuple[np.ndarray, float, int]:
    scale, zp = _qparams(w.min(), w.max())
    q = np.clip(np.round(w / scale) + zp, 0, 255).astype(np.uint8)
    return q, scale, zp


def mnv2_layers(width: float = 1.0, classes: int = 1001,
                stages: Optional[int] = None, seed: int = 0) -> List[dict]:
    """Seeded float MobileNetV2 layers (BatchNorm folded): dicts with
    ``kind`` (conv | dw | add | pool | head), weights OHWI (conv) or
    [1, kh, kw, C] (dw), bias, stride, act (relu6 | none)."""
    rng = np.random.default_rng(seed)

    def c(ch):
        return max(8, int(ch * width + 4) // 8 * 8)

    def conv(cin, cout, k, stride, act, groups=1):
        fan_in = k * k * (cin // groups)
        std = np.sqrt(2.0 / fan_in)
        if groups == 1:
            w = rng.normal(0, std, (cout, k, k, cin))
        else:
            w = rng.normal(0, std, (1, k, k, cout))
        b = rng.normal(0, 0.05, (cout,))
        return {"kind": "conv" if groups == 1 else "dw",
                "w": w.astype(np.float32), "b": b.astype(np.float32),
                "stride": stride, "act": act}

    # the port's stage table (expansion t, channels c, repeats n, stride s)
    from nnstreamer_tpu_torch.models.mobilenet_v2 import \
        _INVERTED_RESIDUAL_CFG as cfg

    layers = [conv(3, c(32), 3, 2, "relu6")]
    cin = c(32)
    cfg = cfg if stages is None else cfg[:stages]
    for t, ch, n, s in cfg:
        for i in range(n):
            stride = s if i == 0 else 1
            hidden = cin * t
            start = len(layers)
            if t != 1:
                layers.append(conv(cin, hidden, 1, 1, "relu6"))
            layers.append(conv(hidden, hidden, 3, stride, "relu6",
                               groups=hidden))
            proj = conv(hidden, c(ch), 1, 1, "none")
            proj["w"] *= 0.5          # keep the residual sums in range
            layers.append(proj)
            if stride == 1 and cin == c(ch):
                layers.append({"kind": "add", "skip": start - 1})
            cin = c(ch)
    layers.append(conv(cin, 1280, 1, 1, "relu6"))
    layers.append({"kind": "pool"})
    head = conv(1280, classes, 1, 1, "none")
    # a classifier as confident as a trained one: logits spread enough
    # that the uint8 softmax (scale 1/256) separates the top classes
    head["w"] *= HEAD_GAIN
    layers.append(dict(head, kind="head"))
    return layers


def _float_forward(layers: List[dict], x):
    """The float reference of :func:`mnv2_layers` on NHWC torch f32 ``x``
    (TF SAME padding); returns every layer's output (NHWC) and the
    logits."""
    import torch
    import torch.nn.functional as F

    outs = []
    cur = x
    for layer in layers:
        kind = layer["kind"]
        if kind in ("conv", "dw", "head"):
            w = torch.as_tensor(layer["w"])
            groups = 1
            if kind == "dw":
                w = w.permute(3, 0, 1, 2)
                groups = cur.shape[-1]
            else:
                w = w.permute(0, 3, 1, 2)
            k, s = w.shape[-1], layer["stride"]
            n = cur.shape[1]
            total = max((-(-n // s) - 1) * s + k - n, 0)
            xp = F.pad(cur.permute(0, 3, 1, 2),
                       (total // 2, total - total // 2,
                        total // 2, total - total // 2))
            y = F.conv2d(xp, w, torch.as_tensor(layer["b"]), s,
                         groups=groups).permute(0, 2, 3, 1)
            if layer["act"] == "relu6":
                y = y.clamp(0, 6)
        elif kind == "add":
            y = cur + outs[layer["skip"]]
        else:                                           # pool
            y = cur.mean(dim=(1, 2), keepdim=True)
        outs.append(y)
        cur = y
    return outs, cur.reshape(cur.shape[0], -1)


def mobilenet_v2_tflite(path: str, quantized: bool, width: float = 1.0,
                        size: int = 224, classes: int = 1001,
                        stages: Optional[int] = None, seed: int = 0,
                        calib_frames: int = 2) -> str:
    """Write MobileNetV2 as a ``.tflite`` (see the module docstring);
    scales and zero points of (a) come from the float graph's ranges on
    ``calib_frames`` seeded frames.  Returns ``path``."""
    import torch

    layers = mnv2_layers(width, classes, stages, seed)
    tensors: List[dict] = []
    buffers: List[bytes] = [b""]
    ops: List[dict] = []

    def buf(arr) -> int:
        buffers.append(np.ascontiguousarray(arr).tobytes())
        return len(buffers) - 1

    def tensor(shape, dtype, buffer=0, name="", q=None) -> int:
        t = {"shape": tuple(shape), "dtype": dtype, "buffer": buffer,
             "name": name}
        if q is not None:
            t["scale"], t["zero_point"] = [q[0]], [q[1]]
        tensors.append(t)
        return len(tensors) - 1

    ranges = None
    in_q = (1.0 / 128.0, 128)
    if quantized:
        frames = np.random.default_rng(seed + 1).integers(
            0, 256, (calib_frames, size, size, 3), dtype=np.uint8)
        x = (torch.as_tensor(frames).float() - in_q[1]) * in_q[0]
        with torch.no_grad():
            outs, logits = _float_forward(layers, x)
        probs = torch.softmax(logits, -1)
        ranges = [(float(o.min()), float(o.max())) for o in outs]
        del probs
    q_of = (lambda i: _qparams(*ranges[i])) if quantized else \
        (lambda i: None)
    act_dtype = np.uint8 if quantized else np.float32

    if quantized:
        cur = tensor((1, size, size, 3), np.uint8, name="input", q=in_q)
        graph_in = cur
    else:
        graph_in = tensor((1, size, size, 3), np.uint8, name="input")
        cast = tensor((1, size, size, 3), np.float32)
        ops.append({"code": 53, "inputs": [graph_in], "outputs": [cast],
                    "options": {0: ("int32", 3), 1: ("int32", 0)}})
        mul_c = tensor((), np.float32, buf(np.float32(1.0 / 127.5)))
        scaled = tensor((1, size, size, 3), np.float32)
        ops.append({"code": 18, "inputs": [cast, mul_c],
                    "outputs": [scaled]})
        one = tensor((), np.float32, buf(np.float32(1.0)))
        cur = tensor((1, size, size, 3), np.float32)
        ops.append({"code": 41, "inputs": [scaled, one], "outputs": [cur]})
    hw = size
    cur_q = in_q
    out_ids: List[int] = []
    for li, layer in enumerate(layers):
        kind = layer["kind"]
        if kind in ("conv", "dw", "head"):
            stride = layer["stride"]
            hw = -(-hw // stride)
            cout = layer["w"].shape[0] if kind != "dw" else \
                layer["w"].shape[3]
            if quantized:
                wq, s_w, zp_w = _quant_w(layer["w"])
                w_t = tensor(layer["w"].shape, np.uint8, buf(wq),
                             q=(s_w, zp_w))
                s_b = cur_q[0] * s_w
                bq = np.round(layer["b"] / s_b).astype(np.int32)
                b_t = tensor((cout,), np.int32, buf(bq), q=(s_b, 0))
                oq = q_of(li)
            else:
                w_t = tensor(layer["w"].shape, np.float32, buf(layer["w"]))
                b_t = tensor((cout,), np.float32, buf(layer["b"]))
                oq = None
            out = tensor((1, hw, hw, cout), act_dtype, q=oq)
            act = 3 if (layer["act"] == "relu6" and not quantized) else 0
            if kind == "dw":
                opts = {0: ("int32", 0), 1: ("int32", stride),
                        2: ("int32", stride), 3: ("int32", 1),
                        4: ("int32", act)}
                code = 4
            else:
                opts = {0: ("int32", 0), 1: ("int32", stride),
                        2: ("int32", stride), 3: ("int32", act)}
                code = 3
            ops.append({"code": code, "inputs": [cur, w_t, b_t],
                        "outputs": [out], "options": opts})
        elif kind == "add":
            oq = q_of(li)
            out = tensor((1, hw, hw, tensors[cur]["shape"][-1]), act_dtype,
                         q=oq)
            ops.append({"code": 0, "inputs": [out_ids[layer["skip"]], cur],
                        "outputs": [out], "options": {}})
        else:                                                   # pool
            # the real quant model keeps the pool's input quantization
            oq = cur_q if quantized else None
            out = tensor((1, 1, 1, tensors[cur]["shape"][-1]), act_dtype,
                         q=oq)
            ops.append({"code": 1, "inputs": [cur], "outputs": [out],
                        "options": {0: ("int32", 1), 1: ("int32", hw),
                                    2: ("int32", hw), 3: ("int32", hw),
                                    4: ("int32", hw)}})
            hw = 1
        out_ids.append(out)
        cur, cur_q = out, (oq if quantized else None)
    shape_t = tensor((2,), np.int32, buf(np.asarray([1, classes], np.int32)))
    flat = tensor((1, classes), act_dtype, q=cur_q)
    ops.append({"code": 22, "inputs": [cur, shape_t], "outputs": [flat]})
    probs_q = (1.0 / 256.0, 0) if quantized else None
    probs = tensor((1, classes), act_dtype, name="probabilities", q=probs_q)
    ops.append({"code": 25, "inputs": [flat], "outputs": [probs],
                "options": {0: ("float32", 1.0)}})
    data = tflite_bytes(tensors, ops, [graph_in], [probs], buffers)
    with open(path, "wb") as f:
        f.write(data)
    return path


# -- protobuf wire (TensorFlow GraphDef, Caffe2 NetDef) ------------------------

def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


_PB_DT = {"float32": 1, "int32": 3, "int64": 9, "bool": 10}


def _pb_shape(dims) -> bytes:
    return b"".join(_ld(2, _tag(1, 0) + _varint(d)) for d in dims)


def pb_tensor(arr) -> bytes:
    arr = np.ascontiguousarray(arr)
    body = _tag(1, 0) + _varint(_PB_DT[arr.dtype.name])
    body += _ld(2, _pb_shape(arr.shape))
    body += _ld(4, arr.tobytes())
    return body


def pb_attr(kind: str, value) -> bytes:
    if kind == "type":
        return _tag(6, 0) + _varint(value)
    if kind == "shape":
        return _ld(7, _pb_shape(value))
    if kind == "tensor":
        return _ld(8, pb_tensor(value))
    if kind == "s":
        return _ld(2, value)
    if kind == "i":
        return _tag(3, 0) + _varint(value)
    if kind == "b":
        return _tag(5, 0) + _varint(1 if value else 0)
    if kind == "f":
        return _tag(4, 5) + struct.pack("<f", value)
    if kind == "ilist":
        return _ld(1, b"".join(_tag(3, 0) + _varint(v) for v in value))
    raise ValueError(kind)


def pb_node(name: str, op: str, inputs=(), **attrs) -> bytes:
    body = _ld(1, name.encode()) + _ld(2, op.encode())
    for i in inputs:
        body += _ld(3, i.encode())
    for key, (kind, value) in attrs.items():
        body += _ld(5, _ld(1, key.encode()) + _ld(2, pb_attr(kind, value)))
    return body


def pb_graph(*nodes: bytes) -> bytes:
    return b"".join(_ld(1, n) for n in nodes)


def _f1_nchw(f1: np.ndarray) -> np.ndarray:
    """The first dense layer's rows reordered from NHWC flattening
    (h, w, c) to NCHW flattening (c, h, w): the same function on an NCHW
    net."""
    return f1.reshape(5, 5, 16, -1).transpose(2, 0, 1, 3).reshape(400, -1)


def lenet_weights(seed: int = 0, classes: int = 10) -> Dict[str, np.ndarray]:
    """LeNet-5 (28x28x1 -> 6c5 -> pool -> 16c5 -> pool -> 120 -> 84 ->
    classes) in TF layouts: conv HWIO, dense (in, out)."""
    rng = np.random.default_rng(seed)

    def n(*shape, fan):
        return rng.normal(0, np.sqrt(2.0 / fan), shape).astype(np.float32)

    return {"c1": n(5, 5, 1, 6, fan=25), "b1": n(6, fan=50),
            "c2": n(5, 5, 6, 16, fan=150), "b2": n(16, fan=300),
            "f1": n(400, 120, fan=400), "fb1": n(120, fan=800),
            "f2": n(120, 84, fan=120), "fb2": n(84, fan=240),
            "f3": n(84, classes, fan=84), "fb3": n(classes, fan=168)}


def lenet_graphdef(path: str, seed: int = 0, classes: int = 10) -> str:
    """LeNet-5 as a frozen NHWC ``GraphDef``: input ``x`` (1, 28, 28, 1)
    float32, output ``prob`` (1, classes)."""
    w = lenet_weights(seed, classes)
    c = lambda name, arr: pb_node(name, "Const", (),  # noqa: E731
                                  value=("tensor", arr), dtype=("type", 1))
    nodes = [
        pb_node("x", "Placeholder", (), dtype=("type", 1),
                shape=("shape", (1, 28, 28, 1))),
        c("c1", w["c1"]), c("b1", w["b1"]), c("c2", w["c2"]),
        c("b2", w["b2"]), c("f1", w["f1"]), c("fb1", w["fb1"]),
        c("f2", w["f2"]), c("fb2", w["fb2"]), c("f3", w["f3"]),
        c("fb3", w["fb3"]),
        c("flat_shape", np.asarray([1, 400], np.int32)),
        pb_node("conv1", "Conv2D", ("x", "c1"), strides=("ilist", [1] * 4),
                padding=("s", b"SAME")),
        pb_node("bias1", "BiasAdd", ("conv1", "b1")),
        pb_node("relu1", "Relu", ("bias1",)),
        pb_node("pool1", "MaxPool", ("relu1",), ksize=("ilist", [1, 2, 2, 1]),
                strides=("ilist", [1, 2, 2, 1]), padding=("s", b"VALID")),
        pb_node("conv2", "Conv2D", ("pool1", "c2"), strides=("ilist", [1] * 4),
                padding=("s", b"VALID")),
        pb_node("bias2", "BiasAdd", ("conv2", "b2")),
        pb_node("relu2", "Relu", ("bias2",)),
        pb_node("pool2", "AvgPool", ("relu2",), ksize=("ilist", [1, 2, 2, 1]),
                strides=("ilist", [1, 2, 2, 1]), padding=("s", b"VALID")),
        pb_node("flat", "Reshape", ("pool2", "flat_shape")),
        pb_node("fc1", "MatMul", ("flat", "f1")),
        pb_node("fcb1", "BiasAdd", ("fc1", "fb1")),
        pb_node("fr1", "Relu", ("fcb1",)),
        pb_node("fc2", "MatMul", ("fr1", "f2")),
        pb_node("fcb2", "AddV2", ("fc2", "fb2")),
        pb_node("fr2", "Relu", ("fcb2",)),
        pb_node("fc3", "MatMul", ("fr2", "f3")),
        pb_node("logits", "BiasAdd", ("fc3", "fb3")),
        pb_node("prob", "Softmax", ("logits",)),
    ]
    with open(path, "wb") as f:
        f.write(pb_graph(*nodes))
    return path


def _c2_arg(name: str, *, f=None, i=None, s=None, floats=None, ints=None):
    out = _ld(1, name.encode())
    if f is not None:
        out += _tag(2, 5) + struct.pack("<f", f)
    if i is not None:
        out += _tag(3, 0) + _varint(i)
    if s is not None:
        out += _ld(4, s)
    for v in floats or []:
        out += _tag(5, 5) + struct.pack("<f", v)
    for v in ints or []:
        out += _tag(6, 0) + _varint(v)
    return out


def _c2_op(type_: str, inputs, outputs, args=()) -> bytes:
    out = b"".join(_ld(1, n.encode()) for n in inputs)
    out += b"".join(_ld(2, n.encode()) for n in outputs)
    out += _ld(4, type_.encode())
    out += b"".join(_ld(5, a) for a in args)
    return out


def _c2_net(name: str, ops, external_input=(), external_output=()) -> bytes:
    out = _ld(1, name.encode())
    out += b"".join(_ld(2, o) for o in ops)
    out += b"".join(_ld(7, n.encode()) for n in external_input)
    out += b"".join(_ld(8, n.encode()) for n in external_output)
    return out


def lenet_caffe2(directory: str, seed: int = 0, classes: int = 10) -> str:
    """LeNet-5 as a Caffe2 NCHW ``init_net.pb,predict_net.pb`` pair:
    input ``data`` (1, 1, 28, 28), output ``softmax``.  Returns the
    ``model`` property (the comma pair)."""
    w = lenet_weights(seed, classes)
    blobs = {"conv1_w": w["c1"].transpose(3, 2, 0, 1), "conv1_b": w["b1"],
             "conv2_w": w["c2"].transpose(3, 2, 0, 1), "conv2_b": w["b2"],
             "fc1_w": _f1_nchw(w["f1"]).T, "fc1_b": w["fb1"],
             "fc2_w": w["f2"].T, "fc2_b": w["fb2"],
             "fc3_w": w["f3"].T, "fc3_b": w["fb3"]}
    init = [_c2_op("GivenTensorFill", [], [k],
                   [_c2_arg("shape", ints=list(v.shape)),
                    _c2_arg("values", floats=[float(x) for x in v.ravel()])])
            for k, v in blobs.items()]
    pred = [
        _c2_op("Conv", ["data", "conv1_w", "conv1_b"], ["conv1"],
               [_c2_arg("kernel", i=5), _c2_arg("pad", i=2)]),
        _c2_op("Relu", ["conv1"], ["conv1"]),
        _c2_op("MaxPool", ["conv1"], ["pool1"],
               [_c2_arg("kernel", i=2), _c2_arg("stride", i=2)]),
        _c2_op("Conv", ["pool1", "conv2_w", "conv2_b"], ["conv2"],
               [_c2_arg("kernel", i=5)]),
        _c2_op("Relu", ["conv2"], ["conv2"]),
        _c2_op("AveragePool", ["conv2"], ["pool2"],
               [_c2_arg("kernel", i=2), _c2_arg("stride", i=2)]),
        _c2_op("FC", ["pool2", "fc1_w", "fc1_b"], ["fc1"]),
        _c2_op("Relu", ["fc1"], ["fc1"]),
        _c2_op("FC", ["fc1", "fc2_w", "fc2_b"], ["fc2"]),
        _c2_op("Relu", ["fc2"], ["fc2"]),
        _c2_op("FC", ["fc2", "fc3_w", "fc3_b"], ["fc3"]),
        _c2_op("Softmax", ["fc3"], ["softmax"]),
    ]
    ip = os.path.join(directory, "lenet_init_net.pb")
    pp = os.path.join(directory, "lenet_predict_net.pb")
    with open(ip, "wb") as f:
        f.write(_c2_net("lenet_init", init))
    with open(pp, "wb") as f:
        f.write(_c2_net("lenet", pred, ["data"] + list(blobs), ["softmax"]))
    return f"{ip},{pp}"


def lenet_mxnet(directory: str, seed: int = 0, classes: int = 10) -> str:
    """LeNet-5 as an MXNet symbol ``lenet.json`` + ``lenet.params``
    (written with the port's ``save_params``): input ``data`` (1, 1, 28,
    28), output ``softmax``.  Returns the ``.json`` path."""
    from nnstreamer_tpu_torch.filter.backends.mxnet import save_params

    w = lenet_weights(seed, classes)
    params = {"conv1_weight": w["c1"].transpose(3, 2, 0, 1),
              "conv1_bias": w["b1"],
              "conv2_weight": w["c2"].transpose(3, 2, 0, 1),
              "conv2_bias": w["b2"],
              "fc1_weight": _f1_nchw(w["f1"]).T.copy(),
              "fc1_bias": w["fb1"],
              "fc2_weight": w["f2"].T.copy(), "fc2_bias": w["fb2"],
              "fc3_weight": w["f3"].T.copy(), "fc3_bias": w["fb3"]}
    nodes: List[dict] = []

    def node(op, name, inputs=(), **attrs):
        nodes.append({"op": op, "name": name,
                      "attrs": {k: str(v) for k, v in attrs.items()},
                      "inputs": [[i, 0, 0] for i in inputs]})
        return len(nodes) - 1

    def var(name):
        return node("null", name)

    x = var("data")
    h = node("Convolution", "conv1",
             [x, var("conv1_weight"), var("conv1_bias")],
             kernel="(5, 5)", pad="(2, 2)", num_filter=6)
    h = node("Activation", "relu1", [h], act_type="relu")
    h = node("Pooling", "pool1", [h], kernel="(2, 2)", stride="(2, 2)",
             pool_type="max")
    h = node("Convolution", "conv2",
             [h, var("conv2_weight"), var("conv2_bias")],
             kernel="(5, 5)", num_filter=16)
    h = node("Activation", "relu2", [h], act_type="relu")
    h = node("Pooling", "pool2", [h], kernel="(2, 2)", stride="(2, 2)",
             pool_type="avg")
    h = node("Flatten", "flat", [h])
    for i, units in ((1, 120), (2, 84), (3, classes)):
        h = node("FullyConnected", f"fc{i}",
                 [h, var(f"fc{i}_weight"), var(f"fc{i}_bias")],
                 num_hidden=units)
        if i < 3:
            h = node("Activation", f"relu_fc{i}", [h], act_type="relu")
    h = node("softmax", "softmax", [h])
    sym = os.path.join(directory, "lenet.json")
    with open(sym, "w") as f:
        json.dump({"nodes": nodes, "heads": [[h, 0, 0]],
                   "arg_nodes": [i for i, n in enumerate(nodes)
                                 if n["op"] == "null"]}, f)
    save_params(os.path.join(directory, "lenet.params"), params)
    return sym


# -- TorchScript --------------------------------------------------------------

def mobilenet_v2_torchscript(path: str, width: float = 1.0, size: int = 224,
                             classes: int = 1001, seed: int = 0) -> str:
    """``torch.jit.trace`` on the CPU of the port's MobileNetV2 (f32, its
    normalize step through the plain version of K1) at ``seed``: input a
    uint8 (size, size, 3) frame, output (classes,) f32 logits."""
    import torch

    from nnstreamer_tpu_torch.models.mobilenet_v2 import (MobileNetV2,
                                                          init_weights)

    module = MobileNetV2(num_classes=classes, width=width,
                         dtype=torch.float32, use_pallas=True)
    init_weights(module, torch.Generator().manual_seed(seed))
    module = module.eval()
    example = torch.zeros((size, size, 3), dtype=torch.uint8)
    with torch.no_grad():
        traced = torch.jit.trace(module, (example,), check_trace=False)
    traced.save(path)
    return path
