"""TensorFlow frozen-GraphDef filter backend (dependency-free).

The port of ``nnstreamer_tpu/filter/backends/tensorflow.py`` (reference:
ext/nnstreamer/tensor_filter/tensor_filter_tensorflow.cc).  The ``.pb``
GraphDef is parsed with the in-tree protobuf wire reader
(``utils/protowire.py``), every node is lowered to torch, and the graph
is served through :class:`~._torchexec.TorchExecMixin`: the frozen
weights resident on the card from open, one CUDA graph per input
signature, batching through ``torch.func.vmap`` of the per-frame
forward.  ``custom=compute:auto|float32|bfloat16`` is the shared
compute-dtype policy (``_torchexec._wrap_compute_dtype``): bf16 on the
card by default, f32 on the CPU.

Contract (the reference's properties):

- input/output selection: custom properties ``inputname=a,b`` /
  ``outputname=y``; defaults: all ``Placeholder`` nodes in graph order
  -> inputs, terminal nodes (no consumer) -> outputs.
- input meta: taken from ``input_info`` when given, else derived from
  the Placeholder ``shape`` attr when fully defined.
- output meta is probed with a zero invoke at open.

Layout: the lowerings assume NHWC (``_require_nhwc`` refuses others by
name); a convolution hands cuDNN a permuted view (NCHW logical,
channels_last in memory) and pads TF ``SAME`` explicitly where it is
asymmetric.

Static-shape discipline: shape-like operands (Reshape dims, axes,
perms, paddings, slice bounds, a PadV2 value) must resolve to graph
constants -- a computed shape is a genuinely dynamic model and is
rejected by name, exactly like the tflite loader.

The DecodeWav hoist (a host step before the device forward) and the
AudioSpectrogram/Mfcc front end (``ops/audio.py``) are ported.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...tensor.buffer import to_host
from ...tensor.info import TensorInfo, TensorsInfo
from ...utils.protowire import (fields_dict, first, packed_or_repeated_varints,
                                repeated, to_signed64)
from ..framework import (Accelerator, FilterError, FilterFramework,
                         FilterProperties, FilterStatistics, register_filter)
from ._torchexec import (TorchExecMixin, _wrap_compute_dtype,
                         torch_dtype)
from .tflite import _same_pads, _slice_dim

# -- GraphDef schema field numbers (tensorflow/core/framework/*.proto) -------

#: DataType enum → numpy (types.proto)
_DTYPES = {1: "float32", 2: "float64", 3: "int32", 4: "uint8", 5: "int16",
           6: "int8", 9: "int64", 10: "bool", 14: "bfloat16", 17: "uint16",
           19: "float16", 22: "uint32", 23: "uint64"}


class _Node:
    __slots__ = ("name", "op", "inputs", "attrs", "const")

    def __init__(self, name: str, op: str, inputs: List[str],
                 attrs: Dict[str, Any]):
        self.name, self.op, self.inputs, self.attrs = name, op, inputs, attrs
        self.const: Optional[np.ndarray] = None


def _parse_shape(buf: bytes) -> Optional[Tuple[int, ...]]:
    """TensorShapeProto → tuple, or None when unknown_rank/partial."""
    d = fields_dict(buf)
    if first(d, 3, 0):          # unknown_rank
        return None
    dims = []
    for dim in repeated(d, 2):
        size = to_signed64(first(fields_dict(dim), 1, 0) or 0)
        if size < 0:
            return None
        dims.append(size)
    return tuple(dims)


def _parse_tensor(buf: bytes) -> np.ndarray:
    """TensorProto → numpy (tensor.proto field numbers)."""
    d = fields_dict(buf)
    dt = first(d, 1, 0)
    if dt not in _DTYPES:
        raise FilterError(f"tensorflow: unsupported TensorProto dtype {dt}")
    dtype = np.dtype(_DTYPES[dt])
    shape_buf = first(d, 2)
    shape = _parse_shape(shape_buf) if shape_buf is not None else ()
    if shape is None:
        raise FilterError("tensorflow: TensorProto with unknown shape")
    content = first(d, 4)
    if content:
        arr = np.frombuffer(content, dtype)
    else:
        # typed repeated value fields
        if dt == 1:
            from ...utils.protowire import packed_or_repeated_fixed32
            vals = packed_or_repeated_fixed32(d.get(5, []), "<f")
        elif dt == 3:
            vals = [to_signed64(v) for v in
                    packed_or_repeated_varints(d.get(7, []))]
        elif dt == 9:
            vals = [to_signed64(v) for v in
                    packed_or_repeated_varints(d.get(10, []))]
        elif dt == 10:
            vals = packed_or_repeated_varints(d.get(11, []))
        elif dt == 2:
            from ...utils.protowire import packed_or_repeated_fixed64
            vals = packed_or_repeated_fixed64(d.get(6, []), "<d")
        elif dt in (14, 19):
            # half_val (field 13): varints holding the 16-bit patterns of
            # DT_BFLOAT16 / DT_HALF values
            bits = packed_or_repeated_varints(d.get(13, []))
            arr16 = np.array(bits, np.uint16)
            vals = None
            arr = arr16.view(dtype)
        else:
            vals = []
        if vals is not None:
            arr = np.array(vals, dtype)
        n = int(np.prod(shape)) if shape else 1
        if 0 < arr.size < n:
            # TF repeats the LAST listed value to fill the shape (a single
            # value is the common splat case of the same rule).  Applies to
            # the typed *_val lists ONLY — tensor_content must be full-size.
            arr = np.concatenate([arr,
                                  np.full(n - arr.size, arr[-1], dtype)])
    n = int(np.prod(shape)) if shape else 1
    if arr.size != n:
        raise FilterError(
            f"tensorflow: TensorProto size {arr.size} != shape {shape}")
    return arr.reshape(shape)


def _parse_attr(buf: bytes) -> Any:
    """AttrValue → python value (attr_value.proto)."""
    d = fields_dict(buf)
    if 2 in d:
        return first(d, 2)                              # s: bytes
    if 3 in d:
        return to_signed64(first(d, 3))                 # i
    if 4 in d:
        import struct
        return struct.unpack("<f", struct.pack("<I", first(d, 4)))[0]  # f
    if 5 in d:
        return bool(first(d, 5))                        # b
    if 6 in d:
        return int(first(d, 6))                         # type enum
    if 7 in d:
        return _parse_shape(first(d, 7))                # shape
    if 8 in d:
        return _parse_tensor(first(d, 8))               # tensor
    if 1 in d:                                          # list(...)
        ld = fields_dict(first(d, 1))
        if 3 in ld:
            return [to_signed64(v)
                    for v in packed_or_repeated_varints(ld.get(3, []))]
        if 4 in ld:
            from ...utils.protowire import packed_or_repeated_fixed32
            return packed_or_repeated_fixed32(ld.get(4, []), "<f")
        if 2 in ld:
            return repeated(ld, 2)
        if 6 in ld:
            return packed_or_repeated_varints(ld.get(6, []))
        return []
    return None


def parse_graphdef(data: bytes) -> Dict[str, _Node]:
    """GraphDef wire bytes → name → node (graph.proto: node = field 1)."""
    nodes: Dict[str, _Node] = {}
    for nd in repeated(fields_dict(data), 1):
        d = fields_dict(nd)
        name = (first(d, 1, b"") or b"").decode()
        op = (first(d, 2, b"") or b"").decode()
        inputs = [x.decode() for x in repeated(d, 3)]
        attrs: Dict[str, Any] = {}
        for entry in repeated(d, 5):       # map<string, AttrValue>
            ed = fields_dict(entry)
            key = (first(ed, 1, b"") or b"").decode()
            val = first(ed, 2)
            attrs[key] = _parse_attr(val) if val is not None else None
        node = _Node(name, op, inputs, attrs)
        if op == "Const":
            v = attrs.get("value")
            if not isinstance(v, np.ndarray):
                raise FilterError(f"tensorflow: Const {name} has no value")
            node.const = v
        nodes[name] = node
    if not nodes:
        raise FilterError("tensorflow: empty GraphDef")
    return nodes


def _split_ref(ref: str) -> Tuple[str, int]:
    if ":" in ref:
        name, _, idx = ref.rpartition(":")
        return name, int(idx)
    return ref, 0


# -- op lowering -------------------------------------------------------------

class _Ctx:
    """Per-trace evaluation context handed to op handlers."""

    def __init__(self, graph: "TFGraph", env: Dict[str, Any]):
        self.graph = graph
        self.env = env

    def val(self, ref: str):
        name, idx = _split_ref(ref)
        return self.env[f"{name}:{idx}"]

    def static(self, ref: str) -> np.ndarray:
        """Resolve a shape-like operand to a graph constant (through
        Identity), or fail by name — same policy as the tflite loader."""
        name, _ = _split_ref(ref)
        node = self.graph.nodes.get(name)
        seen = set()
        while node is not None and node.op in ("Identity", "StopGradient") \
                and node.name not in seen:
            seen.add(node.name)
            nxt, _ = _split_ref(node.inputs[0])
            node = self.graph.nodes.get(nxt)
        if node is None or node.const is None:
            raise FilterError(
                f"tensorflow: operand {ref} must be a graph constant "
                "(computed shapes/axes are dynamic — unsupported)")
        return node.const


def _data_inputs(node: _Node) -> List[str]:
    return [i for i in node.inputs if not i.startswith("^")]


def _attr_or(node: _Node, key: str, default: float) -> float:
    """Float attr with a None-safe default.  `attrs.get(k) or d` folds
    an EXPLICIT 0.0 in the graph into the default — but zero is a real
    setting here (LeakyRelu alpha=0.0 is plain relu, FusedBatchNorm
    epsilon=0.0 is exact normalization); only a MISSING attr falls
    back."""
    val = node.attrs.get(key)
    return float(val) if val is not None else float(default)


def _require_nhwc(node: _Node) -> None:
    """Lowerings assume NHWC (TF's CPU default); fail NCHW graphs by name
    instead of producing silently wrong layouts."""
    df = node.attrs.get("data_format")
    if df and df != b"NHWC":
        raise FilterError(
            f"tensorflow: {node.op} node {node.name} has "
            f"data_format={df!r}; only NHWC graphs are supported")


def _nhwc_conv(x, w, strides, padding: str, dilations=(1, 1),
               feature_group_count=1):
    """An NHWC convolution of HWIO ``w`` with TF ``SAME``/``VALID``
    padding, through a channels_last view of ``x``."""
    wk = w.permute(3, 2, 0, 1)                      # HWIO -> OIHW
    pad: Any = 0
    if padding == "SAME":
        (t, b), (l, r) = _same_pads(x.shape[-3:-1], wk.shape[2:], strides,
                                    dilations)
        if t == b and l == r:
            pad = (t, l)
        else:
            x = F.pad(x, (0, 0, l, r, t, b))
    elif padding != "VALID":
        raise FilterError(f"tensorflow: padding {padding!r} unsupported")
    y = F.conv2d(x.permute(0, 3, 1, 2), wk, stride=tuple(strides),
                 padding=pad, dilation=tuple(dilations),
                 groups=feature_group_count)
    return y.permute(0, 2, 3, 1)


def _pool(x, node, kind: str):
    """MaxPool / AvgPool over the H and W axes of an NHWC ``x``; the
    average counts only the window's valid (unpadded) elements."""
    _require_nhwc(node)
    ks = [int(k) for k in node.attrs.get("ksize") or [1, 1, 1, 1]]
    st = [int(s) for s in node.attrs.get("strides") or [1, 1, 1, 1]]
    if ks[0] != 1 or ks[3] != 1 or st[0] != 1 or st[3] != 1:
        raise FilterError(f"tensorflow: {node.op} node {node.name} pools "
                          "over the batch or channel axis — unsupported")
    pad = (node.attrs.get("padding") or b"VALID").decode()
    xc = x.permute(0, 3, 1, 2)
    pads = (0, 0, 0, 0)
    if pad == "SAME":
        (t, b), (l, r) = _same_pads(x.shape[1:3], ks[1:3], st[1:3], (1, 1))
        pads = (l, r, t, b)
    if kind == "max":
        xp = F.pad(xc, pads, value=-float("inf")) if any(pads) else xc
        y = F.max_pool2d(xp, ks[1:3], st[1:3])
    else:
        xp = F.pad(xc, pads) if any(pads) else xc
        total = F.avg_pool2d(xp, ks[1:3], st[1:3], divisor_override=1)
        ones = torch.ones_like(xc)
        ones = F.pad(ones, pads) if any(pads) else ones
        count = F.avg_pool2d(ones, ks[1:3], st[1:3], divisor_override=1)
        y = total / count
    return y.permute(0, 2, 3, 1)


def _binop(fn):
    return lambda node, ins, ctx: fn(ins[0], ins[1])


def _unary(fn):
    return lambda node, ins, ctx: fn(ins[0])


def _matmul(node, ins, ctx):
    a, b = ins[0], ins[1]
    if node.attrs.get("transpose_a"):
        a = a.T
    if node.attrs.get("transpose_b"):
        b = b.T
    return torch.matmul(a, b)


def _conv2d(node, ins, ctx):
    _require_nhwc(node)
    st = node.attrs.get("strides") or [1, 1, 1, 1]
    dl = node.attrs.get("dilations") or [1, 1, 1, 1]
    pad = (node.attrs.get("padding") or b"VALID").decode()
    return _nhwc_conv(ins[0], ins[1], (int(st[1]), int(st[2])), pad,
                      (int(dl[1]), int(dl[2])))


def _depthwise(node, ins, ctx):
    _require_nhwc(node)
    st = node.attrs.get("strides") or [1, 1, 1, 1]
    pad = (node.attrs.get("padding") or b"VALID").decode()
    w = ins[1]                       # TF layout [H, W, C, M]
    h, wd, c, m = w.shape
    w = w.reshape(h, wd, 1, c * m)
    return _nhwc_conv(ins[0], w, (int(st[1]), int(st[2])), pad,
                      feature_group_count=c)


def _bias_add(node, ins, ctx):
    _require_nhwc(node)       # NCHW would need the bias on axis 1
    return ins[0] + ins[1]


def _fused_bn(node, ins, ctx):
    _require_nhwc(node)
    x, scale, offset, mean, var = ins[:5]
    eps = _attr_or(node, "epsilon", 1e-3)
    inv = scale * (1.0 / torch.sqrt(var + eps))
    return x * inv + (offset - mean * inv)


def _static_ints(ctx, ref) -> List[int]:
    return [int(v) for v in np.asarray(ctx.static(ref)).reshape(-1)]


def _reshape(node, ins, ctx):
    return ins[0].reshape(_static_ints(ctx, _data_inputs(node)[1]))


def _reduce(kind: str):
    def run(node, ins, ctx):
        axes = tuple(_static_ints(ctx, _data_inputs(node)[1]))
        keep = bool(node.attrs.get("keep_dims") or
                    node.attrs.get("keepdims"))
        x = ins[0]
        if kind == "mean":
            return torch.mean(x, dim=axes, keepdim=keep)
        if kind == "sum":
            return torch.sum(x, dim=axes, keepdim=keep)
        if kind == "max":
            return torch.amax(x, dim=axes, keepdim=keep)
        return torch.amin(x, dim=axes, keepdim=keep)
    return run


def _concat(node, ins, ctx):
    refs = _data_inputs(node)
    axis = _static_ints(ctx, refs[-1])[0]
    return torch.cat(ins[:-1], dim=axis)


def _concat_v1(node, ins, ctx):
    """TF1 Concat takes the axis as its FIRST input (ConcatV2: last)."""
    refs = _data_inputs(node)
    axis = _static_ints(ctx, refs[0])[0]
    return torch.cat(ins[1:], dim=axis)


def _pad(node, ins, ctx):
    refs = _data_inputs(node)
    pads = np.asarray(ctx.static(refs[1]))
    cval = float(np.asarray(ctx.static(refs[2])).reshape(-1)[0]) \
        if len(refs) > 2 else 0.0
    flat: List[int] = []
    for a, b in pads[::-1]:
        flat += [int(a), int(b)]
    return F.pad(ins[0], flat, value=cval)


def _softmax(node, ins, ctx):
    return torch.softmax(ins[0], dim=-1)


def _argmax(node, ins, ctx):
    axis = _static_ints(ctx, _data_inputs(node)[1])[0]
    out_t = node.attrs.get("output_type") or 9
    return torch.argmax(ins[0], dim=axis).to(
        torch_dtype(_DTYPES.get(out_t, "int64")))


def _squeeze(node, ins, ctx):
    dims = node.attrs.get("squeeze_dims") or node.attrs.get("axis")
    if not dims:
        return torch.squeeze(ins[0])
    return torch.squeeze(ins[0], dim=tuple(int(d) for d in dims))


def _expand_dims(node, ins, ctx):
    axis = _static_ints(ctx, _data_inputs(node)[1])[0]
    if axis < 0:
        axis += ins[0].dim() + 1
    return torch.unsqueeze(ins[0], axis)


def _transpose(node, ins, ctx):
    return ins[0].permute(_static_ints(ctx, _data_inputs(node)[1]))


def _pack(node, ins, ctx):
    return torch.stack(ins, dim=int(node.attrs.get("axis") or 0))


def _shape(node, ins, ctx):
    return torch.tensor(tuple(ins[0].shape), dtype=torch.int32,
                        device=ins[0].device)


def _cast(node, ins, ctx):
    dt = node.attrs.get("DstT") or 1
    return ins[0].to(torch_dtype(_DTYPES.get(dt, "float32")))


def _strided_slice(node, ins, ctx):
    refs = _data_inputs(node)
    begin = np.asarray(ctx.static(refs[1])).reshape(-1)
    end = np.asarray(ctx.static(refs[2])).reshape(-1)
    strides = np.asarray(ctx.static(refs[3])).reshape(-1)
    bm = int(node.attrs.get("begin_mask") or 0)
    em = int(node.attrs.get("end_mask") or 0)
    sm = int(node.attrs.get("shrink_axis_mask") or 0)
    if node.attrs.get("new_axis_mask") or node.attrs.get("ellipsis_mask"):
        raise FilterError(
            "tensorflow: StridedSlice new_axis/ellipsis masks unsupported")
    x = ins[0]
    squeeze = []
    for i in range(len(begin)):
        if sm & (1 << i):
            b = int(begin[i])
            x = _slice_dim(x, i, b, b + 1 if b != -1 else None, 1)
            squeeze.append(i)
            continue
        b = None if bm & (1 << i) else int(begin[i])
        e = None if em & (1 << i) else int(end[i])
        x = _slice_dim(x, i, b, e, int(strides[i]))
    if squeeze:
        x = torch.squeeze(x, dim=tuple(squeeze))
    return x


def _leaky_relu(node, ins, ctx):
    return F.leaky_relu(ins[0], _attr_or(node, "alpha", 0.2))


def _make_ops() -> Dict[str, Callable]:
    ident = lambda node, ins, ctx: ins[0]  # noqa: E731
    return {
        "Identity": ident, "StopGradient": ident, "PreventGradient": ident,
        "CheckNumerics": ident, "PlaceholderWithDefault": ident,
        "Add": _binop(torch.add), "AddV2": _binop(torch.add),
        "BiasAdd": _bias_add,
        "Sub": _binop(torch.sub), "Mul": _binop(torch.mul),
        "RealDiv": _binop(torch.div), "Div": _binop(torch.div),
        "Maximum": _binop(torch.maximum), "Minimum": _binop(torch.minimum),
        "SquaredDifference": _binop(lambda a, b: (a - b) ** 2),
        "Pow": _binop(torch.pow),
        "MatMul": _matmul, "BatchMatMul": _binop(torch.matmul),
        "BatchMatMulV2": _binop(torch.matmul),
        "Conv2D": _conv2d, "DepthwiseConv2dNative": _depthwise,
        "FusedBatchNorm": _fused_bn, "FusedBatchNormV2": _fused_bn,
        "FusedBatchNormV3": _fused_bn,
        "MaxPool": lambda node, ins, ctx: _pool(ins[0], node, "max"),
        "AvgPool": lambda node, ins, ctx: _pool(ins[0], node, "avg"),
        "Relu": _unary(torch.relu),
        "Relu6": _unary(lambda x: torch.clamp(x, 0, 6)),
        "LeakyRelu": _leaky_relu,
        "Elu": _unary(F.elu), "Selu": _unary(F.selu),
        "Sigmoid": _unary(torch.sigmoid), "Tanh": _unary(torch.tanh),
        "Softmax": _softmax,
        "Rsqrt": _unary(torch.rsqrt), "Sqrt": _unary(torch.sqrt),
        "Square": _unary(torch.square), "Exp": _unary(torch.exp),
        "Log": _unary(torch.log), "Neg": _unary(torch.neg),
        "Abs": _unary(torch.abs), "Floor": _unary(torch.floor),
        "Round": _unary(torch.round),
        "Reshape": _reshape, "Squeeze": _squeeze,
        "ExpandDims": _expand_dims, "Transpose": _transpose,
        "Pack": _pack, "ConcatV2": _concat, "Concat": _concat_v1,
        "Pad": _pad, "PadV2": _pad,
        "Mean": _reduce("mean"), "Sum": _reduce("sum"),
        "Max": _reduce("max"), "Min": _reduce("min"),
        "ArgMax": _argmax, "Shape": _shape, "Cast": _cast,
        "StridedSlice": _strided_slice,
        "AudioSpectrogram": _audio_spectrogram, "Mfcc": _mfcc,
    }


def _audio_spectrogram(node, ins, ctx):
    from ...ops.audio import audio_spectrogram

    return audio_spectrogram(
        ins[0], int(node.attrs["window_size"]), int(node.attrs["stride"]),
        bool(node.attrs.get("magnitude_squared")))


def _mfcc(node, ins, ctx):
    """TF Mfcc.  The mel filterbank matrix is rate-dependent and built
    host-side, so the sample rate must be STATIC: the graph-level
    ``audio_rate`` (stamped by the DecodeWav hoist from the declared
    stream) wins, else 16 kHz (the speech-command default)."""
    from ...ops.audio import mfcc

    rate = float(getattr(ctx.graph, "audio_rate", 16000.0))
    return mfcc(
        ins[0], rate,
        channel_count=int(node.attrs.get("filterbank_channel_count", 40)),
        lower_limit=float(node.attrs.get("lower_frequency_limit", 20.0)),
        upper_limit=float(node.attrs.get("upper_frequency_limit", 4000.0)),
        dct_count=int(node.attrs.get("dct_coefficient_count", 13)))


_OPS: Optional[Dict[str, Callable]] = None


class TFGraph:
    """Parsed + lowered frozen graph."""

    def __init__(self, data: bytes):
        self.nodes = parse_graphdef(data)
        self.order = list(self.nodes)            # GraphDef is in def order

    def placeholders(self) -> List[_Node]:
        return [self.nodes[n] for n in self.order
                if self.nodes[n].op in ("Placeholder",
                                        "PlaceholderWithDefault")]

    def terminals(self) -> List[_Node]:
        consumed = set()
        for n in self.nodes.values():
            for ref in _data_inputs(n):
                consumed.add(_split_ref(ref)[0])
        return [self.nodes[n] for n in self.order
                if n not in consumed and self.nodes[n].op != "Const"]

    def topo_order(self, output_names: Sequence[str]) -> List[_Node]:
        """Iterative topological order of the subgraph feeding the outputs
        (no recursion — frozen graphs can be thousands of nodes deep)."""
        order: List[_Node] = []
        state: Dict[str, int] = {}               # 1 = visiting, 2 = done
        stack = [(n, False) for n in reversed(list(output_names))]
        while stack:
            name, processed = stack.pop()
            if processed:
                state[name] = 2
                order.append(self.nodes[name])
                continue
            if state.get(name) == 2:
                continue
            if state.get(name) == 1:
                raise FilterError(f"tensorflow: graph cycle at {name}")
            if name not in self.nodes:
                raise FilterError(f"tensorflow: missing node {name}")
            state[name] = 1
            stack.append((name, True))
            for ref in _data_inputs(self.nodes[name]):
                dep = _split_ref(ref)[0]
                if state.get(dep) != 2:
                    stack.append((dep, False))
        return order

    def build(self, input_names: Sequence[str],
              output_refs: Sequence[str]) -> Callable:
        """Return fn(consts_dict, *inputs) -> [outputs], one frame."""
        global _OPS
        if _OPS is None:
            _OPS = _make_ops()
        ops = _OPS
        supplied = {_split_ref(r)[0] for r in input_names}
        # reachable-from-outputs, STOPPING at supplied nodes: the subgraph
        # above a supplied node (e.g. the string Placeholder feeding a
        # hoisted DecodeWav) must not enter the plan
        reachable = set()
        stack = [_split_ref(r)[0] for r in output_refs]
        while stack:
            name = stack.pop()
            if name in reachable or name in supplied:
                continue
            reachable.add(name)
            node = self.nodes.get(name)
            if node is not None:
                stack.extend(_split_ref(r)[0]
                             for r in _data_inputs(node))
        plan = [n for n in self.topo_order(
            [_split_ref(r)[0] for r in output_refs])
            if n.name in reachable]
        inputs = list(input_names)

        def fn(consts: Dict[str, Any], *xs):
            env: Dict[str, Any] = {}
            for name, x in zip(inputs, xs):
                # inputs may be explicit refs ("node:1") — the DecodeWav
                # hoist feeds both of that node's outputs directly
                env[name if ":" in name else f"{name}:0"] = x
            ctx = _Ctx(self, env)
            for node in plan:
                if node.op == "Const":
                    env[f"{node.name}:0"] = consts[node.name]
                    continue
                handler = ops.get(node.op)
                if handler is None:
                    raise FilterError(
                        f"tensorflow: unsupported op {node.op} "
                        f"(node {node.name})")
                ins = [ctx.val(r) for r in _data_inputs(node)]
                out = handler(node, ins, ctx)
                if isinstance(out, (list, tuple)):
                    for i, o in enumerate(out):
                        env[f"{node.name}:{i}"] = o
                else:
                    env[f"{node.name}:0"] = out
            return [ctx.val(r) for r in output_refs]
        return fn


def parse_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes -> ((frames, channels) samples, rate).  PCM 8/16/32-bit
    and IEEE float32 (the port's copy of the JAX package's
    ``utils/mediadec.parse_wav``)."""
    import struct

    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("wav: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    samples = None
    while pos + 8 <= len(data):
        cid, ln = struct.unpack_from("<4sI", data, pos)
        body = data[pos + 8:pos + 8 + ln]
        pos += 8 + ln + (ln & 1)
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body)
        elif cid == b"data":
            samples = body
    if fmt is None or samples is None:
        raise ValueError("wav: missing fmt/data chunk")
    audio_fmt, channels, rate, _, _, bits = fmt
    if audio_fmt == 3 and bits == 32:
        arr = np.frombuffer(samples, np.float32)
    elif audio_fmt == 1 and bits == 16:
        arr = np.frombuffer(samples, np.int16)
    elif audio_fmt == 1 and bits == 8:
        arr = np.frombuffer(samples, np.uint8)
    elif audio_fmt == 1 and bits == 32:
        arr = np.frombuffer(samples, np.int32)
    else:
        raise ValueError(f"wav: format {audio_fmt}/{bits}bit unsupported")
    return arr.reshape(-1, max(channels, 1)).copy(), rate


def _make_wav_pre(desired_samples: int, desired_channels: int,
                  static_rate: int):
    """Host preprocessing for the DecodeWav hoist: raw wav-file bytes →
    [audio float32 (samples, channels) in [-1, 1), rate int32] with TF's
    trim/pad-to-desired semantics."""
    def pre(inputs):
        raw = np.ascontiguousarray(to_host(inputs[0])).tobytes()
        samples, rate = parse_wav(raw)
        if rate != static_rate:
            raise FilterError(
                f"tensorflow: wav sample rate {rate} != the rate the "
                f"Mfcc filterbank was built for ({static_rate}); set "
                "custom=audio_rate:<hz> to match the stream")
        if samples.dtype == np.int16:
            audio = samples.astype(np.float32) / 32768.0
        elif samples.dtype == np.uint8:
            audio = (samples.astype(np.float32) - 128.0) / 128.0
        else:
            audio = samples.astype(np.float32)
        if desired_channels:
            if audio.shape[1] > desired_channels:
                audio = audio[:, :desired_channels]
            elif audio.shape[1] < desired_channels:
                # TF DecodeWav repeats the last channel to fill
                pad = np.repeat(audio[:, -1:],
                                desired_channels - audio.shape[1], axis=1)
                audio = np.concatenate([audio, pad], axis=1)
        if desired_samples:
            n = audio.shape[0]
            if n >= desired_samples:
                audio = audio[:desired_samples]
            else:
                audio = np.pad(audio,
                               ((0, desired_samples - n), (0, 0)))
        return [audio, np.int32(rate)]

    return pre


@register_filter
class TensorFlowFilter(TorchExecMixin, FilterFramework):
    """``framework=tensorflow``: frozen .pb GraphDef on the card."""

    NAME = "tensorflow"
    SUPPORTED_ACCELERATORS = (Accelerator.GPU, Accelerator.CPU)

    def __init__(self) -> None:
        super().__init__()
        self._graph: Optional[TFGraph] = None
        self._host_pre = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self.stats = FilterStatistics()

    # -- lifecycle -----------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        path = str(props.model)
        if not os.path.isfile(path):
            raise FilterError(f"tensorflow: model file not found: {path}")
        with open(path, "rb") as f:
            graph = TFGraph(f.read())

        custom = props.custom_properties
        # inputname entries address placeholder NODES: strip a ':idx'
        # suffix (outputname keeps/normalizes it, since outputs are refs)
        in_names = [_split_ref(s)[0] for s in
                    (custom.get("inputname") or "").split(",") if s]
        out_names = [s for s in
                     (custom.get("outputname") or "").split(",") if s]
        if not in_names:
            in_names = [n.name for n in graph.placeholders()]
        if not in_names:
            raise FilterError("tensorflow: no Placeholder inputs found; "
                              "set custom=inputname:...")
        if not out_names:
            out_names = [n.name for n in graph.terminals()]
        if not out_names:
            raise FilterError("tensorflow: no terminal outputs found; "
                              "set custom=outputname:...")
        out_refs = [r if ":" in r else f"{r}:0" for r in out_names]

        # input meta: declared > placeholder shape attr
        if props.input_info is not None and props.input_info.is_valid():
            in_info = props.input_info.copy()
            if in_info.num_tensors != len(in_names):
                raise FilterError(
                    f"tensorflow: {len(in_names)} graph inputs but "
                    f"input_info has {in_info.num_tensors}")
        else:
            infos = []
            for name in in_names:
                node = graph.nodes.get(name)
                if node is None:
                    raise FilterError(f"tensorflow: no node {name}")
                shape = node.attrs.get("shape")
                dt = node.attrs.get("dtype") or 1
                if not shape or any(s <= 0 for s in shape):
                    raise FilterError(
                        f"tensorflow: input {name} has undefined shape "
                        f"{shape}; declare input_info (reference requires "
                        "explicit input dims too)")
                infos.append(TensorInfo.from_np(
                    np.zeros(shape, _DTYPES.get(dt, "float32")), name=name))
            in_info = TensorsInfo(infos)

        # DecodeWav hoist: byte parsing cannot trace, so when the (single)
        # input is a string Placeholder feeding DecodeWav, the wav decode
        # runs HOST-SIDE per frame and the jitted graph starts at the
        # decoded (audio, rate) pair (reference parity: the TF runtime's
        # DecodeWav is host work too).
        self._host_pre = None
        self._wav_shape = None
        build_in = list(in_names)
        warm = None
        # the Mfcc filterbank is rate-dependent and built at trace time:
        # honor custom=audio_rate for ANY graph containing Mfcc
        rate = int(custom.get("audio_rate", "16000"))
        graph.audio_rate = float(rate)
        if len(in_names) == 1:
            decode = next(
                (n for n in graph.nodes.values() if n.op == "DecodeWav"
                 and _split_ref(n.inputs[0])[0] == in_names[0]), None)
            if decode is not None:
                want_n = int(decode.attrs.get("desired_samples") or 0) \
                    or int(custom.get("audio_samples", "0"))
                ch = decode.attrs.get("desired_channels")
                want_c = int(ch) if ch is not None else 1
                if want_n <= 0:
                    raise FilterError(
                        "tensorflow: DecodeWav without desired_samples "
                        "is dynamically shaped; set "
                        "custom=audio_samples:<n> to pin the length")
                self._host_pre = _make_wav_pre(want_n, want_c, rate)
                self._wav_shape = (want_n, want_c)
                build_in = [f"{decode.name}:0", f"{decode.name}:1"]
                warm = [np.zeros((want_n, want_c), np.float32),
                        np.int32(rate)]

        fn = graph.build(build_in, out_refs)
        device = self._pick_device(props.accelerators)
        consts = {n.name: torch.as_tensor(np.array(n.const), device=device)
                  for n in graph.nodes.values() if n.const is not None}
        self._graph = graph

        zeros = warm if warm is not None else [
            np.zeros(i.np_shape, i.np_dtype) for i in in_info]
        cdtype = self._resolve_compute(props, device)
        if cdtype is not None:
            fn, consts = _wrap_compute_dtype(fn, consts, cdtype,
                                             example_inputs=zeros)
        outs = self._setup_exec(lambda *xs: tuple(fn(consts, *xs)), device,
                                warmup_inputs=zeros)
        probed = TensorsInfo([TensorInfo.from_np(to_host(o), name=r)
                              for o, r in zip(outs, out_refs)])
        if props.output_info is not None and props.output_info.is_valid():
            if not props.output_info.is_equal(probed):
                raise FilterError(
                    f"tensorflow: declared output {props.output_info} != "
                    f"graph output {probed}")
            self._out_info = props.output_info.copy()
        else:
            self._out_info = probed
        self._in_info = in_info
        super().open(props)

    def close(self) -> None:
        self._graph = None
        self._host_pre = None
        self._teardown_exec()
        super().close()

    # -- hot path: host preprocessing (DecodeWav hoist) ----------------------
    def invoke(self, inputs):
        if self._host_pre is not None:
            inputs = self._host_pre(inputs)
        return super().invoke(inputs)

    def invoke_batched(self, frames, bucket: int, emit_device: bool = False):
        if self._host_pre is not None:
            frames = [self._host_pre(f) for f in frames]
        return super().invoke_batched(frames, bucket,
                                      emit_device=emit_device)

    def _zeros(self, rows=None):
        if self._host_pre is None:
            return super()._zeros(rows)
        # the DECODED shapes, not the byte-blob info
        n, c = self._wav_shape
        lead = () if rows is None else (rows,)
        return [np.zeros(lead + (n, c), np.float32),
                np.zeros(lead, np.int32)]

    # -- model meta ----------------------------------------------------------
    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        if self._graph is None:
            raise FilterError("tensorflow: not opened")
        return self._in_info, self._out_info

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        if not isinstance(model, str) or not model.endswith(".pb"):
            return False
        # a comma pair of .pb files is a caffe2 NetDef bundle, not a
        # GraphDef; a comma elsewhere in the path is still ours
        parts = [p.strip() for p in model.split(",") if p.strip()]
        return not (len(parts) == 2 and all(p.endswith(".pb")
                                            for p in parts))
