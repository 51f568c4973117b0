"""Caffe2 NetDef filter backend (dependency-free).

The port of ``nnstreamer_tpu/filter/backends/caffe2.py`` (reference:
ext/nnstreamer/tensor_filter/tensor_filter_caffe2.cc).  Both NetDef
protobufs are parsed with the in-tree wire reader (``utils/protowire.py``),
the init net is *executed at open* (``_run_init_net``) to produce the
weights, every predict-net operator is lowered to torch in NCHW (torch's
own layout), and the net is served through
:class:`~._torchexec.TorchExecMixin`: weights resident on the card, one
CUDA graph per input signature, batching through ``torch.func.vmap``;
``custom=compute:`` is the shared compute-dtype policy.

Contract (the reference's properties, tensor_filter_caffe2.cc:146-233):

- ``model`` is the comma pair ``init_net.pb,predict_net.pb``.
- input selection: custom property ``inputname=data``; default:
  predict-net ``external_input`` blobs that the init net does not
  produce.
- ``input_info`` is REQUIRED (NetDef carries no shape metadata).
- output selection: ``outputname=softmax``; default: terminal blobs
  (produced, never consumed).  Output meta is probed with the open-time
  warm-up invoke.

Only NCHW nets are supported (caffe2's default ``order``, as the
reference).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...tensor.buffer import to_host
from ...tensor.info import TensorInfo, TensorsInfo
from ...utils.protowire import (fields_dict, first, packed_or_repeated_fixed32,
                                packed_or_repeated_varints, repeated,
                                to_signed64)
from ..framework import (Accelerator, FilterError, FilterFramework,
                         FilterProperties, FilterStatistics, register_filter)
from ._torchexec import TorchExecMixin, _wrap_compute_dtype

# ---------------------------------------------------------------------------
# caffe2.proto wire schema (field numbers from pytorch/caffe2/proto)
# ---------------------------------------------------------------------------
# NetDef:      name=1, op=2, type=3, external_input=7, external_output=8
# OperatorDef: input=1, output=2, name=3, type=4, arg=5, device_option=6,
#              engine=7
# Argument:    name=1, f=2(fixed32), i=3(varint), s=4, floats=5, ints=6,
#              strings=7


class _Arg:
    """One OperatorDef.Argument with typed accessors."""

    __slots__ = ("_d",)

    def __init__(self, d) -> None:
        self._d = d

    @property
    def f(self) -> float:
        import struct

        v = first(self._d, 2)
        return struct.unpack("<f", v.to_bytes(4, "little"))[0] if v else 0.0

    @property
    def i(self) -> int:
        return to_signed64(first(self._d, 3, 0) or 0)

    @property
    def s(self) -> bytes:
        return first(self._d, 4, b"") or b""

    @property
    def floats(self) -> List[float]:
        return packed_or_repeated_fixed32(self._d.get(5, []), "<f")

    @property
    def ints(self) -> List[int]:
        return [to_signed64(v)
                for v in packed_or_repeated_varints(self._d.get(6, []))]


class _Op:
    __slots__ = ("type", "inputs", "outputs", "args")

    def __init__(self, buf: bytes) -> None:
        d = fields_dict(buf)
        self.inputs = [v.decode() for v in repeated(d, 1)]
        self.outputs = [v.decode() for v in repeated(d, 2)]
        self.type = (first(d, 4, b"") or b"").decode()
        self.args: Dict[str, _Arg] = {}
        for _, a in d.get(5, []):
            ad = fields_dict(a)
            self.args[(first(ad, 1, b"") or b"").decode()] = _Arg(ad)

    # -- arg conveniences ----------------------------------------------------
    def geti(self, name: str, default: int = 0) -> int:
        a = self.args.get(name)
        return a.i if a is not None else default

    def getf(self, name: str, default: float = 0.0) -> float:
        a = self.args.get(name)
        return a.f if a is not None else default

    def ints(self, name: str) -> Optional[List[int]]:
        a = self.args.get(name)
        return a.ints if a is not None else None

    def order(self) -> str:
        a = self.args.get("order")
        return a.s.decode() if a is not None and a.s else "NCHW"


class _NetDef:
    __slots__ = ("name", "ops", "external_input", "external_output")

    def __init__(self, data: bytes) -> None:
        d = fields_dict(data)
        self.name = (first(d, 1, b"") or b"").decode()
        self.ops = [_Op(b) for b in repeated(d, 2)]
        self.external_input = [v.decode() for v in repeated(d, 7)]
        self.external_output = [v.decode() for v in repeated(d, 8)]


# ---------------------------------------------------------------------------
# init-net execution: fills → parameter pytree
# ---------------------------------------------------------------------------

def _run_init_net(net: _NetDef) -> Dict[str, np.ndarray]:
    params: Dict[str, np.ndarray] = {}
    for op in net.ops:
        if not op.outputs:
            continue
        shape = tuple(op.ints("shape") or [])
        n = int(np.prod(shape)) if shape else 1
        if op.type == "GivenTensorFill":
            arr = np.array(op.args["values"].floats, np.float32)
        elif op.type in ("GivenTensorIntFill", "GivenTensorBoolFill"):
            arr = np.array(op.args["values"].ints, np.int32)
        elif op.type == "GivenTensorInt64Fill":
            arr = np.array(op.args["values"].ints, np.int64)
        elif op.type == "ConstantFill":
            # dtype arg: caffe2 TensorProto.DataType (1=float default);
            # integer dtypes carry the fill in the Argument `i` field
            if op.geti("dtype", 1) in (1, 12, 13):  # FLOAT/FLOAT16/DOUBLE
                arr = np.full(n, op.getf("value", 0.0), np.float32)
            else:
                arr = np.full(n, op.geti("value", 0), np.int32)
        else:
            raise FilterError(
                f"caffe2: init net op {op.type!r} is not a deterministic "
                "fill — deploy init nets must carry trained weights")
        if arr.size != n:
            raise FilterError(
                f"caffe2: fill for {op.outputs[0]!r} has {arr.size} values "
                f"but shape {shape}")
        params[op.outputs[0]] = arr.reshape(shape)
    return params


# ---------------------------------------------------------------------------
# predict-net lowering: each op type -> torch ops on the blob dict
# ---------------------------------------------------------------------------

def _conv_hw(op: _Op, name: str, default: int) -> Tuple[int, int]:
    """Resolve a possibly-anisotropic conv/pool hyperparameter:
    ``kernel``/``kernels``/``kernel_h``+``kernel_w`` (same family for
    stride/dilation)."""
    many = op.ints(name + "s")
    if many:
        return (many[0], many[1] if len(many) > 1 else many[0])
    h = op.geti(name + "_h", 0)
    w = op.geti(name + "_w", 0)
    if h or w:
        return (h or default, w or default)
    v = op.geti(name, default)
    return (v, v)


def _pads(op: _Op) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """caffe2 pad resolution: ``pads`` [t,l,b,r] > pad_t/l/b/r > ``pad``."""
    many = op.ints("pads")
    if many and len(many) >= 4:
        return ((many[0], many[2]), (many[1], many[3]))
    if any(op.args.get(k) for k in ("pad_t", "pad_l", "pad_b", "pad_r")):
        return ((op.geti("pad_t"), op.geti("pad_b")),
                (op.geti("pad_l"), op.geti("pad_r")))
    p = op.geti("pad", 0)
    return ((p, p), (p, p))


def _require_nchw(op: _Op) -> None:
    if op.order() != "NCHW":
        raise FilterError(f"caffe2: {op.type} order={op.order()!r} "
                          "unsupported (NCHW only, like the reference)")


def _axis_broadcast(b, x_ndim: int, axis: int):
    """caffe2 broadcast=1 semantics: align B's dims with X starting at
    ``axis`` (default: suffix alignment, axis = ndim(X) - ndim(B))."""
    b_ndim = b.dim()
    if axis < 0:
        axis = x_ndim - b_ndim
    shape = [1] * x_ndim
    shape[axis:axis + b_ndim] = list(b.shape)
    return b.reshape(shape)


def _pool2d(x, kind: str, k, s, pad, count_include_pad: bool):
    """Max or average pooling of NCHW ``x`` with explicit ((t, b), (l, r))
    padding; the exclude-pad average divides by the valid count."""
    (t, b), (l, r) = pad
    pads = (l, r, t, b)
    if kind == "max":
        xp = F.pad(x, pads, value=-float("inf")) if any(pads) else x
        return F.max_pool2d(xp, k, s)
    xp = F.pad(x, pads) if any(pads) else x
    total = F.avg_pool2d(xp, k, s, divisor_override=1)
    if count_include_pad:
        return total / float(k[0] * k[1])
    ones = torch.ones_like(x)
    ones = F.pad(ones, pads) if any(pads) else ones
    return total / F.avg_pool2d(ones, k, s, divisor_override=1)


def _lower_op(op: _Op, blobs: Dict[str, Any]) -> None:
    ins = [blobs[n] for n in op.inputs] \
        if op.type in ("Sum", "Concat") else None
    t = op.type

    if t == "Conv":
        _require_nchw(op)
        x, w = blobs[op.inputs[0]], blobs[op.inputs[1]]
        sh, sw = _conv_hw(op, "stride", 1)
        dh, dw = _conv_hw(op, "dilation", 1)
        (pt, pb), (pl, pr) = _pads(op)
        if pt == pb and pl == pr:
            padding: Any = (pt, pl)
        else:
            x, padding = F.pad(x, (pl, pr, pt, pb)), 0
        y = F.conv2d(x, w, stride=(sh, sw), padding=padding,
                     dilation=(dh, dw), groups=op.geti("group", 1))
        if len(op.inputs) > 2:
            y = y + blobs[op.inputs[2]].reshape(1, -1, 1, 1)
        blobs[op.outputs[0]] = y
    elif t == "SpatialBN":
        _require_nchw(op)
        if op.geti("is_test", 0) != 1:
            raise FilterError("caffe2: SpatialBN with is_test=0 in a "
                              "predict net (training-mode BN)")
        x = blobs[op.inputs[0]]
        s, b, rm, rv = (blobs[op.inputs[k]] for k in range(1, 5))
        eps = op.getf("epsilon", 1e-5)
        inv = s * torch.rsqrt(rv + eps)
        blobs[op.outputs[0]] = (x * inv.reshape(1, -1, 1, 1)
                                + (b - rm * inv).reshape(1, -1, 1, 1))
    elif t == "Relu":
        blobs[op.outputs[0]] = torch.relu(blobs[op.inputs[0]])
    elif t == "LeakyRelu":
        blobs[op.outputs[0]] = F.leaky_relu(
            blobs[op.inputs[0]], op.getf("alpha", 0.01))
    elif t == "Sigmoid":
        blobs[op.outputs[0]] = torch.sigmoid(blobs[op.inputs[0]])
    elif t == "Tanh":
        blobs[op.outputs[0]] = torch.tanh(blobs[op.inputs[0]])
    elif t == "Softmax":
        x = blobs[op.inputs[0]]
        axis = op.geti("axis", 1)
        flat = x.reshape((int(np.prod(x.shape[:axis])), -1))
        blobs[op.outputs[0]] = torch.softmax(flat, dim=1).reshape(x.shape)
    elif t == "Sum":
        acc = ins[0]
        for other in ins[1:]:
            acc = acc + other
        blobs[op.outputs[0]] = acc
    elif t in ("Add", "Sub", "Mul", "Div"):
        x, b = blobs[op.inputs[0]], blobs[op.inputs[1]]
        if op.geti("broadcast", 0) and b.dim() < x.dim():
            b = _axis_broadcast(b, x.dim(), op.geti("axis", -1))
        fn = {"Add": torch.add, "Sub": torch.sub,
              "Mul": torch.mul, "Div": torch.div}[t]
        blobs[op.outputs[0]] = fn(x, b)
    elif t in ("AveragePool", "MaxPool"):
        _require_nchw(op)
        if op.geti("legacy_pad", 0) == 3:  # CAFFE_LEGACY_POOLING ceil mode
            raise FilterError("caffe2: CAFFE legacy ceil-mode pooling "
                              "unsupported")
        x = blobs[op.inputs[0]]
        if op.geti("global_pooling", 0):
            kh, kw = x.shape[-2], x.shape[-1]
            sh = sw = 1
            pad = ((0, 0), (0, 0))
        else:
            kh, kw = _conv_hw(op, "kernel", 1)
            sh, sw = _conv_hw(op, "stride", 1)
            pad = _pads(op)
        blobs[op.outputs[0]] = _pool2d(
            x, "max" if t == "MaxPool" else "avg", (kh, kw), (sh, sw), pad,
            bool(op.geti("count_include_pad", 0)))
    elif t == "FC":
        x, w = blobs[op.inputs[0]], blobs[op.inputs[1]]
        axis = op.geti("axis", 1)
        axis_w = op.geti("axis_w", 1)
        x2 = x.reshape((int(np.prod(x.shape[:axis])), -1))
        w2 = w.reshape((int(np.prod(w.shape[:axis_w])), -1))
        y = x2 @ w2.T
        if len(op.inputs) > 2:
            y = y + blobs[op.inputs[2]]
        blobs[op.outputs[0]] = y
    elif t == "Flatten":
        x = blobs[op.inputs[0]]
        axis = op.geti("axis", 1)
        blobs[op.outputs[0]] = x.reshape(
            (int(np.prod(x.shape[:axis])), -1))
    elif t == "Reshape":
        if len(op.inputs) > 1:
            raise FilterError("caffe2: Reshape with a computed shape blob "
                              "is dynamically shaped — unsupported "
                              "(declare the shape as an arg)")
        x = blobs[op.inputs[0]]
        shape = op.ints("shape") or []
        shape = [x.shape[i] if s == 0 else s for i, s in enumerate(shape)]
        blobs[op.outputs[0]] = x.reshape(shape)
        if len(op.outputs) > 1:  # old_shape side output
            blobs[op.outputs[1]] = torch.tensor(
                tuple(x.shape), dtype=torch.int64, device=x.device)
    elif t == "Squeeze":
        x = blobs[op.inputs[0]]
        dims = op.ints("dims") or []
        blobs[op.outputs[0]] = torch.squeeze(x, dim=tuple(dims)) if dims \
            else x
    elif t == "ExpandDims":
        x = blobs[op.inputs[0]]
        for d in sorted(op.ints("dims") or []):
            x = torch.unsqueeze(x, d)
        blobs[op.outputs[0]] = x
    elif t == "Concat":
        axis = op.geti("axis", 1)
        if op.args.get("order") is not None and not op.args.get("axis"):
            axis = 1 if op.order() == "NCHW" else 3
        if op.geti("add_axis", 0):
            blobs[op.outputs[0]] = torch.stack(ins, dim=axis)
            widths = [1] * len(ins)
        else:
            blobs[op.outputs[0]] = torch.cat(ins, dim=axis)
            widths = [x.shape[axis] for x in ins]
        if len(op.outputs) > 1:  # split_info side output
            blobs[op.outputs[1]] = torch.tensor(
                widths, dtype=torch.int32, device=ins[0].device)
    elif t == "Transpose":
        x = blobs[op.inputs[0]]
        axes = op.ints("axes") or list(range(x.dim()))[::-1]
        blobs[op.outputs[0]] = x.permute(axes)
    elif t == "Dropout":
        if op.geti("is_test", 0) != 1:
            raise FilterError("caffe2: Dropout with is_test=0 in a "
                              "predict net")
        blobs[op.outputs[0]] = blobs[op.inputs[0]]
        if len(op.outputs) > 1:  # unused mask output
            blobs[op.outputs[1]] = torch.ones_like(blobs[op.inputs[0]])
    elif t == "Copy" or t == "StopGradient" or t == "Alias":
        blobs[op.outputs[0]] = blobs[op.inputs[0]]
    elif t == "Scale":
        blobs[op.outputs[0]] = blobs[op.inputs[0]] * op.getf("scale", 1.0)
    elif t == "Clip":
        blobs[op.outputs[0]] = torch.clamp(
            blobs[op.inputs[0]], op.getf("min", -np.inf),
            op.getf("max", np.inf))
    else:
        raise FilterError(f"caffe2: operator {t!r} not lowered "
                          "(file an op request; ~25 deploy ops supported)")


def _build_forward(net: _NetDef, in_names: Sequence[str],
                   out_names: Sequence[str]) -> Callable:
    def forward(params: Dict[str, Any], *inputs):
        blobs: Dict[str, Any] = dict(params)
        for name, x in zip(in_names, inputs):
            blobs[name] = x
        for op in net.ops:
            _lower_op(op, blobs)
        return tuple(blobs[n] for n in out_names)

    return forward


def _terminal_blobs(net: _NetDef) -> List[str]:
    consumed = {n for op in net.ops for n in op.inputs}
    seen, order = set(), []
    for op in net.ops:
        for out in op.outputs:
            if out not in consumed and out not in seen:
                seen.add(out)
                order.append(out)
    return order


# ---------------------------------------------------------------------------
# the filter
# ---------------------------------------------------------------------------

@register_filter
class Caffe2Filter(TorchExecMixin, FilterFramework):
    """``framework=caffe2``: NetDef pair on the card."""

    NAME = "caffe2"
    SUPPORTED_ACCELERATORS = (Accelerator.GPU, Accelerator.CPU)

    def __init__(self) -> None:
        super().__init__()
        self._net: Optional[_NetDef] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self.stats = FilterStatistics()

    @staticmethod
    def _split_model(model: Any) -> Tuple[str, str]:
        parts = [p.strip() for p in str(model).split(",") if p.strip()]
        if len(parts) != 2:
            raise FilterError(
                "caffe2: model must be 'init_net.pb,predict_net.pb' "
                f"(reference two-file contract), got {model!r}")
        return parts[0], parts[1]

    def open(self, props: FilterProperties) -> None:
        init_path, pred_path = self._split_model(props.model)
        for p in (init_path, pred_path):
            if not os.path.isfile(p):
                raise FilterError(f"caffe2: model file not found: {p}")
        with open(init_path, "rb") as f:
            init_net = _NetDef(f.read())
        with open(pred_path, "rb") as f:
            net = _NetDef(f.read())
        # Accept either file order: the net whose ops are all fills is init.
        def _is_init(n: _NetDef) -> bool:
            return bool(n.ops) and all(
                o.type.endswith("Fill") for o in n.ops)
        if not _is_init(init_net) and _is_init(net):
            init_net, net = net, init_net

        params = _run_init_net(init_net)

        custom = props.custom_properties
        in_names = [s for s in
                    (custom.get("inputname") or "").split(",") if s]
        out_names = [s for s in
                     (custom.get("outputname") or "").split(",") if s]
        if not in_names:
            in_names = [n for n in net.external_input if n not in params]
        if not in_names and net.external_input:
            # init nets often ConstantFill a placeholder for the data blob
            # too; caffe2 convention orders the real input first
            in_names = [net.external_input[0]]
        if not in_names:
            raise FilterError("caffe2: cannot infer input blobs; set "
                              "custom=inputname:...")
        if not out_names:
            out_names = net.external_output or _terminal_blobs(net)
        if not out_names:
            raise FilterError("caffe2: cannot infer output blobs; set "
                              "custom=outputname:...")

        if props.input_info is None or not props.input_info.is_valid():
            raise FilterError(
                "caffe2: input_info is required (NetDef has no shape "
                "metadata; the reference requires explicit input dims too)")
        in_info = props.input_info.copy()
        if in_info.num_tensors != len(in_names):
            raise FilterError(
                f"caffe2: {len(in_names)} input blobs but input_info has "
                f"{in_info.num_tensors}")

        # drop weights the predict net never reads: no dead device residency
        # (outputs count as reads: outputname may address a constant blob)
        used = {n for op in net.ops for n in op.inputs} | set(out_names)
        params = {k: v for k, v in params.items() if k in used}
        missing = [n for op in net.ops for n in op.inputs
                   if n not in params and n not in in_names
                   and not any(n in o.outputs for o in net.ops)]
        if missing:
            raise FilterError(f"caffe2: blobs never produced: {missing[:4]}")
        produced = ({n for op in net.ops for n in op.outputs}
                    | set(params) | set(in_names))
        bad_outs = [n for n in out_names if n not in produced]
        if bad_outs:
            raise FilterError(f"caffe2: outputname blobs not produced by "
                              f"the net: {bad_outs}")

        fn = _build_forward(net, in_names, out_names)
        device = self._pick_device(props.accelerators)
        self._net = net

        zeros = [np.zeros(i.np_shape, i.np_dtype) for i in in_info]
        params = {k: torch.as_tensor(np.array(v), device=device)
                  for k, v in params.items()}
        cdtype = self._resolve_compute(props, device)
        if cdtype is not None:
            fn, params = _wrap_compute_dtype(fn, params, cdtype,
                                             example_inputs=zeros)
        outs = self._setup_exec(lambda *xs: tuple(fn(params, *xs)), device,
                                warmup_inputs=zeros)
        probed = TensorsInfo([TensorInfo.from_np(to_host(o), name=n)
                              for o, n in zip(outs, out_names)])
        if props.output_info is not None and props.output_info.is_valid():
            if not props.output_info.is_equal(probed):
                raise FilterError(
                    f"caffe2: declared output {props.output_info} != net "
                    f"output {probed}")
            self._out_info = props.output_info.copy()
        else:
            self._out_info = probed
        self._in_info = in_info
        super().open(props)

    def close(self) -> None:
        self._net = None
        self._teardown_exec()
        super().close()

    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        if self._net is None:
            raise FilterError("caffe2: not opened")
        return self._in_info, self._out_info

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        if not isinstance(model, str) or "," not in model:
            return False
        parts = [p.strip() for p in model.split(",") if p.strip()]
        return len(parts) == 2 and all(p.endswith(".pb") for p in parts)
