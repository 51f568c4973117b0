"""MXNet filter backend (dependency-free).

The port of ``nnstreamer_tpu/filter/backends/mxnet.py`` (reference:
ext/nnstreamer/tensor_filter/tensor_filter_mxnet.cc).  The symbol graph
(``model.json``) is parsed as plain JSON, the companion ``model.params``
NDArray-list file is decoded with the in-tree reader (:func:`load_params`;
:func:`save_params` writes the same format), every node is lowered to
torch (NCHW), and the net is served through
:class:`~._torchexec.TorchExecMixin`: weights resident on the card, one
CUDA graph per input signature, batching through ``torch.func.vmap``;
``custom=compute:`` is the shared compute-dtype policy.

Contract (the reference's properties, tensor_filter_mxnet.cc:125-233):

- ``model`` is the symbol ``.json`` path; weights load from the same-stem
  ``.params`` file, or an explicit second comma-separated path.
- ``input_info`` is REQUIRED (the symbol file carries no input shapes).
- default inputs: ``null`` nodes that are not bound by the params file;
  default outputs: the graph ``heads``.  ``inputname``/``outputname``
  custom props override both.

``.params`` wire format: the MXNet NDArray-list layout (uint64 list magic
0x112, per-array V2 magic 0xf993fac9 + storage type + int64 shape +
context + dtype + raw data, then the ``arg:``/``aux:``-prefixed name
table).  Only dense (kDefaultStorage) arrays are supported.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...tensor.buffer import to_host
from ...tensor.info import TensorInfo, TensorsInfo
from ..framework import (Accelerator, FilterError, FilterFramework,
                         FilterProperties, FilterStatistics, register_filter)
from ._torchexec import (TorchExecMixin, _wrap_compute_dtype,
                         torch_dtype)

# -- .params NDArray-list wire constants (mxnet ndarray.cc) ------------------

_LIST_MAGIC = 0x112            # kMXAPINDArrayListMagic
_ND_V2_MAGIC = 0xF993FAC9      # NDARRAY_V2_MAGIC (adds storage type)
_ND_V3_MAGIC = 0xF993FACA      # NDARRAY_V3_MAGIC (adds byte order)

#: mxnet type_flag → numpy
_DTYPES = {0: "float32", 1: "float64", 2: "float16", 3: "uint8", 4: "int32",
           5: "int8", 6: "int64"}


class _Reader:
    __slots__ = ("buf", "off")

    def __init__(self, buf: bytes) -> None:
        self.buf, self.off = buf, 0

    def u32(self) -> int:
        v = struct.unpack_from("<I", self.buf, self.off)[0]
        self.off += 4
        return v

    def i32(self) -> int:
        v = struct.unpack_from("<i", self.buf, self.off)[0]
        self.off += 4
        return v

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.buf, self.off)[0]
        self.off += 8
        return v

    def i64(self) -> int:
        v = struct.unpack_from("<q", self.buf, self.off)[0]
        self.off += 8
        return v

    def raw(self, n: int) -> bytes:
        v = self.buf[self.off:self.off + n]
        if len(v) != n:
            raise FilterError("mxnet: truncated .params file")
        self.off += n
        return v


def _read_ndarray(r: _Reader) -> np.ndarray:
    magic = r.u32()
    if magic == _ND_V3_MAGIC:
        if r.u32() != 1:
            raise FilterError("mxnet: non-little-endian .params")
        magic = _ND_V2_MAGIC
    if magic == _ND_V2_MAGIC:
        stype = r.i32()
        if stype != 0:  # kDefaultStorage
            raise FilterError(f"mxnet: sparse storage type {stype} "
                              "unsupported (dense deploy weights only)")
        ndim = r.u32()
        shape = tuple(r.i64() for _ in range(ndim))
    else:
        # V1/legacy: magic was actually the uint32 ndim of a headerless
        # record
        ndim = magic
        if ndim > 32:
            raise FilterError(f"mxnet: unrecognized .params record "
                              f"(magic 0x{magic:x})")
        shape = tuple(r.u32() for _ in range(ndim))
    r.i32()  # context dev_type
    r.i32()  # context dev_id
    type_flag = r.i32()
    if type_flag not in _DTYPES:
        raise FilterError(f"mxnet: unsupported dtype flag {type_flag}")
    dtype = np.dtype(_DTYPES[type_flag])
    n = int(np.prod(shape)) if shape else 1
    data = r.raw(n * dtype.itemsize)
    return np.frombuffer(data, dtype).reshape(shape).copy()


def load_params(path: str) -> Dict[str, np.ndarray]:
    """Decode an NDArray-list ``.params`` file into name → array,
    stripping the ``arg:``/``aux:`` role prefixes."""
    with open(path, "rb") as f:
        r = _Reader(f.read())
    if r.u64() != _LIST_MAGIC:
        raise FilterError(f"mxnet: {path} is not an NDArray-list file")
    r.u64()  # reserved
    arrays = [_read_ndarray(r) for _ in range(r.u64())]
    names = []
    for _ in range(r.u64()):
        names.append(r.raw(r.u64()).decode())
    if len(names) != len(arrays):
        raise FilterError("mxnet: .params name/array count mismatch")
    out = {}
    for name, arr in zip(names, arrays):
        if ":" in name:
            name = name.split(":", 1)[1]
        out[name] = arr
    return out


def save_params(path: str, params: Dict[str, np.ndarray],
                role: str = "arg") -> None:
    """Write the same wire format (test fixture / checkpoint export)."""
    with open(path, "wb") as f:
        f.write(struct.pack("<QQ", _LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(params)))
        rev_dtypes = {v: k for k, v in _DTYPES.items()}
        for arr in params.values():
            arr = np.ascontiguousarray(arr)
            f.write(struct.pack("<Ii", _ND_V2_MAGIC, 0))
            f.write(struct.pack("<I", arr.ndim))
            f.write(struct.pack(f"<{arr.ndim}q", *arr.shape))
            f.write(struct.pack("<ii", 1, 0))  # cpu context
            f.write(struct.pack("<i", rev_dtypes[str(arr.dtype)]))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", len(params)))
        for name in params:
            key = f"{role}:{name}".encode()
            f.write(struct.pack("<Q", len(key)) + key)


# -- symbol-JSON attribute helpers -------------------------------------------

def _tuple_attr(attrs: Dict[str, str], key: str,
                default: Tuple[int, ...]) -> Tuple[int, ...]:
    """Parse mxnet's stringly-typed shape attrs: "(3, 3)" / "3" / "[3,3]"."""
    raw = attrs.get(key)
    if raw is None:
        return default
    vals = [int(float(t)) for t in
            raw.strip("()[] ").replace(",", " ").split()]
    if len(vals) == 1 and len(default) == 2:
        vals = vals * 2
    return tuple(vals) if vals else default


def _bool_attr(attrs: Dict[str, str], key: str, default: bool) -> bool:
    raw = attrs.get(key)
    if raw is None:
        return default
    return raw.strip().lower() in ("true", "1")


def _f_attr(attrs: Dict[str, str], key: str, default: float) -> float:
    raw = attrs.get(key)
    return float(raw) if raw is not None else default


def _i_attr(attrs: Dict[str, str], key: str, default: int) -> int:
    raw = attrs.get(key)
    return int(float(raw)) if raw is not None else default


# -- node lowering -----------------------------------------------------------

def _pool2d(x, kind: str, k, s, pad, count_include_pad: bool):
    """Max or average pooling of NCHW ``x``, symmetric ``pad``; the
    exclude-pad average divides by the valid count."""
    ph, pw = pad
    pads = (pw, pw, ph, ph)
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


def _lower_node(op: str, name: str, attrs: Dict[str, str], ins: List[Any]):
    if op == "Convolution":
        x, w = ins[0], ins[1]
        if attrs.get("layout", "NCHW") != "NCHW":
            raise FilterError(f"mxnet: Convolution layout "
                              f"{attrs['layout']!r} unsupported")
        stride = _tuple_attr(attrs, "stride", (1, 1))
        pad = _tuple_attr(attrs, "pad", (0, 0))
        dil = _tuple_attr(attrs, "dilate", (1, 1))
        y = F.conv2d(x, w, stride=stride, padding=pad, dilation=dil,
                     groups=_i_attr(attrs, "num_group", 1))
        if not _bool_attr(attrs, "no_bias", False):
            y = y + ins[2].reshape(1, -1, 1, 1)
        return y
    if op == "BatchNorm":
        x, gamma, beta, mean, var = ins[:5]
        eps = _f_attr(attrs, "eps", 1e-3)
        if _bool_attr(attrs, "fix_gamma", True):
            gamma = torch.ones_like(gamma)
        inv = gamma * torch.rsqrt(var + eps)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * inv.reshape(shape) + (beta - mean * inv).reshape(shape)
    if op == "Activation":
        kind = attrs.get("act_type", "relu")
        fn = {"relu": torch.relu, "sigmoid": torch.sigmoid,
              "tanh": torch.tanh, "softrelu": F.softplus,
              "softsign": F.softsign}.get(kind)
        if fn is None:
            raise FilterError(f"mxnet: Activation act_type={kind!r} "
                              "unsupported")
        return fn(ins[0])
    if op == "LeakyReLU":
        kind = attrs.get("act_type", "leaky")
        if kind == "leaky":
            return F.leaky_relu(ins[0], _f_attr(attrs, "slope", 0.25))
        if kind == "elu":
            return F.elu(ins[0], _f_attr(attrs, "slope", 0.25))
        if kind == "prelu":
            alpha = ins[1].reshape((1, -1) + (1,) * (ins[0].dim() - 2))
            return torch.where(ins[0] >= 0, ins[0], alpha * ins[0])
        raise FilterError(f"mxnet: LeakyReLU act_type={kind!r} unsupported")
    if op == "Pooling":
        x = ins[0]
        kind = attrs.get("pool_type", "max")
        if kind not in ("max", "avg"):
            raise FilterError(f"mxnet: pool_type={kind!r} unsupported")
        if _bool_attr(attrs, "global_pool", False):
            if kind == "max":
                return torch.amax(x, dim=(2, 3), keepdim=True)
            return torch.mean(x, dim=(2, 3), keepdim=True)
        k = _tuple_attr(attrs, "kernel", (1, 1))
        s = _tuple_attr(attrs, "stride", (1, 1))
        pad = _tuple_attr(attrs, "pad", (0, 0))
        if attrs.get("pooling_convention", "valid") == "full":
            raise FilterError("mxnet: 'full' pooling convention (ceil "
                              "shapes) unsupported")
        return _pool2d(x, kind, k, s, pad,
                       _bool_attr(attrs, "count_include_pad", True))
    if op == "FullyConnected":
        x, w = ins[0], ins[1]
        if _bool_attr(attrs, "flatten", True):
            x = x.reshape((x.shape[0], -1))
        y = x @ w.T
        if not _bool_attr(attrs, "no_bias", False):
            y = y + ins[2]
        return y
    if op == "Flatten":
        return ins[0].reshape((ins[0].shape[0], -1))
    if op == "Concat":
        return torch.cat(ins, dim=_i_attr(attrs, "dim", 1))
    if op in ("softmax", "SoftmaxOutput", "SoftmaxActivation"):
        axis = _i_attr(attrs, "axis", -1 if op == "softmax" else 1)
        return torch.softmax(ins[0], dim=axis)
    if op in ("elemwise_add", "_Plus", "broadcast_add", "_add"):
        return ins[0] + ins[1]
    if op in ("elemwise_mul", "broadcast_mul", "_mul"):
        return ins[0] * ins[1]
    if op == "Dropout":
        return ins[0]
    if op == "LRN":
        x = ins[0]
        alpha = _f_attr(attrs, "alpha", 1e-4)
        beta = _f_attr(attrs, "beta", 0.75)
        knorm = _f_attr(attrs, "knorm", 2.0)
        nsize = _i_attr(attrs, "nsize", 5)
        sq = x * x
        half = nsize // 2
        pads = [0, 0] * (x.dim() - 2) + [half, half]
        padded = F.pad(sq, pads)
        acc = sum(padded[:, i:i + x.shape[1]] for i in range(nsize))
        return x / torch.pow(knorm + alpha / nsize * acc, beta)
    if op == "Reshape":
        shape = _tuple_attr(attrs, "shape", ())
        if any(s in (-2, -3, -4, 0) for s in shape):
            raise FilterError("mxnet: Reshape special codes -2/-3/-4/0 "
                              "unsupported")
        return ins[0].reshape(shape)
    if op == "transpose":
        axes = _tuple_attr(attrs, "axes", ())
        return ins[0].permute(axes or tuple(range(ins[0].dim()))[::-1])
    if op == "clip":
        return torch.clamp(ins[0], _f_attr(attrs, "a_min", -np.inf),
                           _f_attr(attrs, "a_max", np.inf))
    if op == "Cast":
        return ins[0].to(torch_dtype(attrs.get("dtype", "float32")))
    if op == "identity" or op == "BlockGrad":
        return ins[0]
    raise FilterError(f"mxnet: operator {op!r} not lowered "
                      "(~25 deploy ops supported)")


class _Symbol:
    """Parsed symbol graph: topologically-ordered nodes + heads."""

    def __init__(self, text: str) -> None:
        doc = json.loads(text)
        if "nodes" not in doc:
            raise FilterError("mxnet: symbol json has no 'nodes'")
        self.nodes = doc["nodes"]
        self.heads = [h[0] if isinstance(h, list) else h
                      for h in doc.get("heads", [])]
        if not self.heads:
            self.heads = [len(self.nodes) - 1]
        for node in self.nodes:
            # attribute key renamed across mxnet eras: param → attr → attrs
            node.setdefault("attrs",
                            node.get("attr", node.get("param", {})))

    def null_names(self) -> List[str]:
        return [n["name"] for n in self.nodes if n["op"] == "null"]

    def build(self, in_names: Sequence[str],
              out_names: Sequence[str]) -> Callable:
        name_to_id = {n["name"]: i for i, n in enumerate(self.nodes)}
        for name in list(in_names) + list(out_names):
            if name not in name_to_id:
                raise FilterError(f"mxnet: no node named {name!r}")
        out_ids = [name_to_id[n] for n in out_names]
        nodes = self.nodes

        def forward(params: Dict[str, Any], *inputs):
            vals: List[Any] = [None] * len(nodes)
            bound = dict(zip(in_names, inputs))
            for i, node in enumerate(nodes):
                if node["op"] == "null":
                    # a bound input, else a weight, else unbound (None)
                    vals[i] = bound.get(node["name"],
                                        params.get(node["name"]))
                    continue
                ins = [vals[ref[0]] for ref in node["inputs"]]
                # an unbound weight is None: structure, not a value
                # nnsjit: allow(tracer-branch)
                if any(v is None for v in ins):
                    missing = [nodes[ref[0]]["name"]
                               for ref, v in zip(node["inputs"], ins)
                               if v is None]
                    raise FilterError(
                        f"mxnet: node {node['name']!r} reads unbound "
                        f"blobs {missing} (weight absent from .params?)")
                vals[i] = _lower_node(node["op"], node["name"],
                                      node["attrs"], ins)
            return tuple(vals[i] for i in out_ids)

        return forward


@register_filter
class MXNetFilter(TorchExecMixin, FilterFramework):
    """``framework=mxnet``: symbol.json + .params on the card."""

    NAME = "mxnet"
    SUPPORTED_ACCELERATORS = (Accelerator.GPU, Accelerator.CPU)

    def __init__(self) -> None:
        super().__init__()
        self._sym: Optional[_Symbol] = None
        self._in_info: Optional[TensorsInfo] = None
        self._out_info: Optional[TensorsInfo] = None
        self.stats = FilterStatistics()

    @staticmethod
    def _resolve_paths(model: Any) -> Tuple[str, str]:
        parts = [p.strip() for p in str(model).split(",") if p.strip()]
        sym = parts[0]
        if len(parts) > 1:
            return sym, parts[1]
        stem, _ = os.path.splitext(sym)
        return sym, stem + ".params"

    def open(self, props: FilterProperties) -> None:
        sym_path, params_path = self._resolve_paths(props.model)
        if not os.path.isfile(sym_path):
            raise FilterError(f"mxnet: model file not found: {sym_path}")
        if not os.path.isfile(params_path):
            raise FilterError(f"mxnet: params file not found: {params_path} "
                              "(expected next to the symbol json, like the "
                              "reference)")
        with open(sym_path) as f:
            sym = _Symbol(f.read())
        params = load_params(params_path)

        custom = props.custom_properties
        in_names = [s for s in
                    (custom.get("inputname") or "").split(",") if s]
        out_names = [s for s in
                     (custom.get("outputname") or "").split(",") if s]
        if not in_names:
            in_names = [n for n in sym.null_names() if n not in params]
        if not in_names:
            raise FilterError("mxnet: cannot infer input nodes; set "
                              "custom=inputname:...")
        if not out_names:
            out_names = [sym.nodes[i]["name"] for i in sym.heads]

        if props.input_info is None or not props.input_info.is_valid():
            raise FilterError(
                "mxnet: input_info is required (the symbol json has no "
                "input shapes; the reference requires explicit dims too)")
        in_info = props.input_info.copy()
        if in_info.num_tensors != len(in_names):
            raise FilterError(
                f"mxnet: {len(in_names)} input nodes but input_info has "
                f"{in_info.num_tensors}")

        fn = sym.build(in_names, out_names)
        # no dead device residency: only graph-referenced weights go on it
        wanted = set(sym.null_names()) - set(in_names)
        params = {k: v for k, v in params.items() if k in wanted}
        device = self._pick_device(props.accelerators)
        self._sym = sym

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
                    f"mxnet: declared output {props.output_info} != graph "
                    f"output {probed}")
            self._out_info = props.output_info.copy()
        else:
            self._out_info = probed
        self._in_info = in_info
        super().open(props)

    def close(self) -> None:
        self._sym = None
        self._teardown_exec()
        super().close()

    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        if self._sym is None:
            raise FilterError("mxnet: not opened")
        return self._in_info, self._out_info

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        if not isinstance(model, str):
            return False
        parts = [p.strip() for p in model.split(",") if p.strip()]
        if not parts or not parts[0].endswith(".json"):
            return False
        if len(parts) > 1:
            return parts[1].endswith(".params")
        stem, _ = os.path.splitext(parts[0])
        return os.path.isfile(stem + ".params")
