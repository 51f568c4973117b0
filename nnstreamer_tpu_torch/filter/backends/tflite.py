"""TFLite model-file backend: parse a ``.tflite``, lower it to torch, run
it on the card.

The port of ``nnstreamer_tpu/filter/backends/tflite.py``.  The flatbuffer
is parsed with the in-tree reader (:mod:`nnstreamer_tpu_torch.utils.
flatbuf`), each operator is lowered to torch ops, and the filter serves
the lowered graph through :class:`~._torchexec.TorchExecMixin`: on the
card one CUDA graph per input signature, weights resident from open.

Layout: TFLite is NHWC.  Activations stay NHWC-contiguous through the
graph; a convolution hands cuDNN a permuted view of them (NCHW logical,
channels_last in memory) and a view of the OHWI weights in the same
layout, so no op pays a layout copy.  TF ``SAME`` padding is padded
explicitly where it is asymmetric.

Batching: every activation carries a leading frame axis ``E`` (1 for a
per-frame invoke, the bucket for a batched one).  Operator handlers are
written per frame, as in the JAX package, and mapped over ``E`` with
``torch.func.vmap`` where ``E > 1``; the native-int8 products fold ``E``
into their own batch.

Quantized models (uint8/int8) run their conv/depthwise/fc natively in
integers (``custom=compute:int8``): the activation enters the shifted
int8 domain, the product accumulates EXACTLY in int32 and the
zero-point correction terms of ``_run_native_quant`` are applied.  Each
product picks its route at open (:func:`_pick_route`, recorded in
``_Lowerer.routes``), every route exact:

- ``int_mm``: 1x1 convolutions and fully-connected layers as one
  ``torch._int_mm`` (int8 x int8 -> int32, cuBLASLt IMMA on the card),
  rows padded past 16 and columns to multiples of 8 (the head's 1001
  classes to 1008) with zeros;
- ``f32``: a float32 convolution of the int8 values, rounded, where the
  sum of |products| stays far below 2^24 (K <= 64 taps x channels: every
  partial sum is an integer f32 holds exactly, with room for the
  rounding of a cuDNN Winograd transform that the final round undoes;
  cuDNN's TF32 is off while it dispatches, :func:`_exact_f32`);
- ``f64``: the same in float64 for any other convolution.

Elsewhere quantized graphs run in float emulation (weights dequantized at
open, outputs requantized to the declared dtype), or with
``compute:w8`` with int8 weights resident and dequantized in the forward.
Float graphs run bf16 on the card (``compute:auto``) and f32 on the CPU.
The external tensor interface (dtype/shape per ``get_model_info``) is the
declared one in every mode.

Unsupported operators raise at open with the op name.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...tensor.buffer import BatchView
from ...tensor.info import TensorInfo, TensorsInfo
from ...tensor.types import TensorType, np_shape_to_dim
from ...utils import flatbuf as fb
from ..framework import (Accelerator, FilterError, FilterFramework,
                         FilterProperties, FilterStatistics, register_filter)
from ._torchexec import TorchExecMixin, torch_dtype

# -- tflite schema constants (schema.fbs v3) --------------------------------

_TENSORTYPE_NP = {
    0: np.float32, 1: np.float16, 2: np.int32, 3: np.uint8, 4: np.int64,
    6: np.bool_, 7: np.int16, 9: np.int8, 10: np.float64,
    12: np.uint64, 15: np.uint32, 16: np.uint16,
}  # 5 STRING / 8,11 COMPLEX / 13 RESOURCE / 14 VARIANT unsupported

_ACT_NONE, _ACT_RELU, _ACT_RELU_N1, _ACT_RELU6, _ACT_TANH = 0, 1, 2, 3, 4

_PAD_SAME, _PAD_VALID = 0, 1

#: ``compute:auto`` on a quantized graph on the card.  This is the JAX
#: package's recorded choice for its accelerator
#: (``nnstreamer_tpu/utils/tuned.py``), kept as it is: no H100 measurement
#: has chosen it yet.
QUANT_AUTO_GPU = "int8"

#: largest K (taps x input channels) a native product runs as a float32
#: convolution: K * 2^14 <= 2^20 keeps every partial sum an exact integer
#: with four bits to spare for a transform's rounding
_F32_EXACT_K = 64

#: held while cuDNN's TF32 flag is off for a native product (the flag is
#: process-wide: two products must not restore it over each other)
_TF32_LOCK = threading.Lock()


@contextlib.contextmanager
def _exact_f32(x: torch.Tensor):
    """cuDNN's TF32 off while an ``f32`` route dispatches its
    convolutions on the card (the choice of algorithm is made there, at
    a capture or an eager call).  TF32 rounds the operands to 11 bits: the
    int8 values survive it, a Winograd transform of the weights does not,
    and the sum is then no longer exact."""
    if x.dtype != torch.float32 or not x.is_cuda:
        yield
        return
    with _TF32_LOCK:
        was = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32 = was


@dataclasses.dataclass
class _TSpec:
    """One tflite tensor: declared shape/dtype + quantization."""

    shape: Tuple[int, ...]
    np_dtype: Any
    buffer: int
    name: str
    scale: Optional[np.ndarray] = None       # per-tensor or per-channel
    zero_point: Optional[np.ndarray] = None
    qdim: int = 0

    @property
    def quantized(self) -> bool:
        return (self.scale is not None and self.scale.size > 0
                and np.issubdtype(self.np_dtype, np.integer))


@dataclasses.dataclass
class _Op:
    code: int
    custom_code: Optional[str]
    inputs: List[int]
    outputs: List[int]
    options: Optional[fb.Table]


@dataclasses.dataclass
class _Graph:
    tensors: List[_TSpec]
    inputs: List[int]
    outputs: List[int]
    ops: List[_Op]
    buffers: List[bytes]


def parse_tflite(buf: bytes) -> _Graph:
    """Parse the model flatbuffer (identifier TFL3, schema v3)."""
    model = fb.root(buf, expect_identifier="TFL3")
    opcodes = []
    for oc in model.table_vector(1):           # Model.operator_codes
        dep = oc.scalar(0, "int8")
        builtin = oc.scalar(3, "int32")
        opcodes.append((max(dep, builtin), oc.string(1)))
    buffers = [b.bytes_vector(0) for b in model.table_vector(4)]
    sub = model.table_vector(2)[0]             # first subgraph
    tensors: List[_TSpec] = []
    for t in sub.table_vector(0):
        ttype = t.scalar(1, "int8")
        if ttype not in _TENSORTYPE_NP:
            raise FilterError(f"tflite: unsupported tensor type {ttype}")
        spec = _TSpec(shape=tuple(t.scalar_vector(0, "int32")),
                      np_dtype=_TENSORTYPE_NP[ttype],
                      buffer=t.scalar(2, "uint32"),
                      name=t.string(3) or "")
        q = t.table(4)
        if q is not None:
            scale = q.scalar_vector(2, "float32")
            zp = q.scalar_vector(3, "int64")
            if scale:
                spec.scale = np.asarray(scale, np.float32)
                spec.zero_point = np.asarray(zp or [0], np.int64)
                spec.qdim = q.scalar(6, "int32")
        tensors.append(spec)
    ops = []
    for op in sub.table_vector(3):
        code, custom = opcodes[op.scalar(0, "uint32")]
        ops.append(_Op(code=code, custom_code=custom,
                       inputs=op.scalar_vector(1, "int32"),
                       outputs=op.scalar_vector(2, "int32"),
                       options=op.table(4)))
    return _Graph(tensors=tensors,
                  inputs=sub.scalar_vector(1, "int32"),
                  outputs=sub.scalar_vector(2, "int32"),
                  ops=ops, buffers=buffers)


# -- operand positions that must stay host-static (shapes/axes/perms) -------

_STATIC_OPERANDS: Dict[int, Sequence[int]] = {
    22: (1,),        # RESHAPE new_shape
    34: (1,),        # PAD paddings
    60: (1, 2),      # PADV2 paddings, pad value
    39: (1,),        # TRANSPOSE perm
    40: (1,),        # MEAN axes
    74: (1,),        # SUM axes
    82: (1,),        # REDUCE_MAX axes
    45: (1, 2, 3),   # STRIDED_SLICE begin/end/strides
    65: (1, 2),      # SLICE begin/size
    49: (0,),        # SPLIT axis
    70: (1,),        # EXPAND_DIMS axis
    23: (1,),        # RESIZE_BILINEAR new size
    97: (1,),        # RESIZE_NEAREST_NEIGHBOR new size
    56: (1,),        # ARG_MAX axis
    79: (1,),        # ARG_MIN axis
    67: (0,),        # TRANSPOSE_CONV output_shape
    # 130 BROADCAST_TO is absent on purpose: its shape operand is often
    # COMPUTED shape arithmetic (SHAPE -> BROADCAST_ARGS) that constant-
    # folds to numpy; the handler checks concreteness itself
}

# operands whose handler can recover from a non-constant tensor via the
# op's options: RESHAPE falls back to ReshapeOptions.new_shape
_STATIC_FALLBACK: Dict[int, Sequence[int]] = {
    22: (1,),
}


def _const_array(g: _Graph, idx: int) -> Optional[np.ndarray]:
    """Materialize tensor ``idx`` from its buffer, or None if activation."""
    spec = g.tensors[idx]
    raw = g.buffers[spec.buffer] if spec.buffer < len(g.buffers) else b""
    if not raw:
        return None
    arr = np.frombuffer(raw, dtype=spec.np_dtype)
    return arr.reshape(spec.shape) if spec.shape else arr


def _dequant(arr: np.ndarray, spec: _TSpec) -> np.ndarray:
    """Const dequantize, per-tensor or per-channel along ``spec.qdim``."""
    scale, zp = spec.scale, spec.zero_point.astype(np.float32)
    if scale.size > 1:  # per-channel
        shape = [1] * arr.ndim
        shape[spec.qdim] = scale.size
        scale = scale.reshape(shape)
        zp = zp.reshape(shape) if zp.size > 1 else zp
    return (arr.astype(np.float32) - zp) * scale


def _shift(spec: _TSpec) -> int:
    """The shift that brings a uint8 encoding into int8 (0 for int8)."""
    return 128 if spec.np_dtype == np.uint8 else 0


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _pick_route(kind: str, w_shape: Tuple[int, ...]) -> str:
    """The exact route of one native product (see the module docstring)."""
    if kind == "fc":
        return "int_mm"
    if kind == "conv" and w_shape[1] == w_shape[2] == 1:
        return "int_mm"
    k = (int(w_shape[1]) * int(w_shape[2])
         * (int(w_shape[3]) if kind == "conv" else 1))
    return "f32" if k <= _F32_EXACT_K else "f64"


def _int_mm(a: torch.Tensor, w_t: torch.Tensor, n: int) -> torch.Tensor:
    """``a (m, k) int8`` x ``w_t (k_pad, n_pad) int8`` -> ``(m, n)``
    int32, exact.  ``a``'s columns are zero-padded to ``k_pad`` and its
    rows past 16 (the IMMA kernel's shape rules: m > 16, k and n
    multiples of 8); the padding adds zero products."""
    m, k = a.shape
    k_pad = w_t.shape[0]
    m_pad = m if m > 16 else 32
    if k_pad != k or m_pad != m:
        a = F.pad(a, (0, k_pad - k, 0, m_pad - m))
    acc = torch._int_mm(a.contiguous(), w_t)
    return acc[:m, :n]


class _Lowerer:
    """Lower the op list to a forward over torch tensors.

    ``forward(*inputs)`` takes one frame per input (the graph's declared
    shapes); ``batched(*inputs)`` takes a leading frame axis.  Both walk
    the op list with every activation carrying that axis (``E``); the
    weights live on ``device`` from construction on (``tparams``)."""

    #: op codes eligible for native int8 execution (the matmul-heavy ones)
    _NQ_CODES = {3: "conv", 4: "dw", 9: "fc"}
    #: elementwise ops that can run in the int8 a-domain purely to BRIDGE
    #: residency (MobileNetV2's residual ADDs would otherwise break every
    #: int8 chain back to f32 activations)
    _NQ_ELTWISE = {0: "add"}

    def __init__(self, g: _Graph, compute_dtype: Any = None,
                 quant_native: bool = False, weight_only: bool = False,
                 device: Any = "cpu") -> None:
        if not _OP_HANDLERS:
            _OP_HANDLERS.update(_build_handlers())
        #: None = f32; torch.bfloat16 = bf16 compute (params stored bf16,
        #: float activations cast on entry; external dtypes unchanged)
        self.compute = compute_dtype
        self.quant_native = quant_native
        #: weight-only quantization: int8/uint8 weights stay packed on the
        #: device and dequantize inside the forward; float math otherwise
        self.weight_only = weight_only and not quant_native
        self.device = torch.device(device)
        self.g = g
        self.static: Dict[int, np.ndarray] = {}
        self.params: Dict[str, np.ndarray] = {}
        self._param_key: Dict[int, str] = {}
        self._nq: Dict[int, Dict[str, Any]] = {}     # id(op) -> meta
        self._nq_raw: Dict[int, np.ndarray] = {}     # tensor -> int array
        self._wo: Dict[int, _TSpec] = {}             # packed-weight specs
        #: tensors kept INT8-RESIDENT (shifted a-domain, int8)
        self._qres: set = set()
        #: the route of each native product, in graph order:
        #: (op index, kind, route)
        self.routes: List[Tuple[int, str, str]] = []
        if quant_native:
            self._select_native_quant_ops()
            self._select_resident_tensors()
        self._classify_consts()
        self._stage()

    def _select_native_quant_ops(self) -> None:
        """Pick ops that can run natively in int8: quantized input/weight/
        output, constant weights not shared with a non-native consumer,
        per-channel weight zero-points all zero (tflite spec)."""
        g = self.g
        consumers: Dict[int, int] = {}
        for op in g.ops:
            for t in op.inputs:
                if t >= 0:
                    consumers[t] = consumers.get(t, 0) + 1
        for op in g.ops:
            if op.code in self._NQ_ELTWISE and len(op.inputs) == 2:
                t_a, t_b2 = op.inputs[0], op.inputs[1]
                spec_a, spec_b = g.tensors[t_a], g.tensors[t_b2]
                spec_o = g.tensors[op.outputs[0]]
                act = (op.options.scalar(0, "int32", 0)
                       if op.options else 0)
                if (act == 0
                        and all(s.quantized and s.scale is not None
                                and np.asarray(s.scale).size == 1
                                and np.dtype(s.np_dtype) in (np.int8,
                                                             np.uint8)
                                for s in (spec_a, spec_b, spec_o))
                        and tuple(spec_a.shape) == tuple(spec_b.shape)
                        and _const_array(g, t_a) is None
                        and _const_array(g, t_b2) is None):
                    self._nq[id(op)] = {"kind": "add"}
                continue
            kind = self._NQ_CODES.get(op.code)
            if kind is None or len(op.inputs) < 2:
                continue
            t_x, t_w = op.inputs[0], op.inputs[1]
            t_b = op.inputs[2] if len(op.inputs) > 2 else -1
            spec_x, spec_w = g.tensors[t_x], g.tensors[t_w]
            spec_o = g.tensors[op.outputs[0]]
            w_raw = _const_array(g, t_w)
            if (w_raw is None or not spec_x.quantized
                    or not spec_w.quantized or not spec_o.quantized
                    or consumers.get(t_w, 0) > 1
                    or w_raw.dtype not in (np.int8, np.uint8)
                    # 8-bit activations only: the a-domain is int8; a
                    # 16x8-quantized model would wrap in the int8 cast
                    or np.dtype(spec_x.np_dtype) not in (np.int8, np.uint8)
                    or np.dtype(spec_o.np_dtype) not in (np.int8,
                                                         np.uint8)):
                continue
            zp_w = np.asarray(spec_w.zero_point).ravel()
            if zp_w.size > 1 and np.any(zp_w):
                continue          # per-channel zp != 0: out of tflite spec
            if t_b >= 0 and (_const_array(g, t_b) is None
                             or consumers.get(t_b, 0) > 1):
                continue
            # shift both operands into int8 range exactly (uint8 - 128)
            shift_w = 128 if w_raw.dtype == np.uint8 else 0
            w8 = (w_raw.astype(np.int32) - shift_w).astype(np.int8)
            if kind == "conv":      # OHWI
                colsum = w8.astype(np.int64).sum(axis=(1, 2, 3))
                k_acc = int(np.prod(w8.shape[1:]))
            elif kind == "dw":      # [1, kh, kw, och]
                colsum = w8.astype(np.int64).sum(axis=(0, 1, 2))
                k_acc = int(np.prod(w8.shape[1:3]))
            else:                   # fc [O, I]
                colsum = w8.astype(np.int64).sum(axis=1)
                k_acc = int(w8.shape[1])
            self._nq_raw[t_w] = w8
            if t_b >= 0:
                self._nq_raw[t_b] = _const_array(g, t_b).astype(np.int32)
            self._nq[id(op)] = {
                "kind": kind,
                "colsum": colsum.astype(np.int32),
                "k_acc": k_acc,
                "b0": int(zp_w[0]) - shift_w,
                "s_w": np.asarray(spec_w.scale, np.float32).ravel(),
            }

    def _select_resident_tensors(self) -> None:
        """Mark activations that can stay int8 end-to-end: quantized per
        tensor, EVERY consumer a native op reading it as an activation,
        produced by a native op with no fused activation (or a graph
        input).  Graph outputs may be resident too: the declared output
        dtype IS the quantized encoding."""
        g = self.g
        consumers: Dict[int, list] = {}
        for op2 in g.ops:
            for pos, t in enumerate(op2.inputs):
                if t >= 0:
                    consumers.setdefault(t, []).append((op2, pos))

        def _acts_pos(op2) -> tuple:
            return ((0, 1) if self._nq[id(op2)]["kind"] == "add"
                    else (0,))

        def _eligible(t: int) -> bool:
            spec = g.tensors[t]
            if (not spec.quantized or spec.scale is None
                    or np.asarray(spec.scale).size != 1
                    or np.dtype(spec.np_dtype) not in (np.int8,
                                                       np.uint8)):
                return False
            return all(id(op2) in self._nq and pos in _acts_pos(op2)
                       for op2, pos in consumers.get(t, []))

        act_field = {"fc": 0, "conv": 3, "dw": 4, "add": 0}
        for op in g.ops:
            meta = self._nq.get(id(op))
            if meta is None:
                continue
            opts = op.options
            act = (opts.scalar(act_field[meta["kind"]], "int32", 0)
                   if opts else 0)
            t_o = op.outputs[0]
            if act == 0 and _eligible(t_o):
                self._qres.add(t_o)
        for t in g.inputs:
            if _eligible(t):
                self._qres.add(t)
        # an ADD that bridges no resident tensor buys nothing: drop it
        for op in g.ops:
            meta = self._nq.get(id(op))
            if meta is not None and meta["kind"] == "add":
                ts = (op.inputs[0], op.inputs[1], op.outputs[0])
                if not any(t in self._qres for t in ts):
                    del self._nq[id(op)]

    def _classify_consts(self) -> None:
        g = self.g
        static_idx = set()
        data_idx = set()
        for op in g.ops:
            static_pos = set(_STATIC_OPERANDS.get(op.code, ()))
            for pos, t in enumerate(op.inputs):
                if t < 0:
                    continue
                arr = _const_array(g, t)
                if arr is None:
                    continue
                (static_idx if pos in static_pos else data_idx).add(t)
        for t in static_idx:
            self.static[t] = _const_array(g, t)
        #: static tensors some op ALSO reads as data: a device copy
        self._static_data = sorted(data_idx & static_idx)
        for t in data_idx - static_idx:
            spec = g.tensors[t]
            if t in self._nq_raw:
                # native-int8 weights/bias: keep the integer domain
                self.params[f"t{t}"] = self._nq_raw[t]
                self._param_key[t] = f"t{t}"
                continue
            arr = _const_array(g, t)
            if spec.quantized:
                if (self.weight_only
                        and arr.dtype in (np.int8, np.uint8)):
                    # packed int8 stays resident; dequant runs in forward
                    self.params[f"t{t}"] = arr
                    self._param_key[t] = f"t{t}"
                    self._wo[t] = spec
                    continue
                arr = _dequant(arr, spec)
            elif arr.dtype == np.float16:
                arr = arr.astype(np.float32)
            self.params[f"t{t}"] = arr
            self._param_key[t] = f"t{t}"

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.array(arr, copy=True), device=self.device)

    def _stage(self) -> None:
        """Move the weights to the device once, in their serving dtype,
        and precompute every constant a native op reads: a forward that
        is captured into a CUDA graph must not copy from the host."""
        self.tparams: Dict[int, torch.Tensor] = {}
        self._wo_meta: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        for t, key in self._param_key.items():
            if self.params[key].dtype == np.int8 and t in self._nq_raw:
                continue            # a native product's weight: in meta
            v = self._tensor(self.params[key])
            if t in self._wo:
                self._wo_meta[t] = tuple(
                    self._tensor(c) for c in self._dequant_consts(
                        self.g.tensors[t], v.dim()))
            elif self.compute is not None and v.dtype == torch.float32:
                v = v.to(self.compute)
            self.tparams[t] = v
        for t in self._static_data:
            self.tparams[t] = self._tensor(self.static[t])
        g = self.g
        for i, op in enumerate(g.ops):
            meta = self._nq.get(id(op))
            if meta is None or meta["kind"] == "add":
                continue
            kind = meta["kind"]
            w8 = self._nq_raw[op.inputs[1]]
            opts = op.options
            if kind == "fc":
                stride = dil = (1, 1)
            else:
                sh, sw = opts.scalar(2, "int32", 1), opts.scalar(1, "int32", 1)
                base = 5 if kind == "conv" else 6
                stride = (sh, sw)
                dil = (opts.scalar(base, "int32", 1) or 1,
                       opts.scalar(base - 1, "int32", 1) or 1)
            route = _pick_route(kind, w8.shape)
            meta["route"] = route
            meta["stride"], meta["dil"] = stride, dil
            self.routes.append((i, kind, route))
            spec_x = g.tensors[op.inputs[0]]
            s_x = float(spec_x.scale[0])
            meta["t_colsum"] = self._tensor(meta["colsum"])
            # the same f32 products as the JAX package: numpy f32 math
            meta["t_scale"] = self._tensor(s_x * meta["s_w"])
            t_o = op.outputs[0]
            if t_o in self._qres:
                s_o = float(g.tensors[t_o].scale[0])
                meta["t_mult"] = self._tensor(s_x * meta["s_w"] / s_o)
            if route == "int_mm":
                w2 = w8.reshape(w8.shape[0], -1)          # (n, k)
                n, k = w2.shape
                wp = np.zeros((_round_up(n, 8), _round_up(k, 8)), np.int8)
                wp[:n, :k] = w2
                # (k_pad, n_pad), column-major: the layout IMMA wants
                meta["t_w"] = self._tensor(wp).t()
                meta["n"] = n
            else:
                ft = torch.float32 if route == "f32" else torch.float64
                if kind == "conv":                         # OHWI -> OIHW
                    wk = np.transpose(w8, (0, 3, 1, 2))
                    ones = np.ones((1, 1) + w8.shape[1:3], np.float32)
                else:                                      # [1,kh,kw,och]
                    wk = np.transpose(w8, (3, 0, 1, 2))
                    ones = np.ones((w8.shape[3], 1) + w8.shape[1:3],
                                   np.float32)
                meta["t_w"] = self._tensor(wk).to(ft)
                meta["t_ones"] = self._tensor(ones).to(ft)
                meta["ft"] = ft

    @staticmethod
    def _dequant_consts(spec: _TSpec, ndim: int):
        scale = np.asarray(spec.scale, np.float32)
        zp = np.asarray(spec.zero_point, np.float32)
        if scale.size > 1:  # per-channel
            shape = [1] * ndim
            shape[spec.qdim] = scale.size
            scale = scale.reshape(shape)
            if zp.size > 1:
                zp = zp.reshape(shape)
        return scale, zp

    # -- forwards ------------------------------------------------------------
    def forward(self, *inputs: Any) -> List[torch.Tensor]:
        """One frame per input (the declared shapes)."""
        xs = [torch.as_tensor(x).reshape((1,) + tuple(
            self.g.tensors[t].shape)) for x, t in zip(inputs, self.g.inputs)]
        return [y[0] for y in self._run(xs)]

    def batched(self, *inputs: Any) -> List[torch.Tensor]:
        """A leading frame axis on every input."""
        xs = [x.reshape((x.shape[0],) + tuple(self.g.tensors[t].shape))
              for x, t in zip(inputs, self.g.inputs)]
        return self._run(xs)

    def _run(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        g = self.g
        env: Dict[int, torch.Tensor] = {}          # activations, E-form
        folded: Dict[int, torch.Tensor] = {}       # constant op results
        for i, t in enumerate(g.inputs):
            spec = g.tensors[t]
            x = xs[i]
            if t in self._qres:
                # int8-resident entry: the quantized feed IS the
                # encoding -- shift to the a-domain, no float math
                env[t] = (x.to(torch.int32) - _shift(spec)).to(torch.int8)
                continue
            if spec.quantized:
                x = ((x.to(torch.float32) - float(spec.zero_point[0]))
                     * float(spec.scale[0]))
            elif x.dtype == torch.float16:
                x = x.to(torch.float32)
            if self.compute is not None and x.is_floating_point():
                x = x.to(self.compute)
            env[t] = x
        for op in g.ops:
            self._run_op(op, env, folded)
        outs = []
        for t in g.outputs:
            spec = g.tensors[t]
            y = env[t] if t in env else folded[t].unsqueeze(0)
            if t in self._qres:
                # already the quantized encoding (a-domain): un-shift
                y = (y.to(torch.int32) + _shift(spec)).to(
                    torch_dtype(spec.np_dtype))
            elif spec.quantized:
                info = np.iinfo(spec.np_dtype)
                # requantize in f32 whatever the compute dtype: bf16's
                # 8-bit mantissa would cost quantization steps here
                yq = torch.round(y.to(torch.float32) / float(spec.scale[0])
                                 + float(spec.zero_point[0]))
                y = torch.clamp(yq, info.min, info.max).to(
                    torch_dtype(spec.np_dtype))
            else:
                want = torch_dtype(spec.np_dtype)
                if y.dtype != want:
                    # the declared meta: bf16 compute leaves in f32
                    y = y.to(want)
            outs.append(y)
        return outs

    def _dequant_weight(self, t: int, v: torch.Tensor) -> torch.Tensor:
        """Weight-only mode: the load-time ``_dequant`` in the forward."""
        scale, zp = self._wo_meta[t]
        x = (v.to(torch.float32) - zp) * scale
        if self.compute is not None:
            x = x.to(self.compute)
        return x

    def _const(self, t: int, folded) -> Optional[torch.Tensor]:
        if t in folded:
            return folded[t]
        v = self.tparams.get(t)
        if v is not None and t in self._wo:
            return self._dequant_weight(t, v)
        return v

    def _a_domain(self, env, folded, t: int) -> torch.Tensor:
        """One activation input in the shifted int8 a-domain (resident
        pass-through, or float -> grid requantize), E-form."""
        x = env[t] if t in env else self._const(t, folded).unsqueeze(0)
        if t in self._qres:
            return x
        spec = self.g.tensors[t]
        qi = np.iinfo(spec.np_dtype)
        xq = torch.clamp(torch.round(x.to(torch.float32)
                                     / float(spec.scale[0]))
                         + int(spec.zero_point[0]), qi.min, qi.max)
        return (xq - _shift(spec)).to(torch.int8)

    def _run_native_add(self, op: _Op, env, folded) -> List[torch.Tensor]:
        """Quantized elementwise ADD in the a-domain: int8 in, int8 (or
        float) out; it carries residency across residual connections.

        With a_i the shifted int8 inputs and A0_i = zp_i - shift_i:
          real = s1*(a1 - A0_1) + s2*(a2 - A0_2)"""
        g = self.g
        s1_spec = g.tensors[op.inputs[0]]
        s2_spec = g.tensors[op.inputs[1]]
        a1 = self._a_domain(env, folded, op.inputs[0])
        a2 = self._a_domain(env, folded, op.inputs[1])
        s1 = float(s1_spec.scale[0])
        s2 = float(s2_spec.scale[0])
        a01 = int(s1_spec.zero_point[0]) - _shift(s1_spec)
        a02 = int(s2_spec.zero_point[0]) - _shift(s2_spec)
        f1 = a1.to(torch.float32)
        f2 = a2.to(torch.float32)
        t_o = op.outputs[0]
        spec_o = g.tensors[t_o]
        if t_o in self._qres:
            s_o = float(spec_o.scale[0])
            zp_o = int(spec_o.zero_point[0])
            shift_o = _shift(spec_o)
            qo = np.iinfo(spec_o.np_dtype)
            c = (-(s1 * a01 + s2 * a02) / s_o) + (zp_o - shift_o)
            y = torch.round((s1 / s_o) * f1 + (s2 / s_o) * f2 + c)
            y = torch.clamp(y, qo.min - shift_o, qo.max - shift_o)
            return [y.to(torch.int8)]
        return [s1 * (f1 - a01) + s2 * (f2 - a02)]

    def _accumulate(self, op: _Op, a: torch.Tensor, a0: int,
                    meta: Dict[str, Any]) -> torch.Tensor:
        """The exact int32 accumulator of one native conv/dw/fc over the
        E-form int8 activation ``a``:
          conv(a, w8) - B0*winsum(a) - A0*colsum(w8) + A0*B0*K
        (see ``_run_native_quant``), through the op's route."""
        kind, route, b0 = meta["kind"], meta["route"], meta["b0"]
        opts = op.options
        e = a.shape[0]
        if kind == "fc":
            keep = bool(opts.scalar(2, "bool", False)) if opts else False
            k = int(self._nq_raw[op.inputs[1]].shape[1])
            a2 = a.reshape(-1, k)
            acc = _int_mm(a2, meta["t_w"], meta["n"])
            winsum = (a2.to(torch.int32).sum(-1, keepdim=True)
                      if b0 else 0)
            acc = acc - b0 * winsum - a0 * meta["t_colsum"] \
                + a0 * b0 * meta["k_acc"]
            return acc.reshape(tuple(a.shape[:-1]) + (meta["n"],) if keep
                               else (e, -1, meta["n"]))
        # conv / dw: fold E into the batch, pad with A0 (real 0.0)
        x = a.reshape((-1,) + tuple(a.shape[2:]))           # (E*N, H, W, C)
        w8 = self._nq_raw[op.inputs[1]]
        kh, kw = w8.shape[1], w8.shape[2]
        x = _pad_quant(x, opts.scalar(0, "int32", 0), (kh, kw),
                       meta["stride"], meta["dil"], a0)
        if route == "int_mm":
            sh, sw = meta["stride"]
            xs = x[:, ::sh, ::sw, :]
            m, ho, wo, c = xs.shape
            a2 = xs.reshape(-1, c)
            acc = _int_mm(a2, meta["t_w"], meta["n"]).reshape(
                m, ho, wo, meta["n"])
            winsum = (a2.to(torch.int32).sum(-1).reshape(m, ho, wo, 1)
                      if b0 else 0)
        else:
            ft = meta["ft"]
            xf = x.permute(0, 3, 1, 2).to(ft)                # NCHW view
            groups = 1 if kind == "conv" else x.shape[-1]
            with _exact_f32(xf):
                acc = F.conv2d(xf, meta["t_w"], stride=meta["stride"],
                               dilation=meta["dil"], groups=groups)
                ws = None
                if b0 and kind == "conv":
                    ws = F.conv2d(xf.sum(1, keepdim=True), meta["t_ones"],
                                  stride=meta["stride"], dilation=meta["dil"])
                elif b0:
                    ws = F.conv2d(xf, meta["t_ones"], stride=meta["stride"],
                                  dilation=meta["dil"], groups=groups)
            acc = torch.round(acc).to(torch.int32).permute(0, 2, 3, 1)
            winsum = 0 if ws is None else \
                torch.round(ws).to(torch.int32).permute(0, 2, 3, 1)
        acc = acc - b0 * winsum - a0 * meta["t_colsum"] \
            + a0 * b0 * meta["k_acc"]
        return acc.reshape((e,) + tuple(a.shape[1:2]) + tuple(acc.shape[1:]))

    def _run_native_quant(self, op: _Op, env, folded) -> List[torch.Tensor]:
        """One quantized conv/dw/fc natively: requantize the float-domain
        activation to int8, accumulate int8 x int8 -> int32 exactly,
        apply the zero-point correction terms, add the int32 bias and
        dequantize the accumulator back to the float domain.

        With a = x_q - shift_x, A0 = zp_x - shift_x (and w8/B0 likewise,
        precomputed at load), the exact integer accumulation is
          conv(x_q - zp_x, w_q - zp_w)
            = conv(a, w8) - B0*winsum(a) - A0*colsum(w8) + A0*B0*K
        where winsum is the per-output-position window sum of a (only
        needed when B0 != 0: uint8 weights) and colsum/K are load-time
        constants."""
        g = self.g
        meta = self._nq[id(op)]
        spec_x = g.tensors[op.inputs[0]]
        t_b = op.inputs[2] if len(op.inputs) > 2 else -1
        opts = op.options
        a = self._a_domain(env, folded, op.inputs[0])
        a0 = int(spec_x.zero_point[0]) - _shift(spec_x)
        acc = self._accumulate(op, a, a0, meta)
        if t_b >= 0:
            acc = acc + self.tparams[t_b]           # scale s_x*s_w, zp 0
        t_o = op.outputs[0]
        if t_o in self._qres:
            # requantize STRAIGHT to the consumer's int8 a-domain: one
            # round/clip per link, in the JAX package's float order
            spec_o = g.tensors[t_o]
            zp_o = int(spec_o.zero_point[0])
            shift_o = _shift(spec_o)
            qo = np.iinfo(spec_o.np_dtype)
            y = torch.round(acc.to(torch.float32) * meta["t_mult"]) \
                + (zp_o - shift_o)
            y = torch.clamp(y, qo.min - shift_o, qo.max - shift_o)
            return [y.to(torch.int8)]
        act_field = {"fc": 0, "conv": 3, "dw": 4}[meta["kind"]]
        act = opts.scalar(act_field, "int32", 0) if opts else 0
        y = acc.to(torch.float32) * meta["t_scale"]
        return [_act(y, act)]

    def _run_op(self, op: _Op, env, folded) -> None:
        meta = self._nq.get(id(op))
        if meta is not None:
            runner = (self._run_native_add if meta["kind"] == "add"
                      else self._run_native_quant)
            for t, v in zip(op.outputs, runner(op, env, folded)):
                env[t] = self._clamp_to_qrange(t, v)
            return
        handler = _OP_HANDLERS.get(op.code)
        if handler is None:
            name = op.custom_code or f"builtin#{op.code}"
            raise FilterError(f"tflite: unsupported op {name}")
        # shape-like operands must be graph constants; a computed shape
        # means a genuinely dynamic model -- fail by name
        fallback = _STATIC_FALLBACK.get(op.code, ())
        static_pos = _STATIC_OPERANDS.get(op.code, ())
        for pos in static_pos:
            if (pos < len(op.inputs) and op.inputs[pos] >= 0
                    and op.inputs[pos] not in self.static
                    and not (pos in fallback and op.options is not None)):
                raise FilterError(
                    f"tflite: op builtin#{op.code} operand {pos} is "
                    "dynamic (non-constant shape/axis) — unsupported")
        statics = {pos: self.static.get(op.inputs[pos])
                   for pos in static_pos if pos < len(op.inputs)}
        ins: List[Any] = []
        batched: List[bool] = []
        for pos, t in enumerate(op.inputs):
            if t < 0:
                v, b = None, False
            elif t in env:
                v, b = env[t], True
            elif pos in static_pos and t in self.static:
                v, b = self.static[t], False
            elif t in self.static and t not in self.tparams:
                v, b = self.static[t], False      # constant-folded numpy
            else:
                v, b = self._const(t, folded), False
            ins.append(v)
            batched.append(b)
        if op.code == 77:
            # SHAPE: the frame's static shape, a host constant that lets
            # downstream shape arithmetic fold
            x = ins[0]
            shape = x.shape[1:] if batched[0] else x.shape
            self.static[op.outputs[0]] = np.asarray(shape, np.int32)
            return
        outs, is_batched = _apply(handler, ins, batched, op.options, statics)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        for t, v in zip(op.outputs, outs):
            if isinstance(v, np.ndarray):
                # constant-folded result (shape arithmetic): register it
                # so _STATIC_OPERANDS consumers accept it
                self.static[t] = v
            else:
                if (self.compute is not None and v.is_floating_point()
                        and v.dtype != self.compute):
                    # an op that produces float32 (CAST, a mix with an
                    # f32 constant) re-enters the compute dtype
                    v = v.to(self.compute)
                (env if is_batched else folded)[t] = \
                    self._clamp_to_qrange(t, v)

    def _clamp_to_qrange(self, t: int, v):
        """Emulate requantization saturation: quantized tflite graphs
        encode activation clamps (e.g. relu6) in each tensor's
        representable range [(qmin-zp)*s, (qmax-zp)*s], not in the op's
        fused-activation field."""
        spec = self.g.tensors[t]
        if not spec.quantized or not isinstance(v, torch.Tensor) \
                or not v.is_floating_point():
            return v
        s = float(spec.scale[0])
        zp = float(spec.zero_point[0])
        qinfo = np.iinfo(spec.np_dtype)
        return torch.clamp(v, (qinfo.min - zp) * s, (qinfo.max - zp) * s)


def _apply(handler, ins: List[Any], batched: List[bool], opts, statics):
    """Call a per-frame ``handler`` on E-form activations: directly with
    no activation among its inputs, on frame 0 where ``E == 1``, and
    mapped over the frame axis with ``torch.func.vmap`` otherwise.
    Returns ``(outputs, batched)``."""
    pos = [i for i, b in enumerate(batched) if b]
    if not pos:
        return handler(ins, opts, statics), False
    e = ins[pos[0]].shape[0]
    if e == 1:
        frame = [v[0] if b else v for v, b in zip(ins, batched)]
        outs = handler(frame, opts, statics)
        if isinstance(outs, (list, tuple)):
            return [o.unsqueeze(0) for o in outs], True
        return outs.unsqueeze(0), True

    def per_frame(*xs):
        full = list(ins)
        for i, x in zip(pos, xs):
            full[i] = x
        outs = handler(full, opts, statics)
        return tuple(outs) if isinstance(outs, list) else outs

    outs = torch.func.vmap(per_frame)(*[ins[i] for i in pos])
    return (list(outs) if isinstance(outs, tuple) else outs), True


# -- op handlers ------------------------------------------------------------
# each: (inputs, options Table, statics {pos: np const}) -> output(s), on
# ONE frame (the graph's declared shapes)

def _act(x, code: int):
    if code == _ACT_RELU:
        return torch.relu(x)
    if code == _ACT_RELU_N1:
        return torch.clamp(x, -1, 1)
    if code == _ACT_RELU6:
        return torch.clamp(x, 0, 6)
    if code == _ACT_TANH:
        return torch.tanh(x)
    return x


def _same_pads(in_hw, kernel, stride, dil) -> List[Tuple[int, int]]:
    """TF-convention SAME padding per spatial dim: (before, after), the
    odd pixel after."""
    pads = []
    for in_size, k, s, d in zip(in_hw, kernel, stride, dil):
        eff = (k - 1) * d + 1
        out = -(-in_size // s)
        total = max((out - 1) * s + eff - in_size, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _pad_quant(a, pad_code: int, kernel, stride, dil, fill: int):
    """Explicit TF-convention SAME padding of an NHWC int8 tensor with
    ``fill`` (the shifted input zero-point, the encoding of real 0.0)
    for the native-int8 products; VALID is a no-op."""
    if pad_code != _PAD_SAME:
        return a
    (t, b), (l, r) = _same_pads(a.shape[1:3], kernel, stride, dil)
    if not (t or b or l or r):
        return a
    return F.pad(a, (0, 0, l, r, t, b), value=fill)


def _conv_nhwc(x, w_oihw, stride, dil, pad_code: int, groups: int = 1):
    """A float NHWC convolution through a channels_last view: TF SAME
    padding in the conv where it is symmetric, explicit where not."""
    kh, kw = w_oihw.shape[2], w_oihw.shape[3]
    padding: Any = 0
    if pad_code == _PAD_SAME:
        (t, b), (l, r) = _same_pads(x.shape[1:3], (kh, kw), stride, dil)
        if t == b and l == r:
            padding = (t, l)
        else:
            x = F.pad(x, (0, 0, l, r, t, b))
    y = F.conv2d(x.permute(0, 3, 1, 2), w_oihw, stride=stride,
                 padding=padding, dilation=dil, groups=groups)
    return y.permute(0, 2, 3, 1)


def _conv2d(ins, opts, statics):
    x, w, b = ins[0], ins[1], (ins[2] if len(ins) > 2 else None)
    stride = (opts.scalar(2, "int32", 1), opts.scalar(1, "int32", 1))
    dil = (opts.scalar(5, "int32", 1) or 1, opts.scalar(4, "int32", 1) or 1)
    y = _conv_nhwc(x, w.permute(0, 3, 1, 2), stride, dil,
                   opts.scalar(0, "int32", 0))
    if b is not None:
        y = y + b
    return _act(y, opts.scalar(3, "int32", 0))


def _depthwise_conv2d(ins, opts, statics):
    x, w, b = ins[0], ins[1], (ins[2] if len(ins) > 2 else None)
    stride = (opts.scalar(2, "int32", 1), opts.scalar(1, "int32", 1))
    dil = (opts.scalar(6, "int32", 1) or 1, opts.scalar(5, "int32", 1) or 1)
    # [1, kh, kw, in*mult] -> (in*mult, 1, kh, kw)
    y = _conv_nhwc(x, w.permute(3, 0, 1, 2), stride, dil,
                   opts.scalar(0, "int32", 0), groups=x.shape[-1])
    if b is not None:
        y = y + b
    return _act(y, opts.scalar(4, "int32", 0))


def _fully_connected(ins, opts, statics):
    x, w, b = ins[0], ins[1], (ins[2] if len(ins) > 2 else None)
    keep = bool(opts.scalar(2, "bool", False)) if opts else False
    if not keep:
        x = x.reshape(-1, w.shape[-1])
    y = x @ w.T
    if b is not None:
        y = y + b
    return _act(y, opts.scalar(0, "int32", 0) if opts else 0)


def _pool(kind: str):
    def run(ins, opts, statics):
        x = ins[0]
        stride = (opts.scalar(2, "int32", 1), opts.scalar(1, "int32", 1))
        win = (opts.scalar(4, "int32", 1), opts.scalar(3, "int32", 1))
        same = opts.scalar(0, "int32", 0) == _PAD_SAME
        xc = x.permute(0, 3, 1, 2)
        if same:
            (t, b), (l, r) = _same_pads(x.shape[1:3], win, stride, (1, 1))
            pad = (l, r, t, b)
        else:
            pad = (0, 0, 0, 0)
        if kind == "max":
            xp = F.pad(xc, pad, value=-float("inf")) if any(pad) else xc
            y = F.max_pool2d(xp, win, stride)
        else:
            xp = F.pad(xc, pad) if any(pad) else xc
            total = F.avg_pool2d(xp, win, stride, divisor_override=1)
            if same:   # average over the *valid* window only
                ones = F.pad(torch.ones_like(xc), pad) if any(pad) \
                    else torch.ones_like(xc)
                cnt = F.avg_pool2d(ones, win, stride, divisor_override=1)
                y = total / cnt
            else:
                y = total / float(win[0] * win[1])
        return _act(y.permute(0, 2, 3, 1), opts.scalar(5, "int32", 0))
    return run


def _binop(fn):
    def run(ins, opts, statics):
        a, b = ins[0], ins[1]
        if isinstance(a, np.ndarray):
            a = torch.as_tensor(a)
        if isinstance(b, np.ndarray):
            b = torch.as_tensor(b)
        y = fn(a, b)
        return _act(y, opts.scalar(0, "int32", 0) if opts else 0)
    return run


def _unary(fn):
    def run(ins, opts, statics):
        return fn(ins[0])
    return run


def _broadcast_args(ins, opts, statics):
    """BROADCAST_ARGS: broadcastable result shape of two shape vectors;
    both operands must be concrete (constants or SHAPE results)."""
    a, b = ins
    if not isinstance(a, np.ndarray) or not isinstance(b, np.ndarray):
        raise FilterError("tflite: BROADCAST_ARGS on a computed (dynamic) "
                          "shape — unsupported with static shapes")
    out = np.broadcast_shapes(tuple(int(d) for d in a),
                              tuple(int(d) for d in b))
    return np.asarray(out, a.dtype)


def _broadcast_to(ins, opts, statics):
    shape = ins[1]   # graph constant or constant-folded (145)
    if not isinstance(shape, np.ndarray):
        raise FilterError("tflite: BROADCAST_TO with a computed (dynamic) "
                          "shape — unsupported with static shapes")
    return torch.broadcast_to(ins[0], tuple(int(d) for d in shape))


def _reshape(ins, opts, statics):
    shape = statics.get(1)
    if shape is None and opts is not None:
        ns = opts.scalar_vector(0, "int32")
        shape = np.asarray(ns, np.int32) if ns else None
    if shape is None:
        raise FilterError("tflite: RESHAPE with dynamic shape")
    return ins[0].reshape(tuple(int(v) for v in shape))


def _softmax(ins, opts, statics):
    beta = opts.scalar(0, "float32", 1.0) if opts else 1.0
    return torch.softmax(ins[0] * beta, dim=-1)


def _concat(ins, opts, statics):
    axis = opts.scalar(0, "int32", 0)
    y = torch.cat([torch.as_tensor(v) for v in ins], dim=axis)
    return _act(y, opts.scalar(1, "int32", 0))


def _pad_op(ins, opts, statics):
    pads = statics[1].astype(int)
    const = 0.0
    if statics.get(2) is not None:             # PADV2 value
        const = float(np.asarray(statics[2]).reshape(-1)[0])
    flat: List[int] = []
    for a, b in pads[::-1]:
        flat += [int(a), int(b)]
    return F.pad(ins[0], flat, value=const)


def _reduce(kind: str, default_keep=False):
    def run(ins, opts, statics):
        axes = tuple(int(v) for v in np.atleast_1d(statics[1]))
        keep = bool(opts.scalar(0, "bool", default_keep)) if opts \
            else default_keep
        x = ins[0]
        if kind == "mean":
            return torch.mean(x, dim=axes, keepdim=keep)
        if kind == "sum":
            return torch.sum(x, dim=axes, keepdim=keep)
        return torch.amax(x, dim=axes, keepdim=keep)
    return run


def _transpose(ins, opts, statics):
    return ins[0].permute(tuple(int(v) for v in statics[1]))


def _squeeze(ins, opts, statics):
    dims = opts.scalar_vector(0, "int32") if opts else []
    if not dims:
        return torch.squeeze(ins[0])
    return torch.squeeze(ins[0], dim=tuple(dims))


def _slice_dim(x, d: int, b, e, s: int):
    """``x[..., b:e:s, ...]`` on dim ``d``; a negative step (which torch
    slicing lacks) gathers the indices Python's slice names."""
    if s > 0:
        idx = [slice(None)] * d + [slice(b, e, s)]
        return x[tuple(idx)]
    rows = list(range(*slice(b, e, s).indices(x.shape[d])))
    return torch.index_select(x, d, torch.as_tensor(
        rows, dtype=torch.long, device=x.device))


def _strided_slice(ins, opts, statics):
    x = ins[0]
    begin = statics[1].astype(int)
    end = statics[2].astype(int)
    strides = statics[3].astype(int)
    bm = opts.scalar(0, "int32", 0) if opts else 0
    em = opts.scalar(1, "int32", 0) if opts else 0
    shrink = opts.scalar(4, "int32", 0) if opts else 0
    if opts is not None and (opts.scalar(2, "int32", 0)
                             or opts.scalar(3, "int32", 0)):
        raise FilterError(
            "tflite: STRIDED_SLICE ellipsis/new_axis masks not supported")
    squeeze = []
    for d in range(len(begin)):
        if (shrink >> d) & 1:
            b = int(begin[d])
            x = _slice_dim(x, d, b, b + 1 if b != -1 else None, 1)
            squeeze.append(d)
            continue
        b = None if (bm >> d) & 1 else int(begin[d])
        e = None if (em >> d) & 1 else int(end[d])
        x = _slice_dim(x, d, b, e, int(strides[d]))
    if squeeze:
        x = torch.squeeze(x, dim=tuple(squeeze))
    return x


def _slice_op(ins, opts, statics):
    begin = statics[1].astype(int)
    size = statics[2].astype(int)
    x = ins[0]
    size = [x.shape[d] - int(begin[d]) if s == -1 else int(s)
            for d, s in enumerate(size)]
    for d, (b, s) in enumerate(zip(begin, size)):
        # lax.dynamic_slice clamps the start so the slice fits
        b = max(0, min(int(b), x.shape[d] - s))
        x = x.narrow(d, b, s)
    return x


def _resize(method: str):
    """RESIZE_BILINEAR (flags: align_corners@2, half_pixel_centers@3) /
    RESIZE_NEAREST_NEIGHBOR (align_corners@0, half_pixel_centers@1).
    All three tflite sampling grids are honored: legacy ``i*scale`` (both
    flags false), half-pixel, and align-corners; the coordinates are the
    JAX package's, computed in f32 on the device."""
    ac_f, hp_f = (2, 3) if method == "bilinear" else (0, 1)

    def coords(out_len, in_len, align, half, device):
        i = torch.arange(out_len, dtype=torch.float32, device=device)
        if align and out_len > 1:
            return i * (in_len - 1) / (out_len - 1)
        if half:
            return (i + 0.5) * in_len / out_len - 0.5
        return i * in_len / out_len

    def run(ins, opts, statics):
        x = ins[0]
        h2, w2 = (int(v) for v in statics[1])
        n, h, w, c = x.shape
        align = bool(opts.scalar(ac_f, "bool", False)) if opts else False
        half = bool(opts.scalar(hp_f, "bool", False)) if opts else False
        if method == "nearest":
            # tflite GetNearestNeighbor: the SCALE is chosen by
            # align_corners, the +0.5 OFFSET by half_pixel_centers, and
            # round-vs-floor by align_corners (half away from zero)
            def nn_idx(out_len, in_len):
                i = torch.arange(out_len, dtype=torch.float32,
                                 device=x.device)
                if align and out_len > 1:
                    scale = (in_len - 1) / (out_len - 1)
                else:
                    scale = in_len / out_len
                v = (i + (0.5 if half else 0.0)) * scale
                v = torch.floor(v + 0.5) if align else torch.floor(v)
                return torch.clamp(v, 0, in_len - 1).to(torch.long)

            yi = nn_idx(h2, h)
            xi = nn_idx(w2, w)
            return x[:, yi][:, :, xi]
        ys = coords(h2, h, align, half, x.device)
        xs = coords(w2, w, align, half, x.device)
        y0 = torch.clamp(torch.floor(ys), 0, h - 1).to(torch.long)
        x0 = torch.clamp(torch.floor(xs), 0, w - 1).to(torch.long)
        y1 = torch.clamp(y0 + 1, max=h - 1)
        x1 = torch.clamp(x0 + 1, max=w - 1)
        wy = (torch.clamp(ys, 0, h - 1) - y0).to(x.dtype)      # (h2,)
        wx = (torch.clamp(xs, 0, w - 1) - x0).to(x.dtype)      # (w2,)
        top = (x[:, y0][:, :, x0] * (1 - wx)[None, None, :, None]
               + x[:, y0][:, :, x1] * wx[None, None, :, None])
        bot = (x[:, y1][:, :, x0] * (1 - wx)[None, None, :, None]
               + x[:, y1][:, :, x1] * wx[None, None, :, None])
        return top * (1 - wy)[None, :, None, None] \
            + bot * wy[None, :, None, None]
    return run


def _argminmax(fn):
    def run(ins, opts, statics):
        axis = int(np.asarray(statics[1]).reshape(-1)[0])
        out_i64 = opts is not None and opts.scalar(0, "int32", 0) == 4
        return fn(ins[0], dim=axis).to(
            torch.int64 if out_i64 else torch.int32)
    return run


def _cast(ins, opts, statics):
    out_t = opts.scalar(1, "int32", 0) if opts else 0
    return ins[0].to(torch_dtype(_TENSORTYPE_NP.get(out_t, np.float32)))


def _gather(ins, opts, statics):
    axis = opts.scalar(0, "int32", 0) if opts else 0
    x = torch.as_tensor(ins[0])
    idx = torch.as_tensor(ins[1]).to(torch.long)
    axis = axis % x.dim()
    y = torch.index_select(x, axis, idx.reshape(-1))
    return y.reshape(tuple(x.shape[:axis]) + tuple(idx.shape)
                     + tuple(x.shape[axis + 1:]))


def _pack(ins, opts, statics):
    axis = opts.scalar(1, "int32", 0) if opts else 0
    return torch.stack([torch.as_tensor(v) for v in ins], dim=axis)


def _unpack(ins, opts, statics):
    axis = opts.scalar(1, "int32", 0) if opts else 0
    return list(torch.unbind(ins[0], dim=axis))


def _split(ins, opts, statics):
    axis = int(np.asarray(statics[0]).reshape(-1)[0])
    num = opts.scalar(0, "int32", 1) if opts else 1
    return list(torch.chunk(ins[1], num, dim=axis))


def _expand_dims(ins, opts, statics):
    axis = int(np.asarray(statics[1]).reshape(-1)[0])
    if axis < 0:
        axis += ins[0].dim() + 1
    return torch.unsqueeze(ins[0], axis)


def _transpose_conv(ins, opts, statics):
    """tflite TRANSPOSE_CONV: the gradient of a forward conv, as the JAX
    package's ``lax.conv_transpose(..., transpose_kernel=True)`` computes
    it -- the input dilated by the stride, padded as lax pads, convolved
    with the spatially flipped kernel -- then cropped to the declared
    output shape."""
    out_shape = tuple(int(v) for v in statics[0])
    w = ins[1]                         # [out, kh, kw, in]
    x = ins[2]                         # NHWC
    stride = (opts.scalar(2, "int32", 1), opts.scalar(1, "int32", 1))
    same = opts.scalar(0, "int32", 0) == _PAD_SAME
    n, h, wd, c = x.shape
    kh, kw = w.shape[1], w.shape[2]
    pads = []
    for k, s in zip((kh, kw), stride):
        if same:
            pad_len = k + s - 2
            pad_a = k - 1 if s > k - 1 else -(-pad_len // 2)
        else:
            pad_len = k + s - 2 + max(k - s, 0)
            pad_a = k - 1
        pads.append((pad_a, pad_len - pad_a))
    xc = x.permute(0, 3, 1, 2)
    if stride != (1, 1):
        dil = xc.new_zeros((n, c, (h - 1) * stride[0] + 1,
                            (wd - 1) * stride[1] + 1))
        dil[:, :, ::stride[0], ::stride[1]] = xc
        xc = dil
    xc = F.pad(xc, (pads[1][0], pads[1][1], pads[0][0], pads[0][1]))
    wk = w.permute(0, 3, 1, 2).flip(2, 3)       # (out, in, kh, kw)
    y = F.conv2d(xc, wk).permute(0, 2, 3, 1)
    if tuple(y.shape) != out_shape:            # pad/crop to declared shape
        y = y[:, :out_shape[1], :out_shape[2], :]
    if len(ins) > 3 and ins[3] is not None:
        y = y + ins[3]
    return y


def _space_depth(to_depth: bool):
    def run(ins, opts, statics):
        bs = opts.scalar(0, "int32", 1)
        x = ins[0]
        n, h, w, c = x.shape
        if to_depth:
            x = x.reshape(n, h // bs, bs, w // bs, bs, c)
            x = x.permute(0, 1, 3, 2, 4, 5)
            return x.reshape(n, h // bs, w // bs, c * bs * bs)
        x = x.reshape(n, h, w, bs, bs, c // (bs * bs))
        x = x.permute(0, 1, 3, 2, 4, 5)
        return x.reshape(n, h * bs, w * bs, c // (bs * bs))
    return run


def _leaky_relu(ins, o, s):
    alpha = o.scalar(0, "float32", 0.01) if o else 0.01
    return torch.where(ins[0] >= 0, ins[0], ins[0] * alpha)


def _build_handlers() -> Dict[int, Callable]:
    return {
        0: _binop(torch.add), 41: _binop(torch.sub),
        18: _binop(torch.mul), 42: _binop(torch.div),
        55: _binop(torch.maximum), 57: _binop(torch.minimum),
        78: _binop(torch.pow), 90: _binop(torch.floor_divide),
        99: _binop(lambda a, b: torch.square(a - b)),
        1: _pool("avg"), 17: _pool("max"),
        2: _concat, 3: _conv2d, 4: _depthwise_conv2d, 9: _fully_connected,
        5: _space_depth(False), 26: _space_depth(True),
        6: _unary(lambda x: x), 114: _unary(lambda x: x),  # de/quantize
        8: _unary(torch.floor),
        14: _unary(torch.sigmoid), 19: _unary(torch.relu),
        21: _unary(lambda x: torch.clamp(x, 0, 6)), 28: _unary(torch.tanh),
        22: _reshape, 23: _resize("bilinear"),
        97: _resize("nearest"), 25: _softmax,
        34: _pad_op, 60: _pad_op, 36: _gather, 39: _transpose,
        40: _reduce("mean"), 74: _reduce("sum"), 82: _reduce("max"),
        43: _squeeze, 45: _strided_slice, 65: _slice_op,
        47: _unary(torch.exp), 73: _unary(torch.log),
        49: _split, 50: _unary(lambda x: torch.log_softmax(x, dim=-1)),
        53: _cast, 54: _binop(lambda x, a: torch.where(x >= 0, x, x * a)),
        56: _argminmax(torch.argmax), 79: _argminmax(torch.argmin),
        59: _unary(torch.neg), 66: _unary(torch.sin),
        67: _transpose_conv, 70: _expand_dims,
        75: _unary(torch.sqrt), 76: _unary(lambda x: 1.0 / torch.sqrt(x)),
        # 77 SHAPE is folded by _Lowerer._run_op itself
        130: _broadcast_to, 145: _broadcast_args,
        83: _pack, 88: _unpack,
        92: _unary(torch.square), 101: _unary(torch.abs),
        98: _leaky_relu,
        117: _unary(lambda x: x * torch.clamp(x + 3.0, 0, 6) / 6.0),
    }


_OP_HANDLERS: Dict[int, Callable] = {}


# -- the filter backend -----------------------------------------------------

@register_filter
class TFLiteFilter(TorchExecMixin, FilterFramework):
    """``framework=tensorflow-lite``: run a ``.tflite`` file on the card.

    The reference TFLiteCore open/invoke/getModelInfo lifecycle
    (tensor_filter_tensorflow_lite.cc:152-265); ``custom=num_threads:N``
    is accepted and ignored."""

    NAME = "tensorflow-lite"
    SUPPORTED_ACCELERATORS = (Accelerator.GPU, Accelerator.CPU)

    def __init__(self) -> None:
        super().__init__()
        self._graph: Optional[_Graph] = None
        self._lower: Optional[_Lowerer] = None
        self._forward_fn = None
        self._device = None
        self.stats = FilterStatistics()

    # -- lifecycle -----------------------------------------------------------
    def open(self, props: FilterProperties) -> None:
        path = str(props.model)
        if not os.path.isfile(path):
            raise FilterError(f"tflite: model file not found: {path}")
        if not _OP_HANDLERS:
            _OP_HANDLERS.update(_build_handlers())
        with open(path, "rb") as f:
            self._graph = parse_tflite(f.read())
        device = self._pick_device(props.accelerators)
        cdtype, qnative, wonly = self._compute_mode(props, device)
        self._lower = _Lowerer(self._graph, compute_dtype=cdtype,
                               quant_native=qnative, weight_only=wonly,
                               device=device)
        # the warm-up invoke builds the graph on the device (the
        # reference builds the interpreter and its delegates at open)
        in_info, _ = self.get_model_info()
        zeros = [np.zeros(i.np_shape, i.np_dtype) for i in in_info]
        self._setup_exec(self._lower.forward, device, warmup_inputs=zeros,
                         batched_fn=self._lower.batched)
        super().open(props)

    def _compute_mode(self, props: FilterProperties, device):
        """``custom=compute:{auto,float32,bfloat16,int8,w8}`` -> the
        device math mode as ``(compute_dtype, quant_native,
        weight_only)``.

        auto on the card: float graphs run bfloat16; quantized graphs run
        :data:`QUANT_AUTO_GPU`.  auto on the CPU: f32.  ``w8`` keeps int8
        weights resident, dequantized in the forward, float math (bf16
        on the card).  Explicit values force a mode anywhere (int8/w8 on
        a float graph is a no-op: no quantized tensors)."""
        choice = str(props.custom_properties.get("compute", "auto")).lower()
        if (choice == "auto" and device.type == "cuda"
                and any(t.quantized for t in self._graph.tensors)):
            choice = QUANT_AUTO_GPU
        if choice in ("int8", "quant-native"):
            return None, True, False
        if choice in ("w8", "weight-only"):
            cdtype = torch.bfloat16 if device.type == "cuda" else None
            return cdtype, False, True
        # float32/bfloat16/auto: the shared engine policy
        try:
            return self._resolve_compute(props, device), False, False
        except FilterError:
            raise FilterError(                      # tflite also has int8
                f"tflite: unknown compute dtype {choice!r} "
                "(auto | float32 | bfloat16 | int8 | w8)")

    def close(self) -> None:
        self._graph = self._lower = None
        self._teardown_exec()
        super().close()

    # -- hot path ------------------------------------------------------------
    def _as_declared(self, inputs, batched: bool) -> List[Any]:
        """Each input viewed in the model's declared shape (a converter's
        frame drops the size-1 batch dim of a tflite input), so every
        dispatch of one model has one signature and the open's graphs
        serve the stream."""
        in_info, _ = self.get_model_info()
        out = []
        for x, info in zip(inputs, in_info):
            if isinstance(x, BatchView):
                x = x.device_slice()
            if not isinstance(x, torch.Tensor):
                x = np.asarray(x)
            lead = (x.shape[0],) if batched else ()
            out.append(x.reshape(lead + info.np_shape))
        return out

    def _invoke_device(self, inputs: List[Any]):
        return super()._invoke_device(self._as_declared(inputs, False))

    def _dispatch_batched(self, stacked: List[Any]):
        return super()._dispatch_batched(self._as_declared(stacked, True))

    @property
    def routes(self) -> List[Tuple[int, str, str]]:
        """The exact route of each native-int8 product (empty outside
        ``compute:int8``)."""
        return list(self._lower.routes) if self._lower else []

    # -- model meta ----------------------------------------------------------
    def _spec_info(self, idx: int) -> TensorInfo:
        spec = self._graph.tensors[idx]
        return TensorInfo(dtype=TensorType.from_np(np.dtype(spec.np_dtype)),
                          dims=np_shape_to_dim(spec.shape),
                          name=spec.name or None)

    def get_model_info(self) -> Tuple[TensorsInfo, TensorsInfo]:
        if self._graph is None:
            raise FilterError("tflite: not opened")
        return (TensorsInfo([self._spec_info(i) for i in self._graph.inputs]),
                TensorsInfo([self._spec_info(i)
                             for i in self._graph.outputs]))

    @classmethod
    def handles_model(cls, model: Any) -> bool:
        return isinstance(model, str) and model.endswith(".tflite")


@register_filter
class TFLite2Filter(TFLiteFilter):
    """Alias ``framework=tensorflow2-lite`` (reference registers both)."""

    NAME = "tensorflow2-lite"


@register_filter
class TFLiteShortFilter(TFLiteFilter):
    """Alias ``framework=tflite``."""

    NAME = "tflite"
