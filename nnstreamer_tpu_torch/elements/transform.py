"""tensor_transform: element-wise ops on tensor streams.

Parity with gst/nnstreamer/elements/gsttensor_transform.c (mode enums at
gsttensor_transform.h:57-146): ``typecast``, ``arithmetic`` (op chains with
optional per-channel operands), ``transpose``, ``dimchg``, ``stand``
(standardization / dc-average), ``clamp``; ``apply`` selects which tensors
in the frame are transformed.

The counterpart of ``nnstreamer_tpu/elements/transform.py``, its
re-design of the reference's ORC SIMD acceleration
(gsttensor_transform.c:463-533): when the incoming payload is already a
torch tensor (e.g. directly downstream of a filter on the card, or a
``videotestsrc device-cache``), ops execute as torch expressions on its
device and never force a host sync; host numpy is used otherwise.
``acceleration=false`` forces numpy.  Each mode's output dtype on the
torch path is the JAX package's on its jnp path (numpy, jnp and torch
promote ``uint8 + float`` differently: f64, f32, f32): arithmetic casts
back to the negotiated type, a per-channel op writes back into the
current type (jnp's ``.at[].set``, here an out-of-place ``torch.where``),
and ``clamp`` of an integer tensor by its float bounds computes in f32,
as ``jnp.clip`` does.  The element fuses (``plan_step``) and, in the
``typecast``, ``arithmetic`` and ``dimchg`` modes, lowers into a segment's
graph (``lower_step``: the torch path of the same math).
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

import numpy as np
import torch

from ..pipeline.element import Element, FlowReturn, LoweredStep
from ..pipeline.registry import register_element
from ..utils.log import ml_logw
from ..tensor.buffer import BatchView, TensorBuffer
from ..tensor.caps_util import (caps_from_config, config_from_caps,
                                static_tensors_caps)
from ..tensor.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensor.types import TensorType


def _xp(arr):
    """numpy for host arrays, torch for tensors (keeps transforms on the
    tensor's device — the GPU replacement for ORC SIMD)."""
    return torch if isinstance(arr, torch.Tensor) else np


def _torch_dtype(t: TensorType) -> torch.dtype:
    return getattr(torch, t.value)


def _astype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """jnp's ``astype``: a float → integer cast truncates toward zero and
    saturates at the type's range, NaN → 0, as XLA converts (a plain
    torch cast of an out-of-range value is undefined)."""
    if x.dtype.is_floating_point and not (dtype.is_floating_point
                                          or dtype == torch.bool):
        info = torch.iinfo(dtype)
        # the bounds in f64, int64's top one below 2**63
        hi = min(float(info.max), 9223372036854774784.0)
        x = torch.nan_to_num(x.double(), nan=0.0).clamp(info.min, hi)
    return x.to(dtype)


@register_element
class TensorTransform(Element):
    FACTORY = "tensor_transform"
    PROPERTIES = {
        "mode": (None, "typecast|arithmetic|transpose|dimchg|stand|clamp"),
        "option": (None, "mode option string"),
        "acceleration": (True, "allow on-device (torch) execution"),
        "apply": (None, "comma list of tensor indices to transform"),
    }

    def _make_pads(self):
        self.add_sink_pad(static_tensors_caps(), "sink")
        self.add_src_pad(static_tensors_caps(), "src")

    def start(self):
        mode = str(self.mode or "")
        option = str(self.option or "")
        self._apply_idx: Optional[List[int]] = None
        if self.apply not in (None, ""):
            self._apply_idx = [int(x) for x in str(self.apply).split(",")]
        if mode == "typecast":
            self._out_type = TensorType.from_string(option)
        elif mode == "arithmetic":
            self._ops, self._ch_dim = _parse_arith(option)
        elif mode == "transpose":
            self._perm = tuple(int(x) for x in option.split(":"))
            # the reference's transpose option is a permutation of axis
            # indices (gsttensor_transform.c); an out-of-range or
            # repeated index used to surface as a raw IndexError deep
            # in negotiation
            if sorted(self._perm) != list(range(len(self._perm))):
                raise ValueError(
                    f"{self.name}: transpose option must be a "
                    f"permutation of 0..{len(self._perm) - 1}, got "
                    f"{option!r}")
        elif mode == "dimchg":
            a, _, b = option.partition(":")
            self._dimchg = (int(a), int(b))
            if min(self._dimchg) < 0:
                raise ValueError(f"{self.name}: dimchg indices must be "
                                 f">= 0, got {option!r}")
        elif mode == "stand":
            parts = option.split(":")
            self._stand_mode = parts[0] or "default"
            self._stand_per_channel = len(parts) > 1 and parts[1] == "per-channel"
        elif mode == "clamp":
            lo, _, hi = option.partition(":")
            self._clamp = (float(lo), float(hi))
        else:
            raise ValueError(f"{self.name}: unknown mode {mode!r}")
        self._mode = mode

    # -- negotiation ---------------------------------------------------------
    def set_caps(self, pad, caps):
        cfg = config_from_caps(caps)
        out_infos = []
        for i, info in enumerate(cfg.info):
            if self._applies(i):
                out_infos.append(self._transform_info(info))
            else:
                out_infos.append(info.copy())
        self._out_config = TensorsConfig(info=TensorsInfo(out_infos),
                                         rate=cfg.rate)
        self.announce_src_caps(caps_from_config(self._out_config))

    def _applies(self, idx: int) -> bool:
        return self._apply_idx is None or idx in self._apply_idx

    def _transform_info(self, info: TensorInfo) -> TensorInfo:
        mode = self._mode
        if mode == "typecast":
            return TensorInfo(self._out_type, info.dims, info.name)
        if mode == "arithmetic":
            dtype = info.dtype
            for op, operand, _ch in self._ops:
                if op == "typecast":
                    dtype = operand[0]
            return TensorInfo(dtype, info.dims, info.name)
        if mode == "transpose":
            if len(self._perm) < len(info.dims):
                raise ValueError(
                    f"{self.name}: transpose permutation rank "
                    f"{len(self._perm)} is below tensor rank "
                    f"{len(info.dims)} (dims {info.dims}) — a shorter "
                    "permutation would silently drop trailing dims")
            # reference transpose options are 4-index against NNS dims
            # padded with trailing 1s; pad, permute, strip the padding
            # back off (our dims convention is true-rank)
            padded = info.dims + (1,) * (len(self._perm) - len(info.dims))
            out = [padded[p] for p in self._perm]
            while len(out) > len(info.dims) and out[-1] == 1:
                out.pop()
            return TensorInfo(info.dtype, tuple(out), info.name)
        if mode == "dimchg":
            a, b = self._dimchg
            # same reference convention as transpose: indices address
            # NNS dims padded with trailing 1s (a verbatim '0:3' is
            # valid against a true-rank-3 tensor); pad, move, strip
            rank = max(len(info.dims), a + 1, b + 1)
            dims = list(info.dims) + [1] * (rank - len(info.dims))
            d = dims.pop(a)
            dims.insert(b, d)
            while len(dims) > len(info.dims) and dims[-1] == 1:
                dims.pop()
            return TensorInfo(info.dtype, tuple(dims), info.name)
        if mode == "stand":
            return TensorInfo(TensorType.FLOAT32, info.dims, info.name)
        return info.copy()  # clamp keeps type/shape

    # -- dataflow ------------------------------------------------------------
    def _apply(self, buf: TensorBuffer) -> TensorBuffer:
        outs = []
        for i in range(buf.num_tensors):
            t = buf.tensors[i]
            if not bool(self.acceleration) or isinstance(t, np.ndarray):
                t = buf.np(i)
            elif isinstance(t, BatchView):
                t = t.device_slice()
            if self._applies(i):
                target = self._out_config.info[i].dtype
                outs.append(self._transform(t, target))
            else:
                outs.append(t)
        return buf.with_tensors(outs)

    def chain(self, pad, buf: TensorBuffer) -> FlowReturn:
        return self.push(self._apply(buf))

    def plan_step(self):
        return self._apply

    #: modes the fuse=xla tier lowers (the JAX package's set; stand,
    #: clamp and transpose fall the segment back to fuse-python)
    _LOWERABLE_MODES = ("typecast", "arithmetic", "dimchg")

    def lower_reason(self):
        mode = str(self.mode or "")
        if mode not in self._LOWERABLE_MODES:
            return (f"tensor_transform mode={mode!r} has no jnp lowering "
                    f"(lowerable: {','.join(self._LOWERABLE_MODES)})")
        return None

    def lower_step(self):
        if self.lower_reason() is not None \
                or getattr(self, "_out_config", None) is None:
            return None
        # the torch path of _transform is the lowered math: in a segment
        # every payload is a tensor, so one implementation serves the
        # three tiers (uint8 arithmetic promotes through f32 here, as the
        # JAX package's traced path does, where its host path takes f64)
        info = self._out_config.info
        applies = [self._applies(i) for i in range(info.num_tensors)]
        targets = [info[i].dtype for i in range(info.num_tensors)]
        transform = self._transform_torch

        def fn(ts, _applies=applies, _targets=targets, _tf=transform):
            return [_tf(t, _targets[i]) if _applies[i] else t
                    for i, t in enumerate(ts)]

        return LoweredStep(fn)

    def _transform(self, arr: Any, target=None) -> Any:
        xp = _xp(arr)
        if xp is torch:
            return self._transform_torch(arr, target)
        mode = self._mode
        if mode == "typecast":
            return arr.astype(self._out_type.np_dtype)
        if mode == "arithmetic":
            out = arr
            for op, operand, applying_ch in self._ops:
                if op == "typecast":
                    out = out.astype(operand[0].np_dtype)
                    continue
                val = self._operand(operand, xp)
                if applying_ch >= 0 and self._ch_dim is not None:
                    # reference per-channel arithmetic: the op touches
                    # only index applying_ch along the NNS ch_dim axis
                    # (= numpy axis ndim-1-ch_dim), with the same
                    # padded-dims convention as transpose/dimchg: a
                    # ch_dim beyond the true rank addresses a padded
                    # size-1 axis, where channel 0 is the whole tensor
                    # and any other index never matches (the reference
                    # compares channel indices per element, so an
                    # out-of-range index is a no-op — made identical
                    # here on the numpy AND torch paths)
                    if self._ch_dim >= out.ndim:
                        if applying_ch == 0:
                            new = (out + val if op == "add"
                                   else out * val if op == "mul"
                                   else out / val)
                            # match the in-range slice path, which
                            # writes back into the current dtype
                            out = (new.astype(out.dtype)
                                   if new.dtype != out.dtype else new)
                        continue
                    axis = out.ndim - 1 - self._ch_dim
                    if applying_ch >= out.shape[axis]:
                        continue
                    idx = [slice(None)] * out.ndim
                    idx[axis] = applying_ch
                    idx = tuple(idx)
                    sl = out[idx]
                    new = (sl + val if op == "add"
                           else sl * val if op == "mul" else sl / val)
                    out = out.copy()
                    out[idx] = new
                elif op == "add":
                    out = out + val
                elif op == "mul":
                    out = out * val
                elif op == "div":
                    out = out / val
            # numpy promotion (e.g. uint8 + 0.5 → float64) must not leak
            # past the caps we announced: cast back to the negotiated dtype
            if target is not None and out.dtype != target.np_dtype:
                out = out.astype(target.np_dtype)
            return out
        if mode == "transpose":
            # reference dims are innermost-first; numpy axes are
            # reversed — and a 4-index reference option against a
            # lower-rank tensor pads with 1s (NNS trailing dims =
            # leading numpy axes), permutes, then strips the padding
            orig_ndim = arr.ndim
            nd = len(self._perm)
            if arr.ndim < nd:
                arr = arr.reshape((1,) * (nd - arr.ndim) + arr.shape)
            np_perm = tuple(nd - 1 - self._perm[nd - 1 - ax]
                            for ax in range(nd))
            out = xp.transpose(arr, np_perm)
            while out.ndim > orig_ndim and out.shape[0] == 1:
                out = out.reshape(out.shape[1:])
            return out
        if mode == "dimchg":
            a, b = self._dimchg
            orig_ndim = arr.ndim
            nd = max(arr.ndim, a + 1, b + 1)
            if arr.ndim < nd:
                arr = arr.reshape((1,) * (nd - arr.ndim) + arr.shape)
            out = xp.moveaxis(arr, nd - 1 - a, nd - 1 - b)
            while out.ndim > orig_ndim and out.shape[0] == 1:
                out = out.reshape(out.shape[1:])
            return out
        if mode == "stand":
            x = arr.astype(np.float32)
            axes = (tuple(range(x.ndim - 1)) if self._stand_per_channel
                    else None)
            mean = x.mean(axis=axes, keepdims=axes is not None)
            if self._stand_mode == "dc-average":
                return x - mean
            std = x.std(axis=axes, keepdims=axes is not None)
            return (x - mean) / (std + 1e-10)
        if mode == "clamp":
            lo, hi = self._clamp
            return xp.clip(arr, lo, hi)
        raise AssertionError(mode)

    def _transform_torch(self, arr: torch.Tensor, target=None
                         ) -> torch.Tensor:
        """:meth:`_transform` on a tensor, on its device, with the JAX
        package's jnp values and dtypes."""
        mode = self._mode
        if mode == "typecast":
            return _astype(arr, _torch_dtype(self._out_type))
        if mode == "arithmetic":
            out = arr
            for op, operand, applying_ch in self._ops:
                if op == "typecast":
                    out = _astype(out, _torch_dtype(operand[0]))
                    continue
                val = self._operand(operand, torch, out.device)
                if applying_ch >= 0 and self._ch_dim is not None:
                    # the numpy path's per-channel rules (padded ch_dim,
                    # out-of-range channel a no-op); the result of the
                    # op writes back into the current dtype
                    if self._ch_dim >= out.ndim:
                        if applying_ch == 0:
                            out = _astype(_arith(op, out, val), out.dtype)
                        continue
                    axis = out.ndim - 1 - self._ch_dim
                    if applying_ch >= out.shape[axis]:
                        continue
                    new = _astype(_arith(op, out.select(axis, applying_ch),
                                         val), out.dtype)
                    shape = [1] * out.ndim
                    shape[axis] = out.shape[axis]
                    hit = (torch.arange(out.shape[axis], device=out.device)
                           == applying_ch).reshape(shape)
                    out = torch.where(hit, new.unsqueeze(axis), out)
                else:
                    out = _arith(op, out, val)
            if target is not None and out.dtype != _torch_dtype(target):
                out = _astype(out, _torch_dtype(target))
            return out
        if mode == "transpose":
            orig_ndim = arr.ndim
            nd = len(self._perm)
            if arr.ndim < nd:
                arr = arr.reshape((1,) * (nd - arr.ndim) + tuple(arr.shape))
            np_perm = tuple(nd - 1 - self._perm[nd - 1 - ax]
                            for ax in range(nd))
            out = arr.permute(np_perm)
            while out.ndim > orig_ndim and out.shape[0] == 1:
                out = out[0]
            return out.contiguous()
        if mode == "dimchg":
            a, b = self._dimchg
            orig_ndim = arr.ndim
            nd = max(arr.ndim, a + 1, b + 1)
            if arr.ndim < nd:
                arr = arr.reshape((1,) * (nd - arr.ndim) + tuple(arr.shape))
            out = torch.movedim(arr, nd - 1 - a, nd - 1 - b)
            while out.ndim > orig_ndim and out.shape[0] == 1:
                out = out[0]
            return out.contiguous()
        if mode == "stand":
            x = arr.to(torch.float32)
            if self._stand_per_channel:
                dims = tuple(range(x.ndim - 1))
                mean = x.mean(dim=dims, keepdim=True)
                std = x.std(dim=dims, correction=0, keepdim=True)
            else:
                mean, std = x.mean(), x.std(correction=0)
            if self._stand_mode == "dc-average":
                return x - mean
            return (x - mean) / (std + 1e-10)
        if mode == "clamp":
            lo, hi = self._clamp
            # jnp.clip of an integer array by float bounds computes in f32
            if not arr.dtype.is_floating_point:
                arr = arr.to(torch.float32)
            return torch.clamp(arr, lo, hi)
        raise AssertionError(mode)

    @staticmethod
    def _operand(operand, xp, device=None):
        vals = operand
        if len(vals) == 1:
            return vals[0]
        # per-channel operand along the innermost reference dim = last np
        # axis; kept floating so fractional operands aren't truncated
        # (f32 on the torch path, as jnp.asarray makes it)
        if xp is torch:
            return torch.tensor(vals, dtype=torch.float32, device=device)
        return np.asarray(vals, dtype=np.float64)


def _arith(op: str, x, val):
    if op == "div" and not isinstance(val, torch.Tensor):
        # CUDA divides by a host scalar as a multiply by its reciprocal;
        # a divisor on the tensor's device divides exactly, as numpy and
        # XLA do (same dtype as the scalar would give)
        val = torch.tensor(val, dtype=torch.result_type(x, val),
                           device=x.device)
    return x + val if op == "add" else x * val if op == "mul" else x / val


def _parse_arith(option: str):
    """Parse the reference arithmetic option grammar
    (gsttensor_transform.c REGEX_ARITH_OPTION):
    ``[typecast:TYPE,][per-channel:(false|true@DIM),]
    add|mul|div:NUMBER[@CH_IDX], ...`` — plus this framework's
    multi-value per-channel operand extension ``add:1,2,3`` (values
    bind to the innermost dim).  Reference-verbatim behaviors honored:
    an UNKNOWN operator (``casttype:...``) warns and is skipped
    (GTT_OP_UNKNOWN — the ssat goldens rely on the pipeline running
    with the op dropped), and extra ``:NUMBER`` segments after the
    first operand are accepted-and-ignored (the reference regex admits
    them, its parser reads only values[0]).

    Returns ``(ops, ch_dim)``: ops as ``(op, operand, applying_ch)``
    triples (-1 = all channels), ch_dim the per-channel NNS dim index
    or None."""
    ops: List[Tuple[str, Any, int]] = []
    ch_dim = None
    # break before any "word:" token (op names and per-channel alike);
    # numeric per-channel value lists keep their commas
    parts = re.split(r",(?=[a-z-]+:)", option)
    for part in parts:
        if not part.strip():
            continue
        op, _, val = part.partition(":")
        op = op.strip()
        if op == "per-channel":
            flag, _, dim = val.partition("@")
            if flag.strip().lower() == "true":
                ch_dim = int(dim) if dim.strip() else 0
            continue
        if op == "typecast":
            ops.append((op, [TensorType.from_string(val)], -1))
        elif op in ("add", "mul", "div", "sub"):
            val, _, ch = val.partition("@")
            applying_ch = int(ch) if ch.strip() else -1
            vals = []
            for item in val.split(","):
                segs = item.split(":")
                if len(segs) > 1:
                    ml_logw("arithmetic %s: ignoring extra operand "
                            "segments %s (reference parser reads only "
                            "the first)", op, segs[1:])
                vals.append(float(segs[0]))
            if op == "sub":
                op, vals = "add", [-v for v in vals]
            if applying_ch >= 0 and len(vals) > 1:
                # a multi-value operand binds to the innermost dim; a
                # single-channel selector makes that a shape mismatch,
                # so keep the first value (and say so) instead of
                # deferring to a numpy broadcast crash mid-stream
                ml_logw("arithmetic %s@%d: multi-value operand %s "
                        "reduced to its first value (per-channel "
                        "selector takes one operand)", op, applying_ch,
                        vals)
                vals = vals[:1]
            ops.append((op, vals, applying_ch))
        else:
            # reference GTT_OP_UNKNOWN: warn and drop the op, keep the
            # pipeline running (ssat tests pass casttype:... expecting
            # exactly this)
            ml_logw("arithmetic: unknown operator %r skipped "
                    "(reference GTT_OP_UNKNOWN behavior)", op)
    return ops, ch_dim
