"""tensor_converter: media streams → other/tensors.

Parity with gst/nnstreamer/elements/gsttensor_converter.c (chain at
:1015-1300), as in ``nnstreamer_tpu/elements/converter.py``: accepts
video/audio/text/octet/flexible-tensor input, emits static tensors, with
frames-per-tensor batching.  An ``(h, w, c)`` video frame IS the tensor
layout, so it passes through untouched (a device-resident frame from
``videotestsrc device-cache`` is never synced to host here) and N>1 frames
stack on the device when they are there; at ``frames-per-tensor=1`` video
fuses (``plan_step``) and lowers (``lower_step``: the payload
passthrough).  The other media are host data and convert on the host, as
in the JAX element.  Differences from the reference, by design:

- media buffers in this framework are already ndarray-backed (no stride-4
  row padding to strip — the reference's memcpy unpadding at :1062-1107 has
  no equivalent because our video frames are dense arrays);
- frame accumulation uses a simple list instead of GstAdapter.

Converter *subplugins* (flatbuf/protobuf/… of §2.6) register via
:mod:`nnstreamer_tpu_torch.converters`.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np

from ..pipeline.caps import Caps, Structure
from ..pipeline.element import Element, FlowReturn, LoweredStep
from ..pipeline.registry import register_element
from ..tensor.buffer import (TensorBuffer, frames_to_ns, is_device_array,
                             to_host)
from ..tensor.caps_util import caps_from_config, flexible_tensors_caps
from ..tensor.info import TensorInfo, TensorsConfig, TensorsInfo
from ..tensor.meta import TensorMetaInfo
from ..tensor.types import TensorType, dim_parse, np_shape_to_dim
from .src import _CHANNELS, video_template_caps

_AUDIO_TYPES = {"S8": TensorType.INT8, "U8": TensorType.UINT8,
                "S16LE": TensorType.INT16, "U16LE": TensorType.UINT16,
                "S32LE": TensorType.INT32, "U32LE": TensorType.UINT32,
                "F32LE": TensorType.FLOAT32, "F64LE": TensorType.FLOAT64}


class _Adapter:
    """Byte-FIFO accumulate/split across buffer boundaries — the GstAdapter
    role in the reference's chunk/merge path (gsttensor_converter.c:783,
    1110-1154): incoming buffers of ARBITRARY size are re-chunked into
    exact frame multiples, with the remainder carried to the next buffer."""

    def __init__(self) -> None:
        self._chunks: List[np.ndarray] = []   # 1-D uint8 views
        self.available = 0

    def push(self, raw: np.ndarray) -> None:
        if raw.nbytes:
            self._chunks.append(raw)
            self.available += raw.nbytes

    def take(self, n: int) -> np.ndarray:
        assert n <= self.available
        from ..pipeline.tracing import record_copy

        record_copy(n)   # re-chunking is a real copy: keep it observable
        out = np.empty(n, np.uint8)
        filled = 0
        while filled < n:
            c = self._chunks[0]
            m = min(n - filled, c.nbytes)
            out[filled:filled + m] = c[:m]
            if m == c.nbytes:
                self._chunks.pop(0)
            else:
                self._chunks[0] = c[m:]
            filled += m
        self.available -= n
        return out

    def compact(self) -> None:
        """Own the carried remainder: pushed chunks are zero-copy VIEWS of
        producer arrays, valid only within the chain call that pushed them —
        a producer reusing its scratch buffer would otherwise corrupt bytes
        still queued here.  Call at the end of each chain call."""
        if not self._chunks:
            return
        from ..pipeline.tracing import record_copy

        record_copy(self.available)
        if len(self._chunks) == 1:
            self._chunks[0] = self._chunks[0].copy()
        else:
            self._chunks = [np.concatenate(self._chunks)]

    def clear(self) -> None:
        self._chunks.clear()
        self.available = 0


@register_element
class TensorConverter(Element):
    FACTORY = "tensor_converter"
    PROPERTIES = {
        "frames-per-tensor": (1, "frames batched into one tensor"),
        "input-dim": (None, "forced dim for octet streams"),
        "input-type": (None, "forced type for octet streams"),
        "set-timestamp": (True, "synthesize PTS when absent"),
        "mode": (None, "custom converter subplugin: 'custom-code:<name>'"),
        "sub-plugins": (None, "reference READABLE property: registered "
                              "converter subplugins (get_property "
                              "returns the live list)"),
    }

    #: reference G_PARAM_READABLE-only (enforced by Element.set_property)
    READONLY_PROPERTIES = ("sub-plugins",)

    def get_property(self, key):
        if key in ("sub-plugins", "sub_plugins"):
            from ..converters import list_converters

            return ",".join(list_converters())   # registry is sorted
        return super().get_property(key)

    def _make_pads(self):
        sink_tmpl = (video_template_caps()
                     .append(Caps([Structure("audio/x-raw", {})]))
                     .append(Caps([Structure("text/x-raw", {})]))
                     .append(Caps([Structure("application/octet-stream", {})]))
                     .append(flexible_tensors_caps()))
        self.add_sink_pad(sink_tmpl, "sink")
        from ..tensor.caps_util import tensors_template_caps

        self.add_src_pad(tensors_template_caps(), "src")

    def start(self):
        self._pending: List[np.ndarray] = []
        self._pending_pts: Optional[int] = None
        self._out_config: Optional[TensorsConfig] = None
        self._media: Optional[str] = None
        self._custom = None
        self._adapter = _Adapter()
        self._base_pts: Optional[int] = None   # PTS of adapter head
        self._emitted_frames = 0               # frames since _base_pts
        mode = self.mode
        if mode:
            kind, _, name = str(mode).partition(":")
            if kind == "custom-script":
                # reference tensor_converter_python3.cc contract: the
                # mode value is a .py file path
                from ..converters.python import PythonScriptConverter

                self._custom = PythonScriptConverter(name)
            else:
                from ..converters import find_converter

                self._custom = find_converter(name)

    # -- negotiation ---------------------------------------------------------
    def set_caps(self, pad, caps):
        st = caps.first()
        self._media = st.name
        fpt = int(self.frames_per_tensor)
        rate = st.get("framerate")
        if isinstance(rate, Fraction) and fpt > 1:
            rate = rate / fpt
        if self._custom is not None:
            cfg = self._custom.get_out_config(caps)
        elif st.name == "video/x-raw":
            w, h = int(st.get("width")), int(st.get("height"))
            fmt = str(st.get("format"))
            ch = _CHANNELS[fmt]
            dims = (ch, w, h) if fpt == 1 else (ch, w, h, fpt)
            cfg = TensorsConfig(
                info=TensorsInfo([TensorInfo(TensorType.UINT8, dims)]),
                rate=rate if isinstance(rate, Fraction) else Fraction(30, 1))
        elif st.name == "audio/x-raw":
            fmt = str(st.get("format", "S16LE"))
            dtype = _AUDIO_TYPES.get(fmt)
            if dtype is None:
                raise ValueError(f"unsupported audio format {fmt}")
            ch = int(st.get("channels", 1))
            srate = st.get("rate")
            self._audio_dtype = dtype
            self._audio_channels = ch
            self._audio_srate = int(srate) if srate else 0
            if fpt > 1:
                # explicit frames-per-tensor: announce NOW, adapter
                # re-chunks arbitrary incoming buffer sizes (reference
                # gsttensor_converter.c:1110-1113 frames_in = buf/frame +
                # adapter accumulate/split at :783)
                out_rate = (Fraction(self._audio_srate, fpt)
                            if self._audio_srate else Fraction(0, 1))
                cfg = TensorsConfig(
                    info=TensorsInfo([TensorInfo(dtype, (ch, fpt))]),
                    rate=out_rate)
                self._announce(cfg)
                return
            # fpt=1: frames-per-buffer fixed by the FIRST buffer's sample
            # count; later buffers of different size are re-chunked by the
            # adapter to that negotiated count
            self._out_config = None
            return  # announce on first buffer
        elif st.name == "text/x-raw":
            dim = dim_parse(str(self.input_dim)) if self.input_dim else (256,)
            self._text_frame_dims = dim
            if fpt > 1:
                dim = dim + (fpt,)
            cfg = TensorsConfig(
                info=TensorsInfo([TensorInfo(TensorType.UINT8, dim)]),
                rate=rate if isinstance(rate, Fraction) else Fraction(0, 1))
        elif st.name == "application/octet-stream":
            if not self.input_dim or not self.input_type:
                raise ValueError(
                    "octet stream requires input-dim and input-type")
            dim = dim_parse(str(self.input_dim))
            if fpt > 1:
                dim = dim + (fpt,)
            cfg = TensorsConfig(
                info=TensorsInfo([TensorInfo(
                    TensorType.from_string(str(self.input_type)), dim)]),
                rate=rate if isinstance(rate, Fraction) else Fraction(0, 1))
        elif st.name == "other/tensors":  # flexible → static promotion
            self._out_config = None
            return  # per-buffer meta decides; announced on first buffer
        else:
            raise ValueError(f"unsupported media type {st.name}")
        self._announce(cfg)

    def _announce(self, cfg: TensorsConfig) -> None:
        self._out_config = cfg
        self.announce_src_caps(caps_from_config(cfg))

    # -- dataflow ------------------------------------------------------------
    def chain(self, pad, buf: TensorBuffer) -> FlowReturn:
        if self._custom is not None:
            out = self._custom.convert(buf)
            return self.push(out)
        media = self._media
        if media == "video/x-raw":
            return self._chain_video(buf)
        if media == "audio/x-raw":
            return self._chain_audio(buf)
        if media == "text/x-raw":
            return self._chain_text(buf)
        if media == "application/octet-stream":
            return self._chain_octet(buf)
        if media == "other/tensors":
            return self._chain_flex(buf)
        raise RuntimeError(f"no caps negotiated on {self.name}")

    def plan_step(self):
        # fused dispatch covers the stateless 1:1 conversions; the
        # accumulating paths (frames-per-tensor>1, audio/text adapters,
        # flex promotion) keep interpreted dispatch
        if self._custom is not None and hasattr(self._custom, "convert"):
            return self._custom.convert
        if self._media == "video/x-raw" \
                and int(self.frames_per_tensor) == 1:
            return self._video_frame
        return None

    def lower_reason(self):
        if self.mode:
            return "custom converter subplugins run host code"
        if int(self.frames_per_tensor) != 1:
            return "frames-per-tensor>1 accumulates state across buffers"
        media = getattr(self, "_media", None)
        if media not in (None, "video/x-raw"):
            return (f"converting {media} re-chunks through the host "
                    "adapter")
        return None

    def lower_step(self):
        # only the video fpt=1 path is a pure payload passthrough; the
        # pre-negotiation state (media unknown) also opts out — plans
        # compile on the first buffer, after caps
        if self.lower_reason() is not None \
                or getattr(self, "_media", None) != "video/x-raw":
            return None
        return LoweredStep(_first_tensor, batched=_first_tensor)

    def _video_frame(self, buf: TensorBuffer) -> TensorBuffer:
        t = buf.tensors[0]
        return buf.with_tensors(
            [t if is_device_array(t) else buf.np(0)])

    def _chain_video(self, buf: TensorBuffer) -> FlowReturn:
        fpt = int(self.frames_per_tensor)
        # (h,w,c) video IS the tensor layout: pass the payload handle
        # through untouched -- a device-resident frame (a CUDA tensor
        # from ``videotestsrc device-cache``) must NOT be synced to host
        # here, that's the whole point of the device path
        if fpt == 1:
            return self.push(self._video_frame(buf))
        frame = buf.tensors[0] if is_device_array(buf.tensors[0]) \
            else buf.np(0)
        # accumulate frames → one tensor of dims (c,w,h,fpt); device
        # payloads accumulate as handles and stack ON DEVICE, keeping the
        # zero-h2d property of the device path for frames-per-tensor > 1
        self._pending.append(frame)
        if self._pending_pts is None:
            self._pending_pts = buf.pts
        if len(self._pending) < fpt:
            return FlowReturn.OK
        if all(is_device_array(f) for f in self._pending):
            import torch

            stacked = torch.stack(self._pending, dim=0)   # (fpt,h,w,c)
        else:
            stacked = np.stack([to_host(f) for f in self._pending],
                               axis=0)  # (fpt,h,w,c)
        self._pending = []
        out = TensorBuffer(tensors=[stacked], pts=self._pending_pts,
                           duration=(buf.duration or 0) * fpt)
        self._pending_pts = None
        return self.push(out)

    def _rebase_pts(self, buf: TensorBuffer) -> None:
        """Re-anchor the synthesized-PTS timeline on an upstream timestamp
        when the adapter is at a frame boundary and the buffer carries a
        valid PTS; a PTS-less buffer continues the running timeline
        (reference _gst_tensor_converter_chain_timestamp :783)."""
        if self._adapter.available == 0 and buf.pts is not None:
            self._base_pts = buf.pts
            self._emitted_frames = 0
        elif self._base_pts is None:
            self._base_pts = 0

    def _chain_audio(self, buf: TensorBuffer) -> FlowReturn:
        ch = self._audio_channels
        samples = np.asarray(buf.np(0))
        if samples.ndim == 1:
            samples = samples.reshape(-1, ch)
        if self._out_config is None:
            # fpt=1: the FIRST buffer's sample count fixes frames/tensor
            n = samples.shape[0]
            out_rate = (Fraction(self._audio_srate, n)
                        if self._audio_srate and n else Fraction(0, 1))
            cfg = TensorsConfig(
                info=TensorsInfo([TensorInfo(self._audio_dtype,
                                             np_shape_to_dim(samples.shape))]),
                rate=out_rate)
            self._announce(cfg)
        info = self._out_config.info[0]
        frames_out = info.np_shape[0]
        out_bytes = info.size
        srate = self._audio_srate
        self._rebase_pts(buf)

        def stamp(fallback_pts, fallback_dur):
            if srate and self.set_timestamp:
                pts = self._base_pts + frames_to_ns(
                    self._emitted_frames, srate, 1)
                dur = frames_to_ns(frames_out, srate, 1)
            else:
                pts, dur = fallback_pts, fallback_dur
            self._emitted_frames += frames_out
            return pts, dur

        # fast path: adapter empty and the buffer is exactly one tensor —
        # zero-copy, but it still advances the synthesized timeline so a
        # later adapter-path buffer continues instead of restarting at base
        if (self._adapter.available == 0
                and samples.shape == info.np_shape):
            pts, dur = stamp(buf.pts, buf.duration)
            out = buf.with_tensors([samples])
            out.pts, out.duration = pts, dur
            return self.push(out)
        self._adapter.push(
            np.ascontiguousarray(samples).reshape(-1).view(np.uint8))
        ret = FlowReturn.OK
        while self._adapter.available >= out_bytes:
            arr = (self._adapter.take(out_bytes)
                   .view(info.np_dtype).reshape(info.np_shape))
            pts, dur = stamp(buf.pts, buf.duration)
            ret = self.push(TensorBuffer(tensors=[arr], pts=pts,
                                         duration=dur,
                                         extra=dict(buf.extra)))
            if ret is FlowReturn.ERROR:
                return ret
        self._adapter.compact()
        return ret

    def _chain_text(self, buf: TensorBuffer) -> FlowReturn:
        """Each text buffer is ONE frame, padded/clipped to the frame size
        (reference :1114-1143); frames-per-tensor>1 stacks N frames."""
        frame_dims = self._text_frame_dims
        frame_size = int(np.prod(frame_dims))
        raw = np.asarray(buf.np(0)).reshape(-1).view(np.uint8)
        if raw.nbytes < frame_size:
            raw = np.concatenate(
                [raw, np.zeros(frame_size - raw.nbytes, np.uint8)])
        frame = raw[:frame_size].reshape(tuple(reversed(frame_dims)))
        fpt = int(self.frames_per_tensor)
        if fpt <= 1:
            return self.push(buf.with_tensors([frame]))
        self._pending.append(frame)
        if self._pending_pts is None:
            self._pending_pts = buf.pts
        if len(self._pending) < fpt:
            return FlowReturn.OK
        stacked = np.stack(self._pending, axis=0)
        self._pending = []
        out = TensorBuffer(tensors=[stacked], pts=self._pending_pts,
                           duration=(buf.duration or 0) * fpt,
                           extra=dict(buf.extra))
        self._pending_pts = None
        return self.push(out)

    def _chain_octet(self, buf: TensorBuffer) -> FlowReturn:
        """Static chunking (reference :1144-1154): arbitrary buffer sizes
        are re-chunked to exact tensor multiples via the adapter — a big
        buffer yields several tensors, small ones accumulate."""
        info = self._out_config.info[0]
        out_bytes = info.size
        self._rebase_pts(buf)
        self._adapter.push(np.asarray(buf.np(0)).reshape(-1).view(np.uint8))
        rate = self._out_config.rate
        ret = FlowReturn.OK
        while self._adapter.available >= out_bytes:
            arr = (self._adapter.take(out_bytes)
                   .view(info.np_dtype).reshape(info.np_shape))
            if rate and self.set_timestamp:
                pts = self._base_pts + frames_to_ns(
                    self._emitted_frames, rate.numerator, rate.denominator)
                dur = frames_to_ns(1, rate.numerator, rate.denominator)
            else:
                pts, dur = buf.pts, buf.duration
            self._emitted_frames += 1
            ret = self.push(TensorBuffer(tensors=[arr], pts=pts,
                                         duration=dur,
                                         extra=dict(buf.extra)))
            if ret is FlowReturn.ERROR:
                return ret
        self._adapter.compact()
        return ret

    def _chain_flex(self, buf: TensorBuffer) -> FlowReturn:
        """Flexible → static promotion: first buffer's meta fixes the config
        (reference :1155-1200)."""
        if self._out_config is None:
            infos = []
            for i in range(buf.num_tensors):
                meta = (buf.metas[i] if buf.metas else
                        TensorMetaInfo.from_info(
                            TensorInfo.from_np(buf.np(i))))
                infos.append(meta.to_info())
            cfg = TensorsConfig(info=TensorsInfo(infos), rate=Fraction(0, 1))
            self._announce(cfg)
        for i, info in enumerate(self._out_config.info):
            got = np_shape_to_dim(buf.np(i).shape)
            if not TensorInfo(info.dtype, got).is_equal(info):
                raise ValueError(
                    f"flexible stream changed shape: {got} != {info.dims}")
        return self.push(buf.with_tensors(
            [buf.np(i) for i in range(buf.num_tensors)]))


def _first_tensor(ts):
    return [ts[0]]
