"""Media sources: videotestsrc/audiotestsrc equivalents, filesrc and
multifilesrc.

The reference relies on GStreamer's videotestsrc for every golden test and
benchmark pipeline (e.g. tests/nnstreamer_filter_tensorflow2_lite/runTest.sh).
These sources play the same role: deterministic synthetic frames at a
negotiated format/rate, honoring downstream caps constraints (capsfilter).
The counterpart of ``nnstreamer_tpu/elements/src.py``: ``videotestsrc``
can keep its frames on the card (``device-cache``); the other sources
produce host arrays, as in the JAX package.
"""

from __future__ import annotations

import os
from fractions import Fraction
from typing import Optional

import numpy as np

from ..pipeline.caps import ANY_FRAMERATE, Caps, FractionRange, IntRange, Structure
from ..pipeline.graph import Source
from ..pipeline.registry import register_element
from ..tensor.buffer import SECOND, TensorBuffer

VIDEO_FORMATS = ["RGB", "BGRx", "GRAY8"]  # reference converter's video set
_CHANNELS = {"RGB": 3, "BGRx": 4, "GRAY8": 1}


def video_template_caps() -> Caps:
    return Caps([Structure("video/x-raw", {
        "format": list(VIDEO_FORMATS),
        "width": IntRange(1, 1 << 15),
        "height": IntRange(1, 1 << 15),
        "framerate": ANY_FRAMERATE,
    })])


@register_element
class VideoTestSrc(Source):
    """Deterministic video pattern source.

    Patterns: ``smpte`` (color bands), ``gradient``, ``checkers``,
    ``random`` (seeded), ``solid`` (color via ``foreground-color``).
    """

    FACTORY = "videotestsrc"
    PROPERTIES = {
        "num-buffers": (-1, "frames to emit, -1 = unlimited"),
        "pattern": ("smpte", "smpte|gradient|checkers|random|solid"),
        "foreground-color": (0xFFFFFF, "solid pattern RGB"),
        "seed": (42, "random pattern seed"),
        "cache-frames": (0, "pre-render N distinct frames and cycle them "
                            "(0 = render every frame); removes source "
                            "render cost from throughput measurements"),
        "device-cache": (0, "pre-render N distinct frames, stage them to "
                            "cuda:0 ONCE, and cycle the device-resident "
                            "tensors; downstream device consumers "
                            "(tensor_filter) then see zero host->device "
                            "traffic per frame (frames live in device "
                            "memory for their whole pipeline life)"),
    }

    def _make_pads(self):
        self.add_src_pad(video_template_caps(), "src")

    def start(self):
        self._count = 0
        self._rng = np.random.default_rng(int(self.seed))
        self._cache: Optional[list] = None

    def negotiate(self) -> Caps:
        allowed = self.src_pad.peer_allowed_caps()
        caps = self.src_pad.template.intersect(allowed)
        if caps.is_empty():
            raise ValueError(f"{self.name}: cannot negotiate with downstream")
        # Default resolution when unconstrained.
        fixed = caps.first().fields
        defaults = {"width": 320, "height": 240,
                    "framerate": Fraction(30, 1)}
        s = dict(fixed)
        for k, d in defaults.items():
            v = s.get(k)
            if isinstance(v, (IntRange, FractionRange)):
                # prefer the default when allowed, else let fixate() pick
                # from the range (its low end)
                if v.contains(d):
                    s[k] = d
            elif v is None:
                s[k] = d
        caps = Caps([Structure("video/x-raw", s)]).fixate()
        self._caps = caps
        st = caps.first()
        self._w, self._h = int(st.get("width")), int(st.get("height"))
        self._format = str(st.get("format"))
        self._rate = st.get("framerate")
        return caps

    def create(self) -> Optional[TensorBuffer]:
        n = int(self.num_buffers)
        if n >= 0 and self._count >= n:
            return None
        kd, k = int(self.device_cache), int(self.cache_frames)
        if kd > 0:
            if self._cache is None:
                # one copy per distinct frame, ONCE -- after this the
                # source emits existing device tensors (no per-frame
                # host render, no h2d in the steady state); consumers
                # must not write into them (same contract as tee fan-out)
                import torch

                from ..device import resolve_device

                dev = resolve_device(None)
                self._cache = [torch.from_numpy(self._render(i)).to(dev)
                               for i in range(kd)]
            frame = self._cache[self._count % kd]
        elif k > 0:
            if self._cache is None:
                self._cache = []
                for i in range(k):
                    f = self._render(i)
                    # the same object is re-emitted every cycle: freeze it
                    # so an in-place mutation downstream raises instead of
                    # silently corrupting later cycles
                    f.flags.writeable = False
                    self._cache.append(f)
            frame = self._cache[self._count % k]
        else:
            frame = self._render(self._count)
        rate = self._rate or Fraction(30, 1)
        dur = SECOND * rate.denominator // max(rate.numerator, 1)
        buf = TensorBuffer(tensors=[frame], pts=self._count * dur,
                           duration=dur)
        self._count += 1
        return buf

    #: GStreamer videotestsrc numeric pattern ids → nearest pattern
    #: here (ssat lines say pattern=13/15/18; byte-goldens cannot be
    #: verbatim-portable anyway — gst's pixel generators are its own —
    #: but the launch lines must RUN with a deterministic look-alike)
    GST_PATTERN_IDS = {
        0: "smpte", 1: "random", 2: "black", 3: "white", 7: "checkers",
        8: "checkers", 9: "checkers", 10: "checkers", 11: "gradient",
        13: "smpte", 14: "gradient", 15: "gradient", 16: "gradient",
        17: "solid", 18: "checkers", 19: "smpte", 20: "smpte",
        23: "gradient",
    }

    def _render(self, n: int) -> np.ndarray:
        w, h, ch = self._w, self._h, _CHANNELS[self._format]
        pattern = str(self.pattern)
        try:
            pattern = self.GST_PATTERN_IDS.get(int(pattern), "smpte")
        except ValueError:
            pass                      # a name, not a numeric gst id
        if pattern in ("black", "white"):
            px = np.full((h, w, ch), 0 if pattern == "black" else 255,
                         dtype=np.uint8)
            if ch == 4:
                px[..., 3] = 255
            return px
        if pattern == "random":
            return self._rng.integers(0, 256, (h, w, ch), dtype=np.uint8)
        if pattern == "solid":
            color = int(self.foreground_color)
            rgb = [(color >> 16) & 0xFF, (color >> 8) & 0xFF, color & 0xFF]
            px = np.array((rgb + [255])[:ch], dtype=np.uint8)
            return np.broadcast_to(px, (h, w, ch)).copy()
        if pattern == "checkers":
            yy, xx = np.mgrid[0:h, 0:w]
            cell = ((xx // 8 + yy // 8 + n) % 2) * 255
            return np.repeat(cell.astype(np.uint8)[..., None], ch, axis=2)
        if pattern == "gradient":
            row = np.linspace(0, 255, w, dtype=np.uint8)
            frame = np.broadcast_to(row[None, :, None], (h, w, ch))
            return np.ascontiguousarray(
                np.roll(frame, shift=n, axis=1))
        # smpte-ish: 7 vertical color bars
        bars = np.array([
            [191, 191, 191], [191, 191, 0], [0, 191, 191], [0, 191, 0],
            [191, 0, 191], [191, 0, 0], [0, 0, 191]], dtype=np.uint8)
        idx = (np.arange(w) * 7 // max(w, 1)).clip(0, 6)
        frame = bars[idx][None, :, :].repeat(h, axis=0)
        if ch == 1:
            frame = frame.mean(axis=2, keepdims=True).astype(np.uint8)
        elif ch == 4:
            frame = np.concatenate(
                [frame, np.full((h, w, 1), 255, np.uint8)], axis=2)
        return np.ascontiguousarray(frame)


@register_element
class AudioTestSrc(Source):
    """Sine-wave audio source (audiotestsrc role)."""

    FACTORY = "audiotestsrc"
    PROPERTIES = {
        "num-buffers": (-1, ""),
        "samplesperbuffer": (1024, ""),
        "freq": (440.0, "sine frequency"),
    }

    def _make_pads(self):
        self.add_src_pad(Caps([Structure("audio/x-raw", {
            "format": ["S16LE", "U8", "F32LE"],
            "channels": IntRange(1, 16),
            "rate": IntRange(1, 384000),
        })]), "src")

    def start(self):
        self._count = 0

    def negotiate(self) -> Caps:
        allowed = self.src_pad.peer_allowed_caps()
        caps = self.src_pad.template.intersect(allowed)
        s = dict(caps.first().fields)
        if not isinstance(s.get("channels"), int):
            s["channels"] = 1
        if not isinstance(s.get("rate"), int):
            s["rate"] = 44100
        caps = Caps([Structure("audio/x-raw", s)]).fixate()
        self._caps = caps
        st = caps.first()
        self._format = str(st.get("format"))
        self._channels = int(st.get("channels"))
        self._rate = int(st.get("rate"))
        return caps

    def create(self) -> Optional[TensorBuffer]:
        n = int(self.num_buffers)
        if n >= 0 and self._count >= n:
            return None
        spb = int(self.samplesperbuffer)
        t0 = self._count * spb
        t = (np.arange(spb) + t0) / self._rate
        wave = np.sin(2 * np.pi * float(self.freq) * t)
        if self._format == "S16LE":
            data = (wave * 32767).astype(np.int16)
        elif self._format == "U8":
            data = ((wave * 127) + 128).astype(np.uint8)
        else:
            data = wave.astype(np.float32)
        samples = np.repeat(data[:, None], self._channels, axis=1)
        pts = t0 * SECOND // self._rate
        dur = spb * SECOND // self._rate
        buf = TensorBuffer(tensors=[samples], pts=pts, duration=dur)
        self._count += 1
        return buf


@register_element
class FileSrc(Source):
    """Reads a file and pushes its bytes downstream (GStreamer filesrc
    role).  The reference's ssat pipelines open nearly every golden input
    this way (e.g. tests/nnstreamer_filter_caffe2/runTest.sh:
    ``filesrc location=data/5 blocksize=-1 ! application/octet-stream ! …``).

    Caps are whatever downstream will accept (a caps string right after the
    element types the bytes, exactly like the reference pipelines);
    ``blocksize=-1`` pushes the whole file as ONE buffer, otherwise the
    file streams in ``blocksize``-byte chunks (GstBaseSrc default 4096).
    """

    FACTORY = "filesrc"
    PROPERTIES = {
        "location": (None, "path of the file to read"),
        "blocksize": (4096, "bytes per buffer; -1 = whole file at once"),
    }

    def _make_pads(self):
        self.add_src_pad(Caps.any(), "src")

    def start(self):
        if not self.location:
            raise ValueError(f"{self.name}: location required")
        path = str(self.location)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"{self.name}: no such file: {path}")
        self._f = open(path, "rb")

    def stop(self):
        f = getattr(self, "_f", None)
        if f is not None and not f.closed:
            f.close()

    def negotiate(self) -> Caps:
        return _negotiate_byte_caps(self)

    def create(self) -> Optional[TensorBuffer]:
        size = int(self.blocksize)
        chunk = self._f.read() if size < 0 else self._f.read(size)
        if not chunk:
            return None
        # no pts: file bytes carry no timeline (GStreamer filesrc leaves
        # timestamps unset too — stamping 0 would make QoS throttling and
        # tensor_rate collapse all chunks onto one instant)
        return TensorBuffer(tensors=[np.frombuffer(chunk, np.uint8)])


def _negotiate_byte_caps(el) -> Caps:
    """Byte-source negotiation shared by filesrc/multifilesrc: take
    downstream's constraint, defaulting to raw octets when downstream
    is unconstrained (e.g. fakesink)."""
    allowed = el.src_pad.peer_allowed_caps()
    if allowed.is_empty():
        raise ValueError(f"{el.name}: cannot negotiate with downstream")
    if allowed.is_any():
        return Caps([Structure("application/octet-stream", {})])
    return allowed.fixate()


def _indexed_path(location, index: int, name: str) -> str:
    """printf-style ``location % index`` (GStreamer multifile pattern,
    e.g. ``out_%1d.log`` / ``frames.%d``) with a named error for a
    pattern that doesn't consume the index."""
    try:
        return str(location) % index
    except (TypeError, ValueError) as exc:
        # %-formatting raises TypeError whenever the index is not
        # consumed, so this covers patterns with no directive too
        raise ValueError(f"{name}: location {location!r} must contain "
                         f"one %d-style index directive ({exc})") from exc


@register_element
class MultiFileSrc(Source):
    """Reads an INDEXED file sequence (GStreamer multifilesrc role —
    the ssat detection pipelines stream golden tensors this way:
    ``multifilesrc location=x.%d start-index=0 stop-index=9
    caps=application/octet-stream``).  Each file is pushed as one
    buffer; the sequence ends at stop-index, or at the first missing
    file when stop-index is -1."""

    FACTORY = "multifilesrc"
    PROPERTIES = {
        "location": (None, "printf pattern, e.g. frames.%d"),
        "start-index": (0, "first index"),
        "stop-index": (-1, "last index; -1 = until a file is missing"),
        "caps": (None, "caps of the byte stream (else negotiated like "
                       "filesrc)"),
        "loop": (False, "restart from start-index at the end"),
    }

    def _make_pads(self):
        self.add_src_pad(Caps.any(), "src")

    def start(self):
        if not self.location:
            raise ValueError(f"{self.name}: location required")
        self._idx = int(self.start_index)
        stop = int(self.stop_index)
        if stop >= 0 and self._idx > stop:
            raise ValueError(f"{self.name}: start-index {self._idx} > "
                             f"stop-index {stop}")
        # the pattern must be well-formed even if the first file is
        # checked lazily (stop-index=-1 ends at the first gap)
        _indexed_path(self.location, self._idx, self.name)

    def negotiate(self) -> Caps:
        if self.caps:
            c = self.caps
            caps = Caps.from_string(c) if isinstance(c, str) else c
            return caps.fixate()
        return _negotiate_byte_caps(self)

    def create(self) -> Optional[TensorBuffer]:
        stop = int(self.stop_index)
        while True:
            if stop >= 0 and self._idx > stop:
                if not bool(self.loop):
                    return None
                self._idx = int(self.start_index)
            path = _indexed_path(self.location, self._idx, self.name)
            if not os.path.isfile(path):
                if stop >= 0:
                    raise FileNotFoundError(
                        f"{self.name}: no such file: {path} (index "
                        f"{self._idx} <= stop-index {stop})")
                if bool(self.loop) and self._idx != int(self.start_index):
                    self._idx = int(self.start_index)
                    continue
                return None
            with open(path, "rb") as fh:
                chunk = fh.read()
            self._idx += 1
            return TensorBuffer(tensors=[np.frombuffer(chunk, np.uint8)])
