"""Media test source: the videotestsrc equivalent.

The reference relies on GStreamer's videotestsrc for every golden test and
benchmark pipeline (e.g. tests/nnstreamer_filter_tensorflow2_lite/runTest.sh).
This source plays the same role: deterministic synthetic frames at a
negotiated format/rate, honoring downstream caps constraints (capsfilter).
The port carries over the JAX package's ``videotestsrc`` only; its other
sources (audiotestsrc, filesrc, multifilesrc) are not ported yet.
"""

from __future__ import annotations

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
