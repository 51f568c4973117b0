"""font decoder: byte stream → rendered text video.

Parity with ext/nnstreamer/tensor_decoder/tensordec-font.c (ASCII sprite
text rendering into video frames).  The shared 5×7 raster font
(:mod:`.rasterfont`, also used for bounding-box label sprites) renders the
incoming bytes (interpreted as ASCII) into a GRAY8 video frame.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig
from . import Decoder, register_decoder
from .rasterfont import composite_label


@register_decoder
class FontDecoder(Decoder):
    MODE = "font"

    def __init__(self) -> None:
        self.out_w, self.out_h = 320, 24

    def set_option(self, index: int, value: str) -> None:
        if index == 1 and value:
            w, _, h = value.partition(":")
            self.out_w, self.out_h = int(w), int(h)

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps([Structure("video/x-raw", {
            "format": "GRAY8", "width": self.out_w, "height": self.out_h,
            "framerate": config.rate or Fraction(0, 1)})])

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        text = bytes(np.ascontiguousarray(buf.np(0)).reshape(-1)
                     .view(np.uint8)).decode("ascii", errors="replace")
        canvas = np.zeros((self.out_h, self.out_w, 1), np.uint8)
        composite_label(canvas, text, 2, 2, (255,))
        out = buf.with_tensors([canvas])
        out.extra["text"] = text
        return out
