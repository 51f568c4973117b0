"""Media decode elements: pngdec, pnmdec, wavparse.

The reference's golden pipelines put GStreamer media plugins in front of
``tensor_converter`` (``filesrc ! pngdec ! videoconvert …``,
``filesrc ! wavparse …`` — e.g. tests/nnstreamer_filter_tensorflow2_lite/
runTest.sh, tests/nnstreamer_converter/).  These elements fill the same
slots with the in-tree decoders (utils/mediadec.py — stdlib zlib, no
PIL/libpng/libsndfile):

- ``pngdec`` / ``pnmdec``: accumulate the upstream byte stream (an image
  arrives as one or more filesrc chunks), decode each image as its last
  byte arrives (a ``multifilesrc`` stream carries one a file), announce
  ``video/x-raw`` caps (RGB or GRAY8 — alpha dropped, the role
  ``videoconvert`` plays in the reference pipelines) before the first
  and whenever the format or size changes, push one frame an image.
- ``wavparse``: accumulate until EOS, parse the RIFF container, announce
  ``audio/x-raw`` caps (S16LE/U8/F32LE/S32LE at the file's rate/channels),
  push the sample payload as one buffer (downstream tensor_converter
  re-chunks via frames-per-tensor).

The counterpart of ``nnstreamer_tpu/elements/mediadec.py`` (host code, as
there).  The JAX elements decode once, at EOS, so a stream of several
images gives one frame there (the first): a fault against the reference's
decoders, which decode each image; the port's image decoders decode each,
and give the JAX package's frame for a stream of one image.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np

from ..pipeline.caps import Caps, Structure
from ..pipeline.element import CapsEvent, Element, EOSEvent, FlowReturn
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..utils.mediadec import (decode_png, decode_pnm, parse_wav,
                               png_length, pnm_length)


class _AccumulatingDecoder(Element):
    """Shared base: buffer bytes until EOS, then decode-and-push."""

    def __init__(self, name=None, **props):
        super().__init__(name, **props)
        self._chunks: list = []

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")
        self.add_src_pad(Caps.any(), "src")

    def start(self):
        self._chunks = []

    def set_caps(self, pad, caps):
        pass  # output caps depend on the decoded header; announced at EOS

    def chain(self, pad, buf):
        for i in range(buf.num_tensors):
            self._chunks.append(
                np.ascontiguousarray(buf.np(i)).tobytes())
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            data = b"".join(self._chunks)
            self._chunks = []
            if data:
                self._decode_and_push(data)
            self.src_pad.push_event(EOSEvent())
            return True
        return super().on_event(pad, event)

    def _decode_and_push(self, data: bytes) -> None:
        raise NotImplementedError


class _ImageDecoder(_AccumulatingDecoder):
    """Shared base of the image decoders: each image of the byte stream
    decodes and pushes as its last byte arrives; bytes left at EOS decode
    as the last image."""

    #: (bytes of the first complete image of a stream, or None; decode)
    _length = None
    _decode = None

    def start(self):
        super().start()
        self._pending = b""
        self._shape = None

    def chain(self, pad, buf):
        for i in range(buf.num_tensors):
            self._pending += np.ascontiguousarray(buf.np(i)).tobytes()
        while self._pending:
            n = type(self)._length(self._pending)
            if n is None:
                break
            data, self._pending = self._pending[:n], self._pending[n:]
            ret = self._push_image(type(self)._decode(data),
                                   0 if buf.pts is None else buf.pts)
            if ret is FlowReturn.ERROR:
                return ret
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            data, self._pending = self._pending, b""
            if data:
                self._push_image(type(self)._decode(data), 0)
            self.src_pad.push_event(EOSEvent())
            return True
        return super().on_event(pad, event)

    def _push_image(self, img: np.ndarray, pts: int) -> FlowReturn:
        h, w, ch = img.shape
        fmt = "GRAY8" if ch == 1 else "RGB"
        if self._shape != (fmt, w, h):
            self._shape = (fmt, w, h)
            self.src_pad.push_event(CapsEvent(Caps([Structure(
                "video/x-raw", {"format": fmt, "width": w, "height": h,
                                "framerate": Fraction(0, 1)})])))
        return self.push(TensorBuffer(tensors=[img], pts=pts))


@register_element
class PngDec(_ImageDecoder):
    """``pngdec``: PNG byte stream → a video/x-raw frame an image."""

    FACTORY = "pngdec"
    PROPERTIES = {}
    _length = png_length
    _decode = decode_png


@register_element
class PnmDec(_ImageDecoder):
    """``pnmdec``: binary PGM/PPM byte stream → a video/x-raw frame an
    image."""

    FACTORY = "pnmdec"
    PROPERTIES = {}
    _length = pnm_length
    _decode = decode_pnm


_WAV_FORMATS = {np.dtype(np.int16): "S16LE", np.dtype(np.uint8): "U8",
                np.dtype(np.float32): "F32LE", np.dtype(np.int32): "S32LE"}


@register_element
class WavParse(_AccumulatingDecoder):
    """``wavparse``: RIFF/WAVE byte stream → audio/x-raw samples."""

    FACTORY = "wavparse"
    PROPERTIES = {}

    def _decode_and_push(self, data: bytes) -> None:
        samples, rate = parse_wav(data)
        self.src_pad.push_event(CapsEvent(Caps([Structure("audio/x-raw", {
            "format": _WAV_FORMATS[samples.dtype],
            "channels": samples.shape[1], "rate": rate})])))
        self.push(TensorBuffer(tensors=[samples], pts=0))
