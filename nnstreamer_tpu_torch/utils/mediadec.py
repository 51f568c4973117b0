"""Dependency-free media decoders: PNG, PNM (PGM/PPM), WAV.

The reference's golden pipelines lean on GStreamer's media plugins
(``pngdec``, ``pnmdec``, ``wavparse``) in front of ``tensor_converter``
(e.g. tests/nnstreamer_filter_tensorflow2_lite/runTest.sh pipes
``filesrc ! pngdec ! videoconvert …``).  The port ships the same
roles as in-tree pure functions — stdlib ``zlib`` for the PNG inflate, no
PIL/libpng — wrapped by the ``pngdec``/``pnmdec``/``wavparse`` elements
(elements/mediadec.py).

Scope (sufficient for the reference's fixtures and typical goldens):
8-bit PNGs, color types gray/RGB/palette/gray+alpha/RGBA, no interlace;
binary PGM/PPM with maxval ≤ 255; PCM and IEEE-float WAV.  The port's
copy of ``nnstreamer_tpu/utils/mediadec.py``, plus :func:`png_length` and
:func:`pnm_length`, which find where an image ends in a byte stream that
carries several (the ``pngdec``/``pnmdec`` elements decode each image as
it completes).
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Reverse PNG scanline filtering → flat uint8 image rows."""
    out = np.empty((h, stride), np.uint8)
    pos = 0
    prev = np.zeros(stride, np.uint16)
    for y in range(h):
        ftype = raw[pos]
        line = raw[pos + 1:pos + 1 + stride].astype(np.uint16)
        pos += 1 + stride
        if ftype == 0:              # None
            cur = line
        elif ftype == 2:            # Up
            cur = (line + prev) & 0xFF
        elif ftype == 1:            # Sub: per-channel prefix sum mod 256
            acc = np.add.accumulate(
                raw[pos - stride:pos].reshape(-1, bpp),
                axis=0, dtype=np.uint8)
            cur = acc.reshape(-1).astype(np.uint16)
        elif ftype in (3, 4):       # Average / Paeth: sequential in x
            cur = np.zeros(stride, np.uint16)
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(prev[x])
                if ftype == 3:
                    val = int(line[x]) + ((a + b) >> 1)
                else:
                    c = int(prev[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if (pa <= pb and pa <= pc) else \
                        (b if pb <= pc else c)
                    val = int(line[x]) + pred
                cur[x] = val & 0xFF
        else:
            raise ValueError(f"png: unknown filter type {ftype}")
        out[y] = cur.astype(np.uint8)
        prev = cur
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes → (H, W, C) uint8 (C=1 gray, 3 RGB; alpha dropped)."""
    if not data.startswith(_PNG_SIG):
        raise ValueError("png: bad signature")
    pos = len(_PNG_SIG)
    ihdr = None
    palette = None
    idat = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length  # length + type + body + crc
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError("png: missing IHDR/IDAT")
    w, h, depth, color, comp, filt, interlace = ihdr
    if depth != 8:
        raise ValueError(f"png: bit depth {depth} unsupported (8 only)")
    if interlace:
        raise ValueError("png: Adam7 interlace unsupported")
    if comp or filt:
        raise ValueError("png: nonstandard compression/filter method")
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}.get(color)
    if channels is None:
        raise ValueError(f"png: color type {color} unsupported")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * channels
    img = _unfilter(raw, h, stride, channels).reshape(h, w, channels)
    if color == 3:
        if palette is None:
            raise ValueError("png: palette image without PLTE")
        img = palette[img[..., 0]]
    elif color == 4:    # gray+alpha → gray
        img = img[..., :1]
    elif color == 6:    # RGBA → RGB (GStreamer pipelines videoconvert this)
        img = img[..., :3]
    return np.ascontiguousarray(img)


def png_length(data: bytes) -> Optional[int]:
    """Bytes of the first complete PNG at the head of ``data`` (through
    its IEND chunk), or None while it is incomplete: where an image ends
    in a byte stream that carries several."""
    if len(data) < len(_PNG_SIG):
        return None
    if not data.startswith(_PNG_SIG):
        raise ValueError("png: bad signature")
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack_from(">I4s", data, pos)
        pos += 12 + length
        if ctype == b"IEND":
            return pos if pos <= len(data) else None
    return None


def _pnm_header(data: bytes):
    """``(fields, pos)`` of a P5/P6 header: width, height and maxval, and
    the offset of the first sample; None while the header is incomplete."""
    fields = []
    pos = 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if pos >= len(data):
            return None
        fields.append(int(data[start:pos]))
    return fields, pos + 1


def pnm_length(data: bytes) -> Optional[int]:
    """Bytes of the first complete binary PGM/PPM at the head of
    ``data``, or None while it is incomplete."""
    if len(data) < 2:
        return None
    if not data[:2] in (b"P5", b"P6"):
        raise ValueError("pnm: only binary P5/P6 supported")
    head = _pnm_header(data)
    if head is None:
        return None
    (w, h, _maxval), pos = head
    end = pos + w * h * (3 if data[:2] == b"P6" else 1)
    return end if end <= len(data) else None


def decode_pnm(data: bytes) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6) → (H, W, C) uint8."""
    if not data[:2] in (b"P5", b"P6"):
        raise ValueError("pnm: only binary P5/P6 supported")
    fields = []
    pos = 2
    while len(fields) < 3:
        # skip whitespace and comments
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        fields.append(int(data[start:pos]))
    pos += 1  # single whitespace after maxval
    w, h, maxval = fields
    if maxval > 255:
        raise ValueError("pnm: 16-bit samples unsupported")
    ch = 3 if data[:2] == b"P6" else 1
    img = np.frombuffer(data, np.uint8, count=w * h * ch, offset=pos)
    return img.reshape(h, w, ch).copy()


def parse_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """WAV bytes → ((frames, channels) samples, rate).  PCM 8/16/32-bit
    and IEEE float32."""
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
    if channels > 1:
        arr = arr.reshape(-1, channels)
    else:
        arr = arr.reshape(-1, 1)
    return arr.copy(), rate
