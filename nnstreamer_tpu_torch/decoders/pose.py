"""pose_estimation decoder: heatmaps+offsets → keypoints + skeleton overlay.

Parity with ext/nnstreamer/tensor_decoder/tensordec-pose.c: per-keypoint
heatmap argmax, offset refinement, skeleton drawing into RGBA video.
Options: option1 = output size ``W:H``, option2 = model input size ``W:H``,
option3 = optional label (keypoint-name) file, option4 = score threshold.

The counterpart of ``nnstreamer_tpu/decoders/pose.py``: the pushdown is a
torch function; the offsets at each keypoint's argmax cell are read with
``gather`` on the flattened map, which lifts over a batch axis under
``torch.func.vmap``.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Tuple

import numpy as np
import torch

from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig
from . import Decoder, register_decoder, squeeze_leading

# COCO skeleton edges (17 keypoints)
_EDGES = [(0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8),
          (8, 10), (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14),
          (14, 16)]


@register_decoder
class PoseDecoder(Decoder):
    MODE = "pose_estimation"

    def __init__(self) -> None:
        self.out_w, self.out_h = 640, 480
        self.in_w, self.in_h = 257, 257
        self.threshold = 0.3

    def set_option(self, index: int, value: str) -> None:
        if index == 1 and value:
            w, _, h = value.partition(":")
            self.out_w, self.out_h = int(w), int(h)
        elif index == 2 and value:
            w, _, h = value.partition(":")
            self.in_w, self.in_h = int(w), int(h)
        elif index == 4 and value:
            self.threshold = float(value)

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps([Structure("video/x-raw", {
            "format": "RGBA", "width": self.out_w, "height": self.out_h,
            "framerate": config.rate or Fraction(0, 1)})])

    def device_reduce_spec(self, config: TensorsConfig):
        """Pushdown: the whole keypoint extraction — per-keypoint heatmap
        argmax + offset refinement — runs inside the filter executable;
        only the (K, 3) (x, y, score) table crosses device→host (~200 B
        instead of the full heatmap/offset stack)."""
        if config.info.num_tensors not in (1, 2):
            return None
        heat_i = config.info[0]
        if len(heat_i.np_shape) != 3:
            return None
        hh, ww, k = heat_i.np_shape
        has_off = config.info.num_tensors == 2
        if has_off and config.info[1].np_shape != (hh, ww, 2 * k):
            return None
        in_w, in_h = self.in_w, self.in_h
        from ..tensor.info import TensorInfo, TensorsInfo
        from ..tensor.types import TensorType

        def fn(outs):
            flat = outs[0].reshape(hh * ww, k).float()
            idx = torch.argmax(flat, dim=0)
            score = torch.amax(flat, dim=0)
            gy, gx = idx // ww, idx % ww
            y = gy / max(hh - 1, 1)
            x = gx / max(ww - 1, 1)
            if has_off:
                # off[gy, gx, ks] and off[gy, gx, ks + k]: the argmax
                # cell's row of the flattened map, per keypoint
                off = outs[1].reshape(hh * ww, 2 * k).float()
                y = y + torch.gather(off[:, :k], 0, idx[None])[0] / in_h
                x = x + torch.gather(off[:, k:], 0, idx[None])[0] / in_w
            return [torch.stack([x, y, score], dim=1).float()]

        reduced = TensorsInfo([TensorInfo(TensorType.FLOAT32, (3, k))])
        return fn, reduced

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        first = np.asarray(buf.np(0))
        if (buf.num_tensors == 1 and first.ndim == 2
                and first.shape[1] == 3):
            # device-reduced pushdown form: (K, 3) rows of (x, y, score)
            kps = [(float(x), float(y), float(s)) for x, y, s in first]
        else:
            kps = self._host_keypoints(buf)
        k = len(kps)
        canvas = np.zeros((self.out_h, self.out_w, 4), dtype=np.uint8)
        for x, y, s in kps:
            if s >= self.threshold:
                self._dot(canvas, x, y)
        for a, b in _EDGES:
            if a < k and b < k and kps[a][2] >= self.threshold \
                    and kps[b][2] >= self.threshold:
                self._line(canvas, kps[a][:2], kps[b][:2])
        out = buf.with_tensors([canvas])
        out.extra["keypoints"] = kps
        return out

    def _host_keypoints(self, buf: TensorBuffer
                        ) -> List[Tuple[float, float, float]]:
        heat = squeeze_leading(buf.np(0), 3)             # (H', W', K)
        offsets = squeeze_leading(
            buf.np(1) if buf.num_tensors > 1 else None, 3)  # (H',W',2K)
        hh, ww, k = heat.shape
        kps: List[Tuple[float, float, float]] = []  # (x, y, score) norm.
        for i in range(k):
            flat = int(heat[:, :, i].argmax())
            gy, gx = divmod(flat, ww)
            score = float(heat[gy, gx, i])
            y = gy / max(hh - 1, 1)
            x = gx / max(ww - 1, 1)
            if offsets is not None:
                # short-range offsets in input-pixel units (posenet)
                y += float(offsets[gy, gx, i]) / self.in_h
                x += float(offsets[gy, gx, i + k]) / self.in_w
            kps.append((x, y, score))
        return kps

    def _dot(self, canvas: np.ndarray, x: float, y: float) -> None:
        h, w = canvas.shape[:2]
        cy, cx = int(np.clip(y * h, 2, h - 3)), int(np.clip(x * w, 2, w - 3))
        canvas[cy - 2:cy + 3, cx - 2:cx + 3] = (255, 0, 0, 255)

    def _line(self, canvas: np.ndarray, p0, p1) -> None:
        h, w = canvas.shape[:2]
        n = max(abs(int((p1[0] - p0[0]) * w)), abs(int((p1[1] - p0[1]) * h)), 1)
        xs = np.clip((np.linspace(p0[0], p1[0], n) * w).astype(int), 0, w - 1)
        ys = np.clip((np.linspace(p0[1], p1[1], n) * h).astype(int), 0, h - 1)
        canvas[ys, xs] = (0, 255, 0, 255)
