"""bounding_boxes decoder: detection tensors → RGBA overlay video.

Parity with ext/nnstreamer/tensor_decoder/tensordec-boundingbox.c (schemes
at :148-191): decodes raw detector outputs into boxes (box-prior decode for
mobilenet-ssd, grid decode for yolov5), thresholds, NMS, and draws
rectangles into a transparent RGBA canvas sized by option4.

Options (mirroring the reference's option1..5):
  1: scheme — ``mobilenet-ssd`` (alias ``tflite-ssd``) |
     ``mobilenet-ssd-postprocess`` (alias ``tf-ssd``) |
     ``ov-person-detection`` | ``ov-face-detection`` | ``yolov5`` |
     ``mp-palm-detection`` | ``raw`` (pre-decoded
     [class,score,ymin,xmin,ymax,xmax] rows — net-new convenience)
  2: label file path
  3: per-scheme parameters — mobilenet-ssd: box-priors file (4 lines ×
     N anchors, the reference's box_priors.txt);
     mobilenet-ssd-postprocess: ``loc:cls:score:num,threshold%`` tensor
     mapping (defaults 3:1:2:0, reference :387-391);
     mp-palm-detection: ``num_layers:min_scale:max_scale:offset_x:
     offset_y:stride0:...`` anchor-generation params (defaults
     4:1.0:1.0:0.5:0.5:8:16:16:16, reference :407-416)
  4: output video size ``W:H``
  5: model input size ``W:H``
  6: score threshold (net-new; reference hardcodes per scheme)

Boxes draw as 2px outlines; when a label file is supplied, label-text
sprites composite above each box (reference draw() "2. Write Labels",
via the shared rasterfont module).  Structured detections also ride in
``extra["objects"]`` (class/score/box) for programmatic consumers.

The counterpart of ``nnstreamer_tpu/decoders/boundingbox.py``: the
device pushdowns (``device_reduce_spec``) are torch functions over
:func:`~nnstreamer_tpu_torch.ops.nms.device_nms`, captured in the
upstream filter's graphs; the box priors and palm anchors become f32
tensors on the filter's device once.  Host decode, drawing and
materialization are the JAX module's numpy code.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import List, Optional

import numpy as np
import torch

from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import BatchView, TensorBuffer, to_host
from ..tensor.info import TensorsConfig
from . import Decoder, register_decoder, squeeze_leading
from .imagelabel import load_labels

DEFAULT_THRESHOLD = 0.5
#: pre-NMS candidate cap (reference MOBILENET_SSD_PP_DETECTION_MAX,
#: tensordec-boundingbox.c:124)
DETECTION_MAX = 100

def _cap_candidates(sel: np.ndarray, sc: np.ndarray) -> np.ndarray:
    """Cap threshold-selected candidates to the top DETECTION_MAX by score
    before the O(N²) NMS, like the reference's
    MOBILENET_SSD_PP_DETECTION_MAX (tensordec-boundingbox.c:124)."""
    if int(sel.sum()) <= DETECTION_MAX:
        return sel
    kth = np.argpartition(np.where(sel, sc, -np.inf),
                          -DETECTION_MAX)[-DETECTION_MAX:]
    mask = np.zeros_like(sel)
    mask[kth] = True
    return mask


def _device_topcls(scores: torch.Tensor):
    """Per-anchor best-class reduction (skipping background 0) on the
    tensor's own device; only the two (N,) results cross to the host."""
    cls, sc = ssd_topcls(torch, scores)
    return to_host(cls), to_host(sc)


def _device_table(table: np.ndarray):
    """``table`` as an f32 tensor on the device that asks for it, made
    once per device.  The first ask comes from the eager run that
    precedes a graph capture, so no host copy is ever captured."""
    cache = {}

    def on(device: torch.device) -> torch.Tensor:
        t = cache.get(device)
        if t is None:
            t = cache[device] = torch.as_tensor(
                np.asarray(table, np.float32), device=device)
        return t

    return on
NMS_IOU = 0.5
_PALETTE = np.array([
    [255, 0, 0, 255], [0, 255, 0, 255], [0, 0, 255, 255],
    [255, 255, 0, 255], [0, 255, 255, 255], [255, 0, 255, 255],
], dtype=np.uint8)


@dataclasses.dataclass
class DetectedObject:
    class_id: int
    score: float
    # normalized [0,1] corners
    ymin: float
    xmin: float
    ymax: float
    xmax: float
    label: Optional[str] = None


def ssd_topcls(xp, scores):
    """Background-skipping per-anchor top class: (N, C) -> (cls, score).
    ``xp`` is numpy (host decode) or torch (device decode) — ONE copy of
    the background-offset convention for both paths; ties go to the
    first maximal class in both."""
    if xp is torch:
        return (torch.argmax(scores[:, 1:], dim=1) + 1,
                torch.amax(scores[:, 1:], dim=1))
    cls = xp.argmax(scores[:, 1:], axis=1) + 1
    return cls, xp.max(scores[:, 1:], axis=1)


def ssd_prior_decode(xp, boxes, priors):
    """SSD box regression -> corner coordinates (reference variances
    10/5, _get_objects_mobilenet_ssd): one copy for host and device."""
    cy = boxes[:, 0] / 10.0 * priors[2] + priors[0]
    cx = boxes[:, 1] / 10.0 * priors[3] + priors[1]
    h = xp.exp(boxes[:, 2] / 5.0) * priors[2]
    w = xp.exp(boxes[:, 3] / 5.0) * priors[3]
    return cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2


def nms(objs: List[DetectedObject], iou_thresh: float = NMS_IOU
        ) -> List[DetectedObject]:
    """Greedy per-class NMS (reference boundingbox NMS)."""
    objs = sorted(objs, key=lambda o: -o.score)
    keep: List[DetectedObject] = []
    for o in objs:
        ok = True
        for k in keep:
            if k.class_id != o.class_id:
                continue
            iy = max(0.0, min(o.ymax, k.ymax) - max(o.ymin, k.ymin))
            ix = max(0.0, min(o.xmax, k.xmax) - max(o.xmin, k.xmin))
            inter = iy * ix
            union = ((o.ymax - o.ymin) * (o.xmax - o.xmin)
                     + (k.ymax - k.ymin) * (k.xmax - k.xmin) - inter)
            if union > 0 and inter / union > iou_thresh:
                ok = False
                break
        if ok:
            keep.append(o)
    return keep


@register_decoder
class BoundingBoxDecoder(Decoder):
    MODE = "bounding_boxes"

    #: reference scheme aliases (bb_modes table, tensordec-boundingbox.c)
    ALIASES = {"tflite-ssd": "mobilenet-ssd",
               "tf-ssd": "mobilenet-ssd-postprocess",
               "ov-face-detection": "ov-person-detection"}

    def __init__(self) -> None:
        self.scheme = "mobilenet-ssd"
        self.labels: Optional[List[str]] = None
        self.priors: Optional[np.ndarray] = None  # (4, N)
        self.out_w, self.out_h = 640, 480
        self.in_w, self.in_h = 300, 300
        self.threshold: Optional[float] = None
        # mobilenet-ssd-postprocess tensor mapping (reference defaults
        # :387-391: locations=3 classes=1 scores=2 num=0)
        self.pp_mapping = (3, 1, 2, 0)
        self.pp_threshold = 0.0
        # mp-palm-detection anchor generation params (reference :407-416)
        self.palm_layers = 4
        self.palm_scales = (1.0, 1.0)
        self.palm_offsets = (0.5, 0.5)
        self.palm_strides = (8, 16, 16, 16)
        self._palm_anchors: Optional[np.ndarray] = None

    def set_option(self, index: int, value: str) -> None:
        if index == 1:
            self.scheme = self.ALIASES.get(value, value)
        elif index == 2 and value:
            self.labels = load_labels(value)
        elif index == 3 and value:
            self._set_scheme_params(value)
        elif index == 4 and value:
            w, _, h = value.partition(":")
            self.out_w, self.out_h = int(w), int(h)
        elif index == 5 and value:
            w, _, h = value.partition(":")
            self.in_w, self.in_h = int(w), int(h)
        elif index == 6 and value:
            self.threshold = float(value)

    def _set_scheme_params(self, value: str) -> None:
        """option3 is scheme-specific (reference _setOption_mode)."""
        if self.scheme == "mobilenet-ssd-postprocess":
            mapping, _, thr = value.partition(",")
            idxs = [int(x) for x in mapping.split(":") if x != ""][:4]
            if idxs:
                pp = list(self.pp_mapping)
                pp[:len(idxs)] = idxs
                self.pp_mapping = tuple(pp)
            if thr:
                self.pp_threshold = float(thr) / 100.0
        elif self.scheme == "mp-palm-detection":
            vals = [float(x) for x in value.split(":") if x != ""]
            if len(vals) >= 1:
                self.palm_layers = int(vals[0])
            if len(vals) >= 3:
                self.palm_scales = (vals[1], vals[2])
            if len(vals) >= 5:
                self.palm_offsets = (vals[3], vals[4])
            if len(vals) >= 6:
                self.palm_strides = tuple(int(v) for v in vals[5:])
            self._palm_anchors = None
        else:
            with open(value, encoding="utf-8") as f:
                rows = [np.array([float(x) for x in line.split()])
                        for line in f if line.strip()]
            self.priors = np.stack(rows[:4], axis=0)

    def _threshold(self, default: float) -> float:
        """option6 override, else the reference's per-scheme default."""
        return self.threshold if self.threshold is not None else default

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        return Caps([Structure("video/x-raw", {
            "format": "RGBA", "width": self.out_w, "height": self.out_h,
            "framerate": config.rate or Fraction(0, 1)})])

    # -- per-scheme decode ---------------------------------------------------
    def _nms_reduced_info(self, k):
        from ..tensor.info import TensorInfo, TensorsInfo
        from ..tensor.types import TensorType

        return TensorsInfo([
            TensorInfo(TensorType.FLOAT32, (4, k)),
            TensorInfo(TensorType.INT32, (k,)),
            TensorInfo(TensorType.FLOAT32, (k,)),
            TensorInfo(TensorType.INT32, (1,))])

    def device_reduce_spec(self, config):
        """Pushdown for the single-pass detection schemes.

        mobilenet-ssd without priors: reduce the (N, C) score matrix to
        per-anchor (class, score) on device — SSD-300 fetches
        ~15 KB/frame instead of ~700 KB.  mobilenet-ssd WITH priors
        (option3), yolov5, and mp-palm-detection: the ENTIRE detection
        tail runs on device — box decode, threshold, top-K cap, greedy
        per-class NMS (ops/nms.py) — and only the ≤DETECTION_MAX
        surviving boxes cross device→host (~2.4 KB/frame), in the
        ssd-postprocess output contract (boxes/classes/scores/num)."""
        if self.scheme == "yolov5":
            return self._yolo_reduce_spec(config)
        if self.scheme == "mp-palm-detection":
            return self._palm_reduce_spec(config)
        if self.scheme != "mobilenet-ssd" or config.info.num_tensors != 2:
            return None
        boxes_i, scores_i = config.info[0], config.info[1]
        if len(scores_i.np_shape) != 2:
            return None
        n = scores_i.np_shape[0]
        from ..tensor.info import TensorInfo, TensorsInfo
        from ..tensor.types import TensorType

        if self.priors is not None and self.priors.shape[1] >= n:
            from ..ops.nms import device_nms

            priors_on = _device_table(self.priors[:, :n])
            thr = float(self._threshold(DEFAULT_THRESHOLD))
            k = min(DETECTION_MAX, n)

            def fn(outs):
                boxes, scores = outs
                priors = priors_on(boxes.device)
                boxes = boxes.reshape(-1, 4)[:n].float()
                scores = scores.reshape(n, -1)
                cls, sc = ssd_topcls(torch, scores)
                corners = torch.stack(
                    ssd_prior_decode(torch, boxes, priors), dim=1)
                return list(device_nms(corners, sc.float(),
                                       cls.to(torch.int32), k=k,
                                       iou_thresh=NMS_IOU,
                                       score_thresh=thr))

            return fn, self._nms_reduced_info(k)

        def fn(outs):
            boxes, scores = outs
            cls, sc = ssd_topcls(torch, scores)
            return [boxes, cls.to(torch.int32), sc.float()]

        reduced = TensorsInfo([boxes_i.copy(),
                               TensorInfo(TensorType.INT32, (n,)),
                               TensorInfo(TensorType.FLOAT32, (n,))])
        return fn, reduced

    def _yolo_reduce_spec(self, config):
        """yolov5 full device decode: obj·cls scores, box form
        conversion, threshold, top-K, NMS — same output contract as the
        ssd pushdown."""
        if config.info.num_tensors != 1:
            return None
        pred_i = config.info[0]
        if len(pred_i.np_shape) < 2:
            return None
        n, width = pred_i.np_shape[-2], pred_i.np_shape[-1]
        if width <= 5:
            return None
        from ..ops.nms import device_nms

        thr = float(self._threshold(DEFAULT_THRESHOLD))
        k = min(DETECTION_MAX, n)
        in_w, in_h = float(self.in_w), float(self.in_h)

        def fn(outs):
            pred = outs[0].reshape(-1, width)[:n].float()
            cls_scores = pred[:, 5:] * pred[:, 4:5]
            cls = torch.argmax(cls_scores, dim=1).to(torch.int32)
            sc = torch.amax(cls_scores, dim=1)
            cx, cy = pred[:, 0] / in_w, pred[:, 1] / in_h
            w, h = pred[:, 2] / in_w, pred[:, 3] / in_h
            corners = torch.stack([cy - h / 2, cx - w / 2,
                                   cy + h / 2, cx + w / 2], dim=1)
            return list(device_nms(corners, sc, cls, k=k,
                                   iou_thresh=NMS_IOU, score_thresh=thr))

        return fn, self._nms_reduced_info(k)

    def _palm_reduce_spec(self, config):
        """mp-palm-detection full device decode: sigmoid scores, anchor
        decode, threshold, top-K, NMS.  Unlike the host path this caps
        survivors at DETECTION_MAX (the ssd reference's cap) — a frame
        with >100 above-threshold palms is not a real workload."""
        if config.info.num_tensors != 2:
            return None
        boxes_i, scores_i = config.info[0], config.info[1]
        if len(boxes_i.np_shape) != 2:
            return None
        n, width = boxes_i.np_shape
        anchors_np = self._palm_anchor_table()
        n = min(n, len(anchors_np))
        from ..ops.nms import device_nms

        anchors_on = _device_table(anchors_np[:n])  # (n,4) ycxhw
        thr = float(self._threshold(self.PALM_THRESHOLD))
        k = min(DETECTION_MAX, n)
        in_w, in_h = float(self.in_w), float(self.in_h)

        def fn(outs):
            anchors = anchors_on(outs[0].device)
            boxes = outs[0].reshape(-1, width)[:n].float()
            logits = outs[1].reshape(-1)[:n].float()
            # same clipped sigmoid as the host path (overflow-safe)
            sc = 1.0 / (1.0 + torch.exp(-torch.clamp(logits, -100.0,
                                                     100.0)))
            yc = boxes[:, 0] / in_h * anchors[:, 2] + anchors[:, 0]
            xc = boxes[:, 1] / in_w * anchors[:, 3] + anchors[:, 1]
            h = boxes[:, 2] / in_h * anchors[:, 2]
            w = boxes[:, 3] / in_w * anchors[:, 3]
            corners = torch.stack([yc - h / 2, xc - w / 2,
                                   yc + h / 2, xc + w / 2], dim=1)
            cls = torch.zeros_like(logits, dtype=torch.int32)
            return list(device_nms(corners, sc, cls, k=k,
                                   iou_thresh=NMS_IOU, score_thresh=thr))

        return fn, self._nms_reduced_info(k)

    @staticmethod
    def _materialize_device_nms(buf: TensorBuffer) -> List[DetectedObject]:
        """Fully device-decoded pushdown form (boxes/classes/scores/num,
        NMS already applied on device) — just materialize objects."""
        b = np.asarray(buf.np(0)).reshape(-1, 4)
        cls = np.asarray(buf.np(1)).reshape(-1)
        sc = np.asarray(buf.np(2)).reshape(-1)
        num = int(np.asarray(buf.np(3)).reshape(-1)[0])
        return [DetectedObject(int(c), float(s), float(y0), float(x0),
                               float(y1), float(x1))
                for c, s, (y0, x0, y1, x1) in zip(cls, sc, b)
                if c >= 0][:num]

    def _decode_mobilenet_ssd(self, buf: TensorBuffer) -> List[DetectedObject]:
        if buf.num_tensors == 4:
            return self._materialize_device_nms(buf)
        boxes = squeeze_leading(buf.np(0), 2)    # (N, 4)
        if buf.num_tensors == 3:
            # device-reduced pushdown form: (boxes, class, score)
            cls = np.asarray(buf.np(1)).reshape(-1)
            sc = np.asarray(buf.np(2)).reshape(-1)
        elif isinstance(buf.tensors[1], (torch.Tensor, BatchView)):
            # device buffer without pushdown: reduce where it lies
            t = buf.tensors[1]
            if isinstance(t, BatchView):
                t = t.device_slice()
            cls, sc = _device_topcls(squeeze_leading(t, 2))
        else:
            scores = squeeze_leading(buf.np(1), 2)   # (N, C)
            cls, sc = ssd_topcls(np, scores)
        if self.priors is not None:
            ymin, xmin, ymax, xmax = ssd_prior_decode(np, boxes,
                                                      self.priors)
        else:
            ymin, xmin, ymax, xmax = boxes.T
        sel = _cap_candidates(sc >= self._threshold(DEFAULT_THRESHOLD), sc)
        return [DetectedObject(int(c), float(s), float(y0), float(x0),
                               float(y1), float(x1))
                for c, s, y0, x0, y1, x1 in zip(
                    cls[sel], sc[sel], ymin[sel], xmin[sel],
                    ymax[sel], xmax[sel])]

    def _decode_ssd_postprocess(self, buf: TensorBuffer
                                ) -> List[DetectedObject]:
        """mobilenet-ssd-postprocess: the model already decoded + NMSed;
        tensors are (locations [N,4] ymin,xmin,ymax,xmax, classes [N],
        scores [N], num [1]) indexed by the option3 mapping (reference
        _get_objects_mobilenet_ssd_pp, tensordec-boundingbox.c:1309)."""
        loc_i, cls_i, sc_i, num_i = self.pp_mapping
        if buf.num_tensors <= max(self.pp_mapping):
            # reference validates MOBILENET_SSD_PP_MAX_TENSORS=4 up front
            raise ValueError(
                f"mobilenet-ssd-postprocess: tensor mapping "
                f"{self.pp_mapping} needs {max(self.pp_mapping) + 1} "
                f"tensors, buffer has {buf.num_tensors} (set option3)")
        num = int(np.asarray(buf.np(num_i)).reshape(-1)[0])
        boxes = buf.np(loc_i).reshape(-1, buf.np(loc_i).shape[-1])
        classes = np.asarray(buf.np(cls_i)).reshape(-1)
        scores = np.asarray(buf.np(sc_i)).reshape(-1)
        n = min(num, len(scores))
        thr = self._threshold(self.pp_threshold)
        out = []
        for d in range(n):
            if scores[d] < thr:
                continue
            y0, x0, y1, x1 = (float(np.clip(boxes[d, k], 0.0, 1.0))
                              for k in range(4))
            out.append(DetectedObject(int(classes[d]), float(scores[d]),
                                      y0, x0, y1, x1))
        return out

    # reference OV_PERSON_DETECTION_CONF_THRESHOLD (:129)
    OV_THRESHOLD = 0.8
    OV_MAX = 200  # reference OV_PERSON_DETECTION_MAX (:126)

    def _decode_ov_person(self, buf: TensorBuffer) -> List[DetectedObject]:
        """ov-person/face-detection: one tensor of 7-float rows
        (image_id, label, conf, xmin, ymin, xmax, ymax), terminated by
        image_id < 0 (reference _get_persons_ov)."""
        rows = np.asarray(buf.np(0)).reshape(-1, 7)[:self.OV_MAX]
        thr = self._threshold(self.OV_THRESHOLD)
        out = []
        for row in rows:
            if row[0] < 0:
                break
            if row[2] < thr:
                continue
            x0, y0, x1, y1 = (float(v) for v in row[3:7])
            # reference reports prob=1 and class_id=-1 (no label lookup)
            out.append(DetectedObject(-1, 1.0, y0, x0, y1, x1))
        return out

    # mp-palm-detection fixed model geometry (reference :134-136)
    PALM_INPUT = 192
    PALM_THRESHOLD = 0.5

    def _palm_anchor_table(self) -> np.ndarray:
        """SSD anchor generation for the 192×192 palm model (reference
        _mp_palm_detection_generate_anchors): per layer-group two unit
        aspect ratios with interpolated scales, centers on the feature
        grid.  Returns (N, 4) rows (y_center, x_center, h, w)."""
        if self._palm_anchors is not None:
            return self._palm_anchors
        num = self.palm_layers
        mn, mx = self.palm_scales
        off_x, off_y = self.palm_offsets
        strides = list(self.palm_strides)[:num]

        def scale(i):
            if num == 1:
                return (mn + mx) * 0.5
            return mn + (mx - mn) * i / (num - 1.0)

        anchors = []
        layer_id = 0
        while layer_id < num:
            hw = []
            last = layer_id
            while last < num and strides[last] == strides[layer_id]:
                hw.append((scale(last), scale(last)))
                hw.append((scale(last + 1), scale(last + 1)))
                last += 1
            fm = int(np.ceil(self.PALM_INPUT / strides[layer_id]))
            for y in range(fm):
                for x in range(fm):
                    for h, w in hw:
                        anchors.append(((y + off_y) / fm, (x + off_x) / fm,
                                        h, w))
            layer_id = last
        self._palm_anchors = np.array(anchors, dtype=np.float32)
        return self._palm_anchors

    def _decode_mp_palm(self, buf: TensorBuffer) -> List[DetectedObject]:
        """mp-palm-detection: tensors (boxes [N,18], scores [N]); box rows
        are (y, x, h, w, 7×2 keypoints) in input pixels relative to the
        anchor (reference _get_objects_mp_palm_detection)."""
        boxes = np.asarray(buf.np(0)).reshape(-1, buf.np(0).shape[-1])
        scores = np.asarray(buf.np(1)).reshape(-1).astype(np.float64)
        anchors = self._palm_anchor_table()
        n = min(len(boxes), len(scores), len(anchors))
        sc = 1.0 / (1.0 + np.exp(-np.clip(scores[:n], -100.0, 100.0)))
        thr = self._threshold(self.PALM_THRESHOLD)
        out = []
        for d in np.nonzero(sc >= thr)[0]:
            ay, ax, ah, aw = anchors[d]
            yc = boxes[d, 0] / self.in_h * ah + ay
            xc = boxes[d, 1] / self.in_w * aw + ax
            h = boxes[d, 2] / self.in_h * ah
            w = boxes[d, 3] / self.in_w * aw
            out.append(DetectedObject(0, float(sc[d]), float(yc - h / 2),
                                      float(xc - w / 2), float(yc + h / 2),
                                      float(xc + w / 2)))
        return out

    def _decode_yolov5(self, buf: TensorBuffer) -> List[DetectedObject]:
        pred = squeeze_leading(buf.np(0), 2)  # (N, 5+C): cx,cy,w,h,obj...
        obj = pred[:, 4]
        cls_scores = pred[:, 5:] * obj[:, None]
        cls = cls_scores.argmax(axis=1)
        sc = cls_scores[np.arange(len(cls)), cls]
        sel = _cap_candidates(sc >= self._threshold(DEFAULT_THRESHOLD), sc)
        cx, cy = pred[sel, 0] / self.in_w, pred[sel, 1] / self.in_h
        w, h = pred[sel, 2] / self.in_w, pred[sel, 3] / self.in_h
        return [DetectedObject(int(c), float(s), float(y - hh / 2),
                               float(x - ww / 2), float(y + hh / 2),
                               float(x + ww / 2))
                for c, s, x, y, ww, hh in zip(cls[sel], sc[sel], cx, cy, w, h)]

    def _decode_raw(self, buf: TensorBuffer) -> List[DetectedObject]:
        boxes = squeeze_leading(buf.np(0), 2)   # (N, 6): cls,score,y0,x0,y1,x1
        out = []
        thr = self._threshold(DEFAULT_THRESHOLD)
        for row in boxes:
            if row[1] >= thr:
                out.append(DetectedObject(int(row[0]), float(row[1]),
                                          *map(float, row[2:6])))
        return out

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        if self.scheme == "mobilenet-ssd":
            objs = self._decode_mobilenet_ssd(buf)
            if buf.num_tensors != 4:   # 4-tensor form: NMS ran on device
                objs = nms(objs)
        elif self.scheme == "mobilenet-ssd-postprocess":
            objs = self._decode_ssd_postprocess(buf)  # model already NMSed
        elif self.scheme == "ov-person-detection":
            objs = self._decode_ov_person(buf)        # model already NMSed
        elif self.scheme == "yolov5":
            objs = (self._materialize_device_nms(buf)
                    if buf.num_tensors == 4
                    else nms(self._decode_yolov5(buf)))
        elif self.scheme == "mp-palm-detection":
            objs = (self._materialize_device_nms(buf)
                    if buf.num_tensors == 4
                    else nms(self._decode_mp_palm(buf)))
        elif self.scheme == "raw":
            objs = nms(self._decode_raw(buf))
        else:
            raise ValueError(f"unknown bounding-box scheme {self.scheme!r}")
        if self.labels:
            for o in objs:
                if 0 <= o.class_id < len(self.labels):
                    o.label = self.labels[o.class_id]
        canvas = np.zeros((self.out_h, self.out_w, 4), dtype=np.uint8)
        for o in objs:
            self._draw_box(canvas, o)
        out = buf.with_tensors([canvas])
        out.extra["objects"] = objs
        return out

    def _draw_box(self, canvas: np.ndarray, o: DetectedObject) -> None:
        h, w = canvas.shape[:2]
        y0 = int(np.clip(o.ymin * h, 0, h - 1))
        y1 = int(np.clip(o.ymax * h, 0, h - 1))
        x0 = int(np.clip(o.xmin * w, 0, w - 1))
        x1 = int(np.clip(o.xmax * w, 0, w - 1))
        color = _PALETTE[o.class_id % len(_PALETTE)]
        t = 2  # outline thickness
        canvas[y0:y0 + t, x0:x1 + 1] = color
        canvas[max(y1 - t + 1, 0):y1 + 1, x0:x1 + 1] = color
        canvas[y0:y1 + 1, x0:x0 + t] = color
        canvas[y0:y1 + 1, max(x1 - t + 1, 0):x1 + 1] = color
        if o.label:
            # label sprite above the box (reference draw() "2. Write
            # Labels": one glyph-height above, clipped to the canvas)
            from .rasterfont import GLYPH_H, composite_label

            composite_label(canvas, o.label, x0, y0 - GLYPH_H - 1, color)
