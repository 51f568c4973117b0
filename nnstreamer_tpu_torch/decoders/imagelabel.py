"""image_labeling decoder: classifier logits → text label.

Parity with ext/nnstreamer/tensor_decoder/tensordec-imagelabel.c (argmax over
the score tensor + label-file lookup; option1 = labels path).  Output is a
``text/x-raw`` stream whose buffer holds the label string (uint8 bytes) plus
``extra["label"]``/``extra["index"]`` for programmatic consumers.
"""

from __future__ import annotations

from fractions import Fraction
from typing import List, Optional

import numpy as np

from ..pipeline.caps import Caps, Structure
from ..tensor.buffer import TensorBuffer
from ..tensor.info import TensorsConfig
from . import Decoder, register_decoder


def load_labels(path: str) -> List[str]:
    """Label file: one label per line (reference tensordecutil.c label
    loading)."""
    with open(path, "r", encoding="utf-8") as f:
        return [line.strip() for line in f]


@register_decoder
class ImageLabelDecoder(Decoder):
    MODE = "image_labeling"

    def __init__(self) -> None:
        self.labels: Optional[List[str]] = None

    def set_option(self, index: int, value: str) -> None:
        if index == 1 and value:
            self.labels = load_labels(value)

    def get_out_caps(self, config: TensorsConfig) -> Caps:
        if config.info.num_tensors != 1:
            raise ValueError("image_labeling expects exactly 1 score tensor")
        return Caps([Structure("text/x-raw", {
            "format": "utf8",
            "framerate": config.rate or Fraction(0, 1)})])

    def device_reduce_spec(self, config: TensorsConfig):
        """Pushdown: argmax on device, fetch ONE int32 instead of the whole
        score vector (1001 floats for MobileNet)."""
        if config.info.num_tensors != 1:
            return None
        info = config.info[0]
        if int(np.prod(info.np_shape)) <= 1:    # already reduced
            return None
        from ..ops.classify import top1

        from ..tensor.info import TensorInfo, TensorsInfo
        from ..tensor.types import TensorType

        def fn(outs):
            return [top1(outs[0])]

        return fn, TensorsInfo([TensorInfo(TensorType.INT32, (1,))])

    def lower_decode(self, config: TensorsConfig):
        """fuse=xla: the argmax reduction (ops/classify.py ``top1``) joins
        the segment's graph; the label lookup stays a host post-finisher
        over the reduced (1,) int32, which ``decode`` already reads.  When
        the reduction was ALREADY pushed into the upstream filter
        (``device_reduce_spec`` is None on the reduced config), the
        lowered part is the identity."""
        if config.info.num_tensors != 1:
            return None
        spec = self.device_reduce_spec(config)
        if spec is None:
            return (lambda ts: ts), True
        red_fn, _ = spec
        return (lambda ts: red_fn(ts)), True

    def decode(self, buf: TensorBuffer, config: TensorsConfig) -> TensorBuffer:
        scores = buf.np(0)
        if scores.size == 1 and scores.dtype == np.int32:
            idx = int(scores.reshape(-1)[0])    # reduced on device
        else:
            idx = int(np.argmax(scores))
        label = (self.labels[idx] if self.labels and idx < len(self.labels)
                 else str(idx))
        out = buf.with_tensors(
            [np.frombuffer(label.encode("utf-8"), dtype=np.uint8)])
        out.extra["label"] = label
        out.extra["index"] = idx
        return out
