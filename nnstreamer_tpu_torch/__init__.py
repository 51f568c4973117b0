"""nnstreamer_tpu_torch — the tensor stream pipeline framework on PyTorch.

The PyTorch/CUDA port of ``nnstreamer_tpu``: the same media↔tensor
stream pipelines and gst-launch-style pipeline language, with inference
elements that run PyTorch models on an NVIDIA GPU (``cuda:0``) and the
JAX package's Pallas TPU kernels rewritten as hand-written CUDA kernels
(``csrc/``).  Module names and layout follow the JAX package, so each
module's counterpart sits at the same path there.

Entry points run on ``cuda:0`` unless the caller asks for the CPU
(``tensor_filter accelerator=true:cpu``, or ``device="cpu"``); without a
GPU and without that request they raise.
"""

__version__ = "0.1.0"

from .tensor import (TensorBuffer, TensorFormat, TensorInfo, TensorsConfig,
                     TensorsInfo, TensorType)
from .pipeline import (Caps, Element, FlowReturn, ParseError, Pipeline,
                       parse_launch)

__all__ = [
    "TensorType", "TensorFormat", "TensorInfo", "TensorsInfo",
    "TensorsConfig", "TensorBuffer", "Caps", "Element", "FlowReturn",
    "ParseError", "Pipeline", "parse_launch", "__version__",
]
