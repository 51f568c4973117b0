"""Built-in filter backends.  Importing this package registers them all
(the in-process analogue of subplugin .so discovery,
gst/nnstreamer/nnstreamer_subplugin.c:116): the JAX package's thirteen
names."""

from .caffe2 import Caffe2Filter
from .custom import (CustomEasyFilter, CustomFilter, DummyFilter,
                     register_custom_easy, unregister_custom_easy)
from .lua import LuaFilter
from .mxnet import MXNetFilter
from .python import PythonFilter
from .pytorch import PyTorchFilter
from .tensorflow import TensorFlowFilter
from .tflite import TFLiteFilter
from .xla import XLAFilter

__all__ = [
    "XLAFilter", "Caffe2Filter", "CustomFilter", "CustomEasyFilter",
    "DummyFilter", "LuaFilter", "MXNetFilter",
    "PythonFilter", "TFLiteFilter", "PyTorchFilter", "TensorFlowFilter",
    "register_custom_easy", "unregister_custom_easy",
]
