"""Element library of the port.  Importing this package registers every
element factory the port has (the reference's plugin registerer role,
gst/nnstreamer/registerer/nnstreamer.c:91-133): the flagship
image-labeling pipeline's elements and ``tensor_trainer``.
"""

from .converter import TensorConverter
from .decoder_elem import TensorDecoder
from .filter_elem import TensorFilter
from .sink import FakeSink, TensorSink
from .src import VideoTestSrc
from .trainer import TensorTrainer

__all__ = ["FakeSink", "TensorConverter", "TensorDecoder", "TensorFilter",
           "TensorSink", "TensorTrainer", "VideoTestSrc"]
