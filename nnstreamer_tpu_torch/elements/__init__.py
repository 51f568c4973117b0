"""Element library of the port.  Importing this package registers every
element factory the port has (the reference's plugin registerer role,
gst/nnstreamer/registerer/nnstreamer.c:91-133): the flagship
image-labeling pipeline's elements, ``tensor_trainer`` and the query
plane's ``tensor_query_serversrc``/``serversink``/``client``.
"""

from .converter import TensorConverter
from .decoder_elem import TensorDecoder
from .filter_elem import TensorFilter
from .sink import FakeSink, TensorSink
from .src import VideoTestSrc
from .trainer import TensorTrainer
from ..query import client as _query_client  # noqa: F401
from ..query import server as _query_server  # noqa: F401

__all__ = ["FakeSink", "TensorConverter", "TensorDecoder", "TensorFilter",
           "TensorSink", "TensorTrainer", "VideoTestSrc"]
