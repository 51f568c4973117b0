"""Element library of the port.  Importing this package registers every
element factory the port has (the reference's plugin registerer role,
gst/nnstreamer/registerer/nnstreamer.c:91-133): the flagship
image-labeling pipeline's elements, ``identity`` and ``tensor_debug``,
``tensor_transform``,
``tensor_trainer``, the query plane's
``tensor_query_serversrc``/``serversink``/``client``, the among-device
transports (``tensor_shm_sink``/``tensor_shm_src``, ``edge_sink``/
``edge_src`` with their reference spellings ``edgesink``/``edgesrc``,
``mqttsink``/``mqttsrc``, ``tensor_sink_grpc``/``tensor_src_grpc``) and
the LLM serving tier's ``tensor_llm``.
"""

from .converter import TensorConverter
from .decoder_elem import TensorDecoder
from .filter_elem import TensorFilter
from .misc import Identity, TensorDebug
from .sink import FakeSink, TensorSink
from .src import VideoTestSrc
from .trainer import TensorTrainer
from .transform import TensorTransform
from ..llm import element as _llm_element  # noqa: F401
from ..query import client as _query_client  # noqa: F401
from ..query import edge as _query_edge  # noqa: F401
from ..query import grpc_service as _query_grpc  # noqa: F401
from ..query import mqtt as _query_mqtt  # noqa: F401
from ..query import server as _query_server  # noqa: F401
from ..query import shm as _query_shm  # noqa: F401

__all__ = ["FakeSink", "Identity", "TensorConverter", "TensorDebug",
           "TensorDecoder", "TensorFilter", "TensorSink", "TensorTrainer",
           "TensorTransform", "VideoTestSrc"]
