"""Element library of the port.  Importing this package registers every
element factory (the reference's plugin registerer role,
gst/nnstreamer/registerer/nnstreamer.c:91-133): the JAX package's element
library (``nnstreamer_tpu/elements/``) plus ``identity``, the query
plane's ``tensor_query_serversrc``/``serversink``/``client``, the
among-device transports (``tensor_shm_sink``/``tensor_shm_src``,
``edge_sink``/``edge_src`` with their reference spellings
``edgesink``/``edgesrc``, ``mqttsink``/``mqttsrc``,
``tensor_sink_grpc``/``tensor_src_grpc``) and the LLM serving tier's
``tensor_llm``.
"""

from . import aggregator  # noqa: F401
from . import converter  # noqa: F401
from . import decoder_elem  # noqa: F401
from . import filter_elem  # noqa: F401
from . import mediadec  # noqa: F401
from . import merge_split  # noqa: F401
from . import misc  # noqa: F401
from . import mux  # noqa: F401
from . import rate  # noqa: F401
from . import repo  # noqa: F401
from . import sink  # noqa: F401
from . import sparse  # noqa: F401
from . import src  # noqa: F401
from . import srciio  # noqa: F401
from . import tensor_if  # noqa: F401
from . import trainer  # noqa: F401
from . import transform  # noqa: F401
from ..llm import element as _llm_element  # noqa: F401
from ..query import client as _query_client  # noqa: F401
from ..query import edge as _query_edge  # noqa: F401
from ..query import grpc_service as _query_grpc  # noqa: F401
from ..query import mqtt as _query_mqtt  # noqa: F401
from ..query import server as _query_server  # noqa: F401
from ..query import shm as _query_shm  # noqa: F401

from .aggregator import TensorAggregator
from .converter import TensorConverter
from .decoder_elem import TensorDecoder
from .filter_elem import TensorFilter
from .mediadec import PngDec, PnmDec, WavParse
from .merge_split import TensorMerge, TensorSplit
from .misc import DataRepoSrc, Identity, Join, TensorCrop, TensorDebug
from .mux import TensorDemux, TensorMux
from .rate import TensorRate
from .repo import TensorRepoSink, TensorRepoSrc
from .sink import FakeSink, FileSink, MultiFileSink, TensorSink
from .sparse import TensorSparseDec, TensorSparseEnc
from .src import AudioTestSrc, FileSrc, MultiFileSrc, VideoTestSrc
from .srciio import TensorSrcIIO
from .tensor_if import TensorIf, register_if_custom
from .trainer import TensorTrainer
from .transform import TensorTransform

__all__ = [
    "AudioTestSrc", "DataRepoSrc", "FakeSink", "FileSink", "FileSrc",
    "Identity", "Join", "MultiFileSink", "MultiFileSrc", "PngDec", "PnmDec",
    "TensorAggregator", "TensorConverter", "TensorCrop", "TensorDebug",
    "TensorDecoder", "TensorDemux", "TensorFilter", "TensorIf",
    "TensorMerge", "TensorMux", "TensorRate", "TensorRepoSink",
    "TensorRepoSrc", "TensorSink", "TensorSparseDec", "TensorSparseEnc",
    "TensorSplit", "TensorSrcIIO", "TensorTrainer", "TensorTransform",
    "VideoTestSrc", "WavParse", "register_if_custom",
]
