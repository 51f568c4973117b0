"""Distributed query layer (L5): offload tensor streams between hosts.

The port of ``nnstreamer_tpu/query``: the wire protocol, the query
server and client elements, the resilience policies, the overload
controls and the among-device transports (``shm``, ``edge``, ``mqtt``,
``grpc_service``); it exports what the JAX package's ``__init__`` does.
"""

from .client import (FailoverConnection, QueryConnection, TensorQueryClient,
                     parse_endpoints)
from .overload import (AdmissionController, ShedError, ShedPolicy,
                       TokenBucket, WatermarkShedPolicy, qos_of_class)
from .protocol import (Message, decode_tensors, encode_tensors, recv_msg,
                       send_msg)
from .resilience import (STATS, CircuitBreaker, CircuitOpenError,
                         HealthMonitor, RetryExhausted, RetryPolicy)
from .server import (QueryServer, TensorQueryServerSink, TensorQueryServerSrc,
                     get_server, shutdown_server)

__all__ = [
    "QueryConnection", "FailoverConnection", "TensorQueryClient",
    "parse_endpoints", "QueryServer",
    "TensorQueryServerSrc", "TensorQueryServerSink", "get_server",
    "shutdown_server", "Message", "encode_tensors", "decode_tensors",
    "send_msg", "recv_msg",
    "STATS", "RetryPolicy", "RetryExhausted", "CircuitBreaker",
    "CircuitOpenError", "HealthMonitor",
    "ShedError", "ShedPolicy", "WatermarkShedPolicy",
    "AdmissionController", "TokenBucket", "qos_of_class",
]
