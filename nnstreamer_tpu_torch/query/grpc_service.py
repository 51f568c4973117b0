"""gRPC tensor service: the reference's canonical RPC transport.

Parity with ``ext/nnstreamer/extra/nnstreamer_grpc_common.cc`` (418) /
``…_grpc_protobuf.cc`` (522) / ``…_grpc_flatbuf.cc`` (564) and the
``tensor_src_grpc`` / ``tensor_sink_grpc`` elements
(ext/nnstreamer/tensor_source/tensor_src_grpc.c:71-89,
tensor_sink/tensor_sink_grpc.c): a real HTTP/2 gRPC ``TensorService``
with the reference's two streaming RPCs

    rpc SendTensors (stream Tensors) returns (Empty)   // client → server
    rpc RecvTensors (Empty) returns (stream Tensors)   // server → client

over either IDL (``idl=protobuf`` → ``nnstreamer.proto`` wire messages via
the in-tree protowire codec; ``idl=flatbuf`` → ``nnstreamer.fbs`` wire via
the in-tree flatbuffer runtime).  Messages are (de)serialized by our own
codecs and handed to grpcio as raw bytes, so the frames on the wire are
byte-compatible with the reference service (oracle-tested against
protoc-generated bindings in tests/test_grpc.py).

Like the reference, BOTH elements can run as gRPC server or client
(``server=true/false``): a src in server mode accepts SendTensors pushes;
a src in client mode dials out and pulls RecvTensors; and vice versa for
the sink.  This gives all four pairings of the reference
(src/server, src/client, sink/server, sink/client).

The port of ``nnstreamer_tpu/query/grpc_service.py``: the same frames on
the wire, so either package's elements pair with the other's.  ``grpc``
is imported only when an element starts.
"""

from __future__ import annotations

import queue as _queue
import threading
from fractions import Fraction
from typing import List, Optional

import numpy as np

from ..pipeline.caps import Caps
from ..pipeline.element import Element, EOSEvent, FlowReturn
from ..pipeline.graph import Source
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..tensor.caps_util import caps_from_config, tensors_template_caps
from ..tensor.info import TensorInfo, TensorsConfig, TensorsInfo
from ..utils.log import logger
from .resilience import STATS, RetryPolicy

_EOS = object()  # in-queue end-of-stream sentinel


def _redial_client(elem) -> None:
    """Swap ``elem._client`` for a freshly-dialed :class:`GrpcTensorClient`
    (same host/port/IDL) and close the broken one, counting the redial.
    Shared by the src pull loop and the sink send loop."""
    old, elem._client = elem._client, GrpcTensorClient(
        str(elem.host), int(elem.port), elem._codec.idl)
    STATS.incr("grpc.redials")
    try:
        old.close()
    except Exception:  # noqa: BLE001 - channel already broken
        pass


def _method(idl: str, rpc: str) -> str:
    pkg = "nnstreamer.flatbuf" if idl == "flatbuf" else "nnstreamer.protobuf"
    return f"/{pkg}.TensorService/{rpc}"


class _Codec:
    """IDL-selected encode/decode of one stream frame."""

    def __init__(self, idl: str) -> None:
        if idl not in ("protobuf", "flatbuf"):
            raise ValueError(f"grpc: unknown idl {idl!r} "
                             "(protobuf|flatbuf, reference grpc_common.cc)")
        self.idl = idl

    def encode(self, buf: TensorBuffer,
               rate: Optional[Fraction]) -> bytes:
        if self.idl == "flatbuf":
            from ..utils.tensor_flatbuf import encode_tensors

            return encode_tensors([buf.np(i) for i in
                                   range(buf.num_tensors)], rate=rate)
        from ..decoders.serialize import encode_tensors_proto

        return encode_tensors_proto(buf, rate=rate)

    def decode(self, blob: bytes) -> List[np.ndarray]:
        if self.idl == "flatbuf":
            from ..utils.tensor_flatbuf import decode_tensors

            arrays, _rate, _names = decode_tensors(blob)
            return arrays
        from ..decoders.serialize import decode_tensors_proto

        return decode_tensors_proto(blob)


class _BytesService:
    """Generic TensorService endpoint speaking raw bytes (our codecs own
    the message layer).  ``recv_q`` collects frames pushed by remote
    SendTensors callers; RecvTensors streams frames from per-subscriber
    queues fed by :meth:`publish`."""

    def __init__(self, idl: str) -> None:
        self.idl = idl
        # paced by the gRPC stream's flow control; drained every
        # create() on the element streaming thread
        # nnslint: allow(unbounded-queue)
        self.recv_q: _queue.Queue = _queue.Queue()
        self._subs: List[_queue.Queue] = []
        self._lock = threading.Lock()

    # -- rpc implementations -------------------------------------------------
    def _send_tensors(self, request_iterator, context):
        for blob in request_iterator:
            self.recv_q.put(blob)
        return b""  # google.protobuf.Empty

    def _recv_tensors(self, request, context):
        # per-subscriber relay fifo, drained by the subscriber's own
        # RPC response stream (gRPC flow control backpressures it)
        # nnslint: allow(unbounded-queue)
        q: _queue.Queue = _queue.Queue()
        with self._lock:
            self._subs.append(q)
        try:
            while True:
                item = q.get()
                if item is _EOS:
                    return
                yield item
        finally:
            with self._lock:
                if q in self._subs:
                    self._subs.remove(q)

    # -- publisher side ------------------------------------------------------
    def publish(self, blob: bytes) -> None:
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            q.put(blob)

    def finish(self) -> None:
        with self._lock:
            subs = list(self._subs)
        for q in subs:
            q.put(_EOS)

    def handler(self):
        import grpc

        send = grpc.stream_unary_rpc_method_handler(self._send_tensors)
        recv = grpc.unary_stream_rpc_method_handler(self._recv_tensors)
        table = {_method(self.idl, "SendTensors"): send,
                 _method(self.idl, "RecvTensors"): recv}

        class _Handler(grpc.GenericRpcHandler):
            def service(self, details):
                return table.get(details.method)

        return _Handler()


class GrpcTensorServer:
    """Hosts a TensorService on an insecure HTTP/2 port."""

    def __init__(self, host: str, port: int, idl: str) -> None:
        import grpc
        from concurrent import futures

        self.service = _BytesService(idl)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((self.service.handler(),))
        self.port = self._server.add_insecure_port(f"{host}:{port}")
        if self.port == 0:
            raise RuntimeError(f"grpc: cannot bind {host}:{port}")
        self._server.start()

    def close(self) -> None:
        self.service.finish()
        self._server.stop(grace=1.0)


class GrpcTensorClient:
    """Dials a remote TensorService."""

    def __init__(self, host: str, port: int, idl: str) -> None:
        import grpc

        self.idl = idl
        self._channel = grpc.insecure_channel(f"{host}:{port}")
        self._send = self._channel.stream_unary(
            _method(idl, "SendTensors"))
        self._recv = self._channel.unary_stream(
            _method(idl, "RecvTensors"))

    def send_stream(self, blob_iterator) -> None:
        """Blocking client-streaming SendTensors call."""
        self._send(blob_iterator)

    def recv_stream(self):
        """Server-streaming RecvTensors call: yields raw frames."""
        return self._recv(b"")

    def close(self) -> None:
        self._channel.close()


def _config_from_arrays(arrays: List[np.ndarray]) -> TensorsConfig:
    return TensorsConfig(
        info=TensorsInfo([TensorInfo.from_np(a) for a in arrays]),
        rate=Fraction(0, 1))


@register_element
class GrpcTensorSrc(Source):
    """``tensor_src_grpc``: receive tensor frames over gRPC.

    server=true (default, reference default too): host the service; remote
    peers push via SendTensors.  server=false: dial ``host:port`` and pull
    the RecvTensors stream.  Output caps come from the ``caps`` property or
    are derived from the first received frame's dims/types.
    """

    FACTORY = "tensor_src_grpc"
    PROPERTIES = {
        "host": ("localhost", "bind/dial host"),
        "port": (55115, "bind/dial port (0 = ephemeral when serving)"),
        "server": (True, "host the service (else dial as client)"),
        "idl": ("protobuf", "message IDL: protobuf|flatbuf"),
        "caps": (None, "override out caps (else derived from first frame)"),
        "num-buffers": (-1, "stop after N buffers, -1 unlimited"),
        "blocking": (True, "reference working-mode flag (accepted for "
                           "launch-line parity; receive here is always "
                           "queue-blocking with a halt check)"),
        "out": (0, "reference READABLE counter: output buffers "
                   "generated so far"),
        "retry": (None, "client mode: redial policy spec 'attempts=4,"
                        "base=0.05,cap=0.5,…' applied when the pulled "
                        "stream breaks mid-run (query/resilience.py); "
                        "unset = a broken stream is end-of-stream (the "
                        "pre-resilience behavior, and the only correct "
                        "one when the server signals EOS by closing)"),
    }

    #: reference G_PARAM_READABLE-only buffer counter — a write is an
    #: error there (critical warning), matching tensor_converter/
    #: decoder/filter; enforced by Element.set_property
    READONLY_PROPERTIES = ("out",)

    def _make_pads(self):
        self.add_src_pad(tensors_template_caps(), "src")

    def start(self):
        self._codec = _Codec(str(self.idl))
        self._count = 0
        self._first: Optional[List[np.ndarray]] = None
        if self.server:
            self._grpc_server = GrpcTensorServer(str(self.host),
                                                 int(self.port), self._codec.idl)
            self.port = self._grpc_server.port  # readable ephemeral port
            self._fifo = self._grpc_server.service.recv_q
            self._client = None
        else:
            self._grpc_server = None
            self._retry = (RetryPolicy.parse(self.retry)
                           if self.retry not in (None, "") else None)
            self._client = GrpcTensorClient(str(self.host), int(self.port),
                                            self._codec.idl)
            # paced by the gRPC stream; drained every create()
            # nnslint: allow(unbounded-queue)
            self._fifo = _queue.Queue()
            threading.Thread(target=self._pull_loop, daemon=True,
                             name=f"grpc-src:{self.name}").start()

    def _pull_loop(self) -> None:
        # a clean server-side finish ends the iterator without raising;
        # only the error path is retryable.  Channel creation is lazy
        # (grpcio never fails at dial time), so the backoff loop is
        # driven here: each broken stream costs one delay step, a
        # delivered frame resets the budget.
        attempt = 0
        while True:
            try:
                for blob in self._client.recv_stream():
                    attempt = 0
                    self._fifo.put(blob)
            except Exception as e:  # noqa: BLE001 - stream broke
                if (self._retry is not None and not self._halted.is_set()
                        and attempt + 1 < self._retry.max_attempts):
                    logger.warning("grpc src %s: stream broke (%r), "
                                   "redialing", self.name, e)
                    STATS.incr("grpc.reconnect.retries")
                    attempt += 1
                    # the backoff ends early at stop(): a redial then
                    # would leak a live channel pulling into an
                    # unconsumed fifo, and the thread ends at once
                    if self._halted.wait(self._retry.delay(attempt - 1)):
                        break
                    _redial_client(self)
                    continue
                logger.debug("grpc src %s: recv stream ended: %r",
                             self.name, e)
            break
        self._fifo.put(_EOS)

    def stop(self):
        # halt BEFORE closing the client: closing first makes
        # recv_stream raise while _halted is still clear, and a
        # configured retry policy would redial a live server from a
        # stopped element (leaked channel + unconsumed fifo growth)
        super()._halt()
        if self._grpc_server is not None:
            self._grpc_server.close()
        if self._client is not None:
            self._client.close()

    def _next_blob(self):
        while not self._halted.is_set():
            try:
                return self._fifo.get(timeout=0.1)
            except _queue.Empty:
                continue
        return _EOS

    def negotiate(self) -> Caps:
        if self.caps:
            c = self.caps
            return Caps.from_string(c) if isinstance(c, str) else c
        blob = self._next_blob()
        if blob is _EOS:
            raise ValueError(f"{self.name}: stream closed before first "
                             "frame; cannot derive caps")
        self._first = self._codec.decode(blob)
        return caps_from_config(_config_from_arrays(self._first))

    def create(self) -> Optional[TensorBuffer]:
        n = int(self.num_buffers)
        if n >= 0 and self._count >= n:
            return None
        if self._first is not None:
            arrays, self._first = self._first, None
        else:
            blob = self._next_blob()
            if blob is _EOS:
                return None
            arrays = self._codec.decode(blob)
        self._count += 1
        self.out = self._count    # reference READABLE buffer counter
        return TensorBuffer(tensors=arrays)


@register_element
class GrpcTensorSink(Element):
    """``tensor_sink_grpc``: send the stream over gRPC.

    server=true: host the service; remote peers pull via RecvTensors.
    server=false (reference sink default): dial and push via SendTensors.
    """

    FACTORY = "tensor_sink_grpc"
    PROPERTIES = {
        "host": ("localhost", "bind/dial host"),
        "port": (55115, "bind/dial port (0 = ephemeral when serving)"),
        "server": (False, "host the service (else dial as client)"),
        "idl": ("protobuf", "message IDL: protobuf|flatbuf"),
        "retry": (None, "client mode: redial policy spec 'attempts=4,"
                        "base=0.05,cap=0.5,…' applied when the push "
                        "stream breaks mid-run (frames in flight are "
                        "lost, QoS-0 style); unset = log and stop "
                        "sending (the pre-resilience behavior)"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")

    def start(self):
        self._codec = _Codec(str(self.idl))
        self._rate: Optional[Fraction] = None
        if self.server:
            self._grpc_server = GrpcTensorServer(str(self.host),
                                                 int(self.port), self._codec.idl)
            self.port = self._grpc_server.port
            self._client = None
            self._sendq = None
            self._send_thread = None
        else:
            self._grpc_server = None
            self._retry = (RetryPolicy.parse(self.retry)
                           if self.retry not in (None, "") else None)
            self._client = GrpcTensorClient(str(self.host), int(self.port),
                                            self._codec.idl)
            # fed by chain() on the streaming thread, drained by the
            # send loop: depth is bounded by the pipeline's own
            # upstream queue capacities
            # nnslint: allow(unbounded-queue)
            self._sendq: _queue.Queue = _queue.Queue()
            self._send_thread = threading.Thread(
                target=self._send_loop, daemon=True,
                name=f"grpc-sink:{self.name}")
            self._send_thread.start()

    def _send_loop(self) -> None:
        import time as _time

        attempt = 0
        while True:
            # per-attempt state and queue binding: after a broken RPC,
            # grpcio's consumer thread may still sit in the OLD gen()'s
            # queue.get(); it must not share state (or steal frames /
            # the _EOS sentinel) with the replacement stream
            state = {"eos": False}
            sendq = self._sendq

            def gen(q=sendq, s=state):
                while True:
                    item = q.get()
                    if item is _EOS:
                        s["eos"] = True
                        return
                    yield item

            try:
                self._client.send_stream(gen())
                return
            except Exception as e:  # noqa: BLE001 - stream broke
                # retryable only when a redial policy is set and the
                # stream didn't already consume its EOS sentinel (frames
                # in flight are lost — QoS-0 semantics, like the
                # reference's paho publishes)
                if (self._retry is not None and not state["eos"]
                        and attempt + 1 < self._retry.max_attempts):
                    logger.warning("grpc sink %s: send stream broke "
                                   "(%r), redialing", self.name, e)
                    STATS.incr("grpc.reconnect.retries")
                    # retire the old queue: chain()/stop() move to the
                    # fresh one, and an _EOS posted to the old unblocks
                    # the zombie consumer so it can't swallow new items
                    # fresh queue per redial (same bound as above)
                    # nnslint: allow(unbounded-queue)
                    self._sendq = _queue.Queue()
                    sendq.put(_EOS)
                    _time.sleep(self._retry.delay(attempt))
                    attempt += 1
                    _redial_client(self)
                    continue
                logger.warning("grpc sink %s: send stream failed: %r",
                               self.name, e)
                return

    def stop(self):
        if self._sendq is not None:
            self._sendq.put(_EOS)
        if self._send_thread is not None:
            self._send_thread.join(timeout=10)
        if self._grpc_server is not None:
            self._grpc_server.close()
        if self._client is not None:
            self._client.close()

    def set_caps(self, pad, caps):
        from ..tensor.caps_util import config_from_caps

        self._rate = config_from_caps(caps).rate

    def chain(self, pad, buf):
        blob = self._codec.encode(buf, self._rate)
        if self._grpc_server is not None:
            self._grpc_server.service.publish(blob)
        else:
            self._sendq.put(blob)
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            if self._sendq is not None:
                self._sendq.put(_EOS)
                if self._send_thread is not None:
                    self._send_thread.join(timeout=10)
                    self._send_thread = None
                self._sendq = None
            elif self._grpc_server is not None:
                self._grpc_server.service.finish()
            self.post_eos_reached()
