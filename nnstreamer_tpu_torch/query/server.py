"""Tensor query server: serve pipeline inference to remote clients.

Parity with the reference server trio (SURVEY.md §2.7):
- gst/nnstreamer/tensor_query/tensor_query_serversrc.c (receive → queue →
  push into the serving pipeline)
- tensor_query_serversink.c (send answers matched by client id meta)
- tensor_query_server.c (shared server-data table pairing src/sink by id)

The transport thread owns the sockets; client identity rides in
``buf.extra["query_client_id"]`` (the role of GstMeta in
gst/nnstreamer/tensor_meta.c).

The port of ``nnstreamer_tpu/query/server.py``.  Its own server table
(:func:`get_server`) lives beside the JAX package's: a process may run
both packages' servers, under distinct ids.  What differs is where the
frames meet the card: a cross-stream bucket is stacked ONCE, straight
from the received payload views into pinned host memory (the filter's
graph input copies from there asynchronously), and the serversink takes
a bucket's outputs off the card in one pinned copy with one sync before
it splits the replies from host memory.  ``connect-type=HYBRID``
advertises the server's address as a retained MQTT record
(``query/mqtt.py``), which a client of either package discovers.
"""

from __future__ import annotations

import queue as _queue
import socket
import threading
from typing import Dict, Optional

from ..analysis.sanitizer import make_condition, make_lock
from ..obs.clock import wall_us
from ..obs.span import TraceContext
from ..pipeline.caps import Caps
from ..pipeline.element import Element, EOSEvent, FlowReturn
from ..pipeline.graph import Source
from ..pipeline.registry import register_element
from .. import _cuda
from ..filter.framework import start_output_transfers
from ..tensor.buffer import TensorBuffer, XBatchMeta, default_pool
from ..tensor.caps_util import tensors_template_caps
from ..utils.conf import parse_bool
from .overload import (DEFAULT_QOS, QOS_CLASSES, AdmissionController,
                       TokenBucket, bucket_budget, qos_of_class)
from .protocol import (Message, T_BYE, T_DATA, T_HELLO, T_METRICS,
                       T_PING, T_PONG, T_REPLY, T_SHED, T_TRACE,
                       decode_tensors, parse_hello_tokens, recv_msg,
                       send_msg, send_tensors, shutdown_close)

#: default bound on the server's incoming frame queue (frames, not
#: bytes): deep enough that bursty-but-sustainable traffic never sheds,
#: shallow enough that queued latency stays bounded (256 frames at the
#: measured ~2 ms/query loopback service time is ~0.5 s of backlog)
DEFAULT_QUEUE_DEPTH = 256
#: default per-connection socket send timeout: a client that stops
#: draining replies for this long is a zombie and gets evicted, instead
#: of wedging the serving pipeline thread inside reply()
DEFAULT_SEND_TIMEOUT = 5.0


class QueryServer:
    """Accepts clients, queues incoming frames, routes replies by client id.

    The shared table (reference tensor_query_server.c:76-238) pairs the
    serversrc and serversink elements of one serving pipeline.

    Overload safety (query/overload.py): ``incoming`` is BOUNDED
    (``queue_depth`` frames) and every DATA frame passes admission
    control before its tensors pin a pooled slab — a refused request is
    answered with an explicit ``T_SHED`` carrying a retry-after hint,
    chosen by QoS class (bronze sheds first, gold last; per-connection
    class negotiated in the T_HELLO handshake).  ``drain(deadline)``
    stops admitting, finishes in-flight replies, then closes — the
    server half of the pipeline ``draining`` lifecycle state.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 queue_depth: int = DEFAULT_QUEUE_DEPTH,
                 admission: Optional[AdmissionController] = None,
                 shed: bool = True,
                 send_timeout: float = DEFAULT_SEND_TIMEOUT):
        self.host = host
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        self.queue_depth = max(1, int(queue_depth))
        self.incoming: _queue.Queue = _queue.Queue(maxsize=self.queue_depth)
        #: admit-or-shed decider; ``shed=False`` disables shedding
        #: entirely (overload degrades to per-connection backpressure
        #: on the bounded queue — the pre-overload-layer behavior,
        #: minus the unbounded memory growth)
        self.admission = (admission if admission is not None
                          else AdmissionController()) if shed else None
        self.send_timeout = float(send_timeout)
        self._clients: Dict[int, socket.socket] = {}
        # per-client send locks: the reader thread's handshake/pong
        # replies must not interleave with a partially-written T_REPLY
        # from the pipeline thread (mirror of the client's _send_lock)
        self._send_locks: Dict[int, threading.Lock] = {}
        self._qos: Dict[int, str] = {}   # client id -> negotiated class
        self._caps_str: Optional[str] = None
        self._next_id = 1
        #: serving pipeline's tracer (set by the serversink element);
        #: when it records spans, replies piggyback them as T_TRACE so
        #: the client merges both processes into one timeline
        self.obs_tracer = None
        #: telemetry-federation collector (obs/federation.py): attach
        #: one and every connection doubles as a metrics drain —
        #: T_METRICS pushes from worker processes already connected to
        #: this front-end merge into the federated view without a
        #: second wire.  Unattached (the default), pushes are ignored.
        self.collector = None
        self._span_cursors: Dict[int, int] = {}   # client id -> ring pos
        self._lock = make_lock("query.registry")
        self._stop = threading.Event()
        self._draining = threading.Event()
        #: admitted-minus-replied frames; drain() waits for zero
        self._inflight = 0
        self._drain_cv = make_condition("query.registry")
        self.peak_depth = 0
        # scrape-time gauges for the soak harness: connected-client
        # count / queue depth / shed rate are lazy callables (zero
        # per-frame cost); admit/shed counters are one inc per decision
        from ..obs.metrics import REGISTRY

        self._m_clients = REGISTRY.gauge(
            "nns_query_server_clients", fn=lambda: len(self._clients),
            port=str(self.port))
        self._m_accepted = REGISTRY.counter(
            "nns_query_server_accepted_total", port=str(self.port))
        self._m_depth = REGISTRY.gauge(
            "nns_query_server_queue_depth",
            fn=self.incoming.qsize, port=str(self.port))
        self._m_peak = REGISTRY.gauge(
            "nns_query_server_queue_peak",
            fn=lambda: self.peak_depth, port=str(self.port))
        self._m_admitted = {
            c: REGISTRY.counter("nns_query_server_admitted_total",
                                port=str(self.port), qos=c)
            for c in QOS_CLASSES}
        self._m_shed = {
            c: REGISTRY.counter("nns_query_server_shed_total",
                                port=str(self.port), qos=c)
            for c in QOS_CLASSES}
        self._m_shed_rate = REGISTRY.gauge(
            "nns_query_server_shed_rate", fn=self._shed_rate,
            port=str(self.port))
        self._m_evicted = REGISTRY.counter(
            "nns_query_server_evicted_total", port=str(self.port))
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="query-accept")
        self._accept_thread.start()

    def _shed_rate(self) -> float:
        shed = sum(c.value for c in self._m_shed.values())
        admitted = sum(c.value for c in self._m_admitted.values())
        return shed / max(1, shed + admitted)

    def counters(self) -> Dict[str, Dict[str, int]]:
        """Point-in-time admit/shed counts by QoS class (test/verdict
        surface; the live metrics ride the registry)."""
        return {"admitted": {c: m.value
                             for c, m in self._m_admitted.items()},
                "shed": {c: m.value for c, m in self._m_shed.items()}}

    def set_caps_string(self, caps: str) -> None:
        self._caps_str = caps

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            # bound EVERY per-connection send path: a client that stops
            # draining its socket can only stall a send for
            # send_timeout before it is evicted, instead of wedging the
            # pipeline thread inside reply() forever.  The same timeout
            # applies to the reader's recv — protocol.recv_msg treats
            # an idle timeout as retryable, so quiet clients survive.
            if self.send_timeout > 0:
                conn.settimeout(self.send_timeout)
            with self._lock:
                cid = self._next_id
                self._next_id += 1
                self._clients[cid] = conn
                self._send_locks[cid] = make_lock("query.send")
            self._m_accepted.inc()
            threading.Thread(target=self._client_loop, args=(cid, conn),
                             daemon=True, name=f"query-client-{cid}").start()

    def _admit_frame(self, cid: int, msg: Message) -> Optional[float]:
        """Admission decision for one DATA frame: ``None`` admits, a
        float sheds with that retry-after hint (seconds).  Header-only:
        runs BEFORE the payload is decoded into tensors, so a shed
        request's slab goes straight back to the pool."""
        if self.admission is None:
            return None
        qos = self._qos.get(cid, DEFAULT_QOS)
        return self.admission.admit(qos, self.incoming.qsize(),
                                    self.queue_depth)

    def _send_shed(self, conn, slock, cid: int, seq: int,
                   retry_after_s: float) -> None:
        qos = self._qos.get(cid, DEFAULT_QOS)
        self._m_shed[qos].inc()
        with slock:
            send_msg(conn, Message(
                T_SHED, client_id=cid, seq=seq, epoch_us=wall_us(),
                payload=str(int(retry_after_s * 1000)).encode()))

    def _client_loop(self, cid: int, conn: socket.socket) -> None:
        # snapshot: stop() clears the dict concurrently, and a KeyError
        # here would escape the except-OSError below
        slock = self._send_locks.get(cid) or make_lock("query.send")
        pool = default_pool()
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn, pool=pool)
                except TimeoutError:   # idle socket on a bounded-send
                    continue           # connection: keep listening
                except ValueError:   # bad magic / CRC: drop the connection
                    break
                if msg is None or msg.type == T_BYE:
                    break
                if msg.type == T_HELLO:
                    # capability handshake: record the client's QoS
                    # declaration (``qos=<class>`` token —
                    # query/overload.py; the payload is the ``;``-token
                    # grammar so fleet clients may also carry a model
                    # identity), reply with server caps string
                    tokens = parse_hello_tokens(msg.payload)
                    if "qos" in tokens:
                        qos = qos_of_class(tokens["qos"])
                        if qos is not None:
                            with self._lock:
                                self._qos[cid] = qos
                    with slock:
                        send_msg(conn, Message(T_HELLO, client_id=cid,
                                               payload=(self._caps_str
                                                        or "").encode()))
                    continue
                if msg.type == T_PING:
                    # liveness heartbeat: echo seq+payload immediately,
                    # out of band with DATA/REPLY (query/resilience.py).
                    # The pong also stamps this host's wall clock: a
                    # ping round trip has near-zero service time, so it
                    # is the UNBIASED clock-offset sample (obs/clock.py)
                    # — a reply stamp rides on top of model latency.
                    with slock:
                        send_msg(conn, Message(T_PONG, client_id=cid,
                                               seq=msg.seq,
                                               epoch_us=wall_us(),
                                               payload=msg.payload))
                    continue
                if msg.type == T_METRICS:
                    # telemetry piggyback (obs/federation.py): a worker
                    # pushing its registry on the data wire.  One attr
                    # read per push on unattached servers; the payload
                    # is JSON, never tensors, so no slab is pinned.
                    collector = self.collector
                    if collector is not None:
                        collector.ingest(bytes(msg.payload or b""))
                    continue
                if msg.type == T_DATA:
                    # admission BEFORE tensor decode: a shed frame's
                    # pooled payload slab releases immediately instead
                    # of pinning memory through the serving pipeline
                    retry_after = self._admit_frame(cid, msg)
                    if retry_after is not None:
                        if msg.lease is not None:
                            msg.payload = b""
                            msg.lease.release()
                        self._send_shed(conn, slock, cid, msg.seq,
                                        retry_after)
                        continue
                    buf = TensorBuffer(tensors=decode_tensors(msg.payload),
                                       pts=msg.pts, lease=msg.lease)
                    buf.extra["query_client_id"] = cid
                    buf.extra["query_seq"] = msg.seq
                    buf.extra["nns_class"] = qos = self._qos.get(
                        cid, DEFAULT_QOS)
                    if msg.trace_id:
                        # restore the client's trace context: spans this
                        # buffer produces in the serving pipeline record
                        # under the client's trace id (obs/span.py)
                        buf.extra["nns_trace"] = TraceContext(
                            msg.trace_id, msg.span_id, msg.origin_us)
                    self._enqueue(conn, slock, cid, qos, buf)
        except OSError:
            pass   # link reset under us (recv, or a handshake/pong send)
        finally:
            with self._lock:
                self._clients.pop(cid, None)
                self._send_locks.pop(cid, None)
                self._qos.pop(cid, None)
                # client ids are never reused: an unreaped cursor per
                # connection ever made is a slow leak on a long server
                self._span_cursors.pop(cid, None)
            conn.close()

    def _dec_inflight(self) -> None:
        with self._drain_cv:
            if self._inflight > 0:
                self._inflight -= 1
                if self._inflight == 0:
                    self._drain_cv.notify_all()

    def _enqueue(self, conn, slock, cid: int, qos: str,
                 buf: TensorBuffer) -> None:
        """Admit ``buf`` into the bounded queue.  With shedding enabled
        a full queue sheds (the queue bound is the hard watermark the
        policy's soft watermarks sit under); without it, the put blocks
        — per-connection backpressure, woken by stop().

        The in-flight count is raised BEFORE the put: the pipeline
        thread can dequeue and reply the instant the frame lands, and
        a decrement racing ahead of the increment would leave a
        permanent +1 skew that makes drain() time out forever."""
        tracer = self.obs_tracer
        if tracer is not None and tracer.ring is not None:
            # wait-state attribution (obs/attrib.py): arrival stamp so
            # the serversrc can annotate this frame's admission-wait —
            # the time it sat in the bounded queue before the serving
            # pipeline picked it up.  Untraced servers pay one attr
            # read + None test per frame.
            from ..obs.clock import mono_ns

            buf.extra["nns_enq_ns"] = mono_ns()
        with self._drain_cv:
            self._inflight += 1
        while not self._stop.is_set():
            try:
                self.incoming.put(buf, timeout=0.25)
            except _queue.Full:
                if self.admission is not None:
                    self._dec_inflight()   # refused after all
                    buf.lease = None   # buffer dies here: drop its slab
                    self._send_shed(conn, slock, cid,
                                    buf.extra.get("query_seq", 0),
                                    retry_after_s=0.25)
                    return
                continue
            self._m_admitted[qos].inc()
            depth = self.incoming.qsize()
            if depth > self.peak_depth:
                self.peak_depth = depth
            return
        self._dec_inflight()           # server stopped before the put

    def _trace_piggyback(self, cid: int, ctx: TraceContext
                         ) -> Optional[Message]:
        """T_TRACE message carrying this pipeline's new spans for the
        client's trace, or None when there is nothing to send (no
        span-recording tracer attached, or no new spans)."""
        tracer = self.obs_tracer
        if tracer is None or getattr(tracer, "ring", None) is None \
                or not ctx.trace_id:
            return None
        import json as _json

        with self._lock:
            cursor = self._span_cursors.get(cid, 0)
        payload, cursor = tracer.publish_spans(cursor,
                                               trace_id=ctx.trace_id)
        with self._lock:
            self._span_cursors[cid] = cursor
        if not payload["spans"]:
            return None
        return Message(T_TRACE, client_id=cid,
                       trace_id=ctx.trace_id,
                       epoch_us=wall_us(),
                       payload=_json.dumps(payload).encode())

    def reply(self, buf: TensorBuffer) -> bool:
        try:
            return self._reply(buf)
        finally:
            # in-flight accounting runs on EVERY outcome — including a
            # reply for a client that disconnected mid-request — so
            # drain() converges exactly when the last admitted frame
            # has been answered (or become unanswerable).  STREAMING
            # answers (the llm tier's per-token frames) mark every
            # frame but the last with ``extra["nns_more"]``: one
            # admitted request stays ONE in-flight unit until its final
            # frame, so drain() waits for whole token streams, not just
            # their first token.
            if not buf.extra.get("nns_more"):
                self._dec_inflight()

    def shed_frame(self, extra: Dict, retry_after_s: float) -> bool:
        """Explicit ``T_SHED`` for an ALREADY-ADMITTED frame that a
        downstream serving stage refused — the llm tier's KV-cache slot
        admission (``llm/element.py``): queue-depth admission at the
        wire cannot see slot exhaustion, so the element answers the
        frame's client here with a retry-after hint instead of holding
        the request as unbounded memory.  Settles the frame's in-flight
        unit (a shed IS its final answer); returns False when the
        client is already gone (its accounting still settles)."""
        cid = extra.get("query_client_id")
        seq = extra.get("query_seq", 0)
        try:
            with self._lock:
                conn = self._clients.get(cid)
                slock = self._send_locks.get(cid)
            if conn is None:
                return False
            if slock is None:
                slock = make_lock("query.send")   # teardown race
            self._send_shed(conn, slock, cid, seq, retry_after_s)
            return True
        except OSError:
            return False
        finally:
            self._dec_inflight()

    def client_connected(self, cid) -> bool:
        """Is this client id still connected?  The llm tier's session
        pruner polls it so a disconnected client's cache slot reclaims
        promptly instead of decoding tokens nobody will read."""
        with self._lock:
            return cid in self._clients

    def _reply(self, buf: TensorBuffer) -> bool:
        cid = buf.extra.get("query_client_id")
        with self._lock:
            conn = self._clients.get(cid)
            slock = self._send_locks.get(cid)
        if conn is None:
            return False
        seq = buf.extra.get("query_seq", 0)
        ctx = buf.extra.get("nns_trace") or TraceContext()
        trace_msg = self._trace_piggyback(cid, ctx)
        try:
            if slock is None:
                slock = make_lock("query.send")   # teardown race: one-shot
            with slock:
                # reply stamps: echo the trace context, carry this
                # host's wall clock so the client estimates the offset
                # (obs/clock.py) from the very frames it already sends
                send_tensors(conn, T_REPLY, buf, client_id=cid,
                             seq=seq, pts=buf.pts or 0,
                             epoch_us=wall_us(),
                             trace_id=ctx.trace_id, span_id=ctx.span_id,
                             origin_us=ctx.origin_us)
                if trace_msg is not None:
                    send_msg(conn, trace_msg)
            return True
        except socket.timeout:
            # the bounded send path fired: this client stopped draining
            # its socket.  Evict it — a zombie peer must cost one send
            # timeout, not one timeout per reply forever.
            self._m_evicted.inc()
            with self._lock:
                self._clients.pop(cid, None)
            shutdown_close(conn)
            return False
        except OSError:
            return False

    def drain(self, deadline: float = 5.0) -> bool:
        """Graceful drain: stop admitting (every new DATA frame sheds
        with a retry-after sized past the drain), let in-flight frames
        finish their replies, then close.  Returns True when the last
        in-flight reply completed within ``deadline`` seconds, False on
        a deadline cut (remaining frames are dropped by close()).

        Wired to the pipeline ``draining`` lifecycle state: the
        /healthz endpoint answers 503 while this runs, so load
        balancers route away while existing requests complete.
        """
        self._draining.set()
        if self.admission is None:
            # drain must stop admitting even on a shed=False server:
            # install a controller whose only act is the drain-mode
            # shed-everything answer
            self.admission = AdmissionController()
        self.admission.start_drain(deadline)
        with self._drain_cv:
            ok = self._drain_cv.wait_for(
                lambda: self._inflight <= 0, timeout=max(0.0, deadline))
        self.close()
        return bool(ok)

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def close(self) -> None:
        self._stop.set()
        from ..obs.metrics import REGISTRY

        for g in (self._m_clients, self._m_depth, self._m_peak,
                  self._m_shed_rate):
            REGISTRY.unregister(g)
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._clients.values())
            self._clients.clear()
            self._send_locks.clear()
            self._qos.clear()
        for conn in conns:
            # shutdown-then-close: a plain close of a socket another
            # thread is blocked reading sends no FIN (protocol.py)
            shutdown_close(conn)


#: server table: id → QueryServer (pairs serversrc/serversink)
_SERVERS: Dict[int, QueryServer] = {}
_SERVERS_LOCK = make_lock("leaf")
#: serializes server CREATION: a new QueryServer registers its metrics
#: (obs.metrics ranks below leaf), so it is built under this lock, not
#: under the table's leaf lock
_CREATE_LOCK = make_lock("query.registry")


def get_server(server_id: int, host: str = "127.0.0.1",
               port: int = 0,
               queue_depth: Optional[int] = None,
               shed: Optional[bool] = None,
               capacity_rps: float = 0.0,
               send_timeout: Optional[float] = None) -> QueryServer:
    """Server-table lookup; overload-protection kwargs apply only when
    this call CREATES the server (the serversink's bare lookup must not
    reconfigure the serversrc's server)."""
    with _CREATE_LOCK:
        with _SERVERS_LOCK:
            srv = _SERVERS.get(server_id)
        if srv is None:
            admission = None
            if capacity_rps and float(capacity_rps) > 0:
                admission = AdmissionController(
                    bucket=TokenBucket(float(capacity_rps)))
            srv = QueryServer(
                host, port,
                queue_depth=(DEFAULT_QUEUE_DEPTH if queue_depth is None
                             else int(queue_depth)),
                admission=admission,
                shed=(True if shed is None else bool(shed)),
                send_timeout=(DEFAULT_SEND_TIMEOUT if send_timeout is None
                              else float(send_timeout)))
            with _SERVERS_LOCK:
                _SERVERS[server_id] = srv
        return srv


def peek_server(server_id: int) -> Optional[QueryServer]:
    """Server-table read WITHOUT creation: consumers that only want an
    existing server's state (the llm element's disconnect pruner) must
    not conjure a default-configured server into the table."""
    with _SERVERS_LOCK:
        return _SERVERS.get(server_id)


def shutdown_server(server_id: int) -> None:
    with _SERVERS_LOCK:
        srv = _SERVERS.pop(server_id, None)
    if srv is not None:
        srv.close()


@register_element
class TensorQueryServerSrc(Source):
    """Receives client frames and pushes them into the serving pipeline."""

    FACTORY = "tensor_query_serversrc"
    PROPERTIES = {
        "host": ("127.0.0.1", ""),
        "port": (0, "0 = ephemeral"),
        "id": (0, "server table id"),
        "caps": (None, "caps announced for received tensors"),
        "connect-type": ("tcp", "TCP | HYBRID (reference nicks; hybrid "
                                "advertises this server's address as a "
                                "retained MQTT record under the topic)"),
        "dest-host": ("127.0.0.1", "hybrid: MQTT broker host"),
        "dest-port": (1883, "hybrid: MQTT broker port"),
        "topic": (None, "hybrid: discovery topic"),
        "advertise-host": (None, "address to advertise in the hybrid "
                                 "record (default: host — set it when "
                                 "bound to 0.0.0.0, which is not a "
                                 "reachable address for remote "
                                 "clients)"),
        "queue-depth": (256, "bound on the incoming frame queue; the "
                             "hard watermark the shed policy's soft "
                             "watermarks sit under"),
        "shed": (True, "admission control: refused frames get explicit "
                       "T_SHED answers with retry-after, QoS-tiered "
                       "(bronze first, gold last — query/overload.py); "
                       "false = pure per-connection backpressure on "
                       "the bounded queue"),
        "capacity-rps": (0.0, "token-bucket admission rate in "
                              "requests/s across all clients "
                              "(0 = depth/latency watermarks only)"),
        "send-timeout": (5.0, "per-connection socket send bound in "
                              "seconds; a client that stops draining "
                              "replies for this long is evicted "
                              "(0 = unbounded sends)"),
        "batch": (1, "cross-stream continuous batching: coalesce up to "
                     "N admitted frames from ALL connected clients into "
                     "one stacked buffer that traverses the serving "
                     "pipeline as a single dispatch, answered per "
                     "client by the paired serversink.  The bucket never waits for "
                     "more frames than the connected-client population "
                     "can have outstanding (fill target = min(batch, "
                     "clients)), so a lone client pays ~zero batching "
                     "tax.  1 = per-frame serving (default)"),
        "batch-timeout-ms": (0.0, "extra wait to FILL a cross-stream "
                                  "bucket once it has a frame, scaled "
                                  "per QoS class (gold waits 1/4 of "
                                  "this, silver 1/2, bronze all — a "
                                  "gold frame never waits out a "
                                  "bronze-opened bucket's window; "
                                  "query/overload.py bucket_budget).  "
                                  "0 = greedy continuous batching: "
                                  "dispatch whatever is queued the "
                                  "moment the previous bucket clears "
                                  "(the service time of bucket k is "
                                  "bucket k+1's natural collect "
                                  "window)"),
    }

    def _make_pads(self):
        self.add_src_pad(tensors_template_caps(), "src")

    def static_check(self):
        """Pre-play verifier hook: surface the batching decisions
        ``start()`` would make silently (mirrors tensor_filter's
        checks)."""
        out = []
        try:
            # mirrors start(): batch=0 and unset both serve unbatched
            # nnslint: allow(falsy-zero-default)
            batch = int(self.batch or 1)
        except (TypeError, ValueError):
            out.append(("error", f"{self.name}: batch={self.batch!r} is "
                                 "not an integer"))
            batch = 1
        try:
            timeout = float(self.batch_timeout_ms or 0)
        except (TypeError, ValueError):
            out.append(("error", f"{self.name}: batch-timeout-ms="
                                 f"{self.batch_timeout_ms!r} is not a "
                                 "number"))
            timeout = 0.0
        if batch < 1:
            out.append(("warning", f"{self.name}: batch={batch} is "
                                   "clamped to 1 at start"))
        if timeout > 0 and batch <= 1:
            out.append(("warning",
                        f"{self.name}: batch-timeout-ms needs "
                        "cross-stream batching (batch>1); ignored"))
        return out

    def start(self):
        self.server = get_server(int(self.id), str(self.host),
                                 int(self.port),
                                 queue_depth=int(self.queue_depth),
                                 shed=parse_bool(self.shed),
                                 capacity_rps=float(self.capacity_rps),
                                 send_timeout=float(self.send_timeout))
        if self.caps:
            self.server.set_caps_string(str(self.caps))
        # cross-stream continuous batching: a per-model bucket (one per
        # server table id, which pairs exactly one serving pipeline,
        # negotiated caps and model) coalescing admitted frames ACROSS
        # client connections, reusing tensor_filter's bucket core
        # batch=0 and unset both clamp to 1 under max()
        # nnslint: allow(falsy-zero-default)
        self._xbatch = max(1, int(self.batch or 1))
        self._xb_timeout = max(0.0, float(self.batch_timeout_ms or 0)) / 1e3
        self._xb_hold = None          # shape-mismatch holdover frame
        self._xb_last_fill = 0.0
        self._xb_gauges = []
        if self._xbatch > 1:
            from ..elements.filter_elem import CrossStreamBatcher
            from ..obs.metrics import REGISTRY

            self._xb_bucket = CrossStreamBatcher(self._xbatch,
                                                 self._xb_timeout)
            labels = {"port": str(self.server.port)}
            from ..obs.metrics import Gauge

            self._xb_gauges = [
                REGISTRY.register(Gauge(n, dict(labels), fn=f))
                for n, f in (
                    # fill fraction of the last dispatched bucket and
                    # live bucket occupancy: the "is the device seeing
                    # full tiles" evidence the profiler reads
                    ("nns_xbatch_fill", lambda: self._xb_last_fill),
                    ("nns_xbatch_occupancy",
                     lambda: self._xb_bucket.fill))]
            self._m_xb_batched = REGISTRY.counter(
                "nns_xbatch_batched_total", **labels)
            self._m_xb_solo = REGISTRY.counter(
                "nns_xbatch_solo_total", **labels)
            self._m_xb_frames = REGISTRY.counter(
                "nns_xbatch_frames_total", **labels)
        self._mqtt = None
        if str(self.connect_type).lower() == "hybrid":
            # reference HYBRID (tensor_query_serversrc.c via
            # nnstreamer-edge): dest-host/dest-port address the MQTT
            # broker; the server advertises its own data address as a
            # retained record so clients discover it by topic alone
            from .mqtt import MqttClient

            if self.topic in (None, ""):
                raise ValueError(f"{self.name}: connect-type=HYBRID "
                                 "requires topic")
            self._mqtt = MqttClient(str(self.dest_host),
                                    int(self.dest_port),
                                    f"nns-query-srv-{self.name}")
            adv = str(self.advertise_host or self.host)
            self._mqtt.publish(
                f"nns/query/{self.topic}",
                f"{adv}:{self.server.port}".encode(), retain=True)
            # return only once the broker holds the record: a client that
            # subscribes right after start() must find it
            self._mqtt.flush()

    def stop(self):
        if getattr(self, "_xb_gauges", None):
            from ..obs.metrics import REGISTRY

            for g in self._xb_gauges:
                REGISTRY.unregister(g)
            self._xb_gauges = []
        if getattr(self, "_mqtt", None) is not None:
            try:
                # clear the retained record: late clients must see "no
                # record", not a dead address
                self._mqtt.publish(f"nns/query/{self.topic}", b"",
                                   retain=True)
                self._mqtt.flush()   # the broker has cleared it
            except OSError:
                pass
            self._mqtt.close()
            self._mqtt = None
        super().stop()

    @property
    def bound_port(self) -> int:
        return self.server.port

    def health_state(self):
        srv = getattr(self, "server", None)
        if srv is not None and srv.draining:
            return "draining"
        return None

    def drain(self, deadline: float = 5.0) -> None:
        """Pipeline.drain hook: stop admitting (new frames shed with a
        retry-after), finish in-flight replies, close the server, and
        drop it from the server table so a later play() gets a fresh
        one."""
        srv = getattr(self, "server", None)
        if srv is not None:
            srv.drain(deadline)
            shutdown_server(int(self.id))

    def negotiate(self) -> Caps:
        if not self.caps:
            raise ValueError(f"{self.name}: caps property required")
        c = self.caps
        return Caps.from_string(c) if isinstance(c, str) else c

    def _note_admission(self, buf: TensorBuffer,
                        deq_ns: Optional[int] = None) -> TensorBuffer:
        """Convert the server's arrival stamp into a deferred
        admission-wait annotation (emitted by Source._loop at the one
        place the frame's seq is assigned — no shadow counter to keep
        in lockstep.  The T_TRACE piggyback then carves it out of the
        client's wire time)."""
        pl = self.pipeline
        if pl is not None and pl.tracer is not None:
            enq = buf.extra.pop("nns_enq_ns", None)
            if enq is not None and pl.tracer.ring is not None:
                from ..obs.clock import mono_ns

                buf.extra["nns_admission_ns"] = (
                    enq, mono_ns() if deq_ns is None else deq_ns)
        return buf

    def create(self) -> Optional[TensorBuffer]:
        if getattr(self, "_xbatch", 1) > 1:
            return self._create_batched()
        while not self._halted.is_set():
            try:
                buf = self.server.incoming.get(timeout=0.1)
            except _queue.Empty:
                continue
            return self._note_admission(buf)
        return None

    @staticmethod
    def _frame_sig(buf: TensorBuffer):
        return tuple((tuple(t.shape), str(getattr(t, "dtype", "")))
                     for t in buf.tensors)

    def _create_batched(self) -> Optional[TensorBuffer]:
        """Cross-stream bucket collect: block for the first admitted
        frame, then coalesce whatever the client population has queued —
        greedily at ``batch-timeout-ms=0`` (the previous bucket's
        service time is the collect window), or waiting up to the
        residents' QoS-scaled budgets to fill the bucket.  The fill
        TARGET is ``min(batch, connected clients)``: synchronous clients
        hold at most one outstanding frame each, so waiting for more
        than the population can deliver is provably pure latency.

        A drain (``QueryServer.drain``) or pipeline halt flushes the
        partial bucket immediately — resident frames are ADMITTED
        (inflight-counted) and must be dispatched, never dropped; a halt
        first takes in the admitted frames still queued (up to the
        bucket's capacity), which the JAX package drops when the halt
        comes before its bucket thread has dequeued them.
        Frames whose tensor signature differs from the bucket's (flex
        caps) close the bucket and open the next one, preserving
        arrival order."""
        srv = self.server
        bucket = self._xb_bucket
        pl = self.pipeline
        tracer = pl.tracer if pl is not None else None
        rec = tracer is not None and tracer.ring is not None
        mono_ns = None
        if rec:
            from ..obs.clock import mono_ns

        first = self._xb_hold
        self._xb_hold = None
        while first is None:
            halted = self._halted.is_set()
            try:
                first = (srv.incoming.get_nowait() if halted
                         else srv.incoming.get(timeout=0.1))
            except _queue.Empty:
                if halted:
                    return None
        if rec:
            first.extra["nns_deq_ns"] = mono_ns()
        sig = self._frame_sig(first)
        timeout = self._xb_timeout
        bucket.add(first, bucket_budget(first.extra.get("nns_class"),
                                        timeout))
        while not bucket.full() and not srv.draining:
            halted = self._halted.is_set()
            # fill target: never wait for frames the connected-client
            # population cannot have outstanding; a halt waits for none
            # but still takes in the admitted frames already queued
            if not halted and bucket.fill >= min(bucket.capacity,
                                                 max(1, len(srv._clients))):
                break
            wait = 0.0 if halted else min(bucket.remaining(), 0.05)
            try:
                buf = (srv.incoming.get_nowait() if wait <= 0
                       else srv.incoming.get(timeout=wait))
            except _queue.Empty:
                if wait <= 0 or bucket.expired():
                    break
                continue
            if rec:
                buf.extra["nns_deq_ns"] = mono_ns()
            if self._frame_sig(buf) != sig:
                self._xb_hold = buf    # opener of the NEXT bucket
                break
            bucket.add(buf, bucket_budget(buf.extra.get("nns_class"),
                                          timeout))
        bufs = bucket.take()
        n = len(bufs)
        self._xb_last_fill = n / bucket.capacity
        if n == 1:
            self._m_xb_solo.inc()
            solo = bufs[0]
            solo.extra.pop("nns_deq_ns", None)
            return self._note_admission(solo)
        self._m_xb_batched.inc()
        self._m_xb_frames.inc(n)
        # one copy a frame, from the received payload views straight into
        # the bucket's host stack: pinned where the filter it feeds runs on
        # the card, whose copy there is then the stack's only other one
        peer = self.src_pad.peer
        pin = peer is not None and bool(getattr(
            peer.element, "pins_host_input", lambda: False)())
        tensors = [_cuda.stack_host([b.tensors[k] for b in bufs], 0, pin)
                   for k in range(bufs[0].num_tensors)]
        spans = None
        if rec:
            # per-frame residency evidence (obs/attrib.py): arrival →
            # dequeue is admission-wait, dequeue → bucket dispatch is
            # queue-wait.  Deferred to Source._loop (nns_xb_spans) so
            # every span carries the batch buffer's assigned seq; each
            # frame's own trace id routes it to that client's merged
            # timeline via the T_TRACE piggyback.
            disp_ns = mono_ns()
            spans = []
            for b in bufs:
                enq = b.extra.pop("nns_enq_ns", None)
                deq = b.extra.pop("nns_deq_ns", disp_ns)
                ctx = b.extra.get("nns_trace")
                tid = ctx.trace_id if ctx is not None else 0
                if enq is not None:
                    spans.append(("admission-wait", enq, deq, tid))
                spans.append(("queue-wait", deq, disp_ns, tid))
        else:
            for b in bufs:
                b.extra.pop("nns_enq_ns", None)
                b.extra.pop("nns_deq_ns", None)
        out = TensorBuffer(tensors=tensors, pts=bufs[0].pts)
        # the per-frame extras (client id, wire seq, QoS class, trace
        # context) ride the meta to the serversink split; the per-frame
        # pooled slabs release right here
        out.extra["nns_xbatch"] = XBatchMeta(
            [b.extra for b in bufs], [b.pts for b in bufs],
            bucket.capacity)
        if spans:
            out.extra["nns_xb_spans"] = spans
        return out


@register_element
class TensorQueryServerSink(Element):
    """Sends pipeline results back to the originating client."""

    FACTORY = "tensor_query_serversink"
    PROPERTIES = {
        "id": (0, "server table id"),
        "async-replies": (False, "cross-stream batching: move the "
                                 "reply split (host materialization + "
                                 "per-row sends) onto ONE ordered "
                                 "pusher thread so the serving thread "
                                 "collects/dispatches the next bucket "
                                 "meanwhile.  Wins when device dispatch "
                                 "is truly asynchronous (accelerators); "
                                 "on small CPU hosts the two threads "
                                 "contend for the same cores and "
                                 "latency suffers — hence opt-in"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")

    def start(self):
        # LAZY lookup: creating the server here would race the paired
        # serversrc's start — if the sink started first, its bare
        # get_server(id) would create the server with DEFAULT overload
        # settings and silently discard the src's queue-depth / shed /
        # capacity-rps / send-timeout properties.  Buffers only reach
        # chain() after the src produced them, so by first use the
        # src-configured server exists.
        self.server = None
        # async reply worker (opt-in via async-replies, spawned at the
        # first cross-stream batch buffer): the reply split (host
        # materialization, the device sync; per-row framing; N socket
        # sends) moves off the serving thread onto ONE ordered pusher
        # (strict FIFO, so per-client seq order is untouched).  The
        # serving thread is then free to collect and
        # dispatch bucket k+1 while the device computes bucket k and
        # the pusher answers bucket k-1 — the stages overlap instead of
        # serializing into one long cycle.  Depth 1 (double buffering):
        # one bucket being answered while one is collected/dispatched —
        # deeper queues stack concurrent device executions, which
        # oversubscribes the backend's intra-op pool and inflates
        # latency without adding throughput.
        self._rq: Optional[_queue.Queue] = None
        self._rthread: Optional[threading.Thread] = None

    def stop(self):
        self._stop_reply_worker()
        super().stop()

    def _start_reply_worker(self) -> None:
        self._rq = _queue.Queue(maxsize=1)
        self._rthread = threading.Thread(
            target=self._reply_loop, daemon=True,
            name=f"reply-push:{self.name}")
        self._rthread.start()

    def _stop_reply_worker(self) -> None:
        rq, self._rq = self._rq, None
        if rq is not None:
            rq.put(None)
            if self._rthread is not None:
                self._rthread.join(timeout=10)
                self._rthread = None

    def _reply_loop(self) -> None:
        # the loop's own reference: _stop_reply_worker clears self._rq
        # before its sentinel arrives here (the JAX package's loop reads
        # self._rq after it and dies with an AttributeError at stop)
        rq = self._rq
        while True:
            buf = rq.get()
            try:
                if buf is None:
                    return
                xb = buf.extra.get("nns_xbatch")
                if xb is None:
                    self.server.reply(buf)
                else:
                    self._reply_batch(self.server, buf, xb)
            finally:
                rq.task_done()

    def set_caps(self, pad, caps):
        pass

    def chain(self, pad, buf):
        server = self.server
        if server is None:
            server = self.server = get_server(int(self.id))
        # publish the serving pipeline's tracer (one attr store per
        # reply): when it records spans, QueryServer.reply piggybacks
        # them to the requesting client as T_TRACE
        server.obs_tracer = (self.pipeline.tracer
                             if self.pipeline is not None else None)
        xb = buf.extra.get("nns_xbatch")
        if xb is not None and self._rq is None \
                and parse_bool(self.async_replies):
            self._start_reply_worker()
        if self._rq is not None:
            # once the worker exists EVERY buffer rides it (a solo
            # frame jumping the queue would answer ahead of an earlier
            # bucket's rows); chain() was serial before the switch, so
            # order across the transition holds too
            self._rq.put(buf)
            return FlowReturn.OK
        if xb is None:
            server.reply(buf)
            return FlowReturn.OK
        self._reply_batch(server, buf, xb)
        return FlowReturn.OK

    def _reply_batch(self, server, buf: TensorBuffer, xb) -> None:
        """Split a cross-stream batch back into per-client replies, in
        bucket (= per-client arrival) order — exact per-client seq order
        by construction: one serving thread collects, dispatches and
        splits, so client *c*'s row *i* is always answered before its
        row *i+1*.  Padding rows (``>= xb.n``, partial-bucket padded
        invokes) are never replied."""
        tracer = server.obs_tracer
        rec = tracer is not None and getattr(tracer, "ring", None) \
            is not None
        t0 = 0
        if rec:
            import time as _time

            t0 = _time.monotonic_ns()
        # the bucket's outputs leave the card ONCE: one pinned copy an
        # output and one sync for the bucket; the rows are zero-copy
        # views of host memory, so the replies make no further copy
        mats = start_output_transfers(buf.tensors).wait()
        if rec:
            import time as _time

            t1 = _time.monotonic_ns()
            seq = buf.extra.get("nns_seq", -1)
            for extra in xb.extras:
                ctx = extra.get("nns_trace")
                if ctx is not None and ctx.trace_id:
                    tracer.annotate_span("device-invoke", t0, t1,
                                         seq=seq, trace_id=ctx.trace_id)
        for i in range(xb.n):
            frame = TensorBuffer(tensors=[m[i] for m in mats],
                                 pts=xb.pts[i], extra=xb.extras[i])
            server.reply(frame)

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            rq = self._rq
            if rq is not None:
                # every queued reply precedes EOS: admitted frames must
                # be ANSWERED, and drain's inflight accounting only
                # converges once the pusher has sent them
                rq.join()
            self.post_eos_reached()
