"""Edge pub/sub: topic-based tensor stream bridging between pipelines/hosts.

Parity with the reference's edge elements (gst/edge/edge_sink.c /
edge_src.c over libnnstreamer-edge: create handle / set_info(HOST, PORT,
TOPIC, CAPS) / start / connect / send, SURVEY.md §2.7) and the broker role
of its MQTT path — but self-contained: :class:`EdgeBroker` is an in-process
TCP broker (no external mosquitto), and pub/sub frames reuse the query wire
protocol with the topic carried in HELLO.

A publisher pipeline ends in ``edge_sink``; subscriber pipelines start with
``edge_src`` pointed at the same broker host/port/topic.

The port of ``nnstreamer_tpu/query/edge.py``.  Its frames are the query
wire's, so either package's sinks publish to the other's brokers and
srcs.  The broker table (:func:`get_broker`) is the port's own.
"""

from __future__ import annotations

import queue as _queue
import socket
import threading
from typing import Dict, Optional, Set

from ..analysis.sanitizer import make_lock
from ..pipeline.caps import Caps
from ..pipeline.element import Element, EOSEvent, FlowReturn
from ..pipeline.graph import Source
from ..pipeline.registry import (register_element,
                                 register_element_alias)
from ..tensor.buffer import TensorBuffer, default_pool
from ..tensor.caps_util import tensors_template_caps
from .protocol import (Message, T_BYE, T_DATA, T_HELLO, T_PING, T_PONG,
                       decode_tensors, recv_msg, send_msg, send_msg_zc,
                       send_tensors, shutdown_close)
from .protocol import create_connection as checked_connect
from .resilience import STATS, RetryExhausted, RetryPolicy

#: default reconnect policy for edge pub/sub when the ``retry`` property
#: is unset: the backoff must span a plausible broker restart (seconds),
#: not just a transient send error — parse(None)'s generic 4x50ms-base
#: window (~0.35 s of sleep) would give up before a restarted broker is
#: back, defeating the documented restart survival
_EDGE_RETRY_DEFAULT = RetryPolicy(max_attempts=10, base_delay=0.1,
                                  max_delay=1.0, deadline=10.0)


def _edge_retry(spec) -> RetryPolicy:
    if spec in (None, ""):
        return _EDGE_RETRY_DEFAULT
    return RetryPolicy.parse(spec)


class EdgeBroker:
    """Topic broker: HELLO payload = ``pub:<topic>[|caps]`` or
    ``sub:<topic>``; DATA from publishers fan out to all matching
    subscribers."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._sock.listen(32)
        self._subs: Dict[str, Set[socket.socket]] = {}
        self._conns: Set[socket.socket] = set()
        self._topic_caps: Dict[str, str] = {}
        # per-subscriber-socket send locks: concurrent publishers must not
        # interleave partial frames on one subscriber stream
        self._send_locks: Dict[socket.socket, threading.Lock] = {}
        self._lock = make_lock("query.registry")
        self._stop = threading.Event()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="edge-broker").start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._conns.add(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True).start()

    def _conn_loop(self, conn: socket.socket) -> None:
        role, topic = None, None
        pool = default_pool()
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn, pool=pool)
                except ValueError:   # bad magic / CRC: drop the connection
                    break
                if msg is None or msg.type == T_BYE:
                    break
                if msg.type == T_HELLO:
                    spec = msg.payload.decode()
                    role, _, rest = spec.partition(":")
                    topic, _, caps = rest.partition("|")
                    if role == "sub":
                        with self._lock:
                            self._subs.setdefault(topic, set()).add(conn)
                            slock = self._send_locks[conn] = \
                                make_lock("query.send")
                            retained = self._topic_caps.get(topic, "")
                            # Take this conn's send lock before releasing the
                            # broker lock: a publisher recording new caps B
                            # snapshots subscribers under the broker lock and
                            # then needs this send lock, so it cannot overtake
                            # the retained send — the subscriber always sees
                            # retained-then-B.  The broker lock itself is NOT
                            # held across send_msg: a subscriber with a full
                            # TCP send buffer stalls only its own stream, not
                            # every topic/publisher.
                            if retained:
                                slock.acquire()
                        if retained:
                            try:
                                send_msg(conn, Message(
                                    T_HELLO, payload=retained.encode()))
                            except OSError:
                                break
                            finally:
                                slock.release()
                    elif role == "pub" and caps:
                        with self._lock:
                            self._topic_caps[topic] = caps
                        # push caps to subscribers that arrived first
                        # (MQTT retained-message semantics; closes the
                        # sub-before-pub startup race)
                        self._fanout(topic, Message(T_HELLO,
                                                    payload=caps.encode()))
                elif msg.type == T_PING:
                    # liveness heartbeat: echo seq+payload as PONG (under
                    # the subscriber's send lock so the reply never
                    # interleaves with a fanout frame)
                    with self._lock:
                        slock = self._send_locks.get(conn)
                    # pong wall-clock stamp = unbiased offset sample for
                    # the peer (query/server.py does the same)
                    from ..obs.clock import wall_us

                    pong = Message(T_PONG, seq=msg.seq,
                                   epoch_us=wall_us(),
                                   payload=msg.payload)
                    if slock is None:
                        send_msg(conn, pong)
                    else:
                        with slock:
                            send_msg(conn, pong)
                elif msg.type == T_DATA and role == "pub":
                    self._fanout(topic, msg)
                    if msg.lease is not None:
                        # fan-out copies nothing and keeps no views:
                        # drop the payload view, then release so the
                        # slab recycles for the next recv
                        msg.payload = b""
                        msg.lease.release()
                        msg.lease = None
        finally:
            with self._lock:
                if role == "sub" and topic is not None:
                    self._subs.get(topic, set()).discard(conn)
                    self._send_locks.pop(conn, None)
                self._conns.discard(conn)
            conn.close()

    def _fanout(self, topic: str, msg: Message) -> None:
        with self._lock:
            subs = [(s, self._send_locks.get(s)) for s in
                    self._subs.get(topic, ())]
        for s, slock in subs:
            try:
                # zero-copy relay: header + received payload view as one
                # sendmsg iovec (no pack() flattening per subscriber)
                if slock is None:
                    send_msg_zc(s, msg)
                else:
                    with slock:
                        send_msg_zc(s, msg)
            except OSError:
                with self._lock:
                    self._subs.get(topic, set()).discard(s)
                    self._send_locks.pop(s, None)

    def close(self) -> None:
        """Stop the listener AND drop every live connection: a broker
        "kill" must look like one to its peers immediately (their reads
        see EOF and the publisher/subscriber reconnect paths kick in)
        instead of leaving half-dead links blocked in recv."""
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            # shutdown-then-close: a plain close of a socket another
            # thread is blocked reading sends no FIN, so peers would
            # never notice the kill AND the dead conns would keep
            # squatting on the listener's port (protocol.py)
            shutdown_close(c)


_BROKERS: Dict[int, EdgeBroker] = {}
_BROKERS_LOCK = make_lock("leaf")


def get_broker(port: int = 0, host: str = "127.0.0.1") -> EdgeBroker:
    """Start (or reuse) an in-process broker."""
    with _BROKERS_LOCK:
        if port and port in _BROKERS:
            return _BROKERS[port]
        broker = EdgeBroker(host, port)
        _BROKERS[broker.port] = broker
        return broker


def shutdown_brokers() -> None:
    with _BROKERS_LOCK:
        for b in _BROKERS.values():
            b.close()
        _BROKERS.clear()



def _resolve_reference_dest(el) -> str:
    """Reference addressing (edge_sink.c/edge_src.c): dest-host/
    dest-port name the broker the element connects to — the TCP data
    broker for connect-type=TCP, the MQTT broker for HYBRID — and the
    connect-type nick is spelled UPPER-case in every ssat line.  Maps
    dest-* onto the canonical host/port or mqtt-host/mqtt-port pair
    and returns the normalized connect type ('aitt' is the dropped
    Tizen-only transport: a named error, not a silent TCP fallback)."""
    ctype = str(el.connect_type or "tcp").strip().lower()
    if ctype == "aitt":
        raise ValueError(
            f"{el.name}: connect-type=AITT is the Tizen-only transport "
            "this framework drops — use TCP or HYBRID")
    if not (el.dest_port in (None, "", 0) and el.dest_host in (None, "")):
        host = str(el.dest_host or "127.0.0.1")
        port = el.dest_port
        if ctype == "hybrid":
            # dest-* is the MQTT broker; its well-known port is the
            # default when only dest-host was given
            el.mqtt_host = host
            el.mqtt_port = int(port) if port not in (None, "", 0) else 1883
        else:
            if port in (None, "", 0):
                # a silent port-0 connect would be an opaque OSError on
                # the wrong machine (same guard as tensor_query_client)
                raise ValueError(f"{el.name}: dest-host={host!r} needs "
                                 "dest-port")
            el.host = host
            el.port = int(port)
    return ctype


@register_element
class EdgeSink(Element):
    """Publish the stream to a broker topic (edge_sink role).

    ``connect-type`` mirrors libnnstreamer-edge's transports
    (tensor_query_common.h:33-34): ``tcp`` (default) talks straight to
    the TCP broker; ``hybrid`` additionally advertises the broker's
    ``host:port`` as a RETAINED MQTT message on ``nns/edge/<topic>`` so
    subscribers discover the data channel via the MQTT broker and then
    stream over TCP — the reference's MQTT-hybrid control/data split
    (Documentation/component-description.md:158-163)."""

    FACTORY = "edge_sink"
    PROPERTIES = {
        "host": ("127.0.0.1", "broker host"),
        "port": (0, "broker port"),
        "topic": ("default", ""),
        "connect-type": ("tcp", "tcp | hybrid (MQTT discovery + TCP data)"),
        "mqtt-host": ("127.0.0.1", "MQTT broker host (connect-type=hybrid)"),
        "mqtt-port": (1883, "MQTT broker port (connect-type=hybrid)"),
        "advertise-host": (None, "externally reachable address published "
                                 "in the hybrid discovery record (default: "
                                 "the host property — loopback only "
                                 "reaches same-host subscribers)"),
        "dest-host": (None, "reference addressing: the TCP broker "
                            "(connect-type=TCP) or the MQTT broker "
                            "(HYBRID) — resolves onto host/mqtt-host "
                            "at start"),
        "dest-port": (None, "reference addressing: broker port"),
        "ntp-host": (None, "NTP server(s) for epoch alignment, comma-sep "
                           "(default: local wall clock)"),
        "retry": (None, "reconnect policy spec 'attempts=4,base=0.05,"
                        "cap=0.5,…' applied when a publish send fails "
                        "(broker restart survival)"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")

    def start(self):
        from ..utils.ntp import stream_origin_epoch_us

        self._ctype = _resolve_reference_dest(self)
        self._retry = _edge_retry(self.retry)
        if self._ctype == "hybrid" and int(self.port or 0) == 0:
            # verbatim reference HYBRID sink lines configure ONLY the
            # MQTT broker (dest-*): there the sink itself is the data
            # endpoint, so with no data broker configured start an
            # in-process one and advertise it — subscribers discover
            # whatever address the record carries either way
            broker = get_broker()
            self.host, self.port = broker.host, broker.port
        self._caps_str: Optional[str] = None
        self._caps_sent = False
        self._dial_broker()
        # stream-origin epoch: wall clock (NTP-aligned when ntp-host set) at
        # start, when running-time 0 ≈ now — the reference mqttsink's
        # base_time_epoch (mqttsink.c, synchronization-in-mqtt-elements.md)
        self._base_epoch_us = stream_origin_epoch_us(self.ntp_host, self.name)
        self._mqtt = None
        if self._ctype == "hybrid":
            from .mqtt import MqttClient

            self._mqtt = MqttClient(str(self.mqtt_host),
                                    int(self.mqtt_port),
                                    f"nns-edge-sink-{self.name}",
                                    publish_only=True)
            adv = str(self.advertise_host or self.host)
            self._mqtt.publish(
                f"nns/edge/{self.topic}",
                f"{adv}:{int(self.port)}".encode(), retain=True)

    def stop(self):
        if self._mqtt is not None:
            try:
                # clear the retained discovery record so late subscribers
                # get the clean "no record" error, not a dead address
                self._mqtt.publish(f"nns/edge/{self.topic}", b"",
                                   retain=True)
            except OSError:
                pass
            self._mqtt.close()
        try:
            send_msg(self._sock, Message(T_BYE))
            self._sock.close()
        except OSError:
            pass

    def _dial_broker(self) -> None:
        """(Re)connect to the broker and re-announce the pub role (+caps
        when already negotiated, restoring the retained record a
        restarted broker lost)."""
        old = getattr(self, "_sock", None)
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        self._sock = checked_connect(
            (str(self.host), int(self.port)), timeout=10)
        # publisher sockets only SEND: keep a bounded (long) send timeout
        # so a wedged broker/subscriber surfaces as a pipeline error
        # instead of hanging chain() forever (a timed-out partial send
        # would desync the stream, but the error tears the connection
        # down anyway)
        self._sock.settimeout(30.0)
        if self._caps_str is not None:
            send_msg(self._sock, Message(T_HELLO, payload=(
                f"pub:{self.topic}|{self._caps_str}").encode()))
            self._caps_sent = True
        elif self._caps_sent:
            send_msg(self._sock, Message(
                T_HELLO, payload=f"pub:{self.topic}".encode()))

    def _send_resilient(self, msg: Message) -> None:
        self._send_resilient_fn(lambda sock: send_msg(sock, msg))

    def _send_resilient_fn(self, send_fn) -> None:
        """Send via ``send_fn(sock)``, reconnecting with backoff on
        failure (satellite fix: a publisher socket used to die
        permanently on the first send error — one broker restart killed
        the pipeline)."""
        try:
            send_fn(self._sock)
            return
        except OSError:
            STATS.incr("edge.send_failures")

        def _redial_and_send():
            self._dial_broker()
            send_fn(self._sock)
            STATS.incr("edge.pub_reconnects")

        try:
            self._retry.run(_redial_and_send,
                            retry_on=(OSError, ConnectionError),
                            counter="edge.reconnect")
        except RetryExhausted as exc:
            raise ConnectionError(
                f"{self.name}: cannot republish to broker "
                f"{self.host}:{self.port}: {exc.__cause__!r}") from exc

    def set_caps(self, pad, caps):
        self._caps_str = str(caps)
        self._send_resilient(Message(T_HELLO, payload=(
            f"pub:{self.topic}|{caps}").encode()))
        self._caps_sent = True

    def chain(self, pad, buf):
        if not self._caps_sent:
            self._send_resilient(Message(
                T_HELLO, payload=f"pub:{self.topic}".encode()))
            self._caps_sent = True
        # trace propagation (obs/span.py): the publisher's trace context
        # rides the rev-4 header so subscriber-side spans join the trace
        from ..obs.span import TraceContext

        ctx = buf.extra.get("nns_trace") or TraceContext()
        # scatter-gather publish: tensor views go straight to sendmsg
        self._send_resilient_fn(
            lambda sock: send_tensors(sock, T_DATA, buf,
                                      pts=buf.pts or 0,
                                      epoch_us=self._base_epoch_us,
                                      trace_id=ctx.trace_id,
                                      span_id=ctx.span_id,
                                      origin_us=ctx.origin_us))
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            self.post_eos_reached()


@register_element
class EdgeSrc(Source):
    """Subscribe to a broker topic (edge_src role).

    ``connect-type=hybrid`` discovers the TCP broker's address from the
    RETAINED MQTT record a hybrid edge_sink published on
    ``nns/edge/<topic>`` — the subscriber then needs only the MQTT
    broker's address (the reference's MQTT-hybrid discovery)."""

    FACTORY = "edge_src"
    PROPERTIES = {
        "host": ("127.0.0.1", "broker host"),
        "port": (0, "broker port"),
        "topic": ("default", ""),
        "connect-type": ("tcp", "tcp | hybrid (MQTT discovery + TCP data)"),
        "mqtt-host": ("127.0.0.1", "MQTT broker host (connect-type=hybrid)"),
        "mqtt-port": (1883, "MQTT broker port (connect-type=hybrid)"),
        "dest-host": (None, "reference addressing: the TCP broker "
                            "(connect-type=TCP) or the MQTT broker "
                            "(HYBRID)"),
        "dest-port": (None, "reference addressing: broker port"),
        "caps": (None, "override caps (else retained topic caps)"),
        "num-buffers": (-1, "stop after N buffers, -1 unlimited"),
        "sync-pts": (False, "re-base incoming PTS onto this host's clock "
                            "using the sender's embedded epoch"),
        "ntp-host": (None, "NTP server(s) for epoch alignment, comma-sep"),
        "retry": (None, "reconnect policy spec 'attempts=4,base=0.05,"
                        "cap=0.5,…' applied when the broker link drops "
                        "(resubscribe after broker restart)"),
    }

    def _make_pads(self):
        self.add_src_pad(tensors_template_caps(), "src")

    def _discover_hybrid(self) -> None:
        """Resolve host/port from the retained MQTT discovery record
        (bounded wait mirroring the TCP path's 10 s connect timeout)."""
        from .mqtt import fetch_retained_record

        record = fetch_retained_record(
            str(self.mqtt_host), int(self.mqtt_port),
            f"nns/edge/{self.topic}", 10.0, f"nns-edge-src-{self.name}")
        if not record:
            raise ValueError(
                f"{self.name}: no retained discovery record on "
                f"nns/edge/{self.topic}")
        host, sep, port = record.decode().rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(f"{self.name}: malformed discovery record "
                             f"{record!r} (want host:port)")
        self.host, self.port = host, int(port)

    def start(self):
        from ..utils.ntp import stream_origin_epoch_us

        self._ctype = _resolve_reference_dest(self)
        self._retry = _edge_retry(self.retry)
        self._closing = False
        # own stream-origin epoch, for re-basing sender PTS (the receiver
        # half of the reference's NTP-based mqtt timestamp alignment)
        self._base_epoch_us = stream_origin_epoch_us(self.ntp_host, self.name)
        if self._ctype == "hybrid":
            self._discover_hybrid()
        self._sock = None
        self._subscribe()
        # paced by the broker's TCP stream and drained every create();
        # bounding needs a stop-cancellable put in the reader thread —
        # the serving-plane admission story (query/overload.py) covers
        # the query path, pub/sub keeps QoS-0 semantics for now
        # nnslint: allow(unbounded-queue)
        self._fifo: _queue.Queue = _queue.Queue()
        self._retained_caps: Optional[str] = None
        self._caps_evt = threading.Event()
        self._count = 0
        threading.Thread(target=self._read_loop, daemon=True,
                         name=f"edge-src:{self.name}").start()

    class _Closing(Exception):
        """Teardown raced a resubscribe: abort the retry loop (not an
        OSError, so RetryPolicy.run doesn't keep dialing)."""

    def _subscribe(self) -> None:
        """Dial the broker and announce the sub role (used at start and
        after a broker restart — the retained topic caps are redelivered
        on the new link, so a resubscribed source keeps streaming)."""
        if self._closing:
            raise EdgeSrc._Closing()
        old = self._sock
        if old is not None:
            try:
                old.close()
            except OSError:
                pass
        sock = checked_connect(
            (str(self.host), int(self.port)), timeout=10)
        # the connect timeout must NOT persist as an idle-read timeout: a
        # subscriber legitimately sits idle until the first publish (e.g.
        # while a downstream model compiles), and _recv_exact would treat
        # the timeout as EOF, silently killing the subscription — the
        # round-2 edge-bench deadline failure
        sock.settimeout(None)
        send_msg(sock, Message(T_HELLO,
                               payload=f"sub:{self.topic}".encode()))
        self._sock = sock
        if self._closing:
            # stop() may have closed the OLD socket while we dialed; it
            # must not leave this fresh one (and a reader blocked on it)
            shutdown_close(sock)
            raise EdgeSrc._Closing()

    def stop(self):
        self._closing = True
        # shutdown-then-close wakes the read loop blocked in recv
        # (protocol.py) so teardown doesn't leak a subscriber thread
        shutdown_close(self._sock)
        super()._halt()

    def _read_loop(self) -> None:
        pool = default_pool()
        while True:
            try:
                msg = recv_msg(self._sock, pool=pool)
            except ValueError as e:   # bad magic / CRC: stream corrupt
                from ..utils.log import logger

                logger.error("edge src %s: corrupt stream: %s",
                             self.name, e)
                msg = None
            if msg is None:
                # link dropped: resubscribe with backoff unless this is
                # element teardown (broker-restart survival; the broker
                # pushes the retained caps again once a publisher
                # re-announces them)
                if not self._closing and not self._halted.is_set():
                    try:
                        self._retry.run(self._subscribe,
                                        retry_on=(OSError,
                                                  ConnectionError),
                                        counter="edge.resubscribe")
                        STATS.incr("edge.resubscribes")
                        continue
                    except EdgeSrc._Closing:
                        pass   # teardown raced the redial
                    except RetryExhausted as e:
                        from ..utils.log import logger

                        logger.error("edge src %s: broker gone, giving "
                                     "up: %s", self.name, e)
                self._fifo.put(None)
                return
            if msg.type == T_HELLO:
                if msg.payload:
                    self._retained_caps = msg.payload.decode()
                    self._caps_evt.set()
            elif msg.type == T_DATA:
                pts = msg.pts
                if self.sync_pts and msg.epoch_us:
                    # sender running-time → this host's running time:
                    # shift by the epoch difference (µs → ns)
                    pts = msg.pts + (msg.epoch_us - self._base_epoch_us) * 1000
                buf = TensorBuffer(tensors=decode_tensors(msg.payload),
                                   pts=pts, lease=msg.lease)
                if msg.trace_id:
                    from ..obs.span import TraceContext

                    buf.extra["nns_trace"] = TraceContext(
                        msg.trace_id, msg.span_id, msg.origin_us)
                self._fifo.put(buf)

    def negotiate(self) -> Caps:
        if self.caps:
            c = self.caps
            return Caps.from_string(c) if isinstance(c, str) else c
        self._caps_evt.wait(timeout=10)
        if self._retained_caps:
            return Caps.from_string(self._retained_caps)
        raise ValueError(f"{self.name}: no caps known for topic "
                         f"{self.topic!r}; set the caps property")

    def create(self) -> Optional[TensorBuffer]:
        n = int(self.num_buffers)
        if n >= 0 and self._count >= n:
            return None
        while not self._halted.is_set():
            try:
                item = self._fifo.get(timeout=0.1)
            except _queue.Empty:
                continue
            if item is not None:
                self._count += 1
            return item
        return None


# the reference registers these factories WITHOUT the underscore
# (gst/edge/edge_elements.c) — verbatim reference launch lines use
# `edgesink`/`edgesrc`
register_element_alias("edgesink", EdgeSink)
register_element_alias("edgesrc", EdgeSrc)
