"""MQTT pub/sub elements: broker-based loose coupling between pipelines.

Parity with the reference's mqttsink/mqttsrc (gst/mqtt/mqttsink.c,
mqttsrc.c over paho MQTTAsync):

- **Protocol**: a from-scratch MQTT 3.1.1 client (CONNECT/CONNACK,
  QoS-0 PUBLISH, SUBSCRIBE/SUBACK, PINGREQ, DISCONNECT) speaking the
  standard wire format, so it interoperates with any external broker
  (mosquitto etc.) exactly like the reference's paho link — this image
  ships neither paho nor a broker, so the protocol layer is in-tree and
  :class:`MqttBroker` provides the localhost broker the reference's
  tests gate on (tests/check_broker.sh).
- **Message layout**: the reference's 1024-byte ``GstMQTTMessageHdr``
  (mqttcommon.h:29-61) prepended to the concatenated memory blocks:
  num_mems + 16 memory sizes + base/sent NTP-epoch times (µs) + duration/
  dts/pts + a 512-byte caps string, zero-padded to 1024 bytes.
- **Timestamp sync**: base_time_epoch embeds the publisher's stream-origin
  wall clock (NTP-aligned when ``ntp-host`` is set); ``mqttsrc
  sync-pts=true`` re-bases incoming PTS onto the subscriber's clock
  (Documentation/synchronization-in-mqtt-elements.md).

The port of ``nnstreamer_tpu/query/mqtt.py``: the same MQTT packets and
header bytes, so either package's clients use the other's broker.  On the
card ``mqttsink`` brings each tensor to the host with ``buf.np(i)`` (one
sync a tensor) before it frames the message.  The broker table
(:func:`get_mqtt_broker`) is the port's own.
"""

from __future__ import annotations

import queue as _queue
import socket
import struct
import threading
import time
from fractions import Fraction
from typing import Dict, List, Optional, Set

import numpy as np

from ..analysis.sanitizer import make_lock
from ..pipeline.caps import Caps
from ..pipeline.element import Element, EOSEvent, FlowReturn
from ..pipeline.graph import Source
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..tensor.caps_util import (caps_from_config, config_from_caps,
                                tensors_template_caps)
from ..utils.log import logger

# -- GstMQTTMessageHdr (mqttcommon.h:29-61) ---------------------------------
HDR_LEN = 1024                 # GST_MQTT_LEN_MSG_HDR
MAX_CAPS_LEN = 512             # GST_MQTT_MAX_LEN_GST_CAPS_STR
MAX_NUM_MEMS = 16              # GST_MQTT_MAX_NUM_MEMS
CLOCK_NONE = (1 << 64) - 1     # GST_CLOCK_TIME_NONE
# natural C alignment: u32 num_mems, 4 pad, 16*u64 sizes, 2*i64 epochs,
# 3*u64 clock times, 512 caps chars; zero-padded to 1024
_HDR_FMT = "<I4x16QqqQQQ512s"
_HDR_PAD = HDR_LEN - struct.calcsize(_HDR_FMT)


def pack_header(sizes: List[int], base_epoch_us: int, sent_epoch_us: int,
                duration: Optional[int], dts: Optional[int],
                pts: Optional[int], caps_str: str, ctx=None) -> bytes:
    if len(sizes) > MAX_NUM_MEMS:
        raise ValueError(f"mqtt: {len(sizes)} memories > {MAX_NUM_MEMS}")
    caps_b = caps_str.encode()
    if len(caps_b) >= MAX_CAPS_LEN:
        raise ValueError(f"mqtt: caps string {len(caps_b)}B >= "
                         f"{MAX_CAPS_LEN}B limit (mqttcommon.h)")
    padded = list(sizes) + [0] * (MAX_NUM_MEMS - len(sizes))
    hdr = struct.pack(_HDR_FMT, len(sizes), *padded,
                      base_epoch_us, sent_epoch_us,
                      CLOCK_NONE if duration is None else duration,
                      CLOCK_NONE if dts is None else dts,
                      CLOCK_NONE if pts is None else pts, caps_b)
    if ctx is not None and ctx.trace_id:
        # trace context rides the zero-pad region after the reference
        # fields (obs/span.py trailer blob, self-identifying by magic):
        # a context-unaware reference peer sees it as padding
        from ..obs.span import pack_ctx_trailer

        blob = pack_ctx_trailer(ctx)
        return hdr + blob + b"\x00" * (_HDR_PAD - len(blob))
    return hdr + b"\x00" * _HDR_PAD


def header_trace_ctx(blob: bytes):
    """Trace context stashed in the header's pad region by
    :func:`pack_header`, or None (reference-compatible zero padding)."""
    from ..obs.span import TRAILER_SIZE, unpack_ctx_trailer

    base = struct.calcsize(_HDR_FMT)
    if len(blob) < base + TRAILER_SIZE:
        return None
    return unpack_ctx_trailer(blob, base + TRAILER_SIZE)


def unpack_header(blob: bytes):
    vals = struct.unpack_from(_HDR_FMT, blob)
    num = vals[0]
    sizes = list(vals[1:1 + MAX_NUM_MEMS])[:num]
    base_us, sent_us, duration, dts, pts = vals[17:22]
    caps_str = vals[22].split(b"\x00", 1)[0].decode(errors="replace")
    none = lambda v: None if v == CLOCK_NONE else v  # noqa: E731
    return (sizes, base_us, sent_us, none(duration), none(dts), none(pts),
            caps_str)


# -- minimal MQTT 3.1.1 wire ------------------------------------------------

def _remaining_len(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n % 128
        n //= 128
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _read_packet(sock: socket.socket):
    """Returns (packet_type, payload bytes) or None on EOF."""
    h = sock.recv(1)
    if not h:
        return None
    ptype = h[0]
    mult, n = 1, 0
    while True:
        b = sock.recv(1)
        if not b:
            return None
        n += (b[0] & 0x7F) * mult
        if not b[0] & 0x80:
            break
        mult *= 128
    data = b""
    while len(data) < n:
        chunk = sock.recv(n - len(data))
        if not chunk:
            return None
        data += chunk
    return ptype, data


def _mqtt_str(s: str) -> bytes:
    b = s.encode()
    return struct.pack(">H", len(b)) + b


class MqttClient:
    """Blocking MQTT 3.1.1 client, QoS 0 (the reference publishes QoS-0
    data frames the same way).

    ``keepalive`` (seconds) is a REAL keepalive: it is declared in
    CONNECT (so a spec-conforming broker may drop us at 1.5× silence)
    and honored by a background pinger sending PINGREQ every
    ``keepalive/2`` seconds — the liveness role the reference delegates
    to paho's keepAliveInterval (mqttsink.c).  0 disables both (the old
    behavior, still used by one-shot discovery reads)."""

    def __init__(self, host: str, port: int, client_id: str,
                 timeout: float = 5.0, keepalive: int = 30,
                 publish_only: bool = False) -> None:
        self._publish_only = bool(publish_only)
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(timeout)
        self.keepalive = max(0, int(keepalive))
        var = (_mqtt_str("MQTT") + bytes([4])    # protocol level 3.1.1
               + bytes([0x02])                   # clean session
               + struct.pack(">H", self.keepalive))
        payload = _mqtt_str(client_id)
        pkt = bytes([0x10]) + _remaining_len(len(var) + len(payload)) \
            + var + payload
        self._sock.sendall(pkt)
        resp = _read_packet(self._sock)
        if resp is None or resp[0] >> 4 != 2 or resp[1][1] != 0:
            raise ConnectionError(f"mqtt: CONNACK refused: {resp}")
        self._sock.settimeout(None)
        self._pid = 0
        self._lock = make_lock("query.send")   # one writer at a time on
        #                                        the broker stream
        self._early: List = []   # PUBLISHes delivered before SUBACK
        self._closed = False
        self._ping_stop = threading.Event()
        self.pings_sent = 0
        if self.keepalive:
            threading.Thread(target=self._ping_loop, daemon=True,
                             name=f"mqtt-keepalive:{client_id}").start()

    def _ping_loop(self) -> None:
        # half the declared interval keeps us safely inside the broker's
        # 1.5×-keepalive disconnect window even if one PINGREQ is lost
        while not self._ping_stop.wait(self.keepalive / 2.0):
            try:
                with self._lock:
                    self._sock.sendall(bytes([0xC0, 0]))  # PINGREQ
                self.pings_sent += 1
                if self._publish_only:
                    self._drain_unread()
            except OSError:
                return   # link gone; reader surfaces the disconnect

    def _drain_unread(self) -> None:
        """Discard pending inbound bytes (PINGRESPs and stray packets) on
        a publish-only link: nothing else ever reads this socket, so
        without this the receive buffer eventually fills and the broker's
        send side wedges.  Never used when a reader consumes the stream —
        the two would steal each other's bytes."""
        import select

        while True:
            r, _, _ = select.select([self._sock], [], [], 0)
            if not r:
                return
            try:
                if not self._sock.recv(4096):
                    return   # EOF: the ping send will surface the close
            except OSError:
                return

    @staticmethod
    def _split_publish(ptype: int, data: bytes):
        """(topic, packet_id|None, payload) of a PUBLISH packet — QoS>0
        carries a 2-byte packet id between topic and payload."""
        qos = (ptype >> 1) & 3
        tlen = struct.unpack(">H", data[:2])[0]
        topic = data[2:2 + tlen].decode()
        off = 2 + tlen
        pid = None
        if qos:
            pid = struct.unpack(">H", data[off:off + 2])[0]
            off += 2
        return topic, pid, data[off:]

    def publish(self, topic: str, payload: bytes,
                retain: bool = False) -> None:
        var = _mqtt_str(topic)   # QoS 0: no packet id
        with self._lock:
            self._sock.sendall(bytes([0x31 if retain else 0x30])
                               + _remaining_len(len(var) + len(payload))
                               + var + payload)

    def subscribe(self, topic: str) -> None:
        self._pid += 1
        var = struct.pack(">H", self._pid)
        payload = _mqtt_str(topic) + bytes([0])  # requested QoS 0
        with self._lock:
            self._sock.sendall(bytes([0x82])
                               + _remaining_len(len(var) + len(payload))
                               + var + payload)
        # the broker may deliver matching (e.g. retained) PUBLISHes before
        # the SUBACK — buffer them for recv_publish instead of failing
        while True:
            resp = _read_packet(self._sock)
            if resp is None:
                raise ConnectionError("mqtt: connection lost before SUBACK")
            if resp[0] >> 4 == 9:
                return
            if resp[0] >> 4 == 3:
                topic_, _pid, body = self._split_publish(*resp)
                self._early.append((topic_, body))

    def recv_publish(self):
        """Blocks for the next PUBLISH; returns (topic, payload) or None
        on disconnect/close."""
        if self._early:
            return self._early.pop(0)
        while True:
            try:
                pkt = _read_packet(self._sock)
            except OSError:
                return None      # closed under us (element stop())
            if pkt is None:
                return None
            ptype, data = pkt
            if ptype >> 4 == 3:        # PUBLISH
                topic, pid, body = self._split_publish(ptype, data)
                if pid is not None:    # QoS 1 delivery → PUBACK
                    with self._lock:
                        self._sock.sendall(
                            bytes([0x40, 2]) + struct.pack(">H", pid))
                return topic, body
            if ptype >> 4 == 13:       # PINGRESP (keepalive answer)
                continue

    def close(self) -> None:
        self._closed = True
        self._ping_stop.set()
        try:
            with self._lock:
                self._sock.sendall(bytes([0xE0, 0]))  # DISCONNECT
            self._sock.close()
        except OSError:
            pass


def fetch_retained_record(host: str, port: int, topic: str,
                          timeout: float, client_id: str):
    """One-shot hybrid-discovery read: connect to the broker, subscribe
    to ``topic``, and wait (bounded by ``timeout`` — covering the
    SUBACK handshake too, so a wedged broker cannot hang the caller
    indefinitely) for the retained record.  Returns the payload bytes,
    or None when the broker has no record.  Shared by edge_src and
    tensor_query_client HYBRID discovery (one copy of the
    subscribe/wait/parse sequence to keep in sync)."""
    client = MqttClient(host, port, client_id, keepalive=0)
    try:
        client._sock.settimeout(timeout)
        client.subscribe(topic)
        got = client.recv_publish()
        return got[1] if got else None
    finally:
        client.close()


class MqttBroker:
    """Minimal in-process MQTT 3.1.1 broker (QoS 0, exact-topic match) —
    the localhost broker the reference's MQTT tests gate on
    (tests/check_broker.sh), self-contained so no mosquitto is needed."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self.host, self.port = host, self._sock.getsockname()[1]
        self._sock.listen(16)
        self._subs: Dict[str, Set[socket.socket]] = {}
        self._locks: Dict[socket.socket, threading.Lock] = {}
        self._retained: Dict[str, bytes] = {}
        self._lock = make_lock("query.registry")
        self._stop = threading.Event()
        threading.Thread(target=self._accept, daemon=True,
                         name="mqtt-broker").start()

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        topics: List[str] = []
        try:
            pkt = _read_packet(conn)
            if pkt is None or pkt[0] >> 4 != 1:
                return
            conn.sendall(bytes([0x20, 2, 0, 0]))  # CONNACK accepted
            self._locks[conn] = make_lock("query.send")
            while not self._stop.is_set():
                pkt = _read_packet(conn)
                if pkt is None:
                    return
                ptype, data = pkt
                code = ptype >> 4
                if code == 8:       # SUBSCRIBE
                    pid = data[:2]
                    tlen = struct.unpack(">H", data[2:4])[0]
                    topic = data[4:4 + tlen].decode()
                    topics.append(topic)
                    # take this conn's send lock BEFORE releasing the
                    # broker lock: a concurrent publisher snapshots the
                    # new subscriber and then needs the send lock, so it
                    # cannot interleave with (or overtake) the
                    # SUBACK+retained writes (same handoff as
                    # edge.EdgeBroker)
                    with self._lock:
                        self._subs.setdefault(topic, set()).add(conn)
                        retained = self._retained.get(topic)
                        slock = self._locks.get(conn)
                        if slock is not None:
                            slock.acquire()
                    try:
                        conn.sendall(bytes([0x90, 3]) + pid + bytes([0]))
                        if retained is not None:
                            body = _mqtt_str(topic) + retained
                            conn.sendall(bytes([0x31])
                                         + _remaining_len(len(body)) + body)
                    finally:
                        if slock is not None:
                            slock.release()
                elif code == 3:     # PUBLISH → fan out (downgraded to QoS 0)
                    topic, pid, body = MqttClient._split_publish(ptype, data)
                    if pid is not None:   # QoS-1 sender needs a PUBACK
                        with self._locks[conn]:   # see PINGREQ below
                            conn.sendall(bytes([0x40, 2])
                                         + struct.pack(">H", pid))
                    if ptype & 0x01:      # retain flag
                        with self._lock:
                            if body:
                                self._retained[topic] = body
                            else:
                                # MQTT 3.1.1: empty retained payload
                                # CLEARS the retained message
                                self._retained.pop(topic, None)
                    out = _mqtt_str(topic) + body
                    with self._lock:
                        subs = [(s, self._locks.get(s))
                                for s in self._subs.get(topic, ())]
                    pkt_out = bytes([0x30]) + _remaining_len(len(out)) + out
                    for s, lk in subs:
                        try:
                            if lk is None:
                                s.sendall(pkt_out)
                            else:
                                with lk:
                                    s.sendall(pkt_out)
                        except OSError:
                            with self._lock:
                                self._subs.get(topic, set()).discard(s)
                elif code == 12:    # PINGREQ
                    # under the conn's send lock: this client may also be
                    # a subscriber receiving a concurrent fanout, and a
                    # PINGRESP spliced into a partially-sent PUBLISH
                    # would corrupt its stream
                    with self._locks[conn]:
                        conn.sendall(bytes([0xD0, 0]))
                elif code == 14:    # DISCONNECT
                    return
        finally:
            with self._lock:
                for t in topics:
                    self._subs.get(t, set()).discard(conn)
                self._locks.pop(conn, None)
            conn.close()

    def close(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


_BROKERS: Dict[int, MqttBroker] = {}
_BROKERS_LOCK = make_lock("leaf")


def get_mqtt_broker(port: int = 0, host: str = "127.0.0.1") -> MqttBroker:
    with _BROKERS_LOCK:
        if port and port in _BROKERS:
            return _BROKERS[port]
        b = MqttBroker(host, port)
        _BROKERS[b.port] = b
        return b


# -- elements ----------------------------------------------------------------

@register_element
class MqttSink(Element):
    """``mqttsink``: publish the stream to an MQTT topic with the
    reference's 1024-B header (mqttsink.c role)."""

    FACTORY = "mqttsink"
    PROPERTIES = {
        "host": ("127.0.0.1", "broker host"),
        "port": (1883, "broker port"),
        "pub-topic": ("nnstreamer", "topic to publish"),
        "ntp-host": (None, "NTP server(s) for epoch alignment, comma-sep"),
        "keepalive": (30, "MQTT keepalive seconds declared in CONNECT "
                          "and honored by a PINGREQ pinger (0 = off)"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")

    def start(self):
        from ..utils.ntp import stream_origin_epoch_us

        self._client = MqttClient(str(self.host), int(self.port),
                                  f"nns-sink-{self.name}",
                                  keepalive=int(self.keepalive),
                                  publish_only=True)
        self._base_epoch_us = stream_origin_epoch_us(self.ntp_host,
                                                     self.name)
        self._caps_str = ""

    def stop(self):
        self._client.close()

    def set_caps(self, pad, caps):
        self._caps_str = str(caps)

    def chain(self, pad, buf):
        from ..pipeline.tracing import record_copy

        mems = [np.ascontiguousarray(buf.np(i)).tobytes()
                for i in range(buf.num_tensors)]
        from ..obs.clock import wall_us

        hdr = pack_header([len(m) for m in mems], self._base_epoch_us,
                          wall_us(), buf.duration, None,
                          buf.pts, self._caps_str,
                          ctx=buf.extra.get("nns_trace"))
        record_copy(len(hdr) + sum(len(m) for m in mems))
        self._client.publish(str(self.pub_topic), hdr + b"".join(mems))
        return FlowReturn.OK

    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            self.post_eos_reached()


@register_element
class MqttSrc(Source):
    """``mqttsrc``: subscribe to an MQTT topic, reconstruct buffers from
    the 1024-B header (mqttsrc.c role); ``sync-pts`` re-bases sender PTS
    via the embedded base-time epoch."""

    FACTORY = "mqttsrc"
    PROPERTIES = {
        "host": ("127.0.0.1", "broker host"),
        "port": (1883, "broker port"),
        "sub-topic": ("nnstreamer", "topic to subscribe"),
        "caps": (None, "override out caps (else the header's caps string)"),
        "num-buffers": (-1, "stop after N buffers, -1 unlimited"),
        "sync-pts": (False, "re-base incoming PTS onto this host's clock"),
        "ntp-host": (None, "NTP server(s) for epoch alignment, comma-sep"),
        # reference mqttsrc launch-line parity (ssat sets both): debug
        # toggles its verbose logging, is-live marks the live-source
        # flag — this source is always live, the flags are accepted
        # state
        "debug": (False, "reference mqttsrc debug flag"),
        "is-live": (True, "reference live-source flag (always live "
                          "here)"),
        "keepalive": (30, "MQTT keepalive seconds declared in CONNECT "
                          "and honored by a PINGREQ pinger (0 = off)"),
    }

    def _make_pads(self):
        self.add_src_pad(tensors_template_caps(), "src")

    def start(self):
        from ..utils.ntp import stream_origin_epoch_us

        self._base_epoch_us = stream_origin_epoch_us(self.ntp_host,
                                                     self.name)
        self._client = MqttClient(str(self.host), int(self.port),
                                  f"nns-src-{self.name}",
                                  keepalive=int(self.keepalive))
        self._client.subscribe(str(self.sub_topic))
        # paced by the broker's TCP stream and drained every create()
        # (QoS-0 pub/sub transport; query-path overload is handled by
        # admission control in query/overload.py)
        # nnslint: allow(unbounded-queue)
        self._fifo: _queue.Queue = _queue.Queue()
        self._count = 0
        self._first = None
        threading.Thread(target=self._pump, daemon=True,
                         name=f"mqttsrc:{self.name}").start()

    def stop(self):
        self._client.close()
        super()._halt()

    def _pump(self) -> None:
        while True:
            got = self._client.recv_publish()
            if got is None:
                self._fifo.put(None)
                return
            _, payload = got
            try:
                self._fifo.put(self._parse(payload))
            except Exception as e:  # noqa: BLE001 - malformed frame
                logger.warning("%s: dropping malformed frame: %r",
                               self.name, e)

    def _parse(self, payload: bytes):
        sizes, base_us, _sent, duration, _dts, pts, caps_str = \
            unpack_header(payload)
        ctx = header_trace_ctx(payload)
        body = payload[HDR_LEN:]
        if sum(sizes) > len(body):
            raise ValueError(f"truncated frame: header declares "
                             f"{sum(sizes)}B, body has {len(body)}B")
        mems, off = [], 0
        for s in sizes:
            mems.append(body[off:off + s])
            off += s
        if self.sync_pts and pts is not None:
            pts = pts + (base_us - self._base_epoch_us) * 1000
        return mems, duration, pts, caps_str, ctx

    def _next(self):
        while not self._halted.is_set():
            try:
                return self._fifo.get(timeout=0.1)
            except _queue.Empty:
                continue
        return None

    def negotiate(self) -> Caps:
        if self.caps:
            c = self.caps
            self._caps = Caps.from_string(c) if isinstance(c, str) else c
        else:
            item = self._next()
            if item is None:
                raise ValueError(f"{self.name}: no frame before teardown; "
                                 "set the caps property")
            self._first = item
            self._caps = Caps.from_string(item[3])
        self._config = config_from_caps(self._caps)
        return caps_from_config(self._config)

    def create(self) -> Optional[TensorBuffer]:
        n = int(self.num_buffers)
        if n >= 0 and self._count >= n:
            return None
        if self._first is not None:
            item, self._first = self._first, None
        else:
            item = self._next()
        while item is not None:
            mems, duration, pts, _caps, ctx = item
            infos = self._config.info
            try:
                if len(mems) != infos.num_tensors:
                    raise ValueError(
                        f"frame has {len(mems)} memories, negotiated "
                        f"{infos.num_tensors}")
                tensors = [np.frombuffer(mem, info.np_dtype)
                           .reshape(info.np_shape)
                           for mem, info in zip(mems, infos)]
            except ValueError as e:
                # a foreign publisher on the topic; drop, keep streaming
                logger.warning("%s: dropping mismatched frame: %s",
                               self.name, e)
                item = self._next()
                continue
            self._count += 1
            out = TensorBuffer(tensors=tensors, pts=pts,
                               duration=duration)
            if ctx is not None:
                out.extra["nns_trace"] = ctx
            return out
        return None
