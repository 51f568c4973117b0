"""Tensor query client: offload frames to a remote serving pipeline.

Parity with gst/nnstreamer/tensor_query/tensor_query_client.c: chain sends
the frame over the transport, blocks on an async queue for the answer
(:656-743), with reconnect/retry (:368-380,728-732) and a caps handshake
over the same channel (:512-559).

Resilience (query/resilience.py): connects back off exponentially with
jitter (:class:`RetryPolicy`); each endpoint sits behind a
:class:`CircuitBreaker` so a dead server fails fast instead of eating a
timeout per frame; a :class:`HealthMonitor` heartbeats the active
endpoint over ``T_PING``/``T_PONG`` and a dead verdict triggers failover
to the next entry of the ``dest-hosts`` list.  The ``fallback`` property
picks what a frame does when every endpoint is down: ``error`` (pipeline
error, the reference default), ``passthrough`` (push the input frame
unchanged — graceful degradation), or ``drop``.

Overload (query/overload.py): the connection declares a QoS class
(``qos`` property, or inherited from the first frame's ``nns_class``
tag) in the T_HELLO handshake; a ``T_SHED`` answer from the server's
admission control surfaces as :class:`ShedError` and maps into the
same fallback machinery — but breakers record SUCCESS on a shed (the
server is alive and protecting itself); with alternates the client
rotates to the next endpoint immediately (routing away is what an
overloaded or draining server asked for), alone it floors its retry
backoff at the server's retry-after hint capped by the request budget.

The port of ``nnstreamer_tpu/query/client.py``; it speaks the same wire,
so it offloads to either package's servers.  ``connect-type=HYBRID``
(MQTT discovery) waits for ``query/mqtt.py``.
"""

from __future__ import annotations

import queue as _queue
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.sanitizer import make_lock, make_rlock
from ..obs.clock import OffsetEstimator, wall_us
from ..obs.span import TraceContext
from ..pipeline.caps import Caps
from ..pipeline.element import Element, FlowReturn
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer, default_pool
from ..tensor.caps_util import tensors_template_caps
from .overload import ShedError, qos_of_class
from .protocol import (Message, T_BYE, T_DATA, T_HELLO, T_PING, T_PONG,
                       T_REPLY, T_SHED, T_TRACE, decode_tensors,
                       parse_retry_after, recv_msg, send_msg,
                       send_tensors, shutdown_close)
from .protocol import create_connection as checked_connect
from .resilience import (STATS, CircuitBreaker, CircuitOpenError,
                         HealthMonitor, RetryExhausted, RetryPolicy)


class _PongWaiter:
    """One outstanding ping: completion event + the pong's wall-clock
    stamp (0 = peer predates the stamp)."""

    __slots__ = ("evt", "epoch_us")

    def __init__(self) -> None:
        self.evt = threading.Event()
        self.epoch_us = 0


class QueryConnection:
    """Socket + reader thread + reply queue, with reconnect.

    One TCP connection to one endpoint.  ``query()`` owns the whole
    request budget (``timeout`` seconds covering send, reconnect, and
    reply wait); ``ping()`` is the heartbeat probe matched by seq on the
    same stream, handled out of band by the reader thread.
    """

    def __init__(self, host: str, port: int, timeout: float = 10.0,
                 max_retries: int = 3,
                 retry: Optional[RetryPolicy] = None,
                 qos: Optional[str] = None,
                 model: Optional[str] = None):
        self.host, self.port = host, port
        self.timeout = timeout
        self.max_retries = max_retries
        #: QoS class declared to the server in the T_HELLO handshake
        #: (query/overload.py admission control: bronze sheds first,
        #: gold last).  None = unnegotiated; the first query whose
        #: ``buf.extra["nns_class"]`` implies a class negotiates it
        #: late (the loadgen's class tagging becomes the QoS default)
        self.qos = qos
        #: model identity declared in the handshake (a ``model=`` HELLO
        #: token): the fleet router's consistent-hash key — connections
        #: naming the same model concentrate on the same workers so
        #: their cross-stream buckets stay dense (fleet/router.py).
        #: Plain servers ignore it.
        self.model = model
        self.retry = retry or RetryPolicy(max_attempts=max(1, max_retries),
                                          base_delay=0.05, max_delay=0.5)
        # bounded by the request protocol: at most one outstanding
        # reply (plus a disconnect sentinel) per in-flight query
        # nnslint: allow(unbounded-queue)
        self.replies: _queue.Queue = _queue.Queue()
        self.server_caps: Optional[str] = None
        #: set when the server's HELLO answer lands (the caps arrive on
        #: the reader thread; waiters — the fleet router forwarding a
        #: handshake — block on this instead of polling)
        self._caps_evt = threading.Event()
        self._pool = default_pool()   # reply payloads land in recycled slabs
        self._sock: Optional[socket.socket] = None
        self._reader: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._seq = 0
        self._send_lock = make_lock("query.send")  # query+ping share the
        #                                            stream
        self._pong_waiters: Dict[int, "_PongWaiter"] = {}
        self._waiters_lock = make_lock("query.registry")
        self._offset_sampled = float("-inf")   # last ping-sample time
        #: server clock offset (NTP-midpoint over reply epoch stamps)
        self.offset = OffsetEstimator()
        #: T_TRACE span-batch payloads from the server, drained by the
        #: client element into its pipeline tracer (bounded: a client
        #: with no tracer silently ages them out)
        import collections

        self._trace_in: "collections.deque" = collections.deque(maxlen=256)
        #: loadgen hook (slo/loadgen.py): called as ``(request_class,
        #: latency_s, ok)`` after every query() — service latency from
        #: send to reply, per-class via ``buf.extra["nns_class"]``.
        #: Fires on raising paths too (timeouts, dead endpoints) but
        #: NOT on sheds: a T_SHED's near-instant round trip would
        #: flatter the admitted-traffic service distribution.
        #: None (the default) costs one attribute test per query.
        self.on_outcome: Optional[Callable[[str, float, bool], None]] = None

    def _hello_payload(self) -> bytes:
        """`;`-token handshake payload (protocol.parse_hello_tokens):
        QoS class for admission control, model identity for fleet
        routing — both optional, empty when neither is set."""
        parts = []
        if self.qos:
            parts.append(f"qos={self.qos}")
        if self.model:
            parts.append(f"model={self.model}")
        return ";".join(parts).encode()

    def connect(self) -> None:
        def _dial():
            sock = checked_connect(
                (self.host, self.port), timeout=self.timeout)
            sock.settimeout(None)
            self._sock = sock
            self._stop.clear()
            reader = threading.Thread(
                target=self._read_loop, daemon=True, name="query-reader")
            self._reader = reader
            reader.start()
            try:
                # caps handshake; declares this connection's QoS class
                # / model identity when set (server-side admission
                # control; fleet-router placement)
                self._send(Message(T_HELLO,
                                   payload=self._hello_payload()))
            except OSError:
                # tear this half-made connection down before the retry:
                # otherwise every failed attempt leaks a socket and a
                # reader thread whose None sentinel would later be
                # mistaken for a disconnect on the healthy link
                shutdown_close(sock)
                self._sock = None
                reader.join(timeout=5)
                while True:
                    try:
                        self.replies.get_nowait()
                    except _queue.Empty:
                        break
                raise

        try:
            self.retry.run(_dial, retry_on=(OSError,),
                           counter="query.connect")
        except RetryExhausted as exc:
            raise ConnectionError(
                f"cannot connect to {self.host}:{self.port}: "
                f"{exc.__cause__}") from exc.__cause__

    def _send(self, msg: Message) -> None:
        # serialize writers: a heartbeat ping must never interleave with
        # a partially-written DATA frame from the streaming thread
        with self._send_lock:
            send_msg(self._sock, msg)

    def _read_loop(self) -> None:
        sock = self._sock
        while not self._stop.is_set():
            try:
                msg = recv_msg(sock, pool=self._pool)
            except ValueError as e:   # bad magic / CRC: stream corrupt
                from ..utils.log import logger

                logger.error("query client: corrupt stream: %s", e)
                msg = None
            if msg is None:
                self.replies.put(None)  # signal disconnect
                return
            if msg.type == T_HELLO:
                self.server_caps = msg.payload.decode()
                self._caps_evt.set()
            elif msg.type in (T_REPLY, T_SHED):
                # a shed is a first-class answer: it rides the reply
                # queue so _await_reply matches it to ITS request by seq
                self.replies.put(msg)
            elif msg.type == T_TRACE:
                # server timeline piggyback: park the raw JSON batch;
                # the element thread parses and merges it (or it ages
                # out of the bounded deque when no tracer wants it)
                self._trace_in.append(bytes(msg.payload))
            elif msg.type == T_PONG:
                with self._waiters_lock:
                    waiter = self._pong_waiters.pop(msg.seq, None)
                if waiter is not None:
                    waiter.epoch_us = msg.epoch_us
                    waiter.evt.set()

    def wait_server_caps(self, timeout: float = 2.0) -> Optional[str]:
        """Block until the server's HELLO answer (its caps string)
        arrived, or ``timeout`` — the handshake-forwarding path's read
        (a router must answer the client's HELLO with the WORKER's
        caps, which land asynchronously on the reader thread)."""
        self._caps_evt.wait(timeout)
        return self.server_caps

    def ping(self, timeout: float = 1.0) -> float:
        """Heartbeat probe: send ``T_PING``, await the matching
        ``T_PONG``.  Returns the RTT in seconds; raises ``TimeoutError``
        / ``OSError`` on a dead or silent peer.

        A pong's wall-clock stamp feeds the clock-offset estimator:
        ping service time is near zero, so these are the samples that
        bound the offset error by rtt/2 (a REPLY stamp rides on top of
        model latency — its bias equals half the service time, which
        min-RTT filtering then discards once a ping sample exists)."""
        waiter = _PongWaiter()
        with self._waiters_lock:
            # seq allocation must be atomic with waiter registration:
            # the monitor probe thread, the element thread's offset
            # sampler and query() all share this counter — a lost
            # update would give two pings one seq and strand a waiter
            self._seq += 1
            seq = self._seq
            self._pong_waiters[seq] = waiter
        try:
            t0 = time.monotonic()
            t_send_us = wall_us()
            try:
                self._send(Message(T_PING, seq=seq))
            except AttributeError:   # _sock is None: closed under us
                raise ConnectionError("not connected") from None
            if not waiter.evt.wait(timeout):
                raise TimeoutError(
                    f"no pong from {self.host}:{self.port} "
                    f"within {timeout}s")
            if waiter.epoch_us:
                self.offset.add_sample(t_send_us, wall_us(),
                                       waiter.epoch_us)
            return time.monotonic() - t0
        finally:
            with self._waiters_lock:
                self._pong_waiters.pop(seq, None)

    def sample_clock_offset(self, max_age_s: float = 2.0,
                            timeout: float = 1.0) -> None:
        """Refresh the offset estimate with a ping sample unless a
        recent one exists.  The ping runs on a short-lived daemon
        thread: the caller is the STREAMING thread mid-chain, and a
        degraded peer must cost it nothing (failures are ignored — the
        reply-stamp fallback samples keep the estimator populated)."""
        now = time.monotonic()
        if now - self._offset_sampled < max_age_s:
            return
        self._offset_sampled = now

        def _probe():
            try:
                self.ping(timeout=timeout)
            except (TimeoutError, ConnectionError, OSError):
                pass

        threading.Thread(target=_probe, daemon=True,
                         name="query-offset-probe").start()

    def query(self, buf: TensorBuffer) -> Optional[TensorBuffer]:
        """Send one frame, await ITS reply (matched by seq; stale replies
        from timed-out requests are discarded), reconnecting within the
        request's deadline budget (``timeout`` covers send + reconnect +
        reply).

        When :attr:`on_outcome` is set (the loadgen hook), the request's
        class tag (``buf.extra["nns_class"]``, default ``"default"``),
        service latency and success flag are reported after every
        attempt — including raising ones, so error accounting sees
        timeouts and dead endpoints, not just clean replies."""
        hook = self.on_outcome
        if hook is None:
            return self._query(buf)
        cls = str(buf.extra.get("nns_class", "default"))
        t0 = time.monotonic()
        try:
            out = self._query(buf)
        except ShedError:
            # a shed is not a service outcome: its ~instant round trip
            # in the service histogram would flatter the admitted
            # traffic's latency — the caller's shed accounting owns it
            raise
        except BaseException:
            hook(cls, time.monotonic() - t0, False)
            raise
        hook(cls, time.monotonic() - t0, True)
        return out

    def _negotiate_qos_late(self, buf: TensorBuffer) -> None:
        """Default the connection's QoS class from the request's class
        tag: the first ``buf.extra["nns_class"]`` that implies a QoS
        class re-announces the handshake with it (servers accept a
        fresh T_HELLO at any time), so loadgen-tagged traffic gets
        tiered shedding without explicit configuration."""
        implied = qos_of_class(buf.extra.get("nns_class"))
        if implied is None:
            return
        self.qos = implied
        try:
            self._send(Message(T_HELLO, payload=self._hello_payload()))
        except (OSError, AttributeError):
            pass   # connection is down: connect() re-announces

    def _query(self, buf: TensorBuffer) -> Optional[TensorBuffer]:
        if self.qos is None:
            self._negotiate_qos_late(buf)
        with self._waiters_lock:   # shared with ping allocations
            self._seq += 1
            seq = self._seq
        deadline = time.monotonic() + self.timeout
        ctx = buf.extra.get("nns_trace") or TraceContext()
        for attempt in (0, 1):
            t_send_us = wall_us()
            try:
                # scatter-gather framing: tensor payloads go to the
                # kernel as views, no per-frame blob materialization
                with self._send_lock:
                    send_tensors(self._sock, T_DATA, buf, seq=seq,
                                 pts=buf.pts or 0,
                                 trace_id=ctx.trace_id,
                                 span_id=ctx.span_id,
                                 origin_us=ctx.origin_us)
            except (OSError, AttributeError):
                if attempt:
                    raise
                STATS.incr("query.reconnects")
                self._reconnect(deadline)
                continue
            reply = self._await_reply(seq, deadline)
            if reply is None:  # disconnected mid-wait → retry once
                if attempt:
                    raise ConnectionError("server closed connection")
                STATS.incr("query.reconnects")
                self._reconnect(deadline)
                continue
            if reply.type == T_SHED:
                # explicit load shed: the server refused this request
                # by admission control and told us when to come back.
                # NOT a failure — the caller's resilience layer must
                # keep breakers closed and honor the retry-after.
                retry_after = parse_retry_after(reply.payload)
                qos = self.qos or "default"
                STATS.incr("query.sheds")
                STATS.incr(f"query.sheds.{qos}")
                raise ShedError(retry_after, qos=qos)
            if reply.epoch_us:
                # reply stamps carry the server wall clock: one offset
                # sample per round trip, min-RTT filtered (obs/clock.py)
                self.offset.add_sample(t_send_us, wall_us(),
                                       reply.epoch_us)
            out = buf.with_tensors(decode_tensors(reply.payload))
            out.pts = reply.pts
            out.lease = reply.lease   # views alias the pooled slab
            return out
        return None

    def drain_traces(self) -> List[bytes]:
        """Pending T_TRACE span batches (raw JSON), oldest first."""
        out: List[bytes] = []
        while True:
            try:
                out.append(self._trace_in.popleft())
            except IndexError:
                return out

    def _await_reply(self, seq: int,
                     deadline: Optional[float] = None) -> Optional[Message]:
        if deadline is None:
            deadline = time.monotonic() + self.timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"no reply within {self.timeout}s")
            try:
                reply = self.replies.get(timeout=remaining)
            except _queue.Empty:
                raise TimeoutError(
                    f"no reply within {self.timeout}s") from None
            if reply is None or reply.seq == seq:
                return reply
            # stale reply from an earlier timed-out request: discard
            STATS.incr("query.stale_replies")

    def _reconnect(self, deadline: Optional[float] = None) -> None:
        self.close(send_bye=False)
        # drop anything queued by the dying reader (incl. its None sentinel)
        while True:
            try:
                self.replies.get_nowait()
            except _queue.Empty:
                break
        if deadline is not None:
            # bound the reconnect by the request's remaining budget
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise TimeoutError(
                    f"no budget left to reconnect to "
                    f"{self.host}:{self.port}")
            retry, self.retry = self.retry, self.retry.with_deadline(budget)
            try:
                self.connect()
            finally:
                self.retry = retry
        else:
            self.connect()

    def close(self, send_bye: bool = True) -> None:
        self._stop.set()
        sock = self._sock
        if sock is not None:
            if send_bye:
                try:
                    # send on the CAPTURED sock (still under the send
                    # lock): _send re-reads self._sock, which a racing
                    # _reconnect may have nulled — an AttributeError
                    # here would escape teardown
                    with self._send_lock:
                        send_msg(sock, Message(T_BYE))
                except OSError:
                    pass
            # shutdown-then-close wakes the reader thread blocked in
            # recv (a plain close would leave it blocked forever and the
            # server would never see a FIN — protocol.py)
            shutdown_close(sock)
        self._sock = None


class FailoverConnection:
    """Multi-endpoint query connection: one active
    :class:`QueryConnection` at a time, per-endpoint circuit breakers,
    optional heartbeat-driven failover.

    ``endpoints`` is an ordered ``[(host, port), …]`` preference list
    (the ``dest-hosts`` property).  A query failure records on the active
    endpoint's breaker and rotates to the next endpoint whose breaker
    admits a call; a heartbeat ``dead`` verdict demotes the active
    endpoint between frames so the next query fails over without eating
    a full reply timeout first.

    The endpoint list is HOT-updatable (:meth:`set_endpoints` — the
    fleet router's rebalance path): the active connection survives the
    update when its endpoint is still listed, so a membership change
    never causes a reconnect storm; a removed active endpoint rotates
    on the NEXT query.

    ``shed_passthrough=True`` (the router's forwarding mode) raises a
    lone endpoint's :class:`ShedError` immediately instead of honoring
    its retry-after in place — a proxy sleeping out the hint would turn
    an explicit fast shed into opaque latency inside the caller's own
    budget.  With alternates, sheds still rotate (routing away IS
    honoring the hint) and only an all-candidates shed propagates.
    """

    _FAILURE = (TimeoutError, ConnectionError, OSError, AttributeError)

    def __init__(self, endpoints: List[Tuple[str, int]],
                 timeout: float = 10.0, max_retries: int = 3,
                 retry: Optional[RetryPolicy] = None,
                 breaker_failures: int = 5,
                 breaker_cooldown: float = 30.0,
                 heartbeat_interval: float = 0.0,
                 heartbeat_max_missed: int = 3,
                 name: str = "query",
                 qos: Optional[str] = None,
                 model: Optional[str] = None,
                 shed_passthrough: bool = False):
        if not endpoints:
            raise ValueError("FailoverConnection needs >= 1 endpoint")
        self.endpoints = list(endpoints)
        self.timeout = timeout
        self.max_retries = max_retries
        self.qos = qos
        self.model = model
        self.name = name
        self.breaker_failures = int(breaker_failures)
        self.breaker_cooldown = float(breaker_cooldown)
        self._shed_passthrough = bool(shed_passthrough)
        self.retry = retry or RetryPolicy(max_attempts=max(1, max_retries),
                                          base_delay=0.05, max_delay=0.5)
        self.breakers = [self._make_breaker(h, p)
                         for h, p in self.endpoints]
        self._idx = 0                    # preferred endpoint index
        self._active: Optional[QueryConnection] = None
        self._active_idx: Optional[int] = None
        self._active_key: Optional[str] = None   # lock-free monitor read
        self._dead = threading.Event()   # heartbeat verdict on active
        self._lock = make_rlock("query.client")
        self.monitor: Optional[HealthMonitor] = None
        if heartbeat_interval > 0:
            self.monitor = HealthMonitor(
                interval=heartbeat_interval,
                max_missed=heartbeat_max_missed,
                on_down=self._on_endpoint_down, name=name)

    # -- endpoint bookkeeping ------------------------------------------------
    def _make_breaker(self, host: str, port: int) -> CircuitBreaker:
        return CircuitBreaker(failure_threshold=self.breaker_failures,
                              cooldown=self.breaker_cooldown,
                              name=f"{self.name}:{host}:{port}")

    def _key(self, idx: int) -> str:
        h, p = self.endpoints[idx]
        return f"{h}:{p}"

    def set_endpoints(self, endpoints: List[Tuple[str, int]]) -> None:
        """Hot ``dest-hosts`` update (the fleet router's rebalance
        primitive).  Endpoints present before AND after keep their
        circuit-breaker state; new ones start fresh.  When the ACTIVE
        endpoint survives the update, the live connection is kept
        untouched — a fleet membership change must move only the
        clients whose assignment changed, never storm every socket.
        When it was removed, the connection closes and the next query
        dials the new preferred endpoint (rotate-on-update)."""
        endpoints = [(str(h), int(p)) for h, p in endpoints]
        if not endpoints:
            raise ValueError("set_endpoints needs >= 1 endpoint")
        with self._lock:
            kept = {self._key(i): self.breakers[i]
                    for i in range(len(self.endpoints))}
            active_key = self._active_key
            self.endpoints = endpoints
            self.breakers = [kept.get(f"{h}:{p}")
                             or self._make_breaker(h, p)
                             for h, p in endpoints]
            keys = [self._key(i) for i in range(len(endpoints))]
            if active_key is not None and active_key in keys:
                # active endpoint survives: same socket, new index
                self._active_idx = self._idx = keys.index(active_key)
                return
            # active endpoint removed (or none yet): next query starts
            # at the new preference head.  Close WITHOUT a failure mark
            # — this is a routing decision, not an endpoint fault — and
            # WITHOUT a BYE: a goodbye send can block on a wedged
            # peer's full socket buffer, and the router calls this
            # under its membership lock for every displaced client
            # (one sick worker must not stall the whole control
            # plane); shutdown_close's FIN tells the worker enough.
            if self._active is not None:
                if self.monitor is not None and active_key is not None:
                    self.monitor.unwatch(active_key)
                self._active.close(send_bye=False)
                self._active = None
                STATS.incr("query.rebalances")
            self._active_idx = None
            self._active_key = None
            self._idx = 0
            self._dead.clear()

    def set_qos(self, qos: Optional[str]) -> None:
        """Update the QoS class mid-stream: the active connection
        re-announces the full token payload (servers accept a fresh
        T_HELLO at any time) and later dials inherit it."""
        with self._lock:
            self.qos = qos
            conn = self._active
        if conn is not None:
            conn.qos = qos
            try:
                conn._send(Message(T_HELLO,
                                   payload=conn._hello_payload()))
            except (OSError, AttributeError):
                pass   # next dial re-announces

    def _on_endpoint_down(self, key: str) -> None:
        """Heartbeat verdict: the active endpoint stopped answering.
        Mark it so the next query fails over immediately instead of
        waiting out a reply timeout on a dead socket."""
        # deliberately lock-free: the query thread holds self._lock for
        # the whole (possibly seconds-long, backoff-sleeping) dial in
        # _ensure_active, and heartbeats for other endpoints must not
        # stall behind it.  A stale match only sets a flag the next
        # _ensure_active clears after reconnecting.
        if key == self._active_key:
            self._dead.set()

    @property
    def server_caps(self) -> Optional[str]:
        with self._lock:
            return (self._active.server_caps
                    if self._active is not None else None)

    def wait_server_caps(self, timeout: float = 2.0) -> Optional[str]:
        """Active connection's :meth:`QueryConnection.wait_server_caps`
        (None when no endpoint is live)."""
        with self._lock:
            conn = self._active
        return (conn.wait_server_caps(timeout)
                if conn is not None else None)

    @property
    def active_endpoint(self) -> Optional[Tuple[str, int]]:
        with self._lock:
            return (self.endpoints[self._active_idx]
                    if self._active_idx is not None else None)

    def health_report(self) -> Dict[str, Dict[str, object]]:
        return self.monitor.report() if self.monitor is not None else {}

    def degraded(self) -> bool:
        """True while this connection runs in a reduced mode: no live
        endpoint (degraded start / mid-stream loss awaiting the next
        frame's redial) or any endpoint breaker OPEN.  Scrape-time read
        for the /healthz readiness state — deliberately lock-free
        (a torn read costs one conservative scrape, not a stall behind
        a seconds-long dial holding self._lock)."""
        if self._active is None:
            return True
        return any(b.state == "open" for b in self.breakers)

    def sample_clock_offset(self) -> None:
        """Rate-limited ping-based offset refresh on the active
        connection (traced clients call this per frame; it no-ops
        within the sample window)."""
        with self._lock:
            conn = self._active
        if conn is not None:
            conn.sample_clock_offset()

    def drain_remote_traces(self) -> List[Tuple[bytes, int, str]]:
        """Pending server span batches from the active connection:
        ``(raw_json, offset_us, endpoint_key)`` triples, offset already
        min-RTT-filtered per connection."""
        with self._lock:
            conn = self._active
        if conn is None:
            return []
        off = conn.offset.offset_us or 0
        key = f"{conn.host}:{conn.port}"
        return [(raw, off, key) for raw in conn.drain_traces()]

    # -- lifecycle -----------------------------------------------------------
    def connect(self) -> None:
        """Establish the first connection (rotating through endpoints)."""
        # start the heartbeat scheduler BEFORE dialing: on a degraded
        # start (every endpoint down, fallback != error) the dial raises
        # but the element keeps running, and endpoints watched by later
        # recoveries still need a live scheduler
        if self.monitor is not None:
            self.monitor.start()
        with self._lock:
            self._ensure_active()

    def close(self, send_bye: bool = True) -> None:
        if self.monitor is not None:
            self.monitor.stop()
        with self._lock:
            if self._active is not None:
                self._active.close(send_bye=send_bye)
                self._active = None
                self._active_idx = None
                self._active_key = None

    # -- core ----------------------------------------------------------------
    def _ensure_active(self) -> QueryConnection:
        """Return a live connection, failing over as needed.  Raises
        :class:`CircuitOpenError` when every breaker refuses, or
        ``ConnectionError`` when every admitted endpoint is unreachable."""
        if self._dead.is_set():
            self._demote("heartbeat")
        if self._active is not None:
            return self._active
        last: Optional[BaseException] = None
        all_open = True
        n = len(self.endpoints)
        for off in range(n):
            idx = (self._idx + off) % n
            breaker = self.breakers[idx]
            if not breaker.allow():
                continue
            all_open = False
            host, port = self.endpoints[idx]
            # bound the whole per-endpoint dial loop by the request
            # budget: without the deadline, a blackholed endpoint (SYN
            # dropped) costs max_attempts x connect-timeout per rotation
            # inside chain() before the fallback can fire
            conn = QueryConnection(
                host, port, self.timeout, self.max_retries,
                retry=self.retry.with_deadline(self.timeout),
                qos=self.qos, model=self.model)
            try:
                conn.connect()
            except ConnectionError as exc:
                last = exc
                breaker.record_failure()
                continue
            self._active, self._active_idx, self._idx = conn, idx, idx
            self._active_key = self._key(idx)
            self._dead.clear()
            if self.monitor is not None:
                key = self._key(idx)
                self.monitor.watch(
                    key, lambda c=conn: c.ping(
                        timeout=max(0.1, self.monitor.interval)))
            if off:
                STATS.incr("query.failovers")
            return conn
        if all_open and n:
            raise CircuitOpenError(
                "all endpoints have open circuit breakers: "
                + ", ".join(self._key(i) for i in range(n)))
        raise ConnectionError(
            f"no reachable endpoint among "
            f"{[self._key(i) for i in range(n)]}: {last!r}")

    def _demote(self, reason: str) -> None:
        """Drop the active connection and advance the preference index so
        the next ``_ensure_active`` starts at the following endpoint."""
        if self._active is not None:
            if self.monitor is not None and self._active_idx is not None:
                self.monitor.unwatch(self._key(self._active_idx))
            self._active.close(send_bye=False)
            self._active = None
        if self._active_idx is not None:
            self._idx = (self._active_idx + 1) % len(self.endpoints)
            self._active_idx = None
            self._active_key = None
            if len(self.endpoints) > 1:
                # an alternative exists: this demotion starts a failover
                STATS.incr("query.failovers")
        self._dead.clear()
        STATS.incr(f"query.demotions.{reason}")

    def query(self, buf: TensorBuffer) -> Optional[TensorBuffer]:
        """One frame through the resilient path: per-endpoint breaker
        gating, rotation on failure, backoff between rotations (so a
        mid-stream server kill+restart is survived within the retry
        budget)."""
        last: Optional[BaseException] = None
        #: per-REQUEST budget for honoring retry-after hints: capping
        #: each gap alone would still let max_attempts gaps sum to
        #: multiples of the element timeout
        shed_budget = self.timeout
        for attempt in range(self.retry.max_attempts):
            shed_wait: Optional[float] = None
            with self._lock:
                try:
                    conn = self._ensure_active()
                    # capture the breaker OBJECT, not the index: a
                    # concurrent set_endpoints (the router's rebalance)
                    # may replace/reorder/shrink self.breakers before
                    # this request's outcome lands, and indexing then
                    # would charge the wrong endpoint — or walk off the
                    # end of a shrunken list
                    breaker = self.breakers[self._active_idx]
                except CircuitOpenError:
                    raise                # fail fast: no sleeping on OPEN
                except ConnectionError as exc:
                    last = exc
                    conn = None
            if conn is not None:
                try:
                    out = conn.query(buf)
                    breaker.record_success()
                    return out
                except ShedError as exc:
                    # shed ≠ failure: the server is alive and
                    # protecting itself.  The breaker records SUCCESS
                    # (a shed proves liveness — tripping it would turn
                    # transient overload into a 30 s outage).  With
                    # alternates available, routing away IS honoring
                    # the hint — rotate immediately so a draining or
                    # overloaded primary hands traffic to a healthy
                    # secondary instead of stalling the stream; alone,
                    # honor the retry-after capped by the request
                    # budget (a drain-sized hint must not block
                    # chain() for multiples of the element timeout).
                    last = exc
                    breaker.record_success()
                    if len(self.endpoints) > 1:
                        with self._lock:
                            self._demote("shed")
                    elif self._shed_passthrough:
                        # forwarding mode (fleet router): no alternate
                        # can absorb this — hand the worker's own shed
                        # verdict to the caller NOW; sleeping out the
                        # retry-after in a proxy would just disguise it
                        # as latency
                        raise
                    elif shed_budget <= 0:
                        raise          # budget spent honoring hints
                    else:
                        shed_wait = min(exc.retry_after_s, shed_budget)
                        shed_budget -= shed_wait
                except self._FAILURE as exc:
                    last = exc
                    breaker.record_failure()
                    STATS.incr("query.failures")
                    with self._lock:
                        self._demote("error")
            if attempt + 1 < self.retry.max_attempts:
                STATS.incr("query.retries")
                delay = self.retry.delay(attempt)
                if shed_wait is not None:
                    delay = max(delay, shed_wait)
                # retry-after-honoring backoff (delay from the policy,
                # floored by the server's T_SHED hint)
                time.sleep(delay)   # nnslint: allow(sleep-poll)
        if isinstance(last, (TimeoutError, ConnectionError, OSError)):
            raise last
        if last is not None:
            # e.g. AttributeError from a connection closed under us:
            # normalize so chain()'s fallback handling (which catches
            # the transport error types only) always sees it
            raise ConnectionError(f"query failed: {last!r}") from last
        raise ConnectionError("query failed: no endpoint available")


def parse_endpoints(spec: str, default_host: str = "127.0.0.1"
                    ) -> List[Tuple[str, int]]:
    """``host:port,host2:port2,…`` → ordered endpoint list (a bare
    ``port`` entry takes ``default_host``)."""
    out: List[Tuple[str, int]] = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port = part.rpartition(":")
        if not sep:
            host, port = default_host, part
        if not port.isdigit():
            raise ValueError(f"dest-hosts: malformed entry {part!r} "
                             "(want host:port)")
        out.append((host or default_host, int(port)))
    if not out:
        raise ValueError(f"dest-hosts: no endpoints in {spec!r}")
    return out


@register_element
class TensorQueryClient(Element):
    FACTORY = "tensor_query_client"
    PROPERTIES = {
        "host": ("127.0.0.1", "server host (reference: the client's "
                              "own bind address; kept as the server "
                              "fallback when dest-* is unset)"),
        "port": (0, "server port (fallback when dest-port unset)"),
        "dest-host": (None, "server host (TCP) or MQTT broker host "
                            "(HYBRID) — the reference's addressing: "
                            "every ssat line uses dest-host/dest-port"),
        "dest-port": (None, "server/broker port"),
        "dest-hosts": (None, "ordered failover list "
                             "'host:port,host2:port2' — overrides "
                             "dest-host/dest-port; the client serves "
                             "from the first live endpoint and fails "
                             "over down the list"),
        "connect-type": ("tcp", "TCP (HYBRID, MQTT discovery, waits "
                                "for query/mqtt.py)"),
        "topic": (None, "hybrid: discovery topic"),
        "timeout": (10.0, "reply timeout seconds (per-request budget "
                          "covering send + reconnect + reply)"),
        "max-retries": (3, "connect retries"),
        "retry": (None, "retry policy spec 'attempts=4,base=0.05,"
                        "cap=0.5,mult=2,jitter=0.25[,deadline=S]' "
                        "(exponential backoff + jitter)"),
        "fallback": ("error", "what a frame does when the remote is "
                              "down: error | passthrough | drop"),
        "breaker-failures": (5, "consecutive failures that OPEN an "
                                "endpoint's circuit breaker"),
        "breaker-cooldown": (30.0, "seconds an OPEN breaker waits "
                                   "before a half-open trial"),
        "heartbeat-interval": (0.0, "seconds between T_PING heartbeats "
                                    "on the active endpoint (0 = "
                                    "disabled); a dead verdict fails "
                                    "over to the next dest-hosts entry"),
        "heartbeat-max-missed": (3, "missed pongs before an endpoint "
                                    "is declared dead"),
        "qos": (None, "QoS class declared to the server in the "
                      "handshake: gold | silver | bronze (admission "
                      "control sheds bronze first, gold last — "
                      "query/overload.py).  Unset: inherited from the "
                      "first frame's nns_class tag, else the server's "
                      "silver default"),
        "model": (None, "model identity declared in the handshake "
                        "(fleet/router.py): a tensor_query_router "
                        "endpoint consistent-hashes it so this "
                        "stream's frames land on the same workers as "
                        "every other stream of the model — per-model "
                        "cross-stream buckets stay dense.  Plain "
                        "servers ignore it"),
    }

    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")
        self.add_src_pad(tensors_template_caps(), "src")

    def _server_address(self) -> "tuple[str, int]":
        """Resolve the data-channel address the reference way: TCP takes
        dest-host:dest-port directly, with the legacy host/port pair as
        fallback (HYBRID's MQTT lookup is not ported)."""
        if str(self.connect_type).lower() == "hybrid":
            raise ValueError(f"{self.name}: connect-type=HYBRID (MQTT "
                             "discovery) waits for query/mqtt.py, which "
                             "is not ported yet")
        if self.dest_port not in (None, "", 0):
            return str(self.dest_host or "127.0.0.1"), int(self.dest_port)
        if self.dest_host not in (None, ""):
            # silently connecting to the legacy host/port when only
            # dest-host was given would hit the wrong machine
            raise ValueError(f"{self.name}: dest-host={self.dest_host!r} "
                             "needs dest-port")
        return str(self.host), int(self.port)

    def _endpoints(self) -> List[Tuple[str, int]]:
        if self.dest_hosts not in (None, ""):
            return parse_endpoints(str(self.dest_hosts))
        return [self._server_address()]

    def start(self):
        self._fallback = str(self.fallback or "error").lower()
        if self._fallback not in ("error", "passthrough", "drop"):
            raise ValueError(f"{self.name}: fallback={self.fallback!r} "
                             "(want error | passthrough | drop)")
        qos = None
        if self.qos not in (None, ""):
            qos = qos_of_class(self.qos)
            if qos is None:
                raise ValueError(f"{self.name}: qos={self.qos!r} "
                                 "(want gold | silver | bronze)")
        self.conn = FailoverConnection(
            self._endpoints(), float(self.timeout),
            int(self.max_retries),
            # an explicit retry spec wins; otherwise keep the documented
            # max-retries contract (parse(None) would be a truthy
            # 4-attempt default and silently override the property)
            retry=(RetryPolicy.parse(self.retry)
                   if self.retry not in (None, "") else None),
            breaker_failures=int(self.breaker_failures),
            breaker_cooldown=float(self.breaker_cooldown),
            heartbeat_interval=float(self.heartbeat_interval),
            heartbeat_max_missed=int(self.heartbeat_max_missed),
            name=self.name,
            qos=qos,
            model=(str(self.model) if self.model not in (None, "")
                   else None))
        try:
            self.conn.connect()
        except ConnectionError:
            if self._fallback == "error":
                raise
            # degraded start (reference graceful-degradation story):
            # stream flows via the fallback while the remote is down;
            # queries keep probing the endpoints each frame
            from ..utils.log import logger

            STATS.incr("query.degraded_starts")
            logger.warning("%s: no endpoint reachable at start; "
                           "running with fallback=%s", self.name,
                           self._fallback)

    def stop(self):
        conn = getattr(self, "conn", None)
        if conn is not None:
            conn.close()

    def health_state(self):
        conn = getattr(self, "conn", None)
        if conn is not None and conn.degraded():
            return "degraded"
        return None

    def set_caps(self, pad, caps):
        # announce the server's answer caps when it advertised them,
        # else assume passthrough shape (a degraded start has no server
        # caps yet; chain() re-announces once a recovery learns them)
        sc = self.conn.server_caps
        self._announced_server_caps = bool(sc)
        self._sink_caps_str = str(caps)
        if sc:
            self.announce_src_caps(Caps.from_string(sc))
        else:
            super().set_caps(pad, caps)

    def _passthrough_safe(self) -> bool:
        """May an input frame be pushed downstream as-is?  Only when the
        downstream negotiation wasn't built on server answer caps that
        differ from the input caps — otherwise passthrough would hand a
        wrongly-shaped buffer to elements expecting the server output."""
        if not getattr(self, "_announced_server_caps", False):
            return True
        sc, sk = self.conn.server_caps, getattr(self, "_sink_caps_str", None)
        if not sc or not sk:
            return True
        return str(Caps.from_string(sc)) == str(Caps.from_string(sk))

    def _stamp_trace(self, buf, tracer) -> None:
        """Attach the wire trace context (obs/span.py) so the serving
        pipeline's spans land under THIS run's trace id.  origin_us is
        the buffer's source stamp re-based onto the wall clock — the
        cross-process interlatency origin."""
        if "nns_trace" in buf.extra:
            return
        from ..obs.span import new_trace_id

        src_ns = buf.extra.get("nns_src_ns")
        if src_ns is not None:
            origin = (tracer.anchor_wall_us
                      + (src_ns - tracer.anchor_mono_ns) // 1000)
        else:
            origin = wall_us()
        buf.extra["nns_trace"] = TraceContext(tracer.trace_id,
                                              new_trace_id(), origin)

    def _merge_remote_spans(self, tracer) -> None:
        import json as _json

        for raw, off, key in self.conn.drain_remote_traces():
            try:
                payload = _json.loads(raw.decode())
            except (ValueError, UnicodeDecodeError):
                continue
            tracer.add_remote_spans(payload, offset_us=off,
                                    process=f"server:{key}")

    def chain(self, pad, buf):
        tracer = (self.pipeline.tracer
                  if self.pipeline is not None else None)
        if tracer is not None:
            self._stamp_trace(buf, tracer)
        try:
            out = self.conn.query(buf)
        except (TimeoutError, ConnectionError, OSError) as exc:
            # satellite fix: a reply timeout (or a dead endpoint) maps to
            # the element's fallback policy instead of escaping the
            # streaming thread as a raw exception
            STATS.incr("query.fallbacks")
            if self._fallback == "passthrough":
                if self._passthrough_safe():
                    return self.push(buf)
                # shapes differ: degrade to drop rather than push an
                # input-shaped buffer through a downstream negotiated
                # for the server's answer caps
                from ..utils.log import logger

                logger.warning("%s: fallback=passthrough unsafe (server "
                               "caps differ from input); dropping frame",
                               self.name)
                return FlowReturn.DROPPED
            if self._fallback == "drop":
                return FlowReturn.DROPPED
            raise ConnectionError(
                f"{self.name}: query failed with fallback=error: "
                f"{exc!r}") from exc
        if out is None:
            return FlowReturn.ERROR
        if tracer is not None:
            # refresh the clock offset from a ping sample (unbiased by
            # model latency; rate-limited inside), then harvest the
            # server's T_TRACE piggyback into one merged timeline
            self.conn.sample_clock_offset()
            self._merge_remote_spans(tracer)
        if not getattr(self, "_announced_server_caps", True):
            # degraded start negotiated the passthrough shape; the
            # recovery that served this frame learned the server's real
            # answer caps — renegotiate downstream before pushing
            sc = self.conn.server_caps
            if sc:
                self._announced_server_caps = True
                self.announce_src_caps(Caps.from_string(sc))
        return self.push(out)
