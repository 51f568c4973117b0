"""``tensor_query_router``: one endpoint in front of a worker fleet.

Clients speak the ordinary query protocol (query/protocol.py) to ONE
address; the router terminates each client connection and forwards its
frames to a :class:`~nnstreamer_tpu_torch.query.server.QueryServer` worker
process picked by consistent hash (fleet/ring.py) over the client's
negotiated *model identity* (a ``model=<name>`` token in the T_HELLO
payload; clients that declare none get a per-connection spread key, so
anonymous traffic balances while model-tagged traffic concentrates —
the per-model cross-stream buckets stay dense on few workers).

The backend leg of every client is a
:class:`~nnstreamer_tpu_torch.query.client.FailoverConnection` whose
``dest-hosts`` list is the key's ring candidate set in preference
order.  That one choice buys the whole resilience story for free:

- a worker killed mid-query is a transport failure → the failover path
  retries the frame on the next candidate inside the same request
  budget — the client sees a slightly slower reply, never an error;
- a draining worker answers ``T_SHED`` → the failover path rotates to
  a healthy candidate immediately (shed-is-liveness) and only
  when EVERY candidate sheds does the shed pass through to the client,
  retry-after intact — T_SHED/QoS semantics are end-to-end, the router
  adds no policy of its own;
- membership changes (pool spawn/drain/crash) call
  :meth:`FailoverConnection.set_endpoints` on the live clients whose
  candidate set changed — the hot-update path keeps the active backend
  socket when it is still a candidate, so a membership change moves
  the minimal key range with zero reconnect storm.

QoS passes through untouched: the client's ``qos=`` declaration is
re-announced on the backend leg, so the WORKER's admission control
(query/overload.py) stays the only shed decider.
"""

from __future__ import annotations

import socket
import threading
from typing import Dict, List, Optional, Tuple

from ..analysis.sanitizer import make_lock
from ..obs.clock import wall_us
from ..obs.metrics import REGISTRY, Gauge
from ..obs.span import TraceContext
from ..query.client import FailoverConnection
from ..query.overload import ShedError, qos_of_class
from ..query.protocol import (Message, T_BYE, T_DATA, T_HELLO, T_METRICS,
                              T_PING, T_PONG, T_REPLY, T_SHED, T_TRACE,
                              decode_tensors, parse_hello_tokens,
                              recv_msg, send_msg, send_tensors,
                              shutdown_close)
from ..query.resilience import CircuitOpenError, RetryPolicy
from ..tensor.buffer import TensorBuffer, default_pool
from .ring import ConsistentHashRing


class _Worker:
    __slots__ = ("key", "endpoint", "draining", "gauges")

    def __init__(self, key: str, endpoint: Tuple[str, int]) -> None:
        self.key = key
        self.endpoint = endpoint
        self.draining = False
        self.gauges: list = []


class _Routed:
    """One client connection's routing state."""

    __slots__ = ("cid", "conn", "slock", "fc", "key", "model", "qos")

    def __init__(self, cid: int, conn: socket.socket, slock) -> None:
        self.cid = cid
        self.conn = conn
        self.slock = slock
        self.fc: Optional[FailoverConnection] = None
        self.key = ""
        self.model = ""
        self.qos: Optional[str] = None


class TensorQueryRouter:
    """Front-end router: accept clients, forward per-frame to the
    consistent-hash-chosen worker, answer with the worker's reply.

    Membership is driven from outside (fleet/pool.py callbacks or
    direct :meth:`add_worker` / :meth:`mark_draining` /
    :meth:`remove_worker` calls); the router owns only placement and
    per-client forwarding state.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 replicas: int = 2, timeout: float = 10.0,
                 max_retries: int = 3,
                 breaker_failures: int = 5,
                 breaker_cooldown: float = 10.0,
                 ring_seed: str = "nns-fleet",
                 ring_vnodes: int = 64,
                 collector=None) -> None:
        self.host = host
        self.replicas = max(0, int(replicas))
        self.timeout = float(timeout)
        self.max_retries = int(max_retries)
        self.breaker_failures = int(breaker_failures)
        self.breaker_cooldown = float(breaker_cooldown)
        self.ring = ConsistentHashRing(vnodes=ring_vnodes, seed=ring_seed)
        #: telemetry collector (obs/federation.py): workers pushing
        #: T_METRICS through the router's endpoint merge here, exactly
        #: like the QueryServer piggyback.  Unattached: pushes drop.
        self.collector = collector
        self._workers: Dict[str, _Worker] = {}
        self._clients: Dict[int, _Routed] = {}
        self._next_cid = 1
        self._lock = make_lock("fleet.router")
        self._stop = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self.port = self._sock.getsockname()[1]
        self._sock.listen(64)
        labels = {"port": str(self.port)}
        self._gauges = [
            REGISTRY.register(Gauge("nns_fleet_role",
                                    {**labels, "role": "router"},
                                    fn=lambda: 1.0)),
            REGISTRY.register(Gauge("nns_fleet_router_clients",
                                    dict(labels),
                                    fn=lambda: len(self._clients))),
            REGISTRY.register(Gauge("nns_fleet_workers", dict(labels),
                                    fn=lambda: len(self._workers))),
        ]
        self._m_accepted = REGISTRY.counter(
            "nns_fleet_accepted_total", **labels)
        self._m_rebalanced = REGISTRY.counter(
            "nns_fleet_rebalanced_total", **labels)
        self._m_forwarded = REGISTRY.counter(
            "nns_fleet_forwarded_total", **labels)
        self._m_sheds = REGISTRY.counter(
            "nns_fleet_router_sheds_total", **labels)
        self._m_errors = REGISTRY.counter(
            "nns_fleet_router_errors_total", **labels)
        #: unregistered at close(): each router instance labels its
        #: series with its ephemeral port, so abandoned counters would
        #: grow the registry once per router ever built in the process
        #: (the bench gate builds one per measurement attempt)
        self._counters = [self._m_accepted, self._m_rebalanced,
                          self._m_forwarded, self._m_sheds,
                          self._m_errors]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="fleet-router")
        self._accept_thread.start()

    # -- membership ----------------------------------------------------------
    @staticmethod
    def worker_key(host: str, port: int) -> str:
        return f"{host}:{port}"

    def add_worker(self, host: str, port: int) -> str:
        """Join a worker; live clients whose candidate set now includes
        it pick it up via the hot endpoint update (minimal movement:
        only keys on the new member's arcs change owners)."""
        key = self.worker_key(host, port)
        with self._lock:
            if key in self._workers:
                w = self._workers[key]
                if w.draining:     # resurrected (crash-restart reusing
                    w.draining = False   # the port): back in rotation
                    self.ring.add(key)
                    self._rebalance_locked()
                return key
            w = _Worker(key, (host, int(port)))
            w.gauges = [
                REGISTRY.register(Gauge(
                    "nns_fleet_routed_connections",
                    {"port": str(self.port), "worker": key},
                    fn=lambda k=key: self._routed_count(k))),
                REGISTRY.register(Gauge(
                    "nns_fleet_worker_draining",
                    {"port": str(self.port), "worker": key},
                    fn=lambda k=key: 1.0 if (
                        k in self._workers
                        and self._workers[k].draining) else 0.0)),
            ]
            self._workers[key] = w
            self.ring.add(key)
            self._rebalance_locked()
        return key

    def mark_draining(self, key: str) -> None:
        """Scale-down step 1 (BEFORE the worker gets SIGTERM): leave
        the ring so no new connection routes here, and move live
        clients off via the failover hot update — by the time the
        worker starts shedding, the router has already routed away."""
        with self._lock:
            w = self._workers.get(key)
            if w is None or w.draining:
                return
            w.draining = True
            self.ring.remove(key)
            self._rebalance_locked()

    def remove_worker(self, key: str) -> None:
        with self._lock:
            w = self._workers.pop(key, None)
            if w is None:
                return
            self.ring.remove(key)
            for g in w.gauges:
                REGISTRY.unregister(g)
            self._rebalance_locked()

    def workers(self) -> List[Dict[str, object]]:
        """Membership snapshot (dashboard / soak verdict rows)."""
        with self._lock:
            return [{"worker": w.key, "draining": w.draining,
                     "routed": self._routed_count(w.key)}
                    for w in self._workers.values()]

    def _routed_count(self, key: str) -> int:
        # lock-free scrape read over the clients' _active_key mirrors
        # (the same deliberate choice as FailoverConnection.degraded():
        # a torn read costs one off-by-one sample, not a scrape stalled
        # behind a seconds-long backend dial)
        return sum(1 for rc in list(self._clients.values())
                   if rc.fc is not None and rc.fc._active_key == key)

    # -- placement -----------------------------------------------------------
    def _candidates_locked(self, key: str) -> List[Tuple[str, int]]:
        n = self.replicas or len(self.ring)
        cands = self.ring.lookup_n(key, max(1, n))
        eps = [self._workers[k].endpoint for k in cands
               if k in self._workers and not self._workers[k].draining]
        if not eps:
            # every ring candidate gone mid-change: any live worker
            # beats refusing (the ring re-converges on the next
            # membership event)
            eps = [w.endpoint for _k, w in sorted(self._workers.items())
                   if not w.draining]
        return eps

    def _rebalance_locked(self) -> None:
        for rc in self._clients.values():
            if rc.fc is None:
                continue
            eps = self._candidates_locked(rc.key)
            if eps and list(rc.fc.endpoints) != eps:
                rc.fc.set_endpoints(eps)
                self._m_rebalanced.inc()

    def _bind_backend(self, rc: _Routed) -> None:
        """Create the client's backend failover leg (ring candidates in
        preference order).  ``shed_passthrough``: with no alternate to
        absorb a shed the router must FORWARD it immediately — sleeping
        out the retry-after here would turn an explicit, fast shed into
        opaque added latency inside the client's budget."""
        with self._lock:
            eps = self._candidates_locked(rc.key)
        if not eps:
            raise ConnectionError("no workers in the fleet")
        rc.fc = FailoverConnection(
            eps, timeout=self.timeout, max_retries=self.max_retries,
            retry=RetryPolicy(max_attempts=max(1, self.max_retries),
                              base_delay=0.05, max_delay=0.5),
            breaker_failures=self.breaker_failures,
            breaker_cooldown=self.breaker_cooldown,
            name=f"router-{rc.cid}", qos=rc.qos,
            shed_passthrough=True)
        rc.fc.connect()

    # -- wire ----------------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                cid = self._next_cid
                self._next_cid += 1
                rc = _Routed(cid, conn, make_lock("query.send"))
                self._clients[cid] = rc
            self._m_accepted.inc()
            threading.Thread(target=self._client_loop, args=(rc,),
                             daemon=True,
                             name=f"fleet-route-{cid}").start()

    def _client_loop(self, rc: _Routed) -> None:
        pool = default_pool()
        conn = rc.conn
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn, pool=pool)
                except TimeoutError:
                    continue
                except ValueError:   # bad magic / CRC: drop the client
                    break
                if msg is None or msg.type == T_BYE:
                    break
                if msg.type == T_HELLO:
                    self._on_hello(rc, msg)
                elif msg.type == T_PING:
                    # answered locally: liveness of the ENDPOINT is the
                    # router's to prove — heartbeats must not stall
                    # behind a backend dial
                    with rc.slock:
                        send_msg(conn, Message(T_PONG, client_id=rc.cid,
                                               seq=msg.seq,
                                               epoch_us=wall_us(),
                                               payload=msg.payload))
                elif msg.type == T_METRICS:
                    collector = self.collector
                    if collector is not None:
                        collector.ingest(bytes(msg.payload or b""))
                elif msg.type == T_DATA:
                    if not self._on_data(rc, msg):
                        break
        except OSError:
            pass
        finally:
            with self._lock:
                self._clients.pop(rc.cid, None)
            if rc.fc is not None:
                rc.fc.close(send_bye=False)
            shutdown_close(conn)

    def _on_hello(self, rc: _Routed, msg: Message) -> None:
        tokens = parse_hello_tokens(msg.payload)
        qos = qos_of_class(tokens.get("qos"))
        if qos is not None:
            rc.qos = qos
        model = tokens.get("model", rc.model)
        # model identity keys the ring; anonymous connections spread by
        # connection id (consistent placement, no accidental pile-up of
        # every untagged client on one worker)
        rekey = model != rc.model and rc.fc is not None
        rc.model = model
        rc.key = model or f"conn:{rc.cid}"
        caps = ""
        if rc.fc is None:
            try:
                self._bind_backend(rc)
            except (ConnectionError, CircuitOpenError, OSError):
                rc.fc = None   # lazy: first DATA retries the dial
        else:
            if qos is not None:
                rc.fc.set_qos(qos)
            if rekey:
                # re-HELLO with a DIFFERENT model: the backend leg must
                # follow the new key's candidate set now, not at the
                # next unrelated membership event — otherwise this
                # stream keeps diluting the old model's buckets
                with self._lock:
                    eps = self._candidates_locked(rc.key)
                if eps and list(rc.fc.endpoints) != eps:
                    rc.fc.set_endpoints(eps)
                    self._m_rebalanced.inc()
        if rc.fc is not None:
            # the worker's caps answer lands async on the backend
            # reader — wait briefly so the client's handshake carries
            # the real serving caps, not an empty racing read
            caps = rc.fc.wait_server_caps(
                min(2.0, self.timeout)) or ""
        with rc.slock:
            send_msg(rc.conn, Message(T_HELLO, client_id=rc.cid,
                                      payload=caps.encode()))

    def _on_data(self, rc: _Routed, msg: Message) -> bool:
        """Forward one frame; False drops the client connection (the
        honest signal when no backend can be reached — a synthetic shed
        would disguise a dead fleet as a protecting one)."""
        seq = msg.seq
        ctx = TraceContext(msg.trace_id, msg.span_id, msg.origin_us)
        if rc.fc is None:
            rc.key = rc.key or f"conn:{rc.cid}"
            try:
                self._bind_backend(rc)
            except (ConnectionError, CircuitOpenError, OSError):
                self._m_errors.inc()
                return False
        buf = TensorBuffer(tensors=decode_tensors(msg.payload),
                           pts=msg.pts, lease=msg.lease)
        if msg.trace_id:
            buf.extra["nns_trace"] = ctx
        try:
            out = rc.fc.query(buf)
        except ShedError as exc:
            # T_SHED passthrough: every candidate shed (fleet-wide
            # overload or drain) — forward the worker's own verdict,
            # retry-after intact
            self._m_sheds.inc()
            with rc.slock:
                send_msg(rc.conn, Message(
                    T_SHED, client_id=rc.cid, seq=seq,
                    epoch_us=wall_us(),
                    payload=str(int(exc.retry_after_s * 1000)).encode()))
            return True
        except (CircuitOpenError, ConnectionError, TimeoutError,
                OSError):
            self._m_errors.inc()
            return False
        if out is None:
            self._m_errors.inc()
            return False
        self._m_forwarded.inc()
        trace_batches = (rc.fc.drain_remote_traces()
                         if msg.trace_id else ())
        with rc.slock:
            send_tensors(rc.conn, T_REPLY, out, client_id=rc.cid,
                         seq=seq, pts=out.pts or 0, epoch_us=wall_us(),
                         trace_id=ctx.trace_id, span_id=ctx.span_id,
                         origin_us=ctx.origin_us)
            for raw, _off, _key in trace_batches:
                # worker span piggyback rides through: the client's
                # tracer merges the serving process under its timeline
                # exactly as if it had dialed the worker directly
                send_msg(rc.conn, Message(T_TRACE, client_id=rc.cid,
                                          trace_id=ctx.trace_id,
                                          epoch_us=wall_us(),
                                          payload=raw))
        return True

    # -- lifecycle -----------------------------------------------------------
    def close(self) -> None:
        self._stop.set()
        shutdown_close(self._sock)
        with self._lock:
            clients = list(self._clients.values())
            self._clients.clear()
            workers = list(self._workers.values())
            self._workers.clear()
            for g in self._gauges:
                REGISTRY.unregister(g)
            self._gauges = []
            for c in self._counters:
                REGISTRY.unregister(c)
            self._counters = []
            for w in workers:
                for g in w.gauges:
                    REGISTRY.unregister(g)
        for rc in clients:
            if rc.fc is not None:
                rc.fc.close(send_bye=False)
            shutdown_close(rc.conn)
