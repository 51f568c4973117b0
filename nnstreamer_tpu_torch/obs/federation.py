"""Cross-process metric federation: N worker registries, ONE endpoint.

Every :class:`~nnstreamer_tpu_torch.obs.metrics.MetricsRegistry` is
process-local, so an N-worker serving fleet is N blind spots: no single
``/metrics`` scrape sees the fleet's queue depths, no single
``/healthz`` answers "is the fleet ready", and fleet-wide sustained
signals ("occupancy high across workers for 30 s") are not computable
anywhere.  This module closes that gap with a push model riding the
existing query wire:

- :class:`MetricsPublisher` (worker side) periodically snapshots its
  registry and pushes *deltas* — the keys whose state changed since the
  last push, each carrying its CUMULATIVE state — as ``T_METRICS``
  messages (query/protocol.py).  Cumulative-state deltas make the
  stream self-healing: a lost or duplicated push never corrupts
  counts, and a reconnect (collector restart, network blip) resends
  the FULL state.  Publisher wall stamps ride each push; the publisher
  estimates the collector's clock offset over ``T_PING``/``T_PONG``
  (the :class:`~nnstreamer_tpu_torch.obs.clock.OffsetEstimator`) and
  sends it along, so the collector re-bases every origin's timeline
  onto its own wall clock.

- :class:`MetricsCollector` (collector side) merges origin states under
  ``origin="host:pid"`` labels, drops duplicate/out-of-order pushes by
  sequence number, evicts origins that stop pushing
  (``stale_after_s``), and re-renders ONE federated ``/metrics``
  (its ``render_prometheus`` makes it a drop-in registry for
  ``start_metrics_server``) plus a worst-of-origins health source for
  ``/healthz``.  Its ``snapshot_state`` facade means a
  :class:`~nnstreamer_tpu_torch.obs.timeseries.TimeSeriesRing` — and
  therefore every :class:`SustainedSignal` — runs unchanged over the
  federated view.

- :class:`CollectorServer` is the standalone wire endpoint (accept
  loop over the protocol framing); alternatively any
  :class:`~nnstreamer_tpu_torch.query.server.QueryServer` accepts
  ``T_METRICS`` on its existing data connections once a collector is
  attached (``server.collector = collector``) — workers already
  connected to a front-end push telemetry on the same socket.

StreamTensor's (arXiv:2509.13694) framing applies: the dataflow plane
and its utilization evidence travel together — the same wire that
carries tensors carries the proof of how well it is being used.
"""

from __future__ import annotations

import json
import os
import socket
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ..analysis.sanitizer import make_lock
from .clock import OffsetEstimator, mono_ns, wall_us
from .metrics import (REGISTRY, MetricsRegistry, _escape_label_value,
                      quantile_from_counts)

#: default staleness horizon: an origin silent for this long is evicted
#: from the federated view (its worker died without a BYE, or its
#: publisher wedged — either way its last-known gauges are lies now)
DEFAULT_STALE_AFTER_S = 15.0
#: every Nth push is a FULL snapshot even without a reconnect, so keys
#: that disappeared from a worker's registry (unregistered gauges) age
#: out of the federated view within full_every x interval
DEFAULT_FULL_EVERY = 15

_HEALTH_SEVERITY = {"starting": 0, "serving": 1, "degraded": 2,
                    "draining": 3}


def origin_id() -> str:
    """This process's origin key: ``host:pid``."""
    return f"{socket.gethostname()}:{os.getpid()}"


def _valid_entry(entry: Any) -> bool:
    """Shape check for one pushed metric entry: exactly what every
    downstream consumer (state_delta, quantile_from_counts, the
    federated renderer) will read must be present and numeric."""
    if not isinstance(entry, dict):
        return False
    kind = entry.get("kind")
    if kind in ("counter", "gauge"):
        return isinstance(entry.get("value"), (int, float))
    if kind == "histogram":
        counts = entry.get("counts")
        return (isinstance(entry.get("count"), int)
                and isinstance(entry.get("total"), (int, float))
                and isinstance(counts, (list, tuple))
                and all(isinstance(c, int) for c in counts))
    return False


def _with_origin(key: str, origin: str) -> str:
    """Inject ``origin="…"`` into a ``name{labels}`` metric key (the
    federation label: one merged namespace, per-process series)."""
    esc = _escape_label_value(origin)
    name, brace, labels = key.partition("{")
    if not brace:
        return f'{name}{{origin="{esc}"}}'
    inner = labels[:-1]
    sep = "," if inner else ""
    return f'{name}{{{inner}{sep}origin="{esc}"}}'


class _Origin:
    """One worker's federated state."""

    __slots__ = ("key", "state", "last_seq", "epoch", "prev_epochs",
                 "last_push_mono", "last_push_wall_us", "offset_us",
                 "health", "meta", "pushes", "rejected")

    def __init__(self, key: str) -> None:
        self.key = key
        self.state: Dict[str, Any] = {}
        self.last_seq = -1
        self.epoch = None
        #: superseded incarnations (bounded): once an epoch has been
        #: replaced, NOTHING from it merges again — a dying worker's
        #: straggler full push must not resurrect dead state
        self.prev_epochs: "deque" = deque(maxlen=8)
        self.last_push_mono = 0.0
        self.last_push_wall_us = 0
        self.offset_us = 0
        self.health = "starting"
        self.meta: Dict[str, Any] = {}
        self.pushes = 0
        self.rejected = 0


class MetricsCollector:
    """Merges per-origin registry snapshots into one federated view.

    The LOCAL process's registry participates as its own origin (the
    collector host is usually also a worker — the soak's demo server,
    a fleet front-end), snapshotted live at read time so local gauges
    are never stale.

    Registry facade: ``render_prometheus()`` / ``report()`` /
    ``snapshot_state(prefix=)`` make the collector a drop-in for the
    httpd endpoint and the time-series ring; ``health()`` is the
    worst-of-origins readiness source (a stale-but-not-yet-evicted
    origin reads ``degraded`` — silence is not health).
    """

    def __init__(self, registry: Optional[MetricsRegistry] = REGISTRY,
                 local_origin: Optional[str] = None,
                 stale_after_s: float = DEFAULT_STALE_AFTER_S) -> None:
        self.registry = registry
        self.local_origin = local_origin or origin_id()
        self.stale_after_s = float(stale_after_s)
        self._lock = make_lock("obs.federation")
        self._origins: Dict[str, _Origin] = {}

    # -- ingest --------------------------------------------------------------
    def ingest(self, payload: Any, now: Optional[float] = None) -> bool:
        """One ``T_METRICS`` payload (bytes/str JSON or a dict); returns
        False when rejected (malformed, duplicate or out-of-order seq).

        Ordering discipline: pushes carry ``(epoch, seq)`` — ``epoch``
        identifies one publisher incarnation, ``seq`` its push counter.
        Within an epoch, only strictly increasing seqs merge (each
        key's pushed state is CUMULATIVE, so dropping a duplicate or a
        late-arriving older push loses nothing — the newer push already
        superseded it).  A new epoch (worker restarted) or a ``full``
        push REPLACES the origin's state outright — key tombstoning for
        free, and the counter-reset that comes with a restart is then
        caught downstream by ``state_delta``'s reset marking."""
        if isinstance(payload, (bytes, bytearray, memoryview)):
            try:
                payload = json.loads(bytes(payload).decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                return False
        if not isinstance(payload, dict):
            return False
        key = payload.get("origin")
        state = payload.get("state")
        if not key or not isinstance(key, str) \
                or not isinstance(state, dict):
            return False
        try:
            seq = int(payload.get("seq", 0))
            offset_us = int(payload.get("offset_us") or 0)
            wall_us_in = int(payload.get("wall_us") or 0)
        except (TypeError, ValueError):
            # malformed-but-valid-JSON push (buggy or version-skewed
            # publisher): reject it — it must never raise out of the
            # serving connection's reader thread
            return False
        # drop malformed metric entries rather than merging them: one
        # poisoned value (a None gauge, a histogram missing its bucket
        # vector) would crash every later snapshot_state / state_delta
        # / render consumer (the ring sampler, the federated scrape) —
        # and a dead fleet view is a worse failure than a dropped key
        state = {k: v for k, v in state.items()
                 if isinstance(k, str) and _valid_entry(v)}
        epoch = payload.get("epoch")
        full = bool(payload.get("full"))
        if now is None:
            now = mono_ns() / 1e9
        with self._lock:
            org = self._origins.get(key)
            if org is None:
                org = self._origins[key] = _Origin(key)
            elif epoch == org.epoch and seq <= org.last_seq:
                # duplicate or out-of-order within one incarnation:
                # the newer (already-merged) push supersedes it
                org.rejected += 1
                return False
            elif epoch != org.epoch and \
                    (not full or epoch in org.prev_epochs):
                # a LATE push from a superseded incarnation (its
                # SIGTERM final full push landing after the restart's
                # first push), or an epoch change carried by a DELTA
                # (a genuinely new incarnation always opens full —
                # reconnect forces one): merging either would
                # resurrect stale state and flip epoch tracking back
                org.rejected += 1
                return False
            if full or epoch != org.epoch:
                org.state = dict(state)
            else:
                org.state.update(state)
            if epoch != org.epoch and org.epoch is not None:
                org.prev_epochs.append(org.epoch)
            org.epoch = epoch
            org.last_seq = seq
            org.last_push_mono = now
            org.offset_us = offset_us
            # re-base the publisher's wall stamp onto OUR wall clock
            # (offset_us = collector_wall - publisher_wall, estimated
            # publisher-side over T_PING round trips)
            org.last_push_wall_us = wall_us_in + org.offset_us
            org.health = str(payload.get("health") or "serving")
            org.meta = {k: payload[k] for k in ("host", "pid")
                        if k in payload}
            org.pushes += 1
        return True

    def evict_stale(self, now: Optional[float] = None) -> List[str]:
        """Drop origins silent past ``stale_after_s``; returns the
        evicted origin keys."""
        if now is None:
            now = mono_ns() / 1e9
        horizon = now - self.stale_after_s
        with self._lock:
            victims = [k for k, o in self._origins.items()
                       if o.last_push_mono < horizon]
            for k in victims:
                del self._origins[k]
        return victims

    def forget(self, origin: str) -> bool:
        with self._lock:
            return self._origins.pop(origin, None) is not None

    # -- read side -----------------------------------------------------------
    def _origin_states(self, now: Optional[float] = None
                       ) -> List[Tuple[str, Dict[str, Any]]]:
        """(origin, state) pairs: evict first, then remote origins +
        the live local registry snapshot."""
        self.evict_stale(now)
        with self._lock:
            out = [(o.key, o.state) for o in self._origins.values()]
        if self.registry is not None:
            out.append((self.local_origin,
                        self.registry.snapshot_state()))
        return out

    def origins(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Per-origin summary rows (dashboard / flight-recorder feed)."""
        if now is None:
            now = mono_ns() / 1e9
        self.evict_stale(now)
        with self._lock:
            rows = [{"origin": o.key, "health": o.health,
                     "age_s": round(now - o.last_push_mono, 3),
                     "pushes": o.pushes, "rejected": o.rejected,
                     "last_seq": o.last_seq,
                     "offset_us": o.offset_us,
                     "keys": len(o.state), **o.meta}
                    for o in self._origins.values()]
        if self.registry is not None:
            rows.append({"origin": self.local_origin, "health": "local",
                         "age_s": 0.0, "pushes": 0, "rejected": 0,
                         "last_seq": -1, "offset_us": 0,
                         "keys": None, "pid": os.getpid(),
                         "host": socket.gethostname()})
        return rows

    def snapshot_state(self, prefix: str = "") -> Dict[str, Any]:
        """Federated ``snapshot_state``: every origin's keys, origin
        label injected — the time-series ring's substrate, so sustained
        signals evaluate over the whole fleet."""
        out: Dict[str, Any] = {}
        for origin, state in self._origin_states():
            for key, st in state.items():
                if prefix and not key.startswith(prefix):
                    continue
                out[_with_origin(key, origin)] = st
        return out

    def health(self) -> str:
        """Worst-of readiness across origins (the /healthz source):
        remote states as pushed, the local registry's own health rides
        the process's other sources; a stale origin inside the eviction
        horizon reads ``degraded`` — a worker that stopped pushing is
        not known-good."""
        now = mono_ns() / 1e9
        self.evict_stale(now)
        worst = "starting"
        with self._lock:
            for o in self._origins.values():
                state = o.health
                if state not in _HEALTH_SEVERITY:
                    continue
                if now - o.last_push_mono > max(2.0,
                                                self.stale_after_s / 3):
                    state = max(state, "degraded",
                                key=lambda s: _HEALTH_SEVERITY[s])
                if _HEALTH_SEVERITY[state] > _HEALTH_SEVERITY[worst]:
                    worst = state
        return worst

    def register_health(self, label: str = "federation") -> int:
        """Contribute the worst-of-origins state to this process's
        ``/healthz`` (obs/httpd.py health sources); returns the token
        for ``unregister_health_source``.  A federated endpoint then
        answers 503 when ANY worker reports draining/degraded or goes
        silent — load balancers see the fleet, not just this
        process."""
        from .httpd import register_health_source

        return register_health_source(self.health, label=label)

    def report(self) -> Dict[str, Any]:
        """JSON-friendly federated snapshot (flight-recorder timeline
        rows): per-origin flattened metrics + summary."""
        from .timeseries import flatten_state

        out: Dict[str, Any] = {}
        for origin, state in self._origin_states():
            flat = flatten_state(state)
            out[origin] = {k: round(v, 4) for k, v in flat.items()}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition of the FEDERATED view: every
        origin's series under its origin label, one family header per
        name (the httpd endpoint serves this when handed the collector
        as its registry)."""
        lines: List[str] = []
        seen = set()

        def family(name: str, kind: str) -> None:
            if name not in seen:
                seen.add(name)
                lines.append(f"# HELP {name} federated {kind}")
                lines.append(f"# TYPE {name} {kind}")

        for origin, state in self._origin_states():
            for key, st in sorted(state.items()):
                kind = st.get("kind")
                fkey = _with_origin(key, origin)
                name = key.partition("{")[0]
                if kind == "counter":
                    family(name, "counter")
                    lines.append(f"{fkey} {st['value']}")
                elif kind == "gauge":
                    v = st["value"]
                    family(name, "gauge")
                    val = "NaN" if v != v else repr(round(float(v), 6))
                    lines.append(f"{fkey} {val}")
                elif kind == "histogram":
                    family(name, "summary")
                    fname, brace, rest = fkey.partition("{")
                    inner = rest[:-1] if brace else ""
                    sep = "," if inner else ""
                    for q in (0.5, 0.95, 0.99):
                        qv = (quantile_from_counts(st["counts"], q)
                              if st["count"] else 0.0)
                        lines.append(
                            f'{fname}{{{inner}{sep}quantile="{q}"}} '
                            f"{round(qv, 3)}")
                    lines.append(f"{fname}_sum{{{inner}}} "
                                 f"{round(st['total'], 3)}")
                    lines.append(f"{fname}_count{{{inner}}} "
                                 f"{st['count']}")
        return "\n".join(lines) + "\n"


class CollectorServer:
    """Standalone wire endpoint for metric pushes: accepts protocol
    connections, ingests ``T_METRICS``, answers ``T_PING`` with a
    wall-stamped ``T_PONG`` (the publisher's clock-offset samples) and
    ``T_HELLO`` with an empty hello.  Everything else is ignored — this
    is a telemetry drain, not a serving plane."""

    def __init__(self, collector: MetricsCollector,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        self.collector = collector
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self.host = host
        self.port = self._sock.getsockname()[1]
        self._sock.listen(16)
        self._stop = threading.Event()
        self._lock = make_lock("obs.federation")
        self._conns: List[socket.socket] = []
        self._accept = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="nns-collector-accept")
        self._accept.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._conn_loop, args=(conn,),
                             daemon=True,
                             name="nns-collector-conn").start()

    def _conn_loop(self, conn: socket.socket) -> None:
        from ..query.protocol import (Message, T_BYE, T_HELLO,
                                      T_METRICS, T_PING, T_PONG,
                                      recv_msg, send_msg)

        send_lock = make_lock("query.send")
        try:
            while not self._stop.is_set():
                try:
                    msg = recv_msg(conn)
                except (TimeoutError, ValueError):
                    break
                if msg is None or msg.type == T_BYE:
                    break
                if msg.type == T_METRICS:
                    self.collector.ingest(msg.payload)
                elif msg.type == T_PING:
                    # wall-stamped pong: the publisher's offset sample
                    # (obs/clock.py NTP-midpoint over the push wire)
                    with send_lock:
                        send_msg(conn, Message(T_PONG, seq=msg.seq,
                                               epoch_us=wall_us(),
                                               payload=msg.payload))
                elif msg.type == T_HELLO:
                    with send_lock:
                        send_msg(conn, Message(T_HELLO))
        except OSError:
            pass
        finally:
            from ..query.protocol import shutdown_close

            with self._lock:
                try:
                    self._conns.remove(conn)
                except ValueError:
                    pass
            shutdown_close(conn)

    def close(self) -> None:
        from ..query.protocol import shutdown_close

        self._stop.set()
        # shutdown-then-close on the LISTENER too: a plain close does
        # not wake the blocked accept() on every platform, and a live
        # accept keeps squatting on the port so a restarted collector
        # cannot rebind (the protocol.shutdown_close lesson applied to
        # the listening socket)
        shutdown_close(self._sock)
        with self._lock:
            conns, self._conns = self._conns, []
        for conn in conns:
            shutdown_close(conn)


class MetricsPublisher:
    """Worker-side push loop: one background thread snapshotting the
    local registry every ``interval_s`` and pushing changed keys to the
    collector as ``T_METRICS``.

    Delta discipline: each push carries only the keys whose state
    changed since the last SENT snapshot — but every key's state is
    CUMULATIVE, so the stream tolerates loss and reordering by
    construction.  A reconnect (collector restarted, link dropped)
    resends FULL state; so does every ``full_every``-th push, bounding
    how long a deleted key survives in the federated view.

    Clock discipline: the publisher pings the collector every
    ``offset_every`` pushes and keeps the min-RTT offset estimate
    (obs/clock.py); each push carries the estimate so the collector
    re-bases this origin's wall stamps without trusting cross-host
    clock agreement.
    """

    def __init__(self, host: str, port: int,
                 registry: MetricsRegistry = REGISTRY,
                 interval_s: float = 1.0, prefix: str = "nns_",
                 origin: Optional[str] = None,
                 full_every: int = DEFAULT_FULL_EVERY,
                 offset_every: int = 5,
                 health_fn=None) -> None:
        from .span import new_trace_id

        self.host, self.port = host, int(port)
        self.registry = registry
        self.interval_s = max(1e-3, float(interval_s))
        self.prefix = prefix
        self.origin = origin or origin_id()
        self.full_every = max(1, int(full_every))
        self.offset_every = max(1, int(offset_every))
        #: one publisher incarnation: a restarted worker's pushes must
        #: not be sequenced against its previous life's
        self.epoch = new_trace_id()
        self.health_fn = health_fn
        self.offset = OffsetEstimator()
        self.pushes = 0
        self.send_errors = 0
        self._seq = 0
        self._last_sent: Dict[str, Any] = {}
        self._sock: Optional[socket.socket] = None
        self._send_lock = make_lock("query.send")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- wire ----------------------------------------------------------------
    def _connect(self) -> None:
        from ..query.protocol import (Message, T_HELLO, create_connection,
                                      recv_msg, send_msg)

        sock = create_connection((self.host, self.port), timeout=5.0)
        sock.settimeout(5.0)
        send_msg(sock, Message(T_HELLO))
        # drain the hello reply (the collector answers; a QueryServer
        # answers with its caps string — either way it is not ours to
        # interpret).  Sequential request/reply: nothing unsolicited
        # ever comes back on this wire, so no reader thread is needed.
        recv_msg(sock)
        self._sock = sock
        self._last_sent = {}        # force a FULL push after (re)connect

    def _disconnect(self) -> None:
        from ..query.protocol import shutdown_close

        sock, self._sock = self._sock, None
        if sock is not None:
            shutdown_close(sock)

    def _sample_offset(self) -> None:
        """One T_PING round trip → one offset sample (min-RTT filtered
        by the estimator).  Failures are ignored: offset refinement
        must never cost a push."""
        from ..query.protocol import (Message, T_PING, T_PONG, recv_msg,
                                      send_msg)

        sock = self._sock
        if sock is None:
            return
        self._seq += 1
        seq = self._seq
        try:
            t_send = wall_us()
            with self._send_lock:
                send_msg(sock, Message(T_PING, seq=seq))
            while True:
                msg = recv_msg(sock)
                if msg is None:
                    return
                if msg.type == T_PONG and msg.seq == seq:
                    if msg.epoch_us:
                        self.offset.add_sample(t_send, wall_us(),
                                               msg.epoch_us)
                    return
        except (TimeoutError, OSError, ValueError):
            return

    def push(self) -> bool:
        """One push now (the loop's tick; callable directly in tests).
        Returns True when a payload went out."""
        from ..query.protocol import Message, T_METRICS, send_msg

        state = self.registry.snapshot_state(prefix=self.prefix)
        full = (self._sock is None or not self._last_sent
                or self.pushes % self.full_every == 0)
        if self._sock is None:
            try:
                self._connect()
            except (OSError, ValueError):
                self.send_errors += 1
                return False
            full = True
        if full:
            changed = state
        else:
            # an all-quiet registry still pushes an EMPTY delta: the
            # push is the liveness heartbeat, so collector staleness
            # means a dead worker, never an idle one
            changed = {k: v for k, v in state.items()
                       if self._last_sent.get(k) != v}
        self._seq += 1
        health = "serving"
        if self.health_fn is not None:
            try:
                health = str(self.health_fn())
            except Exception:   # noqa: BLE001 — dead provider
                pass
        payload = {"origin": self.origin,
                   "host": socket.gethostname(), "pid": os.getpid(),
                   "epoch": self.epoch, "seq": self._seq,
                   "full": full, "wall_us": wall_us(),
                   "offset_us": self.offset.offset_us,
                   "health": health, "state": changed}
        try:
            with self._send_lock:
                send_msg(self._sock, Message(
                    T_METRICS, seq=self._seq, epoch_us=wall_us(),
                    payload=json.dumps(payload).encode()))
        except (OSError, AttributeError):
            self.send_errors += 1
            self._disconnect()      # next tick reconnects + resends full
            return False
        self._last_sent = state
        self.pushes += 1
        if self.pushes == 1 or self.pushes % self.offset_every == 0:
            self._sample_offset()
        return True

    # -- loop ----------------------------------------------------------------
    def start(self) -> "MetricsPublisher":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop,
                                            daemon=True,
                                            name="nns-metrics-push")
            self._thread.start()
        return self

    def stop(self, final_push: bool = True) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=10)
        if final_push and self._sock is not None:
            self.push()
        self._disconnect()

    def _loop(self) -> None:
        deadline = mono_ns() / 1e9 + self.interval_s
        while not self._stop.is_set():
            wait = deadline - mono_ns() / 1e9
            if wait > 0 and self._stop.wait(wait):
                return
            self.push()
            now = mono_ns() / 1e9
            deadline += self.interval_s
            if deadline < now:      # overran (reconnect): realign
                deadline = now + self.interval_s
