"""Open-loop load generator: coordinated-omission-free latency under
tens-to-hundreds of concurrent query clients.

**Open loop** is the load-model decision that makes the numbers honest.
A closed-loop generator (send, wait for the reply, send again) slows
down exactly when the system under test slows down — every stall
*removes* the requests that would have measured it, the classic
coordinated-omission blind spot.  Here every worker precomputes an
**arrival schedule** (absolute send offsets, Poisson or constant-rate,
seeded) before the run starts, and latency is measured from the
*scheduled* arrival time, not the actual send: when the server stalls
and a worker falls behind its schedule, the queued requests go out
back-to-back and their recorded latency includes the time they spent
waiting to be sent — which is exactly the latency a real independent
client arriving at that moment would have seen.

Each worker owns one :class:`~nnstreamer_tpu_torch.query.client.
QueryConnection` (its own TCP stream + reader thread — N workers model
N independent clients, and a chaos ``kill_connections`` severs N real
sockets).  Requests carry a **class tag** (``buf.extra["nns_class"]``,
weighted-random per request, seeded) and all accounting lands in the
process metrics registry under class-labeled families — the shared
contract ``slo/evaluator.py`` reads:

- ``nns_slo_requests_total{class=}`` / ``nns_slo_errors_total{class=}``
- ``nns_slo_latency_us{class=}`` — schedule-anchored (the honest one)
- ``nns_query_service_us{class=}`` — send-to-reply service latency via
  the ``QueryConnection.on_outcome`` hook; the gap between this and
  the schedule-anchored histogram IS the coordinated-omission evidence

All waits are ``Event.wait`` against absolute deadlines — ``time.sleep``
polling is banned in ``slo/``.
"""

from __future__ import annotations

import random
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.sanitizer import make_lock
from ..obs.clock import mono_ns
from ..obs.metrics import REGISTRY, MetricsRegistry, quantile_from_counts
from ..query.client import QueryConnection
from ..query.overload import ShedError
from ..tensor.buffer import TensorBuffer
from .spec import (ERRORS_TOTAL, ITL_US, LATENCY_US, REQUESTS_TOTAL,
                   TTFT_US)

SERVICE_US = "nns_query_service_us"
#: requests refused by server admission control (explicit T_SHED) — a
#: distinct family from errors: a shed is the overload layer WORKING,
#: and its latency must not poison the admitted-traffic distribution
SHED_TOTAL = "nns_slo_shed_total"


def poisson_schedule(rate_hz: float, duration_s: float,
                     rng: "random.Random") -> List[float]:
    """Poisson-process arrival offsets in ``[0, duration_s)``:
    exponential inter-arrivals at ``rate_hz`` — the memoryless model of
    independent user traffic."""
    out: List[float] = []
    t = rng.expovariate(rate_hz)
    while t < duration_s:
        out.append(t)
        t += rng.expovariate(rate_hz)
    return out


def constant_schedule(rate_hz: float, duration_s: float,
                      phase: float = 0.0) -> List[float]:
    """Constant-rate offsets (one every ``1/rate_hz`` s, shifted by
    ``phase`` so N workers interleave instead of thundering together)."""
    period = 1.0 / rate_hz
    n = int(duration_s * rate_hz)
    return [phase + i * period for i in range(n)
            if phase + i * period < duration_s]


class LoadGenerator:
    """Drive ``clients`` concurrent open-loop query streams against one
    endpoint for ``duration_s`` seconds.

    ``rate_hz`` is PER CLIENT (aggregate offered load =
    ``clients * rate_hz``).  ``classes`` is a ``[(name, weight), ...]``
    request-class mix.  ``run()`` blocks until every schedule is drained
    (or ``stop()``), returning a summary dict; the registry families
    above update live throughout, so an :class:`~nnstreamer_tpu_torch.slo.
    evaluator.SLOMonitor` gates the run while it happens.
    """

    def __init__(self, host: str, port: int, clients: int = 64,
                 rate_hz: float = 2.0, duration_s: float = 60.0,
                 schedule: str = "poisson", seed: int = 1234,
                 classes: Sequence[Tuple[str, float]] = (("default", 1.0),),
                 timeout: float = 2.0,
                 payload: Optional[np.ndarray] = None,
                 registry: MetricsRegistry = REGISTRY,
                 qos: bool = False,
                 payload_fn: Optional[Callable[[int, int],
                                               np.ndarray]] = None,
                 on_reply: Optional[Callable[[int, int, Any],
                                             None]] = None) -> None:
        if schedule not in ("poisson", "constant"):
            raise ValueError(f"schedule {schedule!r} "
                             "(want poisson | constant)")
        if clients < 1 or rate_hz <= 0 or duration_s <= 0:
            raise ValueError("clients >= 1, rate_hz > 0, duration_s > 0")
        self.host, self.port = host, int(port)
        self.clients = int(clients)
        self.rate_hz = float(rate_hz)
        self.duration_s = float(duration_s)
        self.schedule = schedule
        self.seed = int(seed)
        self.classes = [(str(n), float(w)) for n, w in classes]
        self.timeout = float(timeout)
        self.payload = (payload if payload is not None
                        else np.arange(4, dtype=np.float32))
        #: per-request payload ``payload_fn(client, request)`` instead
        #: of the one ``payload``, and ``on_reply(client, request,
        #: reply)`` for every answered request: a run whose replies are
        #: checked frame by frame
        self.payload_fn = payload_fn
        self.on_reply = on_reply
        self.registry = registry
        #: QoS mode: each WORKER is assigned one class from the mix
        #: (largest-remainder apportionment over the weights) and
        #: declares it as its connection's QoS class — the per-client
        #: tiering the server's admission control sheds against.  Off:
        #: classes stay weighted-random per request.
        self.qos = bool(qos)
        self._stop = threading.Event()
        self._lock = make_lock("slo")
        self._threads: List[threading.Thread] = []
        self._t0: float = 0.0
        self._live = 0
        self._peak_live = 0
        self._lag_us = [0] * self.clients
        self._counts = {"scheduled": 0, "sent": 0, "ok": 0, "errors": 0,
                        "shed": 0}
        self._shed_by_class = {c: 0 for c, _ in self.classes}
        # class-labeled metric families (shared contract with the
        # evaluator); gauges are lazy — scrape-time reads of loadgen
        # state, nothing per request beyond the counter/hist writes
        self._m_req = {c: registry.counter(REQUESTS_TOTAL, **{"class": c})
                       for c, _ in self.classes}
        self._m_err = {c: registry.counter(ERRORS_TOTAL, **{"class": c})
                       for c, _ in self.classes}
        self._m_lat = {c: registry.histogram(LATENCY_US, **{"class": c})
                       for c, _ in self.classes}
        self._m_srv = {c: registry.histogram(SERVICE_US, **{"class": c})
                       for c, _ in self.classes}
        self._m_shed = {c: registry.counter(SHED_TOTAL, **{"class": c})
                        for c, _ in self.classes}
        registry.gauge("nns_slo_active_clients", fn=lambda: self._live)
        registry.gauge("nns_slo_sched_lag_ms",
                       fn=lambda: max(self._lag_us) / 1e3)

    # -- schedules -----------------------------------------------------------
    def _make_schedule(self, idx: int) -> List[float]:
        if self.schedule == "poisson":
            return poisson_schedule(self.rate_hz, self.duration_s,
                                    random.Random(self.seed + idx))
        phase = (idx / self.clients) / self.rate_hz
        return constant_schedule(self.rate_hz, self.duration_s, phase)

    def _service_hook(self, cls: str, latency_s: float, ok: bool) -> None:
        hist = self._m_srv.get(cls)
        if hist is not None:
            hist.observe(latency_s * 1e6)

    # -- workers -------------------------------------------------------------
    def _qos_assignment(self) -> List[str]:
        """Per-worker class assignment for QoS mode: largest-remainder
        apportionment of ``clients`` workers over the class weights
        (deterministic — a 1:2:5 gold:silver:bronze mix over 64 workers
        is exactly 8/16/40)."""
        total_w = sum(w for _, w in self.classes) or 1.0
        exact = [(c, self.clients * w / total_w) for c, w in self.classes]
        counts = {c: int(x) for c, x in exact}
        remainder = self.clients - sum(counts.values())
        for c, _ in sorted(exact, key=lambda cw: cw[1] - int(cw[1]),
                           reverse=True)[:remainder]:
            counts[c] += 1
        out: List[str] = []
        for c, _ in self.classes:
            out.extend([c] * counts[c])
        return out

    def _worker(self, idx: int, offsets: List[float],
                cls_picks: List[str], worker_qos: Optional[str]) -> None:
        # staggered dial-in: a fleet of clients connecting in the same
        # instant overruns the server's accept/HELLO turnover, and the
        # colliding dials land in connect-retry backoff — seconds of
        # it, charged to the first scheduled arrivals (observed as a
        # one-bad-request-per-client 10 s latency tail).  Spreading the
        # dials costs nothing: arrivals are still anchored to t0.
        self._stop.wait(idx * 0.025)
        conn = QueryConnection(self.host, self.port,
                               timeout=self.timeout, max_retries=2,
                               qos=worker_qos)
        conn.on_outcome = self._service_hook
        try:
            conn.connect()
        except ConnectionError:
            pass    # each query() re-dials; down-at-start counts as
            #         errors per schedule slot, not a dead worker
        with self._lock:
            self._live += 1
            self._peak_live = max(self._peak_live, self._live)
        sent = ok = errors = 0
        shed_by_class: Dict[str, int] = {}
        try:
            for i, off in enumerate(offsets):
                target = self._t0 + off
                wait = target - mono_ns() / 1e9
                if wait > 0 and self._stop.wait(wait):
                    break
                if self._stop.is_set():
                    break
                cls = cls_picks[i]
                buf = TensorBuffer(tensors=[
                    self.payload if self.payload_fn is None
                    else self.payload_fn(idx, i)])
                buf.extra["nns_class"] = cls
                sent += 1
                shed = False
                try:
                    out = conn.query(buf)
                    good = out is not None
                    if good and self.on_reply is not None:
                        self.on_reply(idx, i, out)
                except ShedError:
                    # explicit server-side refusal: counted in its own
                    # family — neither an error (the overload layer
                    # answered, by design) nor an admitted-latency
                    # observation (a fast shed must not flatter p99)
                    good = False
                    shed = True
                except (TimeoutError, ConnectionError, OSError):
                    good = False
                end = mono_ns() / 1e9
                self._lag_us[idx] = max(0, int((end - target) * 1e6))
                self._m_req[cls].inc()
                if shed:
                    shed_by_class[cls] = shed_by_class.get(cls, 0) + 1
                    self._m_shed[cls].inc()
                    continue
                # schedule-anchored latency: queueing-behind-schedule
                # time included (open-loop correction).  Failed
                # requests observe too — the elapsed time (>= the
                # timeout) is a LOWER bound on what the client
                # experienced, so timeouts burn the latency budget
                # instead of vanishing from the distribution (the
                # blind spot a latency-only SLO would otherwise have)
                self._m_lat[cls].observe(
                    max(0.0, (end - target)) * 1e6)
                if good:
                    ok += 1
                else:
                    errors += 1
                    self._m_err[cls].inc()
        finally:
            try:
                conn.close()
            except OSError:
                pass
            with self._lock:
                self._live -= 1
                self._counts["sent"] += sent
                self._counts["ok"] += ok
                self._counts["errors"] += errors
                self._counts["shed"] += sum(shed_by_class.values())
                for c, n in shed_by_class.items():
                    self._shed_by_class[c] = \
                        self._shed_by_class.get(c, 0) + n

    # -- run -----------------------------------------------------------------
    def stop(self) -> None:
        self._stop.set()

    def run(self, warmup_s: Optional[float] = None) -> Dict[str, Any]:
        """Precompute every schedule, anchor a shared t0 ``warmup_s``
        out (all workers spawn and dial before the first arrival), run
        the schedules to exhaustion, and return the summary.  The
        default warmup scales with the fleet so the staggered dial-in
        (25 ms/client) completes before the first arrival."""
        if warmup_s is None:
            warmup_s = max(0.5, 0.03 * self.clients)
        rng = random.Random(self.seed ^ 0x5105)
        # baseline the shared histograms: registry.histogram() returns
        # the same instance across LoadGenerator runs in one process,
        # so summary quantiles must diff against THIS run's start or a
        # second soak would report the first soak's distribution too
        self._lat_base = {c: h.state()[2]
                          for c, h in self._m_lat.items()}
        self._srv_base = {c: h.state()[2]
                          for c, h in self._m_srv.items()}
        names = [c for c, _ in self.classes]
        weights = [w for _, w in self.classes]
        qos_by_worker = (self._qos_assignment() if self.qos
                         else [None] * self.clients)
        schedules = []
        for idx in range(self.clients):
            offsets = self._make_schedule(idx)
            if self.qos:
                # QoS mode: the worker's whole stream carries its
                # assigned class — per-CLIENT tiering, matching the
                # per-connection QoS the server admits against
                picks = [qos_by_worker[idx]] * len(offsets)
            else:
                picks = rng.choices(names, weights=weights,
                                    k=len(offsets)) if offsets else []
            schedules.append((offsets, picks))
            self._counts["scheduled"] += len(offsets)
        t_start = mono_ns() / 1e9
        self._t0 = t_start + max(0.0, warmup_s)
        self._threads = [
            threading.Thread(target=self._worker,
                             args=(idx, offsets, picks,
                                   qos_by_worker[idx]), daemon=True,
                             name=f"loadgen-{idx}")
            for idx, (offsets, picks) in enumerate(schedules)]
        for t in self._threads:
            t.start()
        for t in self._threads:
            # bounded join: schedules end on their own; the margin
            # covers a final in-flight request timing out
            t.join(timeout=self.duration_s + warmup_s
                   + 4 * self.timeout + 30)
        elapsed = mono_ns() / 1e9 - self._t0
        return self.summary(elapsed)

    def summary(self, elapsed_s: float) -> Dict[str, Any]:
        with self._lock:
            counts = dict(self._counts)
            peak = self._peak_live
            shed_by_class = dict(self._shed_by_class)
        lat = self._quantiles(self._m_lat,
                              getattr(self, "_lat_base", {}))
        srv = self._quantiles(self._m_srv,
                              getattr(self, "_srv_base", {}))
        sent = counts["sent"]
        return {"clients": self.clients, "peak_live_clients": peak,
                "schedule": self.schedule, "qos": self.qos,
                "rate_hz_per_client": self.rate_hz,
                "offered_rate_hz": round(self.clients * self.rate_hz, 2),
                "duration_s": round(elapsed_s, 2), **counts,
                "achieved_rate_hz": round(sent / elapsed_s, 2)
                if elapsed_s > 0 else 0.0,
                "error_fraction": round(counts["errors"] / sent, 6)
                if sent else 0.0,
                # shed accounting: fraction of OFFERED traffic the
                # server refused with explicit T_SHED, and its class
                # split — admitted latency above excludes these
                "shed_fraction": round(counts["shed"] / sent, 6)
                if sent else 0.0,
                "shed_by_class": shed_by_class,
                "latency_us": lat, "service_us": srv,
                "max_sched_lag_ms": round(max(self._lag_us) / 1e3, 1)}

    @staticmethod
    def _hist_bases(hists: Dict[str, Any]) -> Dict[str, Any]:
        """Per-class bucket baselines at run start (shared registry
        instances accumulate across runs — summaries must diff)."""
        return {c: h.state()[2] for c, h in hists.items()}

    @staticmethod
    def _quantiles(hists: Dict[str, Any],
                   bases: Dict[str, Any]) -> Dict[str, float]:
        counts: Optional[List[int]] = None
        for cls, h in hists.items():
            _, _, c = h.state()
            base = bases.get(cls)
            if base is not None:
                c = [max(0, v - b) for v, b in zip(c, base)]
            if counts is None:
                counts = list(c)
            else:
                for i, v in enumerate(c):
                    counts[i] += v
        if not counts or not sum(counts):
            return {}
        return {q: round(quantile_from_counts(counts, v), 1)
                for q, v in (("p50", 0.50), ("p95", 0.95),
                             ("p99", 0.99))}


class TokenLoadGenerator(LoadGenerator):
    """Open-loop TOKEN-STREAM load: every schedule slot opens one
    ``tensor_llm`` stream (:class:`~nnstreamer_tpu_torch.llm.client.
    TokenStreamClient`) and the per-token receive stamps become the
    coordinated-omission-free token-latency families the ttft/itl SLO
    kinds gate:

    - ``nns_slo_ttft_us{class=}`` — first token stamp minus the
      *scheduled* arrival, NOT the actual send: a worker that fell
      behind schedule charges the queueing to TTFT exactly as an
      independent client arriving on time would have experienced it
      (the open-loop correction, applied to token streams).  A stream
      that produced no first token at all (per-token timeout, dead
      connection) observes its elapsed time as a LOWER bound — a
      stalled server burns the TTFT budget instead of vanishing.
    - ``nns_slo_itl_us{class=}`` — consecutive receive-stamp gaps of
      REAL tokens (a negative terminal marker — the server's refusal /
      eviction frame — is not a token: its gap never observes, and a
      marker-only answer is an error with no TTFT at all, so refusals
      cannot flatter the admitted distribution).
    - sheds land in ``nns_slo_shed_total`` and observe nothing, as in
      the base generator.
    """

    def __init__(self, host: str, port: int,
                 prompt: Sequence[int] = (1, 2, 3, 4),
                 max_new: int = 16, stop_token: int = -1,
                 frame_len: Optional[int] = None,
                 token_timeout: Optional[float] = None,
                 **kw: Any) -> None:
        super().__init__(host, port, **kw)
        self.prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        self.max_new = int(max_new)
        self.stop_token = int(stop_token)
        self.frame_len = frame_len
        self.token_timeout = (float(token_timeout)
                              if token_timeout is not None
                              else self.timeout)
        registry = self.registry
        self._m_ttft = {c: registry.histogram(TTFT_US, **{"class": c})
                        for c, _ in self.classes}
        self._m_itl = {c: registry.histogram(ITL_US, **{"class": c})
                       for c, _ in self.classes}

    def run(self, warmup_s: Optional[float] = None) -> Dict[str, Any]:
        self._ttft_base = self._hist_bases(self._m_ttft)
        self._itl_base = self._hist_bases(self._m_itl)
        return super().run(warmup_s)

    def _worker(self, idx: int, offsets: List[float],
                cls_picks: List[str],
                worker_qos: Optional[str]) -> None:
        from ..llm.client import TokenStreamClient, TokenTimeoutError

        self._stop.wait(idx * 0.025)
        cli = TokenStreamClient(self.host, self.port,
                                timeout=self.timeout, qos=worker_qos,
                                token_timeout=self.token_timeout)
        try:
            cli.connect()
        except ConnectionError:
            pass    # stream() raises per slot; down-at-start = errors
        with self._lock:
            self._live += 1
            self._peak_live = max(self._peak_live, self._live)
        sent = ok = errors = 0
        shed_by_class: Dict[str, int] = {}
        try:
            for i, off in enumerate(offsets):
                target = self._t0 + off
                wait = target - mono_ns() / 1e9
                if wait > 0 and self._stop.wait(wait):
                    break
                if self._stop.is_set():
                    break
                cls = cls_picks[i]
                sent += 1
                shed = False
                failed = False
                toks: List[int] = []
                try:
                    for _, tok in cli.stream(self.prompt, self.max_new,
                                             self.stop_token,
                                             self.frame_len):
                        toks.append(tok)
                except ShedError:
                    shed = True
                except (TokenTimeoutError, TimeoutError,
                        ConnectionError, OSError, ValueError):
                    failed = True
                end = mono_ns() / 1e9
                self._lag_us[idx] = max(0, int((end - target) * 1e6))
                self._m_req[cls].inc()
                if shed:
                    shed_by_class[cls] = shed_by_class.get(cls, 0) + 1
                    self._m_shed[cls].inc()
                    continue
                stamps = list(cli.stamps_ns)
                n_real = len(toks)
                if toks and toks[-1] < 0:
                    n_real -= 1    # terminal marker, not a token
                if n_real > 0:
                    # schedule-anchored TTFT (open-loop correction)
                    self._m_ttft[cls].observe(max(
                        0.0, (stamps[0] / 1e9 - target)) * 1e6)
                    hist = self._m_itl[cls]
                    for j in range(1, n_real):
                        hist.observe(max(0.0, (stamps[j]
                                               - stamps[j - 1]) / 1e3))
                elif failed:
                    # no first token at all: elapsed is a LOWER bound
                    self._m_ttft[cls].observe(
                        max(0.0, end - target) * 1e6)
                # a negative LAST token is the server's refusal /
                # eviction marker: the stream answered, but not with
                # the requested generation — an error, though any real
                # tokens before the marker still observed above
                good = not failed and n_real > 0 and toks[-1] >= 0
                if good:
                    ok += 1
                else:
                    errors += 1
                    self._m_err[cls].inc()
        finally:
            try:
                cli.close()
            except OSError:
                pass
            with self._lock:
                self._live -= 1
                self._counts["sent"] += sent
                self._counts["ok"] += ok
                self._counts["errors"] += errors
                self._counts["shed"] += sum(shed_by_class.values())
                for c, n in shed_by_class.items():
                    self._shed_by_class[c] = \
                        self._shed_by_class.get(c, 0) + n

    def summary(self, elapsed_s: float) -> Dict[str, Any]:
        out = super().summary(elapsed_s)
        out["token_latency"] = {
            "ttft_us": self._quantiles(self._m_ttft,
                                       getattr(self, "_ttft_base", {})),
            "itl_us": self._quantiles(self._m_itl,
                                      getattr(self, "_itl_base", {})),
        }
        return out
