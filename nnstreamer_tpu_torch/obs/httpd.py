"""Live metrics endpoint: ``GET /metrics`` in Prometheus text format.

Pull-based by design (the zero-hot-path-cost contract of obs/metrics.py
only holds when evaluation happens at scrape time): a tiny
``ThreadingHTTPServer`` on ``NNS_METRICS_PORT`` serves

- ``/metrics`` — Prometheus text exposition of the process registry
  (plus the query layer's resilience counters), and
- ``/healthz`` — readiness JSON: the worst state across every
  registered health source (``starting < serving < degraded <
  draining``), HTTP 200 while ``starting``/``serving`` and 503 while
  ``degraded``/``draining`` — load-balancer-pollable without parsing.

Health sources are callables returning a state string; pipelines
register one at ``play()`` (lifecycle + per-element degradation — a
``tensor_query_client`` with an OPEN circuit breaker reports
``degraded``) and unregister at ``stop()``.  With no sources the
process reports ``starting``: up, serving nothing yet.

Activation is explicit (``start_metrics_server``) or environmental
(``maybe_start_from_env`` — called once from ``Pipeline.play()`` and
``launch.py``): an unset ``NNS_METRICS_PORT`` costs one cached getenv
per process, nothing per pipeline.
"""

from __future__ import annotations

import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..analysis.sanitizer import make_lock
from .metrics import REGISTRY, MetricsRegistry

_STATE_LOCK = make_lock("leaf")
_SERVER: Optional[ThreadingHTTPServer] = None
_ENV_TRIED = False

#: readiness states ordered by severity: /healthz reports the WORST
#: state any registered source claims (a process serving one healthy
#: and one degraded pipeline is degraded)
HEALTH_STATES = ("starting", "serving", "degraded", "draining")
_SEVERITY = {s: i for i, s in enumerate(HEALTH_STATES)}
#: states the endpoint answers 200 for; degraded/draining answer 503
#: so a load balancer drains traffic without parsing the JSON body
_READY_STATES = frozenset({"starting", "serving"})

_HEALTH_LOCK = make_lock("leaf")
_HEALTH_SOURCES: dict = {}      # token -> (label, provider callable)
_HEALTH_NEXT = 1


def register_health_source(provider, label: str = "") -> int:
    """Register a readiness provider (a callable returning one of
    :data:`HEALTH_STATES`); returns a token for unregistration.
    Pipelines call this from ``play()``."""
    global _HEALTH_NEXT
    with _HEALTH_LOCK:
        token = _HEALTH_NEXT
        _HEALTH_NEXT += 1
        _HEALTH_SOURCES[token] = (label or f"source-{token}", provider)
        return token


def unregister_health_source(token: int) -> None:
    with _HEALTH_LOCK:
        _HEALTH_SOURCES.pop(token, None)


def health_report() -> dict:
    """Aggregate readiness: worst state across sources, plus the
    per-source breakdown.  A provider that raises (element stopped
    under the scrape) is skipped rather than failing the probe."""
    with _HEALTH_LOCK:
        sources = list(_HEALTH_SOURCES.values())
    per = {}
    worst = "starting"
    for label, provider in sources:
        try:
            state = str(provider())
        except Exception:   # noqa: BLE001 — dead provider, skip
            continue
        if state not in _SEVERITY:
            continue
        per[label] = state
        if _SEVERITY[state] > _SEVERITY[worst]:
            worst = state
    return {"state": worst, "ready": worst in _READY_STATES,
            "sources": per}


class _Handler(BaseHTTPRequestHandler):
    registry: MetricsRegistry = REGISTRY

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        import json as _json

        status = 200
        path = self.path.split("?", 1)[0]
        # the render walks live element state (lazy gauge providers)
        # that a concurrent Pipeline.stop() is tearing down: dead
        # providers yield dropped samples (obs/metrics.py Gauge
        # contract), and anything that still escapes answers 503 —
        # a scrape must never 500 or leak an exception into this
        # serving thread
        try:
            if path == "/metrics":
                body = self.registry.render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                report = health_report()
                body = (_json.dumps(report) + "\n").encode()
                ctype = "application/json"
                if not report["ready"]:
                    status = 503
            else:
                self.send_error(404)
                return
        except Exception:   # noqa: BLE001 — teardown race backstop
            status = 503
            body = b"scrape raced teardown; retry\n"
            ctype = "text/plain; charset=utf-8"
        try:
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except OSError:
            pass   # client hung up mid-reply: nothing to serve

    def log_message(self, fmt, *args):  # silence per-scrape stderr spam
        pass


def start_metrics_server(port: int, host: str = "127.0.0.1",
                         registry: MetricsRegistry = REGISTRY
                         ) -> ThreadingHTTPServer:
    """Start the endpoint on ``host:port``.  Idempotent per process: a
    second call returns the running server.

    ``port=0`` binds an EPHEMERAL port — the multi-process contract: a
    fleet of worker processes sharing one machine (or one test suite)
    must never collide on a fixed 9090-style port.  The chosen port is
    logged, readable via :func:`bound_metrics_port` (and
    ``server.server_address[1]``), and exported as
    ``NNS_METRICS_BOUND_PORT`` so subprocess tooling can discover it
    from the environment."""
    global _SERVER
    with _STATE_LOCK:
        if _SERVER is not None:
            return _SERVER
        handler = type("_BoundHandler", (_Handler,),
                       {"registry": registry})
        server = ThreadingHTTPServer((host, int(port)), handler)
        server.daemon_threads = True
        threading.Thread(target=server.serve_forever, daemon=True,
                         name="nns-metrics").start()
        _SERVER = server
        bound = server.server_address[1]
        os.environ["NNS_METRICS_BOUND_PORT"] = str(bound)
        if int(port) == 0:
            from ..utils.log import logger

            logger.info("metrics endpoint on ephemeral port: "
                        "http://%s:%d/metrics", host, bound)
        return server


def bound_metrics_port() -> Optional[int]:
    """Port the running metrics endpoint is bound to (the answer to
    "where did port 0 land"); None when no endpoint is running."""
    with _STATE_LOCK:
        if _SERVER is None:
            return None
        return _SERVER.server_address[1]


def stop_metrics_server() -> None:
    global _SERVER
    with _STATE_LOCK:
        server, _SERVER = _SERVER, None
    if server is not None:
        os.environ.pop("NNS_METRICS_BOUND_PORT", None)
        server.shutdown()
        server.server_close()


def maybe_start_from_env() -> Optional[ThreadingHTTPServer]:
    """Start the endpoint when ``NNS_METRICS_PORT`` is set (once per
    process; a malformed value logs and disables rather than killing
    the pipeline that happened to trigger the first check)."""
    global _ENV_TRIED
    if _ENV_TRIED:
        return _SERVER
    _ENV_TRIED = True
    raw = os.environ.get("NNS_METRICS_PORT")
    if not raw:
        return None
    try:
        return start_metrics_server(int(raw))
    except (ValueError, OSError) as exc:
        from ..utils.log import ml_logw

        ml_logw("NNS_METRICS_PORT=%r: metrics endpoint disabled (%s)",
                raw, exc)
        return None
