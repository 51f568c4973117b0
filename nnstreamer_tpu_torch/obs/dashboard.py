"""``nns-top``: a live terminal view over the telemetry plane.

The rendering core behind ``launch.py --top``; the port of
``nnstreamer_tpu/obs/dashboard.py``.
Deliberately source-agnostic: a frame is built from *flat samples* —
``[(t_seconds, {metric_key: float}), …]`` — which both telemetry
sources produce:

- a local :class:`~nnstreamer_tpu_torch.obs.timeseries.TimeSeriesRing`
  (``flat_samples()``), including one running over a federation
  collector, and
- a scraped ``/metrics`` endpoint (:func:`parse_prometheus` over
  periodic GETs), local or federated.

Everything interesting is therefore computed the same way the fleet
autoscaler will compute it: gauges read from the newest sample, rates
from windowed counter diffs, trends from per-sample series.  The frame
builder (:func:`build_view`) and renderer (:func:`render_frame`) are
pure functions of the samples — tests feed synthetic histories with an
injected clock and assert on the text.

Sections: origins (federation), serving rates (admitted / shed /
batched frames), queue + bucket occupancy bars, MFU, per-element
occupancy/latency, and armed/fired sustained signals
(``nns_signal_state`` travels the same metric plane, so federated
signal states render too).
"""

from __future__ import annotations

import re
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

#: sparkline glyph ramp (8 levels + blank)
_SPARK = " ▁▂▃▄▅▆▇█"
_BAR_FILL, _BAR_EMPTY = "#", "."

_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')
_SIGNAL_STATES = {0: "idle", 1: "holding", 2: "FIRED"}


def parse_prometheus(text: str) -> Dict[str, float]:
    """One ``/metrics`` body parsed to ``{name{labels}: value}`` (the
    flat-sample shape).  Unparseable values are skipped, comments
    ignored.  Handles the exposition format's optional trailing
    timestamp (``name{l} value ts``) and label values containing
    spaces — the split point is after the closing brace, never inside
    the label block."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("{"):
            continue        # malformed: no metric name
        brace = line.find("{")
        if brace >= 0:
            end = line.rfind("}")
            if end < brace:
                continue    # malformed label block
            key, rest = line[:end + 1], line[end + 1:]
        else:
            key, _, rest = line.partition(" ")
        fields = rest.split()
        if not fields:
            continue
        try:
            out[key] = float(fields[0])     # fields[1] = timestamp
        except ValueError:
            continue
    return out


def key_name(key: str) -> str:
    return key.partition("{")[0]


_UNESCAPE_RE = re.compile(r'\\(["\\n])')


def _unescape_label(value: str) -> str:
    """Single-pass inverse of metrics.py's ``_escape_label_value``:
    sequential ``str.replace`` calls cannot round-trip (``\\\\n`` — an
    escaped backslash followed by a literal ``n`` — would decode as a
    newline)."""
    return _UNESCAPE_RE.sub(
        lambda m: "\n" if m.group(1) == "n" else m.group(1), value)


def key_labels(key: str) -> Dict[str, str]:
    _, brace, rest = key.partition("{")
    if not brace:
        return {}
    return {m.group(1): _unescape_label(m.group(2))
            for m in _LABEL_RE.finditer(rest)}


def sparkline(points: Sequence[float], width: int = 16) -> str:
    """Fixed-width sparkline of the most recent ``width`` points,
    scaled to their own min..max (a flat series renders mid-level, so
    'boring' is visibly distinct from 'empty')."""
    pts = list(points)[-width:]
    if not pts:
        return " " * width
    lo, hi = min(pts), max(pts)
    span = hi - lo
    out = []
    for v in pts:
        if span <= 0:
            out.append(_SPARK[4] if hi else _SPARK[0])
        else:
            idx = 1 + int((v - lo) / span * 7)
            out.append(_SPARK[min(8, idx)])
    return "".join(out).rjust(width)


def bar(frac: float, width: int = 12) -> str:
    frac = max(0.0, min(1.0, frac))
    n = int(round(frac * width))
    return "[" + _BAR_FILL * n + _BAR_EMPTY * (width - n) + "]"


# ---------------------------------------------------------------------------
# view model
# ---------------------------------------------------------------------------

def _latest(samples) -> Dict[str, float]:
    return samples[-1][1] if samples else {}


def _match(flat: Dict[str, float], family: str) -> Dict[str, float]:
    return {k: v for k, v in flat.items() if key_name(k) == family}


def _rate(samples, family: str, window_s: float) -> float:
    """Summed counter rate over the trailing window (clamped at 0 so a
    worker restart between samples never renders a negative rate)."""
    if len(samples) < 2:
        return 0.0
    t_new, new = samples[-1]
    base_t, base = samples[0]
    for t, flat in samples:
        if t <= t_new - window_s:
            base_t, base = t, flat
        else:
            break
    span = t_new - base_t
    if span <= 0:
        return 0.0
    total = sum(max(0.0, v - base.get(k, 0.0))
                for k, v in _match(new, family).items())
    return total / span


def _series(samples, family: str, per_second: bool = False
            ) -> List[float]:
    """Per-sample summed family value (optionally diffed to rates) —
    the sparkline feed."""
    out: List[float] = []
    prev_t = prev_v = None
    for t, flat in samples:
        v = sum(_match(flat, family).values())
        if per_second:
            if prev_t is not None and t > prev_t:
                out.append(max(0.0, (v - prev_v) / (t - prev_t)))
            prev_t, prev_v = t, v
        else:
            out.append(v)
    return out


def build_view(samples: Sequence[Tuple[float, Dict[str, float]]],
               window_s: float = 10.0,
               origins: Optional[List[Dict[str, Any]]] = None,
               signal_report: Optional[Dict[str, Any]] = None,
               source: str = "registry") -> Dict[str, Any]:
    """The dashboard's frame model, computed purely from flat samples
    (+ optional collector origin rows / ring signal report)."""
    flat = _latest(samples)
    view: Dict[str, Any] = {"source": source, "window_s": window_s,
                            "samples": len(samples)}

    # -- origins (federation): explicit rows, else derived from labels
    if origins is None:
        keys = sorted({key_labels(k).get("origin") for k in flat}
                      - {None})
        origins = [{"origin": o} for o in keys]

    # -- fleet tier (fleet/router.py + launch.py NNS_FLEET_ROLE):
    # per-origin role tags from the nns_fleet_role gauges, per-worker
    # routed-connection counts + draining state from the router's
    # gauges — all riding the same federated scrape, so the fleet view
    # needs no side channel
    roles: Dict[str, str] = {}
    for k in _match(flat, "nns_fleet_role"):
        labels = key_labels(k)
        role = labels.get("role")
        if role:
            roles[labels.get("origin", "")] = role
    origins = [dict(o) for o in origins]
    for o in origins:
        role = roles.get(str(o.get("origin", "")))
        if role:
            o["role"] = role
    view["origins"] = origins
    fleet_workers: Dict[str, Dict[str, Any]] = {}
    for k, v in _match(flat, "nns_fleet_routed_connections").items():
        w = key_labels(k).get("worker", "?")
        fleet_workers.setdefault(w, {"worker": w})["routed"] = v
    for k, v in _match(flat, "nns_fleet_worker_draining").items():
        w = key_labels(k).get("worker", "?")
        fleet_workers.setdefault(w, {"worker": w})["draining"] = \
            bool(v)
    view["fleet"] = [fleet_workers[w] for w in sorted(fleet_workers)]

    # -- serving rates
    rates = []
    for label, family in (
            ("admitted", "nns_query_server_admitted_total"),
            ("shed", "nns_query_server_shed_total"),
            ("accepted conns", "nns_query_server_accepted_total"),
            ("batched frames", "nns_xbatch_frames_total"),
            ("evicted", "nns_query_server_evicted_total")):
        vals = _match(flat, family)
        if not vals:
            continue
        rates.append({"label": label, "family": family,
                      "total": sum(vals.values()),
                      "rate": _rate(samples, family, window_s),
                      "spark": _series(samples, family,
                                       per_second=True)})
    view["rates"] = rates

    # -- gauges: queue depth vs capacity-ish peak, occupancy, mfu, shed
    def _gauge(family: str, agg=max) -> Optional[float]:
        vals = _match(flat, family)
        return agg(vals.values()) if vals else None

    depth = _gauge("nns_query_server_queue_depth")
    peak = _gauge("nns_query_server_queue_peak")
    gauges = []
    if depth is not None:
        gauges.append({"label": "queue depth", "value": depth,
                       "of": peak,
                       "spark": _series(samples,
                                        "nns_query_server_queue_depth")})
    occ = _gauge("nns_xbatch_occupancy")
    if occ is not None:
        gauges.append({"label": "bucket occupancy", "value": occ,
                       "of": None,
                       "spark": _series(samples,
                                        "nns_xbatch_occupancy")})
    fill = _gauge("nns_xbatch_fill")
    if fill is not None:
        gauges.append({"label": "bucket fill", "value": fill,
                       "of": 1.0,
                       "spark": _series(samples, "nns_xbatch_fill")})
    shed_rate = _gauge("nns_query_server_shed_rate")
    if shed_rate is not None:
        gauges.append({"label": "shed fraction", "value": shed_rate,
                       "of": 1.0,
                       "spark": _series(samples,
                                        "nns_query_server_shed_rate")})
    mfu = _gauge("nns_mfu")
    if mfu is not None:
        gauges.append({"label": "mfu", "value": mfu, "of": None,
                       "spark": _series(samples, "nns_mfu")})
    clients = _gauge("nns_query_server_clients", agg=sum)
    if clients is not None:
        gauges.append({"label": "clients", "value": clients,
                       "of": None,
                       "spark": _series(samples,
                                        "nns_query_server_clients")})
    view["gauges"] = gauges

    # -- per-element occupancy + p99 proctime
    elements: Dict[str, Dict[str, Any]] = {}
    for k, v in _match(flat, "nns_element_occupancy").items():
        name = key_labels(k).get("element", key_labels(k).get(
            "name", "?"))
        elements.setdefault(name, {})["occupancy"] = v
    for k, v in _match(flat, "nns_element_proctime_us").items():
        labels = key_labels(k)
        if labels.get("quantile") != "0.99":
            continue
        name = labels.get("element", labels.get("name", "?"))
        elements.setdefault(name, {})["p99_us"] = v
    view["elements"] = [{"element": n, **row}
                        for n, row in sorted(elements.items())]

    # -- LLM serving panel (llm/element.py gauges + llm/tokenobs.py
    # histograms): resident sessions, mean decode-step fill, decode
    # tok/s, TTFT p99 sparkline, free-pages trend — present only when
    # an LLM element is exporting (the families exist), so non-LLM
    # dashboards render unchanged
    llm: Dict[str, Any] = {}
    active = _gauge("nns_llm_active_seqs", agg=sum)
    if active is not None:
        llm["active_seqs"] = active
        llm["active_spark"] = _series(samples, "nns_llm_active_seqs")
    fill_llm = _gauge("nns_llm_decode_fill")
    if fill_llm is not None:
        llm["decode_fill"] = fill_llm
    toks = _gauge("nns_llm_tokens_per_s", agg=sum)
    if toks is not None:
        llm["tokens_per_s"] = toks
        llm["tokens_spark"] = _series(samples, "nns_llm_tokens_per_s")
    for k, v in flat.items():
        if key_name(k) == "nns_llm_ttft_us" and \
                key_labels(k).get("quantile") == "0.99":
            llm["ttft_p99_us"] = max(v, llm.get("ttft_p99_us", 0.0))
    if "ttft_p99_us" in llm:
        # per-sample max across class labels — the worst class's trend
        spark: List[float] = []
        for _, f in samples:
            vals = [v for k, v in f.items()
                    if key_name(k) == "nns_llm_ttft_us"
                    and key_labels(k).get("quantile") == "0.99"]
            spark.append(max(vals) if vals else 0.0)
        llm["ttft_spark"] = spark
    free = _gauge("nns_llm_free_pages", agg=min)
    if free is not None:
        llm["free_pages"] = free
        llm["pages_spark"] = _series(samples, "nns_llm_free_pages")
    hit = _gauge("nns_llm_prefix_hit_rate")
    if hit is not None:
        llm["prefix_hit_rate"] = hit
    if llm:
        view["llm"] = llm

    # -- sustained signals: the ring's own report when available, else
    # reconstructed from nns_signal_state gauges (scrape / federated)
    signals = []
    if signal_report is not None:
        for s in signal_report.get("signals", ()):
            signals.append({"signal": s["signal"], "state": s["state"],
                            "firings": s["firings"],
                            "value": s.get("value")})
    else:
        for k, v in _match(flat, "nns_signal_state").items():
            labels = key_labels(k)
            signals.append({"signal": labels.get("signal", "?"),
                            "state": _SIGNAL_STATES.get(int(v),
                                                        str(v)),
                            "firings": None, "value": None,
                            "origin": labels.get("origin")})
    view["signals"] = signals

    # -- latency summary (slo loadgen / service histograms, when the
    # source pre-renders quantiles — scrapes and flat_samples both do)
    lat = []
    for family in ("nns_slo_latency_us", "nns_query_service_us",
                   "nns_element_proctime_us"):
        for k, v in flat.items():
            labels = key_labels(k)
            if key_name(k) == family and labels.get("quantile") \
                    == "0.99" and "element" not in labels:
                lat.append({"label": f"{family} p99", "value": v})
                break
    view["latency"] = lat
    return view


# ---------------------------------------------------------------------------
# renderer
# ---------------------------------------------------------------------------

def _fmt(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v != v:
        return "NaN"
    if v and abs(v) < 0.001:
        return f"{v:.2e}"
    if abs(v) >= 1000:
        return f"{v:,.0f}"
    return f"{v:.3g}"


def render_frame(view: Dict[str, Any], width: int = 96,
                 clock: Optional[float] = None) -> str:
    """One dashboard frame as plain text (no ANSI — the refresh loop
    owns cursor control), sectioned and column-aligned."""
    when = time.strftime("%H:%M:%S",
                         time.localtime(clock if clock is not None
                                        else time.time()))
    lines = [f"nns-top — {view['source']}  {when}  "
             f"window {view['window_s']:g}s  "
             f"samples {view['samples']}"]
    lines.append("=" * min(width, 96))

    origins = view.get("origins") or []
    if origins:
        cells = []
        for o in origins:
            cell = o["origin"]
            extra = []
            if o.get("role"):
                extra.append(str(o["role"]))
            if o.get("health"):
                extra.append(str(o["health"]))
            if o.get("age_s") is not None:
                extra.append(f"age {o['age_s']:.1f}s")
            if extra:
                cell += " (" + ", ".join(extra) + ")"
            cells.append(cell)
        lines.append("origins: " + "   ".join(cells))

    fleet = view.get("fleet") or []
    if fleet:
        lines.append(f"{'fleet worker':<24}{'routed':>8}  state")
        for w in fleet:
            state = "draining" if w.get("draining") else "serving"
            lines.append(f"{w['worker']:<24}"
                         f"{_fmt(w.get('routed')):>8}  {state}")

    if view.get("rates"):
        lines.append(f"{'throughput':<18}{'total':>12}{'rate/s':>10}"
                     f"  trend")
        for r in view["rates"]:
            lines.append(f"{r['label']:<18}{_fmt(r['total']):>12}"
                         f"{_fmt(r['rate']):>10}  "
                         f"{sparkline(r['spark'])}")

    if view.get("gauges"):
        lines.append(f"{'gauge':<18}{'value':>12}{'':>10}  trend")
        for g in view["gauges"]:
            if g["of"]:
                meter = bar(g["value"] / g["of"])
                val = f"{_fmt(g['value'])}/{_fmt(g['of'])}"
            else:
                meter = ""
                val = _fmt(g["value"])
            lines.append(f"{g['label']:<18}{val:>12}{meter:>14}  "
                         f"{sparkline(g['spark'])}")

    llm = view.get("llm") or {}
    if llm:
        lines.append(f"{'llm serving':<18}{'value':>12}{'':>10}  trend")
        if "active_seqs" in llm:
            lines.append(f"{'resident sessions':<18}"
                         f"{_fmt(llm['active_seqs']):>12}{'':>14}  "
                         f"{sparkline(llm.get('active_spark', ()))}")
        if "decode_fill" in llm:
            lines.append(f"{'decode step fill':<18}"
                         f"{_fmt(llm['decode_fill']):>12}"
                         f"{bar(llm['decode_fill']):>14}")
        if "tokens_per_s" in llm:
            lines.append(f"{'decode tok/s':<18}"
                         f"{_fmt(llm['tokens_per_s']):>12}{'':>14}  "
                         f"{sparkline(llm.get('tokens_spark', ()))}")
        if "ttft_p99_us" in llm:
            lines.append(f"{'ttft p99 us':<18}"
                         f"{_fmt(llm['ttft_p99_us']):>12}{'':>14}  "
                         f"{sparkline(llm.get('ttft_spark', ()))}")
        if "free_pages" in llm:
            lines.append(f"{'free pages':<18}"
                         f"{_fmt(llm['free_pages']):>12}{'':>14}  "
                         f"{sparkline(llm.get('pages_spark', ()))}")
        if "prefix_hit_rate" in llm:
            lines.append(f"{'prefix hit rate':<18}"
                         f"{_fmt(llm['prefix_hit_rate']):>12}"
                         f"{bar(llm['prefix_hit_rate']):>14}")

    if view.get("latency"):
        for row in view["latency"]:
            lines.append(f"{row['label']:<34}{_fmt(row['value']):>10}us")

    if view.get("elements"):
        lines.append(f"{'element':<18}{'occupancy':>12}{'p99 us':>12}")
        for e in view["elements"]:
            occ = e.get("occupancy")
            meter = bar(occ) if occ is not None else ""
            lines.append(f"{e['element']:<18}{_fmt(occ):>12}"
                         f"{_fmt(e.get('p99_us')):>12}  {meter}")

    sigs = view.get("signals") or []
    if sigs:
        cells = []
        for s in sigs:
            cell = f"{s['signal']}={s['state']}"
            if s.get("firings"):
                cell += f"(x{s['firings']})"
            if s.get("origin"):
                cell += f"@{s['origin']}"
            cells.append(cell)
        lines.append("signals: " + "  ".join(cells))
    else:
        lines.append("signals: (none configured)")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# sources + refresh loop
# ---------------------------------------------------------------------------

class RingSource:
    """Dashboard source over an in-process
    :class:`~nnstreamer_tpu_torch.obs.timeseries.TimeSeriesRing` (optionally
    ring-over-collector — then origin rows come from the collector)."""

    def __init__(self, ring, collector=None,
                 label: str = "registry") -> None:
        self.ring = ring
        self.collector = collector
        self.label = label

    def frame(self, window_s: float) -> Dict[str, Any]:
        samples = self.ring.flat_samples()
        origins = (self.collector.origins()
                   if self.collector is not None else None)
        return build_view(samples, window_s=window_s, origins=origins,
                          signal_report=self.ring.signal_report(),
                          source=self.label)


class ScrapeSource:
    """Dashboard source over a remote ``/metrics`` endpoint: each
    ``frame()`` scrapes once and appends to its own bounded history —
    the dashboard builds its ring from the wire."""

    def __init__(self, url: str, retention: int = 240) -> None:
        from collections import deque
        from urllib.parse import urlparse

        if "://" not in url:
            url = f"http://{url}"
        if urlparse(url).path in ("", "/"):
            # '/metrics appended when missing' applies to full URLs
            # too: http://host:port must scrape the metrics path, not
            # 404 against the endpoint root
            url = url.rstrip("/") + "/metrics"
        self.url = url
        self.samples: "deque" = deque(maxlen=retention)
        self.scrape_errors = 0

    def scrape(self) -> Optional[Dict[str, float]]:
        import urllib.request

        try:
            with urllib.request.urlopen(self.url, timeout=5) as resp:
                return parse_prometheus(
                    resp.read().decode("utf-8", "replace"))
        except OSError:
            self.scrape_errors += 1
            return None

    def frame(self, window_s: float) -> Dict[str, Any]:
        flat = self.scrape()
        if flat is not None:
            self.samples.append((time.monotonic(), flat))
        return build_view(list(self.samples), window_s=window_s,
                          source=self.url)


class TopLoop:
    """The refresh loop: render a frame every ``interval_s`` to
    ``out`` with ANSI home+clear between frames (plain frames when
    ``ansi=False`` — piped output, tests)."""

    def __init__(self, source, interval_s: float = 1.0,
                 window_s: float = 10.0, out=None,
                 ansi: bool = True) -> None:
        import sys
        import threading

        self.source = source
        self.interval_s = max(0.05, float(interval_s))
        self.window_s = float(window_s)
        self.out = out if out is not None else sys.stdout
        self.ansi = ansi
        self.frames = 0
        self._stop = threading.Event()
        self._thread = None

    def render_once(self) -> str:
        text = render_frame(self.source.frame(self.window_s))
        self.frames += 1
        return text

    def _emit(self) -> None:
        text = self.render_once()
        if self.ansi:
            self.out.write("\x1b[H\x1b[2J" + text)
        else:
            self.out.write(text)
        try:
            self.out.flush()
        except (OSError, ValueError):
            pass

    def run(self, duration_s: Optional[float] = None) -> None:
        """Foreground loop: render until stopped,
        Ctrl-C or ``duration_s``."""
        from .clock import mono_ns

        deadline = (mono_ns() / 1e9 + duration_s
                    if duration_s is not None else None)
        self._emit()
        while not self._stop.wait(self.interval_s):
            if deadline is not None and mono_ns() / 1e9 >= deadline:
                return
            self._emit()

    def start(self) -> "TopLoop":
        """Background loop (launch.py --top renders while the pipeline
        streams)."""
        import threading

        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(target=self.run,
                                            daemon=True,
                                            name="nns-top")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)
