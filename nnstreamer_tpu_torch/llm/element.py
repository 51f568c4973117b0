"""``tensor_llm``: the stateful token-streaming serving element.

The PyTorch counterpart of ``nnstreamer_tpu/llm/element.py``, with the
same properties, defaults and semantics.  One element sits between
``tensor_query_serversrc`` and ``tensor_query_serversink`` and turns the
request/response serving plane into a continuous-batching token stream
server:

- **requests in**: one ``(N,) int32`` frame per session —
  ``[prompt_len, max_new_tokens, stop_token, prompt...]`` (in-band
  header framing, so the wire caps stay one static tensor).  The
  serversrc's queue-depth admission and QoS negotiation apply unchanged
  BEFORE the frame reaches this element.
- **slot admission**: a session needs a KV-cache slot
  (:class:`~nnstreamer_tpu_torch.llm.pool.KVCachePool`) or, with
  ``page-size`` > 0, pages of the block-paged arena
  (:class:`~nnstreamer_tpu_torch.llm.paged.PagedKVCachePool`); none
  free ⇒ the request is answered with an explicit ``T_SHED`` +
  retry-after through the paired server (``QueryServer.shed_frame``) —
  never queued as unbounded memory.
- **decode loop**: ONE decode thread owns admission, prefill (dense:
  ``prefill_kv`` through the flash kernel; paged: bounded chunks
  interleaved between decode steps), the per-step padded decode over the
  whole resident set, and every downstream push — so per-client token
  order is exact BY CONSTRUCTION (single pusher, bucket re-forms every
  step, sessions join mid-flight after their prefill and leave on
  stop-token / max-new / disconnect).
- **streaming egress**: per-token ``[1, 1] int32`` frames flow to the
  serversink carrying the request's extras (client id, wire seq, QoS,
  trace context), ``pts`` = token index, and ``extra["nns_more"]`` on
  every frame but the last (the server's in-flight unit stays open for
  the whole stream, so drain waits for completions).
- **eviction**: client disconnect (polled via the server table) and a
  progress deadline reclaim slots mid-stream; EOS / ``Pipeline.drain``
  finish resident sessions before the element lets go.

The element runs on ``cuda:0``; ``custom=...,device:cpu`` asks for the
CPU (the tests' way), and without that request and without a card
``start()`` raises :class:`~nnstreamer_tpu_torch.device.DeviceError`.
``start()`` builds the decode engine's whole executable set (on the
card, every CUDA graph) before the decode thread starts; that thread
replays them.  Weights come from :func:`init_llm_params` (random, from
``seed``).  The verifier hook (``static_check``) waits for the port's
``analysis/verify``.

Stop-token semantics (the client contract): the stream for one request
ends when the client has received ``max_new_tokens`` frames, or earlier
when a frame's token equals the request's ``stop_token`` (that frame is
delivered and IS the end marker); a NEGATIVE token is unconditionally
terminal — vocab tokens are never negative, so refusal/eviction
markers end a stream even for requests that set no stop token.  A
prompt too long for the cache (``prompt_len + max_new > max_seq``) is
answered with a single stop-token frame — a deterministic refusal, not
a shed (retrying an over-length prompt can never succeed).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List

import numpy as np
import torch

from ..analysis.sanitizer import make_condition
from ..pipeline.caps import Caps
from ..pipeline.element import Element, EOSEvent, FlowReturn
from ..pipeline.registry import register_element
from ..tensor.buffer import TensorBuffer
from ..tensor.caps_util import tensors_template_caps

#: request header length: [prompt_len, max_new_tokens, stop_token]
REQ_HEADER = 3


def init_llm_params(cfg, seed: int, device) -> Dict[str, Any]:
    """The served model's weights: the port's StreamFormer tree drawn
    from ``seed`` and placed on ``device`` (matmul weights in
    ``cfg.dtype``)."""
    from ..models.streamformer_lm import place_params
    from ..parallel.train_step import init_params

    return place_params(init_params(cfg, seed), cfg, device)


class _Request:
    """A parsed, slab-free copy of one request frame (the pooled wire
    slab releases the moment chain() returns)."""

    __slots__ = ("key", "prompt", "max_new", "stop_token", "qos",
                 "extra", "born_s", "truncated")

    def __init__(self, key, prompt, max_new, stop_token, qos, extra,
                 born_s, truncated=False) -> None:
        self.key = key
        self.prompt = prompt
        self.max_new = max_new
        self.stop_token = stop_token
        self.qos = qos
        self.extra = extra
        self.born_s = born_s
        #: the request asked for MORE than the server's max-new-tokens
        #: cap: the stream must end with an explicit terminal marker
        #: frame, or the client (counting toward ITS ask) would hang
        self.truncated = truncated


@register_element
class TensorLLM(Element):
    FACTORY = "tensor_llm"
    PROPERTIES = {
        "custom": (None, "streamformer_lm sizing grammar "
                         "(models/streamformer_lm.config_from_custom): "
                         "layers/width/heads/head_dim/mlp/vocab/"
                         "experts/max_seq/dtype — max_seq MUST be "
                         "named (it times slots is the cache memory "
                         "bound); device:cpu serves on the CPU"),
        "seed": (0, "deterministic weight seed"),
        "slots": (8, "KV-cache slots = max concurrently-resident "
                     "sessions; cache memory = (slots+1) x layers x "
                     "max_seq x heads x head_dim x 2 x itemsize, fixed "
                     "at start"),
        "batch": (4, "decode bucket capacity: resident sequences "
                     "advanced per shared device step (> slots is a "
                     "misconfig — the bucket could never fill)"),
        "max-new-tokens": (64, "hard cap on one session's continuation "
                               "(requests asking more are clamped)"),
        "prefill": ("auto", "prompt path: auto (flash where the length "
                            "gate says it wins) | flash | naive | step "
                            "(token-by-token through the decode loop — "
                            "the decode-without-prefill misconfig path)"),
        "id": (-1, "paired query-server table id: >= 0 enables T_SHED "
                   "egress for slot sheds and disconnect pruning "
                   "(sessions of vanished clients reclaim their slot); "
                   "-1 = standalone (appsrc/tensor_sink pipelines — "
                   "sheds emit a stop-token frame tagged "
                   "extra['nns_llm_shed'])"),
        "admit-timeout-ms": (0.0, "how long a request may wait for a "
                                  "slot before shedding (0 = shed "
                                  "immediately when no slot is free)"),
        "session-timeout-ms": (0.0, "slot-lease deadline: a session "
                                    "older than this (since admission) "
                                    "is force-completed with a "
                                    "terminal stop-token frame and its "
                                    "slot reclaimed (0 = off; max-new "
                                    "already bounds well-behaved "
                                    "streams)"),
        "queue-depth": (0, "pending-request bound before chain() "
                           "backpressures (0 = 2 x slots)"),
        "page-size": (0, "KV-cache page size in tokens: > 0 serves "
                         "from the block-paged arena (memory scales "
                         "with what a session USES, not max_seq); "
                         "must tile max_seq evenly; 0 (default) = the "
                         "dense per-session max_seq slot pool — paged "
                         "serving is explicit opt-in so dense "
                         "reference configs stay dense"),
        "pages": (0, "paged arena size in pages; 0 = "
                     "(slots+1) x max_seq / page_size - 1 — byte-"
                     "identical arena to the dense pool at the same "
                     "slots (the apples-to-apples residency sizing)"),
        "prefill-chunk": (-1, "interleaved prefill chunk in tokens: "
                              "the decode loop advances one bounded "
                              "chunk between decode steps so a long "
                              "prompt cannot stall resident streams; "
                              "0 = whole-prompt prefill; -1 = auto "
                              "(32 when paged, off when dense)"),
        "prefix-cache": (-1, "content-hash prefix reuse over full "
                             "prompt pages (chain-hashed, refcounted, "
                             "copy-on-write): 1 on / 0 off / -1 auto "
                             "(on when paged; requires pages)"),
        "token-obs": (1, "token-level observability plane: per-session "
                         "lifecycle records, TTFT/ITL histograms "
                         "(class-labeled), terminal-cause counters and "
                         "head-of-line blame (llm/tokenobs.py); 0 "
                         "disables it structurally — every hot-path "
                         "hook collapses to one attribute test"),
    }

    # -- pads / caps -----------------------------------------------------
    def _make_pads(self):
        self.add_sink_pad(tensors_template_caps(), "sink")
        self.add_src_pad(tensors_template_caps(), "src")

    def set_caps(self, pad, caps):
        from ..tensor.caps_util import config_from_caps

        cfg = config_from_caps(caps)
        info = cfg.info
        if info.num_tensors != 1:
            raise ValueError(f"{self.name}: request caps must carry ONE "
                             f"int32 tensor (got {info.num_tensors})")
        t = info[0]
        if str(t.np_dtype) != "int32" or len(t.np_shape) != 1 \
                or t.np_shape[0] < REQ_HEADER + 1:
            raise ValueError(
                f"{self.name}: request tensor must be (N,) int32 with "
                f"N >= {REQ_HEADER + 1} ([prompt_len, max_new, "
                f"stop_token, prompt...]); got {t.np_shape} "
                f"{t.np_dtype}")
        self._req_cap = int(t.np_shape[0])
        self.announce_src_caps(Caps.from_string(
            "other/tensors,format=static,num_tensors=1,dimensions=1:1,"
            "types=int32,framerate=0/1"))

    # -- lifecycle -------------------------------------------------------
    def start(self):
        from ..device import resolve_device
        from ..filter.framework import FilterProperties
        from ..models.streamformer_lm import config_from_custom
        from ..obs.clock import mono_ns
        from .engine import DecodeEngine
        from .pool import KVCachePool

        custom = FilterProperties.parse_custom(self.custom)
        # the card unless custom= asks for the CPU; no card: DeviceError
        self.device = resolve_device(custom.get("device") or None)
        self.cfg = config_from_custom(custom, device=self.device)
        # for slots/batch/max_new_tokens, 0 and unset both clamp to 1:
        # the `or` default loses nothing under max()
        # nnslint: allow(falsy-zero-default)
        self._slots = max(1, int(self.slots or 1))
        # nnslint: allow(falsy-zero-default)
        self._batch = max(1, int(self.batch or 1))
        # nnslint: allow(falsy-zero-default)
        self._max_new_cap = max(1, int(self.max_new_tokens or 1))
        self._admit_timeout = max(0.0,
                                  float(self.admit_timeout_ms or 0)) / 1e3
        self._sess_timeout = max(0.0,
                                 float(self.session_timeout_ms or 0)) / 1e3
        self._depth = int(self.queue_depth or 0) or 2 * self._slots
        params = init_llm_params(self.cfg, int(self.seed or 0),
                                 self.device)
        ps = max(0, int(self.page_size if self.page_size is not None
                        else 0))
        chunk = int(self.prefill_chunk
                    if self.prefill_chunk is not None else -1)
        pfx = int(self.prefix_cache
                  if self.prefix_cache is not None else -1)
        if ps > 0:
            from .paged import PagedKVCachePool

            table_max = self.cfg.max_seq // ps
            pages = int(self.pages or 0) \
                or (self._slots + 1) * table_max - 1
            self.pool = PagedKVCachePool(
                self.cfg, pages=pages, page_size=ps,
                slots=self._slots, prefix_cache=(pfx != 0),
                device=self.device)
            self._chunk = 32 if chunk < 0 else chunk
            if str(self.prefill or "auto") == "step":
                self._chunk = 0   # prompt rides the decode grid instead
        else:
            self.pool = KVCachePool(self.cfg, self._slots,
                                    device=self.device)
            self._chunk = 0
        self.engine = DecodeEngine(params, self.cfg, self.pool,
                                   capacity=self._batch,
                                   prefill_mode=str(self.prefill
                                                    or "auto"),
                                   chunk=self._chunk)
        # every executable (on the card: every CUDA graph) is built here,
        # before the decode thread that replays them starts
        self.engine.warmup()
        self._mono_ns = mono_ns
        self._cv = make_condition("llm.engine")
        self._pending: List[_Request] = []   # bounded by _depth (cv)
        self._stopping = False
        self._flushing = False
        self._req_n = 0                      # standalone session keys
        self.shed_total = 0
        self.rejected_total = 0
        self.evicted_total = 0
        self.sessions_total = 0
        self._register_gauges()
        self._thread = threading.Thread(target=self._decode_loop,
                                        daemon=True,
                                        name=f"llm-decode:{self.name}")
        self._thread.start()

    def _register_gauges(self) -> None:
        from ..obs.metrics import REGISTRY, Gauge

        labels = {"element": self.name,
                  "pipeline": getattr(self.pipeline, "name", "") or ""}
        eng, pool = self.engine, self.pool
        # token-level observability plane: constructed only when on —
        # when off, self._tok_obs is None and every hook site in the
        # decode loop pays exactly one attribute test
        self._tok_obs = None
        if int(self.token_obs if self.token_obs is not None else 1):
            from .tokenobs import TokenObs

            self._tok_obs = TokenObs(eng.phases, labels=dict(labels))
        rate_state = {"tokens": None, "t": None}

        def _tokens_per_s() -> float:
            # scrape-to-scrape token rate (first scrape: lifetime —
            # the filter gauges' _make_rate discipline)
            import time as _time

            now = _time.monotonic()
            tokens = eng.tokens_total
            prev_t, prev_n = rate_state["t"], rate_state["tokens"]
            rate_state["t"], rate_state["tokens"] = now, tokens
            if prev_t is None or now - prev_t < 0.05:
                total = max(1e-9, eng.phases.report()["total_s"])
                return tokens / total
            return max(0.0, (tokens - prev_n) / (now - prev_t))

        self._obs_gauges = [REGISTRY.register(Gauge(n, dict(labels),
                                                    fn=f))
                            for n, f in (
            ("nns_llm_active_seqs", lambda: pool.live),
            ("nns_llm_cache_occupancy", lambda: pool.occupancy),
            ("nns_llm_cache_bytes", pool.cache_bytes),
            ("nns_llm_tokens_per_s", _tokens_per_s),
            ("nns_llm_decode_fill",
             lambda: eng.last_fill / max(1, eng.capacity)),
            ("nns_llm_pending", lambda: len(self._pending)),
        )]
        if getattr(eng, "paged", False):
            self._obs_gauges.extend(
                REGISTRY.register(Gauge(n, dict(labels), fn=f))
                for n, f in (
                    ("nns_llm_free_pages", lambda: pool.free_pages),
                    ("nns_llm_cached_pages",
                     lambda: pool.stats()["reclaimable"]),
                    ("nns_llm_prefix_hits",
                     lambda: pool.prefix_hits),
                    ("nns_llm_prefix_tokens_reused",
                     lambda: pool.prefix_tokens_reused),
                    # prefix-hit RATE: the time-series signal sources
                    # (tokenobs.default_llm_signals) and the nns-top
                    # LLM panel read a fraction, not raw counts
                    ("nns_llm_prefix_hit_rate",
                     lambda: pool.prefix_hits
                     / max(1, pool.prefix_hits + pool.prefix_misses)),
                ))
        names = ["nns_llm_tokens_total", "nns_llm_sessions_total",
                 "nns_llm_shed_total", "nns_llm_evicted_total",
                 "nns_llm_rejected_total"]
        if getattr(eng, "paged", False):
            from .tokenobs import PAGES_RECLAIMED_TOTAL

            names.append(PAGES_RECLAIMED_TOTAL)
        self._obs_counters = {
            n: REGISTRY.counter(n, **labels) for n in names}
        self._ctr_tokens = 0    # counter mirror of engine.tokens_total
        self._ctr_reclaimed = 0  # mirror of pool.pages_reclaimed

    def stop(self):
        from ..obs.metrics import REGISTRY

        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        thread = getattr(self, "_thread", None)
        if thread is not None:
            thread.join(timeout=30)
            self._thread = None
        for g in getattr(self, "_obs_gauges", ()):
            REGISTRY.unregister(g)
        self._obs_gauges = []
        self.engine = None
        self.pool = None

    def unblock(self):
        with self._cv:
            self._stopping = True
            self._cv.notify_all()

    def health_state(self):
        pool = getattr(self, "pool", None)
        if pool is not None and pool.admission.draining:
            return "draining"
        return None

    def drain(self, deadline: float = 5.0) -> None:
        """Pipeline.drain hook: stop admitting sessions (new requests
        shed with a drain-sized retry-after), finish every resident
        stream, within ``deadline``."""
        pool = getattr(self, "pool", None)
        if pool is None:
            return
        pool.admission.start_drain(deadline)
        with self._cv:
            self._cv.notify_all()
            self._cv.wait_for(
                lambda: not self._pending and pool.live == 0,
                timeout=max(0.0, deadline))

    # -- ingress ---------------------------------------------------------
    def chain(self, pad, buf: TensorBuffer) -> FlowReturn:
        arr = np.asarray(buf.np(0)).reshape(-1)
        bad = None
        plen = 0
        if arr.shape[0] < REQ_HEADER + 1:
            bad = (f"request frame too short ({arr.shape[0]} < "
                   f"{REQ_HEADER + 1})")
        else:
            plen = int(arr[0])
            if plen < 1 or plen > arr.shape[0] - REQ_HEADER:
                bad = (f"prompt_len={plen} out of range for a "
                       f"{arr.shape[0]}-element request frame")
        extra = dict(buf.extra)
        if bad is not None:
            if extra.get("query_client_id") is None:
                # developer path (appsrc tests): loud
                raise ValueError(f"{self.name}: {bad}")
            # serving path: a malformed frame is a CLIENT error — it
            # must not error the pipeline every other client shares.
            # A reject request rides the decode thread (the single
            # pusher) and is answered with one terminal frame there,
            # settling the request's in-flight unit.
            from ..utils.log import ml_logw

            ml_logw("%s: %s — answering with a terminal frame",
                    self.name, bad)
            prompt = None
            asked, max_new, stop_token = 0, 0, -1
        else:
            asked = max(1, int(arr[1]))
            max_new = min(self._max_new_cap, asked)
            stop_token = int(arr[2])
            # slab-free copy: the request's pooled wire slab releases
            # when this buffer dies at return — a disconnecting client
            # can never strand a slab behind a resident session
            prompt = np.array(arr[REQ_HEADER:REQ_HEADER + plen],
                              np.int32)
        cid = extra.get("query_client_id")
        wseq = extra.get("query_seq")
        with self._cv:
            self._req_n += 1
            # the local counter keeps keys unique even against a buggy
            # or hostile client REUSING a wire seq while its first
            # stream is resident — a key collision must never reach
            # pool.acquire's ValueError (one client's duplicate would
            # error the pipeline every client shares); reply routing
            # rides the extras (cid, seq), not the key
            key = ((cid, wseq, self._req_n) if cid is not None
                   else ("local", self._req_n))
            req = _Request(key, prompt, max_new, stop_token,
                           str(extra.get("nns_class", "silver")),
                           extra, self._now(),
                           truncated=(prompt is not None
                                      and asked > max_new))
            # bounded pending: backpressure the serving thread (and
            # through it the serversrc's bounded queue, whose admission
            # sheds at ITS watermarks) rather than queue unbounded
            self._cv.wait_for(
                lambda: len(self._pending) < self._depth
                or self._stopping)
            if self._stopping:
                return FlowReturn.EOS
            self._pending.append(req)
            self._cv.notify_all()
        return FlowReturn.OK

    def _now(self) -> float:
        return self._mono_ns() / 1e9

    # -- events ----------------------------------------------------------
    def on_event(self, pad, event):
        if isinstance(event, EOSEvent):
            # finish every admitted stream before EOS crosses: resident
            # sessions are ADMITTED work (inflight-counted server-side)
            with self._cv:
                self._flushing = True
                self._cv.notify_all()
                self._cv.wait_for(
                    lambda: self._stopping
                    or (not self._pending
                        and (self.pool is None or self.pool.live == 0)),
                    timeout=120.0)
                self._flushing = False
        super().on_event(pad, event)

    # -- decode loop -----------------------------------------------------
    def _server(self):
        sid = int(self.id if self.id is not None else -1)
        if sid < 0:
            return None
        from ..query.server import peek_server

        return peek_server(sid)

    def _decode_loop(self) -> None:
        try:
            if self.device.type == "cuda":
                # the graphs were captured on start()'s thread
                torch.cuda.set_device(self.device)
            self._decode_loop_inner()
        except Exception as exc:  # noqa: BLE001 — surfaced as pipeline err
            if self.pipeline is not None:
                self.pipeline.post_error(self, exc)

    def _decode_loop_inner(self) -> None:
        eng = self.engine
        pool = self.pool
        rr = 0                         # round-robin cursor
        while True:
            with self._cv:
                if self._stopping:
                    return
                if not self._pending and pool.live == 0:
                    eng.phases.enter("idle")
                    # idle tick bounds disconnect-prune latency too
                    self._cv.wait(0.05)
                    if self._stopping:
                        return
                taken, self._pending = self._pending, []
                self._cv.notify_all()   # free chain() backpressure slots
            self._prune_sessions()
            requeue = self._admit(taken)
            sessions = [s for s in pool.sessions()
                        if not getattr(s, "prefilling", False)]
            if sessions:
                n = len(sessions)
                pick = [sessions[(rr + i) % n]
                        for i in range(min(n, self._batch))]
                rr = (rr + len(pick)) % max(1, n)
                self._run_step(pick)
            # interleaved chunked prefill: ONE bounded chunk per loop
            # iteration, so a long prompt time-shares the decode thread
            # with resident streams instead of stalling them (with no
            # decodable sessions the loop spins here chunk after chunk
            # — full prefill throughput when there is no one to starve)
            self._advance_prefills()
            if requeue:
                with self._cv:
                    self._pending[:0] = requeue
            with self._cv:
                if not self._pending and pool.live == 0:
                    self._cv.notify_all()   # EOS/drain waiters

    # -- admission -------------------------------------------------------
    def _admit(self, reqs: List[_Request]) -> List[_Request]:
        """Admit / shed / requeue pending requests.  Returns the
        requests still inside their admit-timeout window (no slot yet,
        not shed by policy)."""
        eng, pool = self.engine, self.pool
        requeue: List[_Request] = []
        for req in reqs:
            prev = eng.phases.enter("admit")
            try:
                if req.prompt is None \
                        or len(req.prompt) + req.max_new \
                        > self.cfg.max_seq:
                    # deterministic refusal (malformed / over-length):
                    # a retry can never succeed, so this is a terminal
                    # stop-token answer, not a shed
                    self.rejected_total += 1
                    self._obs_counters["nns_llm_rejected_total"].inc()
                    if self._tok_obs is not None:
                        self._tok_obs.on_refused(req.qos, "reject")
                    self._emit(req.extra, req.stop_token, 0, last=True)
                    continue
                verdict = pool.admit(req.qos,
                                     no_slot_retry_s=eng
                                     .retry_after_hint(),
                                     prompt=req.prompt,
                                     max_new=req.max_new)
                if verdict is not None:
                    if self._admit_timeout > 0 \
                            and self._now() - req.born_s \
                            < self._admit_timeout \
                            and not pool.admission.draining:
                        requeue.append(req)
                    else:
                        self._shed(req, verdict)
                    continue
                sess = pool.acquire(req.key, qos=req.qos,
                                    extra=req.extra, prompt=req.prompt,
                                    max_new=req.max_new)
                sess.max_new = req.max_new
                sess.stop_token = req.stop_token
                sess.truncated = req.truncated
                self.sessions_total += 1
                self._obs_counters["nns_llm_sessions_total"].inc()
                if self._tok_obs is not None:
                    # the lifecycle record opens HERE, inside the admit
                    # phase: TTFT measures admit → first emitted token,
                    # chunk interleave and bucket waits included — what
                    # the client waited, not what one executable cost
                    self._tok_obs.on_admit(sess)
                if self._chunk > 0:
                    # chunked prefill: the session joins RESIDENT but
                    # not yet decodable — the decode loop advances one
                    # bounded chunk per iteration (_advance_prefills),
                    # so this prompt cannot stall the streams already
                    # emitting tokens; its first token emits when the
                    # last chunk lands
                    continue
                t0 = self._mono_ns()
                first = eng.prefill(sess, req.prompt)
                tracer = self._tracer()
                if tracer is not None:
                    ctx = req.extra.get("nns_trace")
                    if ctx is not None and ctx.trace_id:
                        # the session's one-time prompt cost, in the
                        # CLIENT's merged timeline (obs/attrib.py
                        # llm-prefill state)
                        tracer.annotate_span("llm-prefill", t0,
                                             self._mono_ns(), seq=-1,
                                             trace_id=ctx.trace_id)
                sess.next_token = first
                # the prefill's token is this session's first answer —
                # emit it NOW (time-to-first-token is the prefill, not
                # the prefill plus one bucket cycle)
                self._finish_or_emit(sess, first)
            finally:
                eng.phases.enter(prev)
        return requeue

    def _shed(self, req: _Request, retry_after_s: float) -> None:
        self.shed_total += 1
        self._obs_counters["nns_llm_shed_total"].inc()
        if self._tok_obs is not None:
            # counted, never observed: a fast shed must not flatter
            # the admitted-traffic TTFT distribution
            self._tok_obs.on_refused(req.qos, "shed")
        srv = self._server()
        if srv is not None:
            srv.shed_frame(req.extra, retry_after_s)
            return
        # standalone pipelines (appsrc/tensor_sink): the shed is a
        # tagged stop-token frame so the consumer still sees an
        # explicit, final answer
        extra = dict(req.extra)
        extra["nns_llm_shed"] = retry_after_s
        self._emit(extra, req.stop_token, 0, last=True)

    def _advance_prefills(self) -> None:
        """Advance ONE bounded prefill chunk — the oldest prefilling
        session, admission order — and emit its first token when the
        prompt completes.  One chunk per decode-loop iteration is the
        interleave contract: a 2048-token prompt costs resident streams
        ``ceil(2048/chunk)`` extra bounded slices, never one monolithic
        stall (the PhaseClock's ``llm-prefill-chunk`` share is the
        proof)."""
        if self._chunk <= 0:
            return
        eng, pool = self.engine, self.pool
        for sess in pool.sessions():
            if not getattr(sess, "prefilling", False):
                continue
            t0 = self._mono_ns()
            first = eng.prefill_chunk_step(sess)
            t1 = self._mono_ns()
            if self._tok_obs is not None:
                self._tok_obs.on_chunk(sess)
            tracer = self._tracer()
            if tracer is not None:
                ctx = sess.extra.get("nns_trace")
                if ctx is not None and ctx.trace_id:
                    tracer.annotate_span("llm-prefill-chunk", t0, t1,
                                         seq=-1, trace_id=ctx.trace_id)
            if first is not None:
                sess.next_token = first
                self._finish_or_emit(sess, first)
            return

    # -- stepping / egress -----------------------------------------------
    def _run_step(self, picked) -> None:
        eng = self.engine
        t0 = self._mono_ns()
        toks = eng.step(picked)
        t1 = self._mono_ns()
        self._ctr_sync()
        tracer = self._tracer()
        if tracer is not None:
            # the SHARED decode window, once per resident trace — the
            # cross-stream device-invoke convention (per-token
            # wall-clock truth, not a 1/n share)
            for sess in picked:
                ctx = sess.extra.get("nns_trace")
                if ctx is not None and ctx.trace_id:
                    tracer.annotate_span("llm-decode", t0, t1, seq=-1,
                                         trace_id=ctx.trace_id)
        for sess, tok in zip(picked, toks):
            sess.next_token = tok
            self._finish_or_emit(sess, tok)

    def _finish_or_emit(self, sess, tok: int) -> None:
        """Emit one token frame for ``sess``; release its slot when the
        stream is complete (stop token, or the granted length).  A
        TRUNCATED stream (the request asked more than the server's
        max-new-tokens cap) that runs out without hitting its stop
        token gets one extra terminal MARKER frame (the stop token, -1
        when none — negative is unconditionally terminal client-side):
        the client counts toward ITS ask, so a silently clamped stream
        would otherwise hang it until the per-token timeout."""
        sess.emitted += 1
        by_stop = sess.stop_token >= 0 and tok == sess.stop_token
        done = sess.emitted >= sess.max_new or by_stop
        marker = done and sess.truncated and not by_stop
        self._emit(sess.extra, tok, sess.emitted - 1,
                   last=done and not marker)
        if marker:
            self._emit(sess.extra, sess.stop_token, sess.emitted,
                       last=True)
        tobs = self._tok_obs
        if tobs is not None:
            # after the push: first-token latency includes its egress
            tobs.on_token(sess)
            if done:
                tobs.on_terminal(sess, "stop" if by_stop else "max_new")
        if done:
            self.pool.release(sess.key)

    def _emit(self, extra: Dict[str, Any], tok: int, index: int,
              last: bool) -> None:
        prev = self.engine.phases.enter("egress")
        try:
            out_extra = dict(extra)
            if not last:
                out_extra["nns_more"] = True
            buf = TensorBuffer(
                tensors=[np.array([[tok]], np.int32)], pts=index,
                extra=out_extra)
            # the decode thread is the only pusher: per-client frame
            # order IS emission order
            self.push(buf)
        finally:
            self.engine.phases.enter(prev)

    # -- eviction --------------------------------------------------------
    def _prune_sessions(self) -> None:
        """Reclaim slots of disconnected clients (polled on the server
        table) and deadline-overrun sessions.  Every eviction still
        EMITS a terminal stop-token frame: for a vanished client the
        reply is unsendable but settles the stream's in-flight unit
        (drain must converge), for a live one it explicitly ends the
        stream under the stop-token contract."""
        pool = self.pool
        srv = self._server()
        dead = []
        if srv is not None:
            for sess in pool.sessions():
                cid = sess.extra.get("query_client_id")
                if cid is not None and not srv.client_connected(cid):
                    dead.append((sess.key, "disconnect"))
        if self._sess_timeout > 0:
            dead.extend((k, "evict")
                        for k in pool.aged_keys(self._sess_timeout))
        for key, cause in dead:
            sess = pool.release(key)
            if sess is not None:
                self.evicted_total += 1
                self._obs_counters["nns_llm_evicted_total"].inc()
                if self._tok_obs is not None:
                    # the terminal marker frame is NOT a token: the
                    # record closes under its cause without observing
                    # TTFT/ITL (a reaped zombie must not poison p99)
                    self._tok_obs.on_terminal(sess, cause)
                self._emit(sess.extra, sess.stop_token, sess.emitted,
                           last=True)

    # -- helpers ---------------------------------------------------------
    def _tracer(self):
        pl = self.pipeline
        tracer = pl.tracer if pl is not None else None
        if tracer is not None and tracer.ring is not None:
            return tracer
        return None

    def _ctr_sync(self) -> None:
        """Mirror the engine's token count — and the paged pool's
        reclaim churn plus the blame aggregates when token obs is on —
        into the registry counters (counters are monotonic-inc only)."""
        delta = self.engine.tokens_total - self._ctr_tokens
        if delta > 0:
            self._obs_counters["nns_llm_tokens_total"].inc(delta)
            self._ctr_tokens = self.engine.tokens_total
        reclaimed = getattr(self.pool, "pages_reclaimed", 0)
        if reclaimed > self._ctr_reclaimed:
            from .tokenobs import PAGES_RECLAIMED_TOTAL

            self._obs_counters[PAGES_RECLAIMED_TOTAL].inc(
                reclaimed - self._ctr_reclaimed)
            self._ctr_reclaimed = reclaimed
        if self._tok_obs is not None:
            self._tok_obs.sync_blame_counters()
