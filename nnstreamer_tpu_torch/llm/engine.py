"""Continuous-batching decode engine: one padded step per decode over
every resident sequence, flash-kernel prefill, conserved wall-time
attribution.

The PyTorch counterpart of ``nnstreamer_tpu/llm/engine.py``, dense slot
pool only:

- B single-token steps become ONE ``decode_step_pooled`` over the active
  lanes, padded with ``TorchExecMixin.pad_rows``
  (``filter/backends/_torchexec.py``) so the set of shapes stays bounded
  as sessions join and leave;
- prompt prefill runs ``prefill_kv`` — causal attention through the
  hand-written flash kernel on the card — at a power-of-two padded length
  (:func:`quantize_prompt`); causal masking keeps the padded tail keys
  out of every real row;
- the pool's cache tensors are updated **in place** (scatter and
  ``copy_`` into ``pool.k``/``pool.v``): no step or prefill copies the
  pool, which the JAX package gets from ``donate_argnums``;
- :class:`PhaseClock` assigns every nanosecond of the decode thread to
  exactly one of ``idle`` / ``admit`` / ``prefill`` / ``decode`` /
  ``egress`` / ``compile``.

``jax.jit`` becomes a bounded set of executables under the JAX package's
budgets: one step per ``pad_rows`` lane bucket (site ``llm.engine.step``,
16) and one prefill per :func:`quantize_prompt` length (site
``llm.engine.prefill``, 32), each a miss recorded in the compile ledger
(:mod:`~nnstreamer_tpu_torch.analysis.compileledger`).  On the card an
executable is a ``torch.cuda.CUDAGraph`` over one static int64 buffer
that the host fills before each replay (tokens, positions and slots; the
prefill's slot and last position ride in it as device indices, so one
graph serves every slot and real length under its bucket); its first
dispatch runs eagerly on a side stream and then captures.  On the CPU
the executable runs eagerly.  :meth:`DecodeEngine.warmup` builds the
whole set, after which a serving stream compiles nothing.  The paged
pool is not ported (ROADMAP A8).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import _cuda
from ..analysis import compileledger
from ..analysis.compileledger import compile_budget
from ..filter.backends._torchexec import TorchExecMixin
from .pool import KVCachePool, Session

#: PhaseClock states (closed set; every decode-thread nanosecond lands in
#: exactly one).  ``llm-prefill-chunk`` belongs to the paged tier, kept so
#: reports have the JAX package's keys.
PHASES = ("idle", "admit", "prefill", "llm-prefill-chunk", "decode",
          "egress", "compile")


class PhaseClock:
    """Exact wall-time attribution for one thread: ``enter(state)``
    transitions stamp ``mono_ns`` once, accumulate the outgoing state's
    interval, and by construction the per-state sums partition the
    thread's total wall time."""

    def __init__(self, clock_ns=None) -> None:
        from ..obs.clock import mono_ns

        self._clock_ns = clock_ns if clock_ns is not None else mono_ns
        self.ns: Dict[str, int] = {p: 0 for p in PHASES}
        self._state = "idle"
        self._t0 = self._clock_ns()
        self._born = self._t0

    def enter(self, state: str) -> str:
        """Transition; returns the OUTGOING state so nested phases can
        restore their caller's state on exit."""
        now = self._clock_ns()
        self.ns[self._state] += now - self._t0
        prev, self._state = self._state, state
        self._t0 = now
        return prev

    def totals_ns(self) -> Dict[str, int]:
        """Integer per-state totals INCLUDING the in-progress state's
        open interval: two snapshots subtract into an exact partition of
        the wall time between them."""
        now = self._clock_ns()
        ns = dict(self.ns)
        ns[self._state] += now - self._t0
        return ns

    def report(self) -> Dict[str, Any]:
        """Per-state seconds + shares; ``conserved_pct`` is exactly 100
        by construction."""
        now = self._clock_ns()
        ns = dict(self.ns)
        ns[self._state] += now - self._t0
        total = max(1, now - self._born)
        attributed = sum(ns.values())
        return {
            "total_s": total / 1e9,
            "states_s": {p: round(v / 1e9, 6) for p, v in ns.items()},
            "states_pct": {p: round(100.0 * v / total, 3)
                           for p, v in ns.items()},
            "conserved_pct": round(100.0 * attributed / total, 3),
        }


class _Executable:
    """One warm-set entry: ``fn(buf)`` over an int64 device buffer filled
    from the host.  On the card (unless the engine runs ``_eager``) the
    first call runs ``fn`` eagerly and captures it; later calls copy the
    host values into the static buffer and replay.  Elsewhere it runs
    ``fn`` eagerly on each call."""

    def __init__(self, engine: "DecodeEngine", fn: Callable) -> None:
        self.engine = engine
        self.fn = fn
        self.graph = None

    def __call__(self, values: np.ndarray) -> torch.Tensor:
        eng = self.engine
        host = torch.from_numpy(np.ascontiguousarray(values, np.int64))
        if self.graph is not None:
            self.graph.inputs[0].copy_(host)
            return self.graph.replay()
        buf = host.to(eng.pool.device)
        if eng.pool.device.type != "cuda" or eng._eager:
            return self.fn(buf)
        if eng._graph_memory is None:
            eng._graph_memory = _cuda.graph_memory(buf.device)
        self.graph = _cuda.CapturedGraph(self.fn, [buf], eng._graph_memory)
        return self.graph.first


def quantize_prompt(t: int, max_seq: int) -> int:
    """Padded prompt length for one prefill shape: next power of two from
    8, capped at ``max_seq``."""
    cap = max(1, int(max_seq))
    q = 8
    while q < t:
        q <<= 1
    return min(q, cap)


class DecodeEngine:
    """The device half of the ``tensor_llm`` element: prefill and pooled
    decode over a :class:`KVCachePool`, plus the live accounting (tokens,
    step EWMA, phase attribution) the observability tier reads.

    The step and prefill graphs share one memory pool: a graph's capture
    may reuse the memory of another graph's intermediates, so a replay
    can overwrite another graph's static outputs.  That is safe only
    because every dispatch reads its logits to the host before the next
    replay (:meth:`prefill`, :meth:`_dispatch`); keep it so.

    Single-threaded by contract: exactly one decode thread calls
    :meth:`prefill` / :meth:`step`, so the pool tensors mutate without
    locks.  ``prefill_mode``: ``auto`` (the flash gate: the kernel on the
    card), ``flash``, ``naive`` (plain attention) or ``step`` (the prompt
    decoded token by token through the pooled step)."""

    def __init__(self, params, cfg, pool: KVCachePool, capacity: int,
                 prefill_mode: str = "auto", clock=None) -> None:
        if getattr(pool, "page_size", 0) > 0:
            raise NotImplementedError(
                "DecodeEngine: the paged KV pool is not yet ported to the "
                "PyTorch package (ROADMAP A8)")
        if prefill_mode not in ("auto", "flash", "naive", "step"):
            raise ValueError(f"prefill mode {prefill_mode!r} "
                             "(want auto | flash | naive | step)")
        self.params = params
        self.cfg = cfg
        self.pool = pool
        self.capacity = max(1, int(capacity))
        self.prefill_mode = prefill_mode
        self._clock = clock if clock is not None else time.monotonic
        self._step_fns: Dict[int, Callable] = {}     # padded B -> step
        self._prefill_fns: Dict[int, Callable] = {}  # padded T -> prefill
        self.phases = PhaseClock()
        # tokens_total counts every GENERATED token (incl. each session's
        # first, argmaxed from the prefill logits); step_tokens only the
        # decode-step ones — the honest numerator for mean bucket fill
        self.tokens_total = 0
        self.step_tokens = 0
        self.steps_total = 0
        self.prefills_total = 0
        self.last_fill = 0
        self.ewma_step_s = 0.0
        self.compiles = 0
        #: private: run the executables eagerly on the card as well, for
        #: a reference run to hold the graphs to (set by tests and
        #: chip_smoke.py before the first dispatch)
        self._eager = False
        self._graph_memory = None
        #: host logits (f32) of the last prefill or step, one row per
        #: real lane — what the greedy choice was made from
        self.last_logits: Optional[np.ndarray] = None
        #: set on a per-engine memo miss, consumed by the next dispatch:
        #: that dispatch charges the ``compile`` phase
        self._cold_exec = False

    # -- step and prefill executables ------------------------------------
    @compile_budget(16, site="llm.engine.step")
    def _step_fn(self, padded: int) -> Callable:
        """The step executable for ``padded`` lanes: a ``(3, padded)``
        buffer of tokens, positions and slots → logits ``(padded,
        vocab)``."""
        fn = self._step_fns.get(padded)
        if fn is None:
            compileledger.record("llm.engine.step", (("padded", padded),))
            from ..models.streamformer_lm import decode_step_pooled

            params, cfg, pool = self.params, self.cfg, self.pool

            def step(lanes):
                logits, _, _ = decode_step_pooled(
                    params, pool.k, pool.v, lanes[0], lanes[1], lanes[2],
                    cfg)
                return logits

            fn = _Executable(self, step)
            self._step_fns[padded] = fn
            self.compiles += 1
            self._cold_exec = True
        return fn

    @compile_budget(32, site="llm.engine.prefill")
    def _prefill_fn(self, padded_t: int) -> Callable:
        """The prefill executable for prompts padded to ``padded_t``: a
        ``(padded_t + 2,)`` buffer of the tokens, the slot and the last
        real position → that position's logits ``(vocab,)``."""
        fn = self._prefill_fns.get(padded_t)
        if fn is None:
            compileledger.record("llm.engine.prefill",
                                 (("padded_t", padded_t),))
            from ..models.streamformer_lm import prefill_kv

            params, cfg, pool = self.params, self.cfg, self.pool
            flash = {"auto": None, "flash": True,
                     "naive": False}[self.prefill_mode]

            def prefill(buf):
                tokens = buf[:padded_t]
                slot, last = buf[padded_t:padded_t + 1], buf[padded_t + 1:]
                logits, ks, vs = prefill_kv(params, tokens, cfg,
                                            flash=flash)
                # install the whole padded K/V run into the slot: rows
                # past the real length are garbage the decode mask never
                # reads.  The slot and the last position are device
                # indices, so one graph serves every slot and length.
                pool.k[:, :, :padded_t][slot] = ks[None]
                pool.v[:, :, :padded_t][slot] = vs[None]
                return logits.index_select(0, last)[0]

            fn = _Executable(self, prefill)
            self._prefill_fns[padded_t] = fn
            self.compiles += 1
            self._cold_exec = True
        return fn

    def _call(self, fn: Callable, *args) -> torch.Tensor:
        """Run one dispatch; a memo miss charges its wall time to the
        ``compile`` phase instead of decode/prefill."""
        cold = None
        if self._cold_exec:
            self._cold_exec = False
            cold = self.phases.enter("compile")
        try:
            with torch.inference_mode():
                return fn(*args)
        finally:
            if cold is not None:
                self.phases.enter(cold)

    def warmup(self) -> None:
        """Build every executable live serving can dispatch, on the
        scratch slot: the padded decode-lane counts and (unless ``step``)
        the power-of-two prefill lengths; on the card that captures the
        whole graph set.  Charged to the ``compile`` phase; after it no
        dispatch is cold."""
        cprev = self.phases.enter("compile")
        try:
            shapes = sorted({TorchExecMixin.pad_rows(n, self.capacity)
                             for n in range(1, self.capacity + 1)})
            for rows in shapes:
                lanes = np.zeros((3, rows), np.int64)
                lanes[2] = self.pool.scratch
                with torch.inference_mode():
                    self._step_fn(rows)(lanes)
            if self.prefill_mode != "step":
                for padded in sorted(self._prefill_lengths()):
                    buf = np.zeros((padded + 2,), np.int64)
                    buf[padded] = self.pool.scratch
                    with torch.inference_mode():
                        self._prefill_fn(padded)(buf)
            if self.pool.device.type == "cuda":
                torch.cuda.synchronize(self.pool.device)
        finally:
            self.phases.enter(cprev)
            self._cold_exec = False

    def _prefill_lengths(self) -> List[int]:
        lengths, t = set(), 8
        while True:
            lengths.add(min(t, self.cfg.max_seq))
            if t >= self.cfg.max_seq:
                return sorted(lengths)
            t <<= 1

    # -- prefill ---------------------------------------------------------
    def prefill(self, sess: Session, prompt: np.ndarray) -> int:
        """Seed ``sess``'s cache slot from its prompt and return the
        session's FIRST generated token (greedy argmax of the last prompt
        position's logits — :func:`generate`'s semantics).  Mode ``step``
        decodes the prompt token by token through the pooled step."""
        prev = self.phases.enter("prefill")
        t = int(prompt.shape[0])
        if self.prefill_mode == "step":
            logits = None
            for i in range(t):
                logits = self._dispatch([(sess.slot, i, int(prompt[i]))])[0]
        else:
            padded = quantize_prompt(t, self.cfg.max_seq)
            buf = np.zeros((padded + 2,), np.int64)
            buf[:t] = prompt
            buf[padded], buf[padded + 1] = sess.slot, t - 1
            last = self._call(self._prefill_fn(padded), buf)
            logits = last.float().cpu().numpy()
            self.last_logits = logits[None]
        sess.pos = t
        self.prefills_total += 1
        self.tokens_total += 1
        sess.last_step_s = self._clock()
        self.phases.enter(prev)
        return int(np.argmax(logits))

    # -- decode ----------------------------------------------------------
    def _dispatch(self, lanes: Sequence[Tuple[int, int, int]]) -> np.ndarray:
        """(slot, pos, token) lanes → one padded step; returns the real
        lanes' logits on the host.  Padding lanes point at the pool's
        scratch slot, position 0: their writes land in scratch."""
        n = len(lanes)
        padded = TorchExecMixin.pad_rows(n, self.capacity)
        buf = np.zeros((3, padded), np.int64)      # tokens, pos, slots
        buf[2] = self.pool.scratch
        for i, (slot, p, tok) in enumerate(lanes):
            buf[0, i], buf[1, i], buf[2, i] = tok, p, slot
        logits = self._call(self._step_fn(padded), buf)
        self.last_logits = logits[:n].float().cpu().numpy()
        return self.last_logits

    def step(self, sessions: Sequence[Session]) -> List[int]:
        """One continuous-batching decode step over ``sessions`` (≤
        ``capacity``): consumes each session's ``next_token``, advances
        its cache position, returns the greedily-sampled NEXT token per
        session."""
        if not sessions:
            return []
        t0 = self._clock()
        prev = self.phases.enter("decode")
        logits = self._dispatch([(s.slot, s.pos, s.next_token)
                                 for s in sessions])
        out = np.argmax(logits, axis=1).astype(np.int32)
        now = self._clock()
        for s in sessions:
            s.pos += 1
            s.last_step_s = now
        self.steps_total += 1
        self.tokens_total += len(sessions)
        self.step_tokens += len(sessions)
        self.last_fill = len(sessions)
        dt = now - t0
        self.ewma_step_s = (dt if self.ewma_step_s == 0.0
                            else 0.8 * self.ewma_step_s + 0.2 * dt)
        self.phases.enter(prev)
        return [int(t) for t in out]

    # -- hints / report --------------------------------------------------
    def retry_after_hint(self) -> float:
        """Retry-after for a no-free-slot shed: the soonest-finishing
        resident session's expected remaining wall time under the live
        step EWMA (floored)."""
        sessions = self.pool.sessions()
        step_s = self.ewma_step_s or 0.01
        if not sessions:
            return max(0.05, step_s)
        remaining = min(max(1, s.max_new - s.emitted) for s in sessions)
        return max(0.05, remaining * step_s)

    def report(self) -> Dict[str, Any]:
        return {
            "tokens": self.tokens_total,
            "steps": self.steps_total,
            "prefills": self.prefills_total,
            "mean_fill": round(self.step_tokens
                               / max(1, self.steps_total), 2),
            "ewma_step_ms": round(self.ewma_step_s * 1e3, 3),
            "compiles": self.compiles,
            "cache_bytes": self.pool.cache_bytes(),
            "phases": self.phases.report(),
        }
