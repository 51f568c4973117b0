"""Continuous-batching decode engine: one padded step per decode over
every resident sequence, flash-kernel prefill, conserved wall-time
attribution.

The PyTorch counterpart of ``nnstreamer_tpu/llm/engine.py``, over the
dense slot pool (``pool.py``) or the block-paged arena (``paged.py``):

- B single-token steps become ONE ``decode_step_pooled`` (dense) or
  ``decode_step_paged`` (paged) over the active lanes, padded with
  ``TorchExecMixin.pad_rows`` (``filter/backends/_torchexec.py``) so the
  set of shapes stays bounded as sessions join and leave; a paged step's
  block-table width is quantized too (:func:`quantize_pages`);
- dense prompt prefill runs ``prefill_kv`` — causal attention through
  the hand-written flash kernel on the card — at a power-of-two padded
  length (:func:`quantize_prompt`); causal masking keeps the padded tail
  keys out of every real row;
- paged prefill runs ``prefill_chunk_paged`` one bounded chunk at a time
  (``chunk`` tokens, or the whole remaining prompt when ``chunk`` is 0),
  from the end of a shared prefix: :meth:`DecodeEngine.prefill_chunk_step`
  is what the element interleaves between decode steps;
- the cache tensors are updated **in place** (scatter and ``copy_`` into
  ``pool.k``/``pool.v``): no step or prefill copies the pool, which the
  JAX package gets from ``donate_argnums``;
- :class:`PhaseClock` assigns every nanosecond of the decode thread to
  exactly one of ``idle`` / ``admit`` / ``prefill`` /
  ``llm-prefill-chunk`` / ``decode`` / ``egress`` / ``compile``.

``jax.jit`` becomes a bounded set of executables under the JAX package's
budgets, each a miss recorded in the compile ledger
(:mod:`~nnstreamer_tpu_torch.analysis.compileledger`) with the JAX
package's signature: a dense step per ``pad_rows`` lane bucket (site
``llm.engine.step``, 16), a dense prefill per :func:`quantize_prompt`
length (``llm.engine.prefill``, 32), a paged step per (lane bucket,
table width) (``llm.engine.pstep``, 64) and a paged chunk per (chunk
length, table width) (``llm.engine.chunk``, 64).  On the card an
executable is a ``torch.cuda.CUDAGraph`` over one static int64 buffer
that the host fills before each replay (tokens, positions, slots or
block tables; a prefill's slot and last position, a chunk's origin, real
length and scratch page ride in it as device indices, so one graph
serves every slot, length and offset under its bucket); its first
dispatch runs eagerly on a side stream and then captures.  On the CPU
the executable runs eagerly.  :meth:`DecodeEngine.warmup` builds the
whole set, after which a serving stream compiles nothing.
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
#: exactly one).  ``llm-prefill-chunk`` is the paged tier's interleaved
#: prefill: one bounded prompt chunk between decode steps.  ``compile`` is
#: a dispatch whose executable was not yet in the engine's warm set (on
#: the card: its eager run and capture).
PHASES = ("idle", "admit", "prefill", "llm-prefill-chunk", "decode",
          "egress", "compile")


def quantize_pages(n: int, table_max: int) -> int:
    """Padded block-table WIDTH for a paged dispatch: next power of two
    capped at ``table_max`` (= ``max_seq // page_size``), so block tables
    of every length land on a bounded set of executables.  Padding
    entries point at the scratch page."""
    cap = max(1, int(table_max))
    q = 1
    while q < n:
        q <<= 1
    return min(q, cap)


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
    (dense) or paged decode over a :class:`KVCachePool` or a
    :class:`~.paged.PagedKVCachePool`, plus the live accounting (tokens,
    step EWMA, phase attribution) the observability tier reads.

    Every graph (dense step and prefill, paged step and chunk) shares one
    memory pool: a graph's capture may reuse the memory of another
    graph's intermediates, so a replay can overwrite another graph's
    static outputs.  That is safe only because every dispatch whose
    output is used reads it to the host before the next replay
    (:meth:`prefill`, :meth:`_dispatch`, :meth:`_dispatch_paged`, the
    last chunk of :meth:`_advance_chunk`); keep it so.

    Single-threaded by contract: exactly one decode thread calls
    :meth:`prefill` / :meth:`prefill_chunk_step` / :meth:`step`, so the
    pool tensors mutate without locks.  ``prefill_mode``: ``auto`` (the
    flash gate: the kernel on the card), ``flash``, ``naive`` (plain
    attention) or ``step`` (the prompt decoded token by token through
    the decode step).  ``chunk`` (paged only): the interleaved-prefill
    chunk in tokens; 0 prefills the whole remaining prompt as one
    chunk."""

    #: private: run the executables eagerly on the card as well, for a
    #: reference run to hold the graphs to (set on an engine, or on the
    #: class, by tests and chip_smoke.py before the first dispatch)
    _eager = False

    def __init__(self, params, cfg, pool: KVCachePool, capacity: int,
                 prefill_mode: str = "auto", clock=None,
                 chunk: int = 0) -> None:
        if prefill_mode not in ("auto", "flash", "naive", "step"):
            raise ValueError(f"prefill mode {prefill_mode!r} "
                             "(want auto | flash | naive | step)")
        self.params = params
        self.cfg = cfg
        self.pool = pool
        self.capacity = max(1, int(capacity))
        self.prefill_mode = prefill_mode
        self._clock = clock if clock is not None else time.monotonic
        #: paged pool?  (block-paged arena + tables instead of slots)
        self.paged = getattr(pool, "page_size", 0) > 0
        self.chunk = max(0, int(chunk)) if self.paged else 0
        #: padded B (dense) or (padded B, width) (paged) -> step
        self._step_fns: Dict[Any, Callable] = {}
        #: padded T (dense) or ("chunk", padded C, width) (paged) -> prefill
        self._prefill_fns: Dict[Any, Callable] = {}
        self.phases = PhaseClock()
        # tokens_total counts every GENERATED token (incl. each session's
        # first, argmaxed from the prefill logits); step_tokens only the
        # decode-step ones — the honest numerator for mean bucket fill
        self.tokens_total = 0
        self.step_tokens = 0
        self.steps_total = 0
        self.prefills_total = 0
        self.prefill_chunks_total = 0
        self.last_fill = 0
        self.ewma_step_s = 0.0
        self.compiles = 0
        self._graph_memory = None
        #: host logits (f32) of the last prefill (its last chunk, paged)
        #: or step, one row per real lane — what the greedy choice was
        #: made from
        self.last_logits: Optional[np.ndarray] = None
        #: set on a per-engine memo miss, consumed by the next dispatch:
        #: that dispatch charges the ``compile`` phase
        self._cold_exec = False

    # -- executables -----------------------------------------------------
    def _new_exec(self, key, table: Dict[Any, Callable], fn: Callable
                  ) -> Callable:
        exe = table[key] = _Executable(self, fn)
        self.compiles += 1
        self._cold_exec = True
        return exe

    @compile_budget(16, site="llm.engine.step")
    def _step_fn(self, padded: int) -> Callable:
        """The dense step executable for ``padded`` lanes: a ``(3,
        padded)`` buffer of tokens, positions and slots → logits
        ``(padded, vocab)``."""
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

            fn = self._new_exec(padded, self._step_fns, step)
        return fn

    @compile_budget(64, site="llm.engine.pstep")
    def _pstep_fn(self, padded: int, width: int) -> Callable:
        """The paged step executable for ``padded`` lanes and block
        tables ``width`` pages wide: a ``(padded, 2 + width)`` buffer of
        each lane's token, position and table → logits ``(padded,
        vocab)``.  Both axes are quantized, so the warm set is a bounded
        ``pad_rows x quantize_pages`` grid."""
        key = (padded, width)
        fn = self._step_fns.get(key)
        if fn is None:
            compileledger.record("llm.engine.pstep",
                                 (("padded", padded), ("width", width)))
            from ..models.streamformer_lm import decode_step_paged

            params, cfg, pool = self.params, self.cfg, self.pool
            ps = pool.page_size

            def step(lanes):
                logits, _, _ = decode_step_paged(
                    params, pool.k, pool.v, lanes[:, 0], lanes[:, 1],
                    lanes[:, 2:], cfg, ps)
                return logits

            fn = self._new_exec(key, self._step_fns, step)
        return fn

    @compile_budget(64, site="llm.engine.chunk")
    def _chunk_fn(self, padded_c: int, width: int) -> Callable:
        """The paged prefill-chunk executable for chunks padded to
        ``padded_c`` over tables ``width`` pages wide: a ``(padded_c +
        width + 3,)`` buffer of the tokens, the table, the chunk's origin,
        its real length and the scratch page → the last real position's
        logits ``(vocab,)``.  One executable serves every chunk of every
        prompt at every prefix-hit offset under its bucket."""
        key = ("chunk", padded_c, width)
        fn = self._prefill_fns.get(key)
        if fn is None:
            compileledger.record("llm.engine.chunk",
                                 (("padded_c", padded_c), ("width", width)))
            from ..models.streamformer_lm import prefill_chunk_paged

            params, cfg, pool = self.params, self.cfg, self.pool
            ps = pool.page_size

            def chunk(buf):
                last, _, _ = prefill_chunk_paged(
                    params, pool.k, pool.v, buf[:padded_c],
                    buf[padded_c:padded_c + width], buf[-3], buf[-2], cfg,
                    ps, buf[-1])
                return last

            fn = self._new_exec(key, self._prefill_fns, chunk)
        return fn

    @compile_budget(32, site="llm.engine.prefill")
    def _prefill_fn(self, padded_t: int) -> Callable:
        """The dense prefill executable for prompts padded to
        ``padded_t``: a ``(padded_t + 2,)`` buffer of the tokens, the slot
        and the last real position → that position's logits
        ``(vocab,)``."""
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

            fn = self._new_exec(padded_t, self._prefill_fns, prefill)
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
        scratch slot or page: the padded decode-lane counts (paged: each
        with every table width) and (unless ``step``) the prefill
        lengths (paged: each chunk length with every width that can
        cover it); on the card that captures the whole graph set.
        Charged to the ``compile`` phase; after it no dispatch is
        cold."""
        cprev = self.phases.enter("compile")
        try:
            if self.paged:
                self._warmup_paged()
            else:
                self._warmup_dense()
            if self.pool.device.type == "cuda":
                torch.cuda.synchronize(self.pool.device)
        finally:
            self.phases.enter(cprev)
            self._cold_exec = False

    def _lane_buckets(self) -> List[int]:
        return sorted({TorchExecMixin.pad_rows(n, self.capacity)
                       for n in range(1, self.capacity + 1)})

    def _warmup_dense(self) -> None:
        for rows in self._lane_buckets():
            lanes = np.zeros((3, rows), np.int64)
            lanes[2] = self.pool.scratch
            self._call(self._step_fn(rows), lanes)
        if self.prefill_mode != "step":
            for padded in self._prefill_lengths():
                buf = np.zeros((padded + 2,), np.int64)
                buf[padded] = self.pool.scratch
                self._call(self._prefill_fn(padded), buf)

    def _warmup_paged(self) -> None:
        """The ``pad_rows x quantize_pages`` decode grid plus every
        ``(chunk length, width)`` pair whose width can cover the chunk,
        all dispatched at the scratch page."""
        pool = self.pool
        widths = self._widths()
        for rows in self._lane_buckets():
            for w in widths:
                lanes = np.zeros((rows, 2 + w), np.int64)
                lanes[:, 2:] = pool.scratch
                self._call(self._pstep_fn(rows, w), lanes)
        if self.prefill_mode == "step":
            return   # prompt decode rides the paged step grid above
        ps = pool.page_size
        for c in self._chunk_lengths():
            min_w = quantize_pages(-(-c // ps), pool.table_max)
            for w in widths:
                if w < min_w:
                    continue
                buf = np.zeros((c + w + 3,), np.int64)
                buf[c:c + w] = pool.scratch
                buf[-3:] = (0, 1, pool.scratch)
                self._call(self._chunk_fn(c, w), buf)

    def _prefill_lengths(self) -> List[int]:
        """The power-of-two prompt buckets from 8, capped at max_seq."""
        lengths, t = set(), 8
        while True:
            lengths.add(min(t, self.cfg.max_seq))
            if t >= self.cfg.max_seq:
                return sorted(lengths)
            t <<= 1

    def _widths(self) -> List[int]:
        """The power-of-two block-table widths live dispatch can
        produce, capped at ``table_max``."""
        table_max = self.pool.table_max
        out, w = set(), 1
        while True:
            out.add(min(w, table_max))
            if w >= table_max:
                return sorted(out)
            w <<= 1

    def _chunk_lengths(self) -> List[int]:
        """Padded chunk sizes the paged prefill can dispatch: the fixed
        chunk when interleaving, else the power-of-two prompt buckets
        (one whole-suffix chunk per bucket)."""
        if self.chunk > 0:
            return [self.chunk]
        return self._prefill_lengths()

    # -- prefill ---------------------------------------------------------
    def prefill(self, sess: Session, prompt: np.ndarray) -> int:
        """Seed ``sess``'s cache from its prompt and return the session's
        FIRST generated token (greedy argmax of the last prompt
        position's logits — :func:`generate`'s semantics).  Mode ``step``
        decodes the prompt token by token through the decode step.  A
        paged session prefills from its prefix hit on, every chunk
        inline."""
        prev = self.phases.enter("prefill")
        if self.paged:
            try:
                return self._prefill_paged(sess)
            finally:
                self.phases.enter(prev)
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

    def _prefill_paged(self, sess) -> int:
        """Whole-prompt paged prefill: :meth:`_advance_chunk` walked to
        completion inline (``chunk == 0`` makes it ONE whole-suffix
        chunk).  ``prefill_mode="step"`` decodes the prompt token by
        token through the paged step grid instead."""
        if self.prefill_mode == "step":
            pool = self.pool
            prompt = sess.prompt
            first = None
            for i in range(sess.prefill_pos, sess.plen):
                pool.grow(sess, i + 1)
                logits = self._dispatch_paged(
                    [(sess.table, i, int(prompt[i]))])
                first = int(np.argmax(logits[0]))
            pool.note_prefill(sess, sess.plen)
            sess.pos = sess.plen
            self.prefills_total += 1
            self.tokens_total += 1
            sess.last_step_s = self._clock()
            return first
        while True:
            first = self._advance_chunk(sess)
            if first is not None:
                return first

    def prefill_chunk_step(self, sess) -> Optional[int]:
        """Advance ``sess``'s prefill by ONE bounded chunk — the
        element's decode loop interleaves these between decode steps so
        a long prompt cannot stall resident token streams.  Returns the
        session's first generated token when the prompt completes,
        ``None`` while chunks remain.  Attributed to the PhaseClock's
        ``llm-prefill-chunk`` share."""
        prev = self.phases.enter("llm-prefill-chunk")
        try:
            return self._advance_chunk(sess)
        finally:
            self.phases.enter(prev)

    def _advance_chunk(self, sess) -> Optional[int]:
        """One paged prefill chunk: grow the table over the chunk's real
        positions, dispatch the ``(padded C, width)`` executable, register
        any newly full prompt pages with the prefix cache.  Returns the
        first generated token on the FINAL chunk (argmax of position
        ``plen - 1``'s logits, read to the host), else ``None`` (its
        logits are not read: no host sync between chunks)."""
        pool = self.pool
        ps = pool.page_size
        start = sess.prefill_pos
        remaining = sess.plen - start
        if remaining <= 0:
            raise RuntimeError(f"session {sess.key!r} is not prefilling")
        c_real = remaining if self.chunk <= 0 \
            else min(self.chunk, remaining)
        c_pad = self.chunk if self.chunk > 0 \
            else quantize_prompt(c_real, self.cfg.max_seq)
        pool.grow(sess, start + c_real)
        span = min(start + c_pad, self.cfg.max_seq)
        w = quantize_pages(-(-span // ps), pool.table_max)
        buf = np.zeros((c_pad + w + 3,), np.int64)
        buf[:c_real] = sess.prompt[start:start + c_real]
        m = min(len(sess.table), w)
        buf[c_pad:c_pad + m] = sess.table[:m]
        buf[c_pad + m:c_pad + w] = pool.scratch
        buf[-3:] = (start, c_real, pool.scratch)
        last = self._call(self._chunk_fn(c_pad, w), buf)
        pool.note_prefill(sess, start + c_real)
        self.prefill_chunks_total += 1
        sess.last_step_s = self._clock()
        if sess.prefilling:
            return None
        logits = last.float().cpu().numpy()
        self.last_logits = logits[None]
        sess.pos = sess.plen
        self.prefills_total += 1
        self.tokens_total += 1
        return int(np.argmax(logits))

    # -- decode ----------------------------------------------------------
    def _dispatch(self, lanes: Sequence[Tuple[int, int, int]]) -> np.ndarray:
        """(slot, pos, token) lanes → one padded dense step; returns the
        real lanes' logits on the host.  Padding lanes point at the
        pool's scratch slot, position 0: their writes land in scratch."""
        n = len(lanes)
        padded = TorchExecMixin.pad_rows(n, self.capacity)
        buf = np.zeros((3, padded), np.int64)      # tokens, pos, slots
        buf[2] = self.pool.scratch
        for i, (slot, p, tok) in enumerate(lanes):
            buf[0, i], buf[1, i], buf[2, i] = tok, p, slot
        logits = self._call(self._step_fn(padded), buf)
        self.last_logits = logits[:n].float().cpu().numpy()
        return self.last_logits

    def _dispatch_paged(self, lanes) -> np.ndarray:
        """(table, pos, token) lanes → one padded paged step; returns the
        real lanes' logits on the host.  The table width is the widest
        lane's page count, quantized; padding lanes and padding table
        entries point at the scratch page, so their appends can never
        touch a live page."""
        pool = self.pool
        ps = pool.page_size
        n = len(lanes)
        padded = TorchExecMixin.pad_rows(n, self.capacity)
        w = quantize_pages(max(-(-(p + 1) // ps) for _, p, _ in lanes),
                           pool.table_max)
        buf = np.zeros((padded, 2 + w), np.int64)   # token, pos, table
        buf[:, 2:] = pool.scratch
        for i, (table, p, tok) in enumerate(lanes):
            buf[i, 0], buf[i, 1] = tok, p
            m = min(len(table), w)
            buf[i, 2:2 + m] = table[:m]
        logits = self._call(self._pstep_fn(padded, w), buf)
        self.last_logits = logits[:n].float().cpu().numpy()
        return self.last_logits

    def step(self, sessions: Sequence[Session]) -> List[int]:
        """One continuous-batching decode step over ``sessions`` (≤
        ``capacity``): consumes each session's ``next_token``, advances
        its cache position, returns the greedily-sampled NEXT token per
        session.  A paged session's table grows first when the step
        crosses into a new page."""
        if not sessions:
            return []
        t0 = self._clock()
        prev = self.phases.enter("decode")
        if self.paged:
            for s in sessions:
                self.pool.grow(s, s.pos + 1)   # lazy tail-page alloc
            logits = self._dispatch_paged(
                [(s.table, s.pos, s.next_token) for s in sessions])
        else:
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
        out = {
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
        if self.paged:
            out["prefill_chunks"] = self.prefill_chunks_total
            out["paged"] = self.pool.stats()
        return out
