"""Paged LLM serving tier: the PyTorch port against the JAX package.

The block-paged decode step and prefill chunk must give the JAX
functions' logits and arena writes (f32, CPU); the paged pool's host
bookkeeping (chain hashes, commitment admission, lazy growth, prefix
registration, copy-on-write sharing, LRU reclaim, leak audit) must make
the JAX pool's decisions step for step; and the paged engine — whole and
chunked prefill, prefix hits — must stream the tokens of the JAX
package's ``generate()`` and record the JAX engine's compile-ledger
events in ``warmup()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.analysis import compileledger as jax_ledger
from nnstreamer_tpu.llm import engine as jax_engine
from nnstreamer_tpu.llm import paged as jax_paged
from nnstreamer_tpu.models import streamformer_lm as J
from nnstreamer_tpu.parallel import train_step as JT
from nnstreamer_tpu_torch.analysis import compileledger as torch_ledger
from nnstreamer_tpu_torch.llm import DecodeEngine, PagedKVCachePool
from nnstreamer_tpu_torch.llm import engine as torch_engine
from nnstreamer_tpu_torch.llm import paged as torch_paged
from nnstreamer_tpu_torch.models import streamformer_lm as T
from nnstreamer_tpu_torch.parallel import train_step as TT

SIZES = dict(vocab=61, dim=32, heads=4, head_dim=8, mlp=64, layers=2,
             experts=2, max_seq=48)
PS = 4                       # page size: 12 pages cover max_seq
ATOL = RTOL = 1e-4           # f32, the bound of test_torch_streamformer_lm


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(JAX cfg, JAX params, port cfg, port params carrying them)."""
    jc = JT.StreamFormerConfig(**SIZES, dtype=jnp.float32)
    tc = TT.StreamFormerConfig(**SIZES, dtype=torch.float32)
    jp = JT.init_params(jc, 0)
    tp = T.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                           device="cpu")
    return jc, jp, tc, tp


# ---------------------------------------------------------------------------
# the paged math
# ---------------------------------------------------------------------------

def _arena(seed, pages=9):
    rng = np.random.default_rng(seed)
    shape = (pages + 1, SIZES["layers"], PS, SIZES["heads"],
             SIZES["head_dim"])
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


@pytest.fixture(scope="module")
def jax_paged_fns(model):
    """The JAX package's paged step and chunk, jitted (one compile per
    shape instead of op-by-op dispatch)."""
    jc = model[0]
    step = jax.jit(lambda p, k, v, t, pos, tab: J.decode_step_paged(
        p, k, v, t, pos, tab, jc, PS))
    chunk = jax.jit(lambda p, k, v, t, tab, start, n, scratch:
                    J.prefill_chunk_paged(p, k, v, t, tab, start, n, jc,
                                          PS, scratch))
    return step, chunk


#: (tokens, positions, tables), 3 lanes of 4-page tables — lanes
#: mid-page, at a page start, on the last page; padding lanes all on the
#: scratch page (9); tables scratch-padded
STEP_CASES = {
    "three_lanes": ([3, 5, 7], [5, 0, 10],
                    [[0, 1, 9, 9], [4, 9, 9, 9], [2, 3, 5, 9]]),
    "padding_lanes": ([11, 0, 0], [7, 0, 0],
                      [[6, 7, 9, 9], [9, 9, 9, 9], [9, 9, 9, 9]]),
    "full_width": ([60, 1, 0], [15, 12, 0],
                   [[8, 2, 1, 0], [3, 4, 5, 6], [9, 9, 9, 9]]),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_decode_step_paged_matches_jax(model, jax_paged_fns, case):
    jc, jp, tc, tp = model
    toks, pos, tables = (np.asarray(a, np.int32) for a in STEP_CASES[case])
    k, v = _arena(1)
    jl, jk, jv = jax_paged_fns[0](jp, jnp.asarray(k), jnp.asarray(v),
                                  jnp.asarray(toks), jnp.asarray(pos),
                                  jnp.asarray(tables))
    tk, tv = torch.tensor(k), torch.tensor(v)
    tl, rk, rv = T.decode_step_paged(tp, tk, tv, torch.tensor(toks),
                                     torch.tensor(pos), torch.tensor(tables),
                                     tc, PS)
    assert rk is tk and rv is tv            # written in place
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL,
                               rtol=RTOL)


#: (start, true_len, table width): a chunk from 0, one after a shared
#: prefix, a short tail, and a padded chunk whose padding queries run
#: past max_seq (their gathers clamp, their writes land on scratch)
CHUNK_CASES = [(0, 5, 2), (3, 5, 4), (8, 3, 4), (44, 3, 12)]


@pytest.mark.parametrize("start,true_len,width", CHUNK_CASES)
def test_prefill_chunk_paged_matches_jax(model, jax_paged_fns, start,
                                        true_len, width):
    jc, jp, tc, tp = model
    rng = np.random.default_rng(start)
    toks = np.zeros(8, np.int32)
    toks[:true_len] = rng.integers(0, 61, true_len)
    scratch = 13
    table = np.full(width, scratch, np.int32)
    used = -(-(start + true_len) // PS)
    table[:used] = rng.permutation(scratch)[:used]
    k, v = _arena(2, pages=scratch)
    jl, jk, jv = jax_paged_fns[1](
        jp, jnp.asarray(k), jnp.asarray(v), jnp.asarray(toks),
        jnp.asarray(table), jnp.int32(start), jnp.int32(true_len),
        jnp.int32(scratch))
    tk, tv = torch.tensor(k), torch.tensor(v)
    tl, _, _ = T.prefill_chunk_paged(
        tp, tk, tv, torch.tensor(toks), torch.tensor(table),
        torch.tensor(start), torch.tensor(true_len), tc, PS,
        torch.tensor(scratch))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                               rtol=RTOL)
    # every live page equal; the scratch page takes the padding writes
    # (in an order neither package defines)
    np.testing.assert_allclose(tk.numpy()[:scratch],
                               np.asarray(jk)[:scratch], atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(tv.numpy()[:scratch],
                               np.asarray(jv)[:scratch], atol=ATOL,
                               rtol=RTOL)


def test_chunks_chain_into_the_whole_prefill(model):
    """Three chained chunks' last logits equal the whole-prompt
    forward's last row: chunking changes nothing."""
    _, _, tc, tp = model
    prompt = np.random.default_rng(5).integers(0, 61, 11)
    full = T.forward_logits(tp, torch.tensor(prompt), tc, flash=False)
    k = torch.zeros((10, 2, PS, 4, 8))
    v = torch.zeros_like(k)
    table = torch.tensor([0, 1, 2, 9])
    for start in (0, 4, 8):
        n = min(4, 11 - start)
        toks = torch.zeros(4, dtype=torch.long)
        toks[:n] = torch.tensor(prompt[start:start + n])
        last, _, _ = T.prefill_chunk_paged(tp, k, v, toks, table,
                                           torch.tensor(start),
                                           torch.tensor(n), tc, PS,
                                           torch.tensor(9))
    np.testing.assert_allclose(last.numpy(), full[-1].numpy(), atol=ATOL,
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# quantizers and hashes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table_max", [1, 3, 12, 128])
def test_quantize_pages_matches_jax(table_max):
    for n in range(1, table_max + 2):
        assert (torch_engine.quantize_pages(n, table_max)
                == jax_engine.quantize_pages(n, table_max))


@pytest.mark.parametrize("plen,page_size", [(0, 4), (7, 4), (8, 4),
                                            (33, 16), (300, 16)])
def test_chain_hashes_byte_equal(plen, page_size):
    prompt = np.random.default_rng(plen).integers(0, 8192, plen)
    got = torch_paged.chain_hashes(prompt, page_size)
    assert got == jax_paged.chain_hashes(prompt, page_size)
    assert len(got) == plen // page_size


# ---------------------------------------------------------------------------
# the pool's bookkeeping against the JAX pool's
# ---------------------------------------------------------------------------

def _pools(model, clock, **kw):
    jc, _, tc, _ = model
    jpool = jax_paged.PagedKVCachePool(jc, clock=lambda: clock[0], **kw)
    tpool = PagedKVCachePool(tc, clock=lambda: clock[0], device="cpu", **kw)
    return jpool, tpool


def _state(pool, sessions=()):
    return (pool.stats(), pool.free_pages, round(pool.occupancy, 9),
            pool.check_leaks(), pool.live,
            [(s.key, list(s.table), s.prefill_pos, s.reserve, s.n_reg,
              s.shared_tokens) for s in sessions])


def _scripted(pool):
    """acquire / grow / note_prefill / release / prefix hit / shed /
    reclaim under pressure / reset, with the pool's state after every
    operation (8 pages of 4 tokens)."""
    seen = []
    pre = (np.arange(10) % 61).astype(np.int32)
    a = pool.acquire("a", prompt=pre, max_new=4)
    seen.append(_state(pool, [a]))
    pool.grow(a, 10)
    pool.note_prefill(a, 10)                      # registers 2 full pages
    seen.append(_state(pool, [a]))
    pool.grow(a, 13)
    seen.append(_state(pool, [a]))
    pool.release("a")                             # 2 pages reclaimable
    seen.append(_state(pool))
    b = pool.acquire("b", prompt=np.concatenate([pre[:8], [44, 1]]),
                     max_new=4)                   # 2-page prefix hit
    seen.append(_state(pool, [b]))
    pool.grow(b, 10)
    pool.note_prefill(b, 10)
    seen.append((_state(pool, [b]), pool._page_hash[b.table[2]] is None))
    pool.release("b")
    seen.append(pool.admit("gold", prompt=np.arange(30) % 61, max_new=9))
    c = pool.acquire("c", prompt=np.full(12, 7, np.int32), max_new=16)
    pool.grow(c, 28)                              # reclaims the LRU page
    seen.append(_state(pool, [c]))
    seen.append(pool.admit("gold", prompt=np.arange(4) % 61, max_new=1))
    pool.touch("c")
    seen.append((pool.lru_key(), pool.aged_keys(0.5)))
    for key in ("c", "nope"):
        gone = pool.release(key)
        seen.append(gone.key if gone is not None else None)
    seen.append(_state(pool))
    seen.append(pool.reset_prefix_cache())
    seen.append(_state(pool))
    return seen


def test_scripted_pool_matches_jax(model):
    clock = [0.0]
    jpool, tpool = _pools(model, clock, pages=8, page_size=PS, slots=4)
    want = _scripted(jpool)
    clock[0] = 0.0
    assert _scripted(tpool) == want
    assert tpool.pages_reclaimed == 1 and tpool.prefix_hits == 1
    assert tpool.check_leaks() == [] and tpool.free_pages == 8


def _churn(pool, clock):
    """The JAX package's fragmentation-churn property (tests/test_llm.py):
    random joins, leaves, shared prefixes, mid-prefill abandons and
    cache resets; the pool's state after every step."""
    rng = np.random.default_rng(1234)
    live, seen = {}, []
    for step in range(400):
        clock[0] += 0.01
        roll = rng.random()
        if live and (len(live) >= pool.slots or roll < 0.40):
            key = list(live)[int(rng.integers(0, len(live)))]
            live.pop(key)
            pool.release(key)
        elif roll < 0.45:
            seen.append(pool.reset_prefix_cache())
        else:
            plen = int(rng.integers(1, 20))
            max_new = int(rng.integers(1, 12))
            if rng.random() < 0.5:
                prompt = (np.arange(plen) % 61).astype(np.int32)
            else:
                prompt = rng.integers(0, 61, plen).astype(np.int32)
            if pool.admit("silver", prompt=prompt,
                          max_new=max_new) is not None:
                seen.append("shed")
                continue
            key = f"s{step}"
            sess = pool.acquire(key, prompt=prompt, max_new=max_new)
            live[key] = sess
            upto = int(rng.integers(sess.prefill_pos, plen + 1))
            pool.grow(sess, upto)
            pool.note_prefill(sess, upto)
            if upto == plen and rng.random() < 0.7:
                pool.grow(sess, plen + int(rng.integers(0, max_new)))
        seen.append(_state(pool, live.values()))
    for key in list(live):
        pool.release(key)
    seen.append(_state(pool))
    return seen


def test_churn_matches_jax_and_leaks_nothing(model):
    clock = [0.0]
    jpool, tpool = _pools(model, clock, pages=59, page_size=PS, slots=8)
    want = _churn(jpool, clock)
    clock[0] = 0.0
    got = _churn(tpool, clock)
    assert got == want
    assert tpool.check_leaks() == [] and tpool.free_pages == tpool.pages


def test_arena_layout_matches_jax(model):
    jc, _, tc, _ = model
    jpool = jax_paged.PagedKVCachePool(jc, 59, PS, slots=4)
    tpool = PagedKVCachePool(tc, 59, PS, slots=4, device="cpu")
    assert tuple(tpool.k.shape) == tuple(jpool.k.shape)
    assert tpool.cache_bytes() == jpool.cache_bytes()
    assert tpool.scratch == jpool.scratch == 59
    assert tpool.table_max == jpool.table_max == 12
    # zero-filled: a masked p = 0 times a garbage NaN would still be NaN
    assert not tpool.k.any() and not tpool.v.any()
    with pytest.raises(ValueError, match="tile max_seq"):
        PagedKVCachePool(tc, 8, 5, slots=2, device="cpu")


def test_pool_without_device_raises(model, monkeypatch):
    from nnstreamer_tpu_torch.device import DeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        PagedKVCachePool(model[2], 8, PS, slots=2)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------

def _prompts():
    rng = np.random.default_rng(11)
    return [rng.integers(0, 61, n).astype(np.int32) for n in (13, 5, 17)]


LENS = [6, 8, 5]


@pytest.fixture(scope="module")
def reference(model):
    jc, jp, _, _ = model
    return [J.generate(jp, jc, pr, n).tolist()
            for pr, n in zip(_prompts(), LENS)]


def _paged_engine(tc, tp, chunk, mode="auto", capacity=4):
    pool = PagedKVCachePool(tc, 40, PS, slots=capacity, device="cpu")
    return DecodeEngine(tp, tc, pool, capacity=capacity, prefill_mode=mode,
                        chunk=chunk)


def _serve_paged(eng, prompts, lens):
    """Sessions through a paged engine as the element drives it: each
    admitted onto the pool, prefilled (whole, or one chunk per loop with
    the decodable sessions stepped together between chunks) until each
    has its length; returns the streams."""
    pool, chunk = eng.pool, eng.chunk
    out = {}
    for i, pr in enumerate(prompts):
        s = pool.acquire(i, prompt=pr, max_new=lens[i])
        if chunk == 0:
            s.next_token = eng.prefill(s, pr)
            out[i] = [s.next_token]
    while True:
        ready = [s for s in pool.sessions() if not s.prefilling]
        live = [s for s in ready if len(out.get(s.key, [])) < lens[s.key]]
        for s, tok in zip(live, eng.step(live)):
            out[s.key].append(tok)
            s.next_token = tok
        for s in ready:
            if len(out[s.key]) >= lens[s.key]:
                pool.release(s.key)
        waiting = [s for s in pool.sessions() if s.prefilling]
        if waiting:
            first = eng.prefill_chunk_step(waiting[0])
            if first is not None:
                waiting[0].next_token = first
                out[waiting[0].key] = [first]
        elif not live:
            break
    return [out[i] for i in range(len(prompts))]


@pytest.mark.parametrize("chunk,mode", [(0, "auto"), (4, "auto"),
                                        (0, "step")])
def test_paged_engine_streams_equal_generate(model, reference, chunk, mode):
    _, _, tc, tp = model
    eng = _paged_engine(tc, tp, chunk, mode)
    assert _serve_paged(eng, _prompts(), LENS) == reference
    assert eng.paged and eng.chunk == chunk
    assert eng.tokens_total == sum(LENS)
    assert eng.pool.check_leaks() == []
    if chunk:
        # 13 + 5 + 17 prompt tokens in chunks of 4
        assert eng.prefill_chunks_total == 4 + 2 + 5
        assert eng.phases.totals_ns()["llm-prefill-chunk"] > 0
    assert eng.phases.report()["conserved_pct"] == 100.0


def test_prefix_hit_shares_pages_and_isolates_tails(model):
    """Two sessions on one 8-token system prompt, one after the other:
    the second admits onto the first's registered pages (8 tokens never
    prefilled again), its tail lands on private pages, and both streams
    equal their own generate()."""
    jc, jp, tc, tp = model
    pre = (np.arange(8) % 61).astype(np.int32)
    prompts = [np.concatenate([pre, np.asarray(t, np.int32)])
               for t in ([3, 9], [44, 1])]
    eng = _paged_engine(tc, tp, chunk=4)
    pool = eng.pool
    streams = []
    for pr in prompts:
        streams += _serve_paged(eng, [pr], [6])
    assert pool.prefix_hits == 1 and pool.prefix_tokens_reused == 8
    assert streams == [J.generate(jp, jc, pr, 6).tolist() for pr in prompts]
    assert pool.check_leaks() == [] and pool.free_pages == pool.pages


def test_warmup_makes_every_paged_dispatch_warm(model):
    _, _, tc, tp = model
    eng = _paged_engine(tc, tp, chunk=4)
    eng.warmup()
    warm = eng.compiles
    # pad rows {1, 2, 4} x widths {1, 2, 4, 8, 12}, and chunk 4 at
    # every width
    assert warm == 3 * 5 + 5
    _serve_paged(eng, _prompts(), LENS)
    assert eng.compiles == warm and eng.steps_total > 0


@pytest.fixture
def ledgers():
    was = (jax_ledger.ENABLED, torch_ledger.ENABLED)
    for m in (jax_ledger, torch_ledger):
        m.configure(True)
        m.reset()
    yield
    for m, on in zip((jax_ledger, torch_ledger), was):
        m.configure(on)
        m.reset()


def _events(ledger):
    return [(e.site, e.seq, e.signature, e.diff) for e in ledger.events()]


def test_warmup_records_the_jax_engines_ledger(model, ledgers):
    """16-token pages (widths 1, 2, 3), one lane, chunks of 8: each
    engine's warm set and ledger events, the JAX one's compiled."""
    jc, jp, tc, tp = model
    jeng = jax_engine.DecodeEngine(
        jp, jc, jax_paged.PagedKVCachePool(jc, 10, 16, slots=1),
        capacity=1, chunk=8)
    jeng.warmup()
    teng = DecodeEngine(tp, tc, PagedKVCachePool(tc, 10, 16, slots=1,
                                                 device="cpu"),
                        capacity=1, chunk=8)
    teng.warmup()
    assert teng.compiles == 3 + 3
    assert _events(torch_ledger) == _events(jax_ledger)
    assert torch_ledger.snapshot() == jax_ledger.snapshot()
    assert teng.compiles == jeng.compiles
    assert sorted(teng._step_fns) == sorted(jeng._step_jit)
    assert sorted(teng._prefill_fns) == sorted(jeng._prefill_jit)


def test_report_has_the_jax_keys(model):
    _, _, tc, tp = model
    pool = PagedKVCachePool(tc, 40, PS, slots=2, device="cpu")
    eng = DecodeEngine(tp, tc, pool, capacity=2, chunk=4)
    report = eng.report()
    assert set(report) == {"tokens", "steps", "prefills", "mean_fill",
                           "ewma_step_ms", "compiles", "cache_bytes",
                           "phases", "prefill_chunks", "paged"}
    assert report["paged"] == pool.stats()
