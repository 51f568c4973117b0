"""LLM serving tier (dense slot pool): the PyTorch port against the JAX
package.

The decode engine's greedy token streams — prompts prefilled at padded
power-of-two lengths, sessions sharing one padded decode step — must equal
the port's ``generate`` and the JAX package's ``generate`` with the same
parameters (f32, CPU), token for token.  The pool, its admission control
(the port's copy of ``query/overload.py``, the same code), the lane and
prompt quantizers and the phase clock must behave as the JAX package's
do.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.filter.backends._jitexec import JitExecMixin
from nnstreamer_tpu.llm import engine as jax_engine
from nnstreamer_tpu.llm.pool import KVCachePool as JaxPool
from nnstreamer_tpu.models import streamformer_lm as J
from nnstreamer_tpu.parallel import train_step as JT
from nnstreamer_tpu.query import overload as jax_overload
from nnstreamer_tpu_torch.filter.backends._torchexec import TorchExecMixin
from nnstreamer_tpu_torch.llm import (DecodeEngine, KVCachePool, PhaseClock,
                                      slot_admission_controller)
from nnstreamer_tpu_torch.llm import engine as torch_engine
from nnstreamer_tpu_torch.models import streamformer_lm as T
from nnstreamer_tpu_torch.parallel import train_step as TT
from nnstreamer_tpu_torch.query import overload

SIZES = dict(vocab=61, dim=32, heads=4, head_dim=8, mlp=64, layers=2,
             experts=2, max_seq=48)


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


def _prompts():
    rng = np.random.default_rng(7)
    # 4, 7 and 13 tokens: every prefill pads (to 8, 8 and 16)
    return [rng.integers(0, 61, n).astype(np.int32) for n in (4, 7, 13)]


LENS = [7, 4, 9]       # sessions leave the shared step at different times


def _serve(tc, tp, mode, capacity=4):
    """Three sessions through one engine: prefill each, then step the
    live ones together until each has its length; returns the streams."""
    pool = KVCachePool(tc, capacity, device="cpu")
    eng = DecodeEngine(tp, tc, pool, capacity=capacity, prefill_mode=mode)
    k, v = pool.k, pool.v
    sessions, out = [], {}
    for i, pr in enumerate(_prompts()):
        s = pool.acquire(i)
        s.next_token = eng.prefill(s, pr)
        out[i] = [s.next_token]
        sessions.append(s)
    while True:
        live = [s for s in sessions if len(out[s.key]) < LENS[s.key]]
        if not live:
            break
        for s, tok in zip(live, eng.step(live)):
            out[s.key].append(tok)
            s.next_token = tok
    # the cache was updated in place: same tensors, same storage
    assert pool.k is k and pool.v is v
    return [out[i] for i in range(3)], eng


@pytest.fixture(scope="module")
def reference(model):
    jc, jp, _, _ = model
    return [J.generate(jp, jc, pr, n).tolist()
            for pr, n in zip(_prompts(), LENS)]


@pytest.mark.parametrize("mode", ["auto", "step", "flash", "naive"])
def test_engine_streams_equal_generate(model, reference, mode):
    _, _, tc, tp = model
    streams, eng = _serve(tc, tp, mode)
    assert streams == reference
    assert streams == [T.generate(tp, tc, pr, n).tolist()
                       for pr, n in zip(_prompts(), LENS)]
    assert eng.prefills_total == 3
    assert eng.tokens_total == sum(LENS)
    assert eng.phases.report()["conserved_pct"] == 100.0


def test_warmup_makes_every_fill_warm(model):
    _, _, tc, tp = model
    pool = KVCachePool(tc, 8, device="cpu")
    eng = DecodeEngine(tp, tc, pool, capacity=8)
    eng.warmup()
    compiled = eng.compiles
    sessions = [pool.acquire(i) for i in range(5)]
    for s in sessions:
        s.next_token = s.key + 1
    for fill in (5, 3, 1, 4, 2):
        eng.step(sessions[:fill])
    assert eng.compiles == compiled
    assert eng.steps_total == 5
    # padded lane counts 1, 2, 4, 8 plus prompt lengths 8, 16, 32, 48
    assert compiled == 8


def test_cold_dispatch_is_charged_to_compile(model):
    _, _, tc, tp = model
    ticks = iter(range(0, 10**12, 1000))
    pool = KVCachePool(tc, 2, device="cpu")
    eng = DecodeEngine(tp, tc, pool, capacity=2)
    eng.phases = PhaseClock(clock_ns=lambda: next(ticks))
    s = pool.acquire("a")
    s.next_token = 5
    eng.step([s])
    assert eng.phases.totals_ns()["compile"] > 0
    before = eng.phases.totals_ns()["compile"]
    eng.step([s])
    assert eng.phases.totals_ns()["compile"] == before


def test_last_logits_are_the_greedy_basis(model):
    _, _, tc, tp = model
    _, eng = _serve(tc, tp, "auto")
    assert eng.last_logits.shape[1] == 61


def test_retry_after_hint_tracks_soonest_finisher(model):
    _, _, tc, tp = model
    pool = KVCachePool(tc, 2, device="cpu")
    eng = DecodeEngine(tp, tc, pool, capacity=2)
    a = pool.acquire("a")
    a.max_new, a.emitted = 10, 8
    b = pool.acquire("b")
    b.max_new, b.emitted = 30, 0
    eng.ewma_step_s = 0.1
    assert eng.retry_after_hint() == pytest.approx(0.2)
    assert set(eng.report()) == {"tokens", "steps", "prefills", "mean_fill",
                                 "ewma_step_ms", "compiles", "cache_bytes",
                                 "phases"}


def test_engine_refuses_paged_pool_and_bad_mode(model):
    _, _, tc, tp = model
    pool = KVCachePool(tc, 2, device="cpu")
    pool.page_size = 16
    with pytest.raises(NotImplementedError, match="paged"):
        DecodeEngine(tp, tc, pool, capacity=2)
    with pytest.raises(ValueError, match="prefill mode"):
        DecodeEngine(tp, tc, KVCachePool(tc, 2, device="cpu"), 2,
                     prefill_mode="chunked")


# ---------------------------------------------------------------------------
# pool, admission and quantizers against the JAX package
# ---------------------------------------------------------------------------

def test_pool_cache_matches_jax_layout(model):
    jc, _, tc, _ = model
    jpool, tpool = JaxPool(jc, 3), KVCachePool(tc, 3, device="cpu")
    assert tuple(tpool.k.shape) == tuple(jpool.k.shape)
    assert tpool.cache_bytes() == jpool.cache_bytes()
    assert tpool.scratch == jpool.scratch == 3
    assert tpool.k.device == torch.device("cpu")


def _pool_script(pool, clock):
    """The same admission/lifecycle script on either package's pool."""
    seen = []
    for i in range(4):
        seen.append(pool.admit("bronze"))
        if seen[-1] is None:
            pool.acquire(f"b{i}", qos="bronze")
    seen.append(pool.admit("gold"))
    seen.append(sorted(s.slot for s in pool.sessions()))
    clock[0] = 50.0
    pool.touch("b0")
    seen.append(pool.lru_key())
    seen.append(pool.aged_keys(10.0))
    seen.append(pool.release("b1").slot)
    seen.append(pool.release("nope"))
    seen.append((pool.live, pool.occupancy))
    with pytest.raises(ValueError, match="already live"):
        pool.acquire("b0")
    return seen


def test_pool_behaves_as_jax(model):
    jc, _, tc, _ = model
    jclock, tclock = [0.0], [0.0]
    want = _pool_script(JaxPool(jc, 4, clock=lambda: jclock[0]), jclock)
    got = _pool_script(KVCachePool(tc, 4, clock=lambda: tclock[0],
                                   device="cpu"), tclock)
    assert got == want


def test_pool_without_device_raises(model, monkeypatch):
    from nnstreamer_tpu_torch.device import DeviceError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        KVCachePool(model[2], 2)


def _code_of(module):
    """The module's AST with docstrings dropped."""
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


def test_overload_has_the_jax_packages_code():
    """Only the docstrings differ."""
    assert _code_of(overload) == _code_of(jax_overload)


@pytest.mark.parametrize("depths", [[0, 3, 4, 5, 2, 1, 4], [9, 1, 9, 0]])
def test_slot_admission_decisions_match_jax(depths):
    from nnstreamer_tpu.llm.pool import \
        slot_admission_controller as jax_controller

    mine, theirs = slot_admission_controller(), jax_controller()
    for qos in ("bronze", "silver", "gold"):
        for depth in depths:
            assert (mine.admit(qos, depth, 5)
                    == theirs.admit(qos, depth, 5))


@pytest.mark.parametrize("capacity", [0, 4, 8, 32])
def test_pad_rows_matches_jax(capacity):
    for n in range(1, 41):
        assert (TorchExecMixin.pad_rows(n, capacity)
                == JitExecMixin.pad_rows(n, capacity))


@pytest.mark.parametrize("max_seq", [8, 48, 1024])
def test_quantize_prompt_matches_jax(max_seq):
    for t in range(1, max_seq + 1):
        assert (torch_engine.quantize_prompt(t, max_seq)
                == jax_engine.quantize_prompt(t, max_seq))


def test_phase_clock_matches_jax():
    def script(clock_cls):
        ticks = iter(range(0, 10**9, 7_000))
        pc = clock_cls(clock_ns=lambda: next(ticks))
        for state in ("admit", "prefill", "decode", "egress", "decode",
                      "idle"):
            pc.enter(state)
        return pc.totals_ns(), pc.report()

    assert script(PhaseClock) == script(jax_engine.PhaseClock)
    assert torch_engine.PHASES == jax_engine.PHASES
