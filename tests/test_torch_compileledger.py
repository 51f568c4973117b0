"""The compile ledger: the port's copy against the JAX package's, and the
port's executables recording into it as the JAX package's do.

- the JAX package's ledger cases (``tests/test_analysis.py``) run through
  both modules as parametrised cases, and one script's events, diffs and
  ``CompileBudgetExceeded`` text agree between them;
- ``TorchExecMixin`` records one ``filter.jitexec.invoke`` event per new
  input signature, none on a repeat, and a pushed-down reduction makes
  the next dispatch a compile again: the same events as the JAX
  package's ``JitExecMixin`` for the same calls;
- ``DecodeEngine.warmup()`` records the same step and prefill events in
  both packages, and a mixed session stream after it records none.

All on the CPU, where a port executable's first build is its compile.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnstreamer_tpu.analysis import compileledger as jax_ledger
from nnstreamer_tpu_torch.analysis import compileledger as torch_ledger

LEDGERS = {"jax": jax_ledger, "torch": torch_ledger}


@pytest.fixture
def both_on():
    was = {k: m.ENABLED for k, m in LEDGERS.items()}
    for m in LEDGERS.values():
        m.configure(True)
        m.reset()
    yield
    for k, m in LEDGERS.items():
        m.configure(was[k])
        m.reset()


@pytest.fixture(params=sorted(LEDGERS))
def ledger(request, both_on):
    return LEDGERS[request.param]


# ---------------------------------------------------------------------------
# the JAX package's ledger cases, through both modules
# ---------------------------------------------------------------------------

def test_record_counts_and_snapshot(ledger):
    ledger.record("t.site.a", (("padded", 8),))
    ledger.record("t.site.a", (("padded", 16),))
    ledger.record("t.site.b", (("width", 4),))
    assert ledger.count("t.site.a") == 2
    assert ledger.count("t.site.b") == 1
    snap = ledger.snapshot()
    assert snap["t.site.a"] == 2 and snap["t.site.b"] == 1


def test_duplicate_signature_is_not_novel(ledger):
    ledger.declare_budget("t.site.dup", 1)
    for _ in range(3):
        ledger.record("t.site.dup", (("padded", 8),))
    assert ledger.count("t.site.dup") == 3


def test_budget_overflow_raises_with_both_signatures_diffed(ledger):
    ledger.declare_budget("t.site.over", 1)
    ledger.record("t.site.over", (("padded", 8),))
    with pytest.raises(ledger.CompileBudgetExceeded) as ei:
        ledger.record("t.site.over", (("padded", 136),))
    msg = str(ei.value)
    assert "t.site.over" in msg
    assert "padded" in msg and "8" in msg and "136" in msg
    assert ledger.count("t.site.over") == 2


def test_nearest_neighbor_diff_picks_fewest_fields(ledger):
    site = "t.site.nn"
    ledger.record(site, (("a", 1), ("b", 2)))
    ledger.record(site, (("a", 1), ("b", 3)))
    ev = ledger.record(site, (("a", 9), ("b", 3)))
    assert ev.diff == (("a", 1, 9),)


def test_first_compile_has_empty_diff(ledger):
    ev = ledger.record("t.site.first", (("padded", 8),))
    assert ev.diff == ()
    assert "first compile" in ledger.format_diff(ev.diff)


def test_reset_clears_events_keeps_budgets(ledger):
    ledger.declare_budget("t.site.keep", 7)
    ledger.record("t.site.keep", (("padded", 8),))
    ledger.reset()
    assert ledger.count() == 0
    assert ledger.budgets()["t.site.keep"] == 7


def test_off_is_a_noop(ledger):
    ledger.configure(False)
    assert ledger.record("t.site.off", (("padded", 8),)) is None
    assert ledger.count("t.site.off") == 0


# ---------------------------------------------------------------------------
# the two modules agree
# ---------------------------------------------------------------------------

def _script(ledger):
    """Events, diffs and the overflow's text of one fixed sequence."""
    ledger.declare_budget("t.script", 3)
    for sig in [(("padded", 8),), (("padded", 16),), (("padded", 8),),
                (("padded", 32), ("width", 2)), [1, ("x", 2)], 5,
                {"padded": 64}]:
        try:
            ledger.record("t.script", sig)
        except ledger.CompileBudgetExceeded as exc:
            over = (str(exc), exc.budget, exc.neighbor, exc.event.seq)
    return ([(e.site, e.seq, e.signature, e.diff, str(e))
             for e in ledger.events()], over, ledger.snapshot())


def test_modules_give_the_same_events_diffs_and_errors(both_on):
    assert _script(torch_ledger) == _script(jax_ledger)


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


def test_port_has_the_jax_packages_code():
    """Only the docstrings differ; the obs export stays behind the
    reference's guard, which the port (no ``obs/metrics`` yet) takes."""
    assert _code_of(torch_ledger) == _code_of(jax_ledger)


def test_port_records_without_an_obs_plane(both_on):
    ev = torch_ledger.record("t.site.metric", (("padded", 8),))
    assert ev is not None and torch_ledger.count("t.site.metric") == 1


def test_engine_sites_declare_the_jax_budgets():
    import nnstreamer_tpu.llm.engine  # noqa: F401
    import nnstreamer_tpu_torch.llm.engine  # noqa: F401

    want, got = jax_ledger.budgets(), torch_ledger.budgets()
    for site, n in (("llm.engine.step", 16), ("llm.engine.prefill", 32)):
        assert got[site] == want[site] == n


# ---------------------------------------------------------------------------
# the filter backend's executables
# ---------------------------------------------------------------------------

MOBILENET = dict(framework="xla", model="mobilenet_v2",
                 custom="input_size:32,num_classes:10")


def _frame(size):
    return np.zeros((size, size, 3), np.uint8)


def _events(ledger, site):
    return [(e.seq, e.signature, e.diff) for e in ledger.events(site)]


def _filter_script(single, top1):
    """Open (one warm-up invoke), a repeat, a new signature, a repeat,
    then a pushed-down reduction and one invoke of each signature."""
    fw = single.fw
    for size in (32, 32, 40, 40):
        fw.invoke([_frame(size)])
    fw.set_postprocess(lambda outs: [top1(outs[0])])
    for size in (32, 40, 32):
        fw.invoke([_frame(size)])


def test_filter_records_each_new_signature_once(both_on):
    from nnstreamer_tpu_torch.filter import FilterSingle
    from nnstreamer_tpu_torch.ops.classify import top1

    site = "filter.jitexec.invoke"
    with FilterSingle(accelerator="true:cpu", **MOBILENET) as single:
        assert torch_ledger.count(site) == 1       # the open's warm-up
        single.fw.invoke([_frame(32)])
        assert torch_ledger.count(site) == 1       # a repeat: warm
        single.fw.invoke([_frame(40)])
        assert torch_ledger.count(site) == 2       # a new signature
        single.fw.set_postprocess(lambda outs: [top1(outs[0])])
        single.fw.invoke([_frame(32)])
        assert torch_ledger.count(site) == 3       # cold after the fusion
        single.fw.invoke([_frame(32)])
        assert torch_ledger.count(site) == 3
    first, second, fused = torch_ledger.events(site)
    assert first.signature == (("arg[0]", ((32, 32, 3), "uint8")),)
    assert second.diff == (("arg[0]", ((32, 32, 3), "uint8"),
                            ((40, 40, 3), "uint8")),)
    assert fused.signature == first.signature and fused.diff == ()


def test_filter_events_equal_the_jax_packages(both_on):
    from nnstreamer_tpu.filter.single import FilterSingle as JaxSingle
    from nnstreamer_tpu.ops.classify import top1 as jax_top1
    from nnstreamer_tpu_torch.filter import FilterSingle
    from nnstreamer_tpu_torch.ops.classify import top1

    site = "filter.jitexec.invoke"
    with JaxSingle(**MOBILENET) as single:
        _filter_script(single, jax_top1)
    with FilterSingle(accelerator="true:cpu", **MOBILENET) as single:
        _filter_script(single, top1)
    assert _events(torch_ledger, site) == _events(jax_ledger, site)
    assert len(_events(torch_ledger, site)) == 4


def test_pushdown_compiles_before_the_first_frame(both_on, monkeypatch):
    """The decoder's pushdown drops the graphs after open; the element
    compiles the fused forward at pushdown time, so the first frame's
    invoke finds it warm and the stream compiles nothing."""
    import nnstreamer_tpu_torch
    from nnstreamer_tpu_torch.filter.backends._torchexec import \
        TorchExecMixin

    site = "filter.jitexec.invoke"
    at_invoke = []
    invoke = TorchExecMixin.invoke

    def counting(self, inputs):
        at_invoke.append(torch_ledger.count(site))
        return invoke(self, inputs)

    monkeypatch.setattr(TorchExecMixin, "invoke", counting)
    p = nnstreamer_tpu_torch.parse_launch(
        "videotestsrc num-buffers=3 ! video/x-raw,format=RGB,width=32,"
        "height=32,framerate=30/1 ! tensor_converter ! tensor_filter "
        "framework=xla model=mobilenet_v2 accelerator=true:cpu "
        "custom=input_size:32,num_classes:10 ! "
        "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    p.run(timeout=120)
    assert len(p.get("out").results) == 3
    # open's warm-up, then the fused forward at pushdown
    assert at_invoke == [2, 2, 2]
    (_, open_sig, _), (_, fused_sig, diff) = _events(torch_ledger, site)
    assert open_sig == fused_sig and diff == ()


# ---------------------------------------------------------------------------
# the decode engine's warm set
# ---------------------------------------------------------------------------

SIZES = dict(vocab=31, dim=16, heads=2, head_dim=8, mlp=32, layers=1,
             experts=2, max_seq=16)


def _engine_run(engine_cls, pool_cls, cfg, params, ledger):
    """Warm an engine, then serve a mixed session stream; returns the
    events of the warm-up and the snapshots around the stream."""
    pool = pool_cls(cfg, 2)
    eng = engine_cls(params, cfg, pool, capacity=2)
    eng.warmup()
    warm = [(e.site, e.seq, e.signature, e.diff) for e in ledger.events()]
    mark = ledger.snapshot()
    rng = np.random.default_rng(3)
    sessions = [pool.acquire(i) for i in range(2)]
    for s, n in zip(sessions, (3, 9)):
        s.next_token = eng.prefill(s, rng.integers(0, 31, n).astype(
            np.int32))
    for fill in (2, 1, 2, 1):
        for s, tok in zip(sessions[:fill], eng.step(sessions[:fill])):
            s.next_token = tok
    return warm, mark, ledger.snapshot()


def test_engine_warm_set_equals_the_jax_packages(both_on):
    from nnstreamer_tpu.llm.engine import DecodeEngine as JaxEngine
    from nnstreamer_tpu.llm.pool import KVCachePool as JaxPool
    from nnstreamer_tpu.parallel import train_step as JT
    from nnstreamer_tpu_torch.llm import DecodeEngine, KVCachePool
    from nnstreamer_tpu_torch.models.streamformer_lm import params_from_jax
    from nnstreamer_tpu_torch.parallel import train_step as TT

    jc = JT.StreamFormerConfig(**SIZES, dtype=jnp.float32)
    tc = TT.StreamFormerConfig(**SIZES, dtype=torch.float32)
    jp = JT.init_params(jc, 5)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                         device="cpu")
    jwarm, jmark, jafter = _engine_run(JaxEngine, JaxPool, jc, jp,
                                       jax_ledger)

    def port_pool(cfg, slots):
        return KVCachePool(cfg, slots, device="cpu")

    twarm, tmark, tafter = _engine_run(DecodeEngine, port_pool, tc, tp,
                                       torch_ledger)
    assert twarm == jwarm
    # steps at 1 and 2 lanes, prefills at 8 and 16 tokens
    assert tmark == {"llm.engine.step": 2, "llm.engine.prefill": 2}
    assert tafter == tmark and jafter == jmark
