"""The ``program_span`` readers against hand-made windows and spans whose
idle under each span, and outside every span, is known: two steps of a
traced window, each a ``trainer.step`` with its stage, replay and loss
read, device operations between them, and set-up spans."""

from __future__ import annotations

import pytest

from benchmark import readers, spans
from benchmark import spec as bench_spec
from benchmark.spans import Spanned

BENCH = bench_spec.Benchmark()
A, B = 1, 2                                   # two threads

#: two steps in [1000, 2000] ns; step 1's stage ends 30 ns before its
#: replay starts
STEPS = [
    Spanned("trainer.step", 1000, 1400, 0, A),
    Spanned("trainer.stage", 1000, 1100, 0, A),
    Spanned("trainer.replay", 1100, 1150, 0, A),
    Spanned("trainer.loss_read", 1150, 1400, 0, A),
    Spanned("trainer.step", 1450, 2000, 1, A),
    Spanned("trainer.stage", 1450, 1570, 1, A),
    Spanned("trainer.replay", 1600, 1650, 1, A),
    Spanned("trainer.loss_read", 1650, 2000, 1, A),
]
#: a step before the window (no device operation of the window in it)
#: and set-up long before it
EARLIER = [Spanned("trainer.step", 100, 400, -1, A),
           Spanned("trainer.build", 0, 90, -1, A)]
KERNELS = [("h2d", 1080, 40), ("k", 1130, 170), ("k", 1310, 80),
           ("h2d", 1580, 40), ("k", 1630, 270), ("k", 1905, 90)]
BUSY_NS = 40 + 170 + 80 + 40 + 270 + 90
#: idle ns by innermost span: [1000, 1080] and [1450, 1570] staging,
#: [1570, 1580] between step 1's stage and replay, [1400, 1450] between
#: the steps, the rest under replays and loss reads
IDLE = {"trainer.stage": 80 + 120, "trainer.step": 10,
        "trainer.replay": 10 + 10, "trainer.loss_read": 10 + 10 + 5 + 5,
        None: 50}


def _window(kernels=KERNELS, offset=0):
    return {"kernels": [(n, s + offset, d) for n, s, d in kernels],
            "busy_s": BUSY_NS / 1e9, "window_s": 1000 / 1e9}


def _metric(name):
    return bench_spec.load_module(f"{BENCH.base}/metrics/{name}.py")


def test_window_ends_at_the_last_step_and_keeps_its_steps():
    t0, t1, steps = spans.window_bounds(_window(), EARLIER + STEPS)
    assert (t0, t1) == (1000, 2000)
    assert [s.seq for s in steps] == [0, 1]


def test_idle_is_split_by_the_innermost_open_span():
    got = spans.idle_by_span(_window(), EARLIER + STEPS, 1000, 2000)
    assert dict(got) == IDLE
    # the split adds up to the device trace's own idle share
    assert 100.0 * sum(got.values()) / 1000 == pytest.approx(
        readers.idle_pct(_window()))


@pytest.mark.parametrize("name, pct", [("trainer.stage", 20.0),
                                       (None, 5.0),
                                       ("trainer.loss_read", 3.0)])
def test_idle_shares_are_over_the_window(name, pct):
    assert spans.idle_pct(_window(), name, EARLIER + STEPS) == \
        pytest.approx(pct)


def test_a_window_with_no_device_operation_is_all_idle():
    window = dict(_window(), kernels=[("k", 1500, 0)])
    got = spans.idle_by_span(window, STEPS, 1000, 2000)
    assert sum(got.values()) == 1000 and got[None] == 50


def test_stage_time_is_the_mean_over_the_window_steps():
    assert spans.phase_ms_per_step(_window(), "trainer.stage",
                                   EARLIER + STEPS) == pytest.approx(
        (100 + 120) / 2 / 1e6)


def test_setup_spans_less_the_kernel_builds_inside_them():
    setup = [Spanned("trainer.build", 0, 10, -1, A),
             Spanned("trainer.build", 20, 50, -1, A),
             Spanned("trainer.capture", 1000, 2000, -1, A),
             # two builds overlapping inside the capture, one half in it
             Spanned("kernels.build", 1100, 1300, 1, B),
             Spanned("kernels.build", 1200, 1500, 1, A),
             Spanned("kernels.build", 1900, 2200, 2, A)]
    assert spans.setup_s("trainer.build", spans=setup) == \
        pytest.approx(40 / 1e9)
    assert spans.setup_s("trainer.capture", "kernels.build",
                         spans=setup) == pytest.approx(500 / 1e9)
    assert spans.setup_s("trainer.capture", spans=setup) == \
        pytest.approx(1000 / 1e9)


def test_readers_read_the_program_ring_on_the_profiler_clock():
    """The spans recorded in the program's ring on its monotonic clock,
    the device operations on the profiler's: the metric files read the
    same shares."""
    from nnstreamer_tpu_torch.obs.clock import mono_ns, profiler_ns
    from nnstreamer_tpu_torch.obs.span import record

    base = mono_ns() + 10 ** 12               # clear of every real span
    for s in STEPS:
        record(s.name, base + s.start, base + s.end, s.seq)
    window = _window(offset=profiler_ns(base))
    assert _metric("idle_in_stage_pct.train").read(window) == \
        pytest.approx(20.0)
    assert _metric("idle_unspanned_pct.train").read(window) == \
        pytest.approx(5.0)
    assert _metric("trainer_stage_ms_per_step").read(window) == \
        pytest.approx(110 / 1e6)


NEW = ["trainer_stage_ms_per_step", "idle_in_stage_pct.train",
       "idle_unspanned_pct.train", "setup_build_s", "setup_capture_s"]


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_nothing(monkeypatch, name):
    from nnstreamer_tpu_torch.obs import span

    monkeypatch.delattr(span, "PROCESS_SPANS")
    assert _metric(name).read(_window()) is None


def test_the_new_metrics_read_program_spans_in_the_training_cell():
    entries = {m["name"]: m for m in BENCH.doc["per_layer"]}
    for name in NEW:
        assert entries[name]["source"] == "program_span"
        assert entries[name]["workloads"] == ["vit-train-b32"]
