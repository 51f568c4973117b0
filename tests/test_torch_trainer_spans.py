"""The trainer's program spans on the CPU (obs/span.py): each training
step of a ``tensor_trainer`` pipeline records ``trainer.step`` with its
``trainer.stage``, ``trainer.replay`` and ``trainer.loss_read`` while
``torch.profiler`` runs or a span-recording tracer is attached, and
nothing a step otherwise; ``trainer.build`` is recorded once a trainer,
always; ``obs.clock.profiler_ns`` puts the spans on the profiler's
clock.  The card's half (a span around a kernel against the kernel's
device interval) is in ``tests/test_torch_cuda.py``."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch._cuda import GraphedStep
from nnstreamer_tpu_torch.obs.clock import mono_ns, profiler_ns
from nnstreamer_tpu_torch.obs.span import PROCESS_SPANS
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

STEP_CHILDREN = ("trainer.stage", "trainer.replay", "trainer.loss_read")

#: framework -> (custom props, caps, frames(rng)), each frame one sample
#: (the MLP's batches are ``batch-size`` = 2 samples)
FRAMEWORKS = {
    "mesh-vision": (
        "model:vit,input_size:16,patch:8,dim:16,depth:1,heads:2,"
        "num_classes:4,dtype:float32,attn:naive,device:cpu",
        "dimensions=3:16:16:4.4,types=uint8.int32",
        lambda rng: (rng.integers(0, 256, (4, 16, 16, 3), dtype=np.uint8),
                     rng.integers(0, 4, 4).astype(np.int32))),
    "mesh": (
        "dp:1,sp:1,tp:1,ep:1,vocab:32,dim:16,heads:4,head_dim:4,mlp:32,"
        "layers:1,experts:1,max_seq:8,device:cpu",
        "dimensions=8:2.8:2,types=int32.int32",
        lambda rng: (rng.integers(0, 32, (2, 8)).astype(np.int32),
                     rng.integers(0, 32, (2, 8)).astype(np.int32))),
    "jax": (
        "hidden:8,device:cpu",
        "dimensions=8.4,types=float32.float32",
        lambda rng: (rng.standard_normal(8).astype(np.float32),
                     np.eye(4, dtype=np.float32)[rng.integers(0, 4)])),
}
#: frames pushed and epochs run: steps = EPOCHS x frames (MLP: / 2)
FRAMES, EPOCHS = 4, 2


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _train(framework="mesh-vision", spans=False):
    """Run a tiny trainer pipeline; (its trainer, its tracer, the program
    spans the run recorded)."""
    custom, dims, make = FRAMEWORKS[framework]
    p = parse_launch(
        "appsrc name=src caps=other/tensors,format=static,num_tensors=2,"
        f"{dims},framerate=0/1 ! tensor_trainer name=tr "
        f"framework={framework} num-epochs={EPOCHS} batch-size=2 "
        f"custom={custom} ! tensor_sink name=out collect=false")
    tracer = p.enable_tracing(spans=True) if spans else None
    _, cursor = PROCESS_SPANS.snapshot_since(0)
    rng = np.random.default_rng(0)
    p.play()
    try:
        for i in range(FRAMES):
            p.get("src").push_buffer(TensorBuffer(tensors=list(make(rng)),
                                                  pts=i))
        p.get("src").end_of_stream()
        p.wait(timeout=300)
    finally:
        p.stop()
    return p.get("tr").trainer, tracer, PROCESS_SPANS.snapshot_since(
        cursor)[0]


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _inside(child, parent) -> bool:
    return (child.tid == parent.tid and child.start_ns >= parent.start_ns
            and child.start_ns + child.dur_ns
            <= parent.start_ns + parent.dur_ns)


@pytest.mark.parametrize("framework", list(FRAMEWORKS))
def test_profiled_steps_record_a_step_span_with_three_children(framework):
    with profile(activities=[ProfilerActivity.CPU]):
        trainer, _, spans = _train(framework)
    steps = _named(spans, "trainer.step")
    assert len(steps) == len(trainer.losses) > 0
    assert [s.seq for s in steps] == list(range(len(steps)))
    for step in steps:
        kids = sorted((s for s in spans if s is not step
                       and _inside(s, step)), key=lambda s: s.start_ns)
        assert [k.name for k in kids] == list(STEP_CHILDREN)
        assert all(k.seq == step.seq for k in kids)
        for a, b in zip(kids, kids[1:]):
            assert a.start_ns + a.dur_ns <= b.start_ns
    assert len(_named(spans, "trainer.build")) == 1


def test_untraced_steps_record_no_step_span_and_build_once():
    trainer, _, spans = _train()
    assert len(trainer.losses) == EPOCHS * FRAMES
    assert not any(s.name.startswith("trainer.") and s.name
                   != "trainer.build" for s in spans)
    (build,) = _named(spans, "trainer.build")
    assert build.dur_ns > 0 and build.seq == -1


def test_span_tracer_puts_the_steps_into_its_chrome_trace():
    trainer, tracer, spans = _train(spans=True)
    assert len(_named(spans, "trainer.step")) == len(trainer.losses)
    doc = tracer.chrome_trace()
    program = [e for e in doc["traceEvents"] if e.get("cat") == "program"]
    names = [e["name"] for e in program]
    assert names.count("trainer.step") == len(trainer.losses)
    assert names.count("trainer.build") == 1
    for name in STEP_CHILDREN:
        assert names.count(name) == len(trainer.losses)
    # the pipeline's own element spans are there beside them
    assert any(e.get("cat") == "element" for e in doc["traceEvents"])
    assert doc["metadata"]["profiler_ns_offset"] == profiler_ns(0)


def test_a_step_called_without_its_number_records_no_phase():
    w = torch.zeros(3)
    step = GraphedStep(lambda x: (w.add_(x)).sum(), "cpu")
    _, cursor = PROCESS_SPANS.snapshot_since(0)
    step(np.ones(3, np.float32))
    assert PROCESS_SPANS.snapshot_since(cursor)[0] == []
    step(np.ones(3, np.float32), seq=7)
    spans = PROCESS_SPANS.snapshot_since(cursor)[0]
    assert [(s.name, s.seq) for s in spans] == [("trainer.stage", 7),
                                                ("trainer.replay", 7)]
    assert float(w[0]) == 2.0


def test_profiler_clock_places_a_span_around_the_op_it_timed():
    """A span around a CPU matmul, mapped by ``profiler_ns``, holds the
    profiler's event of that matmul (Kineto's clock is the wall clock)."""
    x = torch.randn(256, 256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = mono_ns()
        torch.mm(x, x)
        t1 = mono_ns()
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    assert profiler_ns(t0) <= mm.start_ns()
    assert mm.start_ns() + mm.duration_ns() <= profiler_ns(t1)
    # and the mapping is the wall clock's, to well under a millisecond
    assert abs(profiler_ns(mono_ns()) - time.time_ns()) < 1_000_000
