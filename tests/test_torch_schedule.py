"""The port's segment compiler against the JAX package's, on the CPU.

The same launch strings run through both packages (``PKGS``): tier
resolution and ``NNS_FUSE``, linear fusion, queue / tee / request-pad
boundaries, EOS order, errors posted from fused steps, traced counters
equal to interpreted dispatch, plan rebuilds on renegotiation and on a
link after play, ``stop()`` restoring interpreted dispatch, and the
``plans()`` rows (heads, fused elements, tails) equal between the
packages.  Every wait is bounded.
"""

import importlib
import time
import types

import numpy as np
import pytest

CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
         "types=float32,framerate=0/1")
CAPS8 = ("other/tensors,format=static,num_tensors=1,dimensions=8,"
         "types=float32,framerate=0/1")
#: an MLP of 4 features (both packages' registry model), on the CPU
MLP4 = ("tensor_filter framework=xla model=mlp {accel}"
        "custom=in_dim:4,width:8,depth:1,out_dim:4,seed:1 name=f")


def _namespace(key: str, root: str, accel: str):
    """One package's pipeline surface, by the same names."""

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    graph = mod("pipeline.graph")
    element = mod("pipeline.element")
    return types.SimpleNamespace(
        key=key, accel=accel, parse_launch=mod("pipeline").parse_launch,
        Pipeline=graph.Pipeline, PipelineError=graph.PipelineError,
        CapsEvent=element.CapsEvent, Caps=mod("pipeline.caps").Caps,
        TensorBuffer=mod("tensor.buffer").TensorBuffer,
        TensorSink=mod("elements").TensorSink,
        Identity=mod("elements.misc").Identity,
        schedule=mod("pipeline.schedule"))


PKGS = {"jax": _namespace("jax", "nnstreamer_tpu", ""),
        "torch": _namespace("torch", "nnstreamer_tpu_torch",
                            "accelerator=true:cpu ")}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def default_tier(monkeypatch):
    """Each test starts from the packages' default tier."""
    monkeypatch.delenv("NNS_FUSE", raising=False)
    monkeypatch.delenv("NNS_FUSE_DEPTH", raising=False)


def _feed(pkg, src, n, dim=4, first=0):
    for i in range(first, first + n):
        src.push_buffer(pkg.TensorBuffer(
            tensors=[np.full(dim, i, np.float32)], pts=i))


def _collector(p, name="out"):
    got = []
    p.get(name).connect("new-data", lambda b: got.append(b))
    return got


def _await(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


def _run(pkg, launch, n, fuse=None, dim=4):
    """Play ``launch`` (appsrc ``in`` → sink ``out``), feed ``n``
    frames, EOS; returns (pts arrived, plan rows)."""
    p = pkg.parse_launch(launch, pkg.Pipeline(fuse=fuse))
    got = _collector(p)
    p.play()
    _feed(pkg, p.get("in"), n, dim)
    p.get("in").end_of_stream()
    p.wait(timeout=60)
    plans = p.planner.plans() if p.planner is not None else []
    p.stop()
    return [b.pts for b in got], plans


def _rows(plans):
    """Plan rows without the counters that depend on timing."""
    keep = ("head", "elements", "tail", "lowering", "fallback")
    return sorted(({k: row[k] for k in keep if k in row} for row in plans),
                  key=lambda r: r["head"])


class TestTiers:
    def test_resolve_tier_values(self, pkg):
        rt = pkg.schedule.resolve_tier
        assert pkg.schedule.FUSE_TIERS == ("interpret", "python", "xla")
        assert rt(False) == "interpret" and rt(True) == "python"
        assert rt("0") == "interpret" and rt("fuse-python") == "python"
        assert rt("xla") == "xla" and rt("fuse-xla") == "xla"
        with pytest.raises(ValueError):
            rt("turbo")

    def test_default_is_python_and_env_sets_it(self, pkg, monkeypatch):
        assert pkg.Pipeline().fuse_tier == "python"
        monkeypatch.setenv("NNS_FUSE", "xla")
        assert pkg.Pipeline().fuse_tier == "xla"
        monkeypatch.setenv("NNS_FUSE", "0")
        p = pkg.Pipeline()
        assert p.fuse_tier == "interpret" and not p.fuse
        assert pkg.Pipeline(fuse="xla").fuse_tier == "xla"

    def test_default_pipeline_installs_a_planner(self, pkg):
        p = pkg.parse_launch(f"appsrc caps={CAPS4} name=in ! identity ! "
                             "tensor_sink name=out")
        got = _collector(p)
        p.play()
        assert p.planner is not None and p.planner.tier == "python"
        _feed(pkg, p.get("in"), 3)
        p.get("in").end_of_stream()
        p.wait(timeout=30)
        p.stop()
        assert [b.pts for b in got] == [0, 1, 2]

    def test_interpret_installs_no_planner(self, pkg):
        pts, plans = _run(pkg, f"appsrc caps={CAPS4} name=in ! identity ! "
                               "tensor_sink name=out", 4, fuse="interpret")
        assert pts == list(range(4)) and plans == []


class TestSegmentFusion:
    def test_linear_chain_fuses_and_flows(self, pkg):
        pts, plans = _run(pkg, f"appsrc caps={CAPS4} name=in ! identity "
                               "name=a ! identity name=b ! identity name=c "
                               "! tensor_sink name=out", 10)
        assert pts == list(range(10))
        assert _rows(plans) == [{"head": "in.src",
                                 "elements": ["a", "b", "c"],
                                 "tail": "out", "lowering": "python"}]

    def test_queue_is_a_segment_boundary(self, pkg):
        pts, plans = _run(pkg, f"appsrc caps={CAPS4} name=in ! identity "
                               "name=a ! identity name=b ! queue name=q ! "
                               "identity name=c ! identity name=d ! "
                               "tensor_sink name=out", 16)
        assert pts == list(range(16))
        assert _rows(plans) == [
            {"head": "in.src", "elements": ["a", "b"], "tail": "q",
             "lowering": "python"},
            {"head": "q.src", "elements": ["c", "d"], "tail": "out",
             "lowering": "python"}]

    def test_tee_branches_head_their_own_segments(self, pkg):
        p = pkg.parse_launch(
            f"appsrc caps={CAPS4} name=in ! identity name=i ! tee name=t "
            "t. ! identity name=ia ! tensor_sink name=a "
            "t. ! identity name=ib1 ! identity name=ib2 ! "
            "tensor_sink name=b")
        got_a, got_b = _collector(p, "a"), _collector(p, "b")
        p.play()
        _feed(pkg, p.get("in"), 8)
        p.get("in").end_of_stream()
        p.wait(timeout=30)
        plans = _rows(p.planner.plans())
        p.stop()
        assert [b.pts for b in got_a] == list(range(8))
        assert [b.pts for b in got_b] == list(range(8))
        assert plans == [
            {"head": "in.src", "elements": ["i"], "tail": "t",
             "lowering": "python"},
            {"head": "t.src_0", "elements": ["ia"], "tail": "a",
             "lowering": "python"},
            {"head": "t.src_1", "elements": ["ib1", "ib2"], "tail": "b",
             "lowering": "python"}]

    def test_tee_last_branch_gets_the_original_wrapper(self, pkg):
        p = pkg.parse_launch(f"appsrc caps={CAPS4} name=in ! tee name=t "
                             "t. ! tensor_sink name=a t. ! tensor_sink name=b")
        p.play()
        buf = pkg.TensorBuffer(tensors=[np.zeros(4, np.float32)], pts=0)
        p.get("in").push_buffer(buf)
        p.get("in").end_of_stream()
        p.wait(timeout=30)
        a, b = p.get("a").results, p.get("b").results
        p.stop()
        assert b[0] is buf and a[0] is not buf
        assert a[0].tensors[0] is buf.tensors[0]

    def test_filter_fuses_on_the_per_frame_path(self, pkg):
        launch = (f"appsrc caps={CAPS4} name=in ! identity name=i ! "
                  f"{MLP4.format(accel=pkg.accel)} ! identity name=j ! "
                  "tensor_sink name=out")
        pts, plans = _run(pkg, launch, 6)
        assert pts == list(range(6))
        assert _rows(plans) == [{"head": "in.src",
                                 "elements": ["i", "f", "j"],
                                 "tail": "out", "lowering": "python"}]

    def test_batching_filter_is_a_boundary(self, pkg):
        launch = (f"appsrc caps={CAPS4} name=in ! identity name=i ! "
                  f"{MLP4.format(accel=pkg.accel)} batch=2 ! identity "
                  "name=j ! tensor_sink name=out")
        pts, plans = _run(pkg, launch, 6)
        assert pts == list(range(6))
        assert _rows(plans) == [
            {"head": "f.src", "elements": ["j"], "tail": "out",
             "lowering": "python"},
            {"head": "in.src", "elements": ["i"], "tail": "f",
             "lowering": "python"}]

    def test_eos_ordering_through_fused_segments(self, pkg):
        p = pkg.parse_launch(f"appsrc caps={CAPS4} name=in ! identity ! "
                             "identity ! queue ! identity ! "
                             "tensor_sink name=out")
        sink = p.get("out")
        seen_at_eos = []
        orig = sink.post_eos_reached

        def probe():
            seen_at_eos.append(len(sink.results))
            orig()

        sink.post_eos_reached = probe
        p.play()
        _feed(pkg, p.get("in"), 25)
        p.get("in").end_of_stream()
        p.wait(timeout=30)
        p.stop()
        assert seen_at_eos == [25]
        assert [b.pts for b in sink.results] == list(range(25))

    def test_error_in_fused_step_posts_pipeline_error(self, pkg):
        """A buffer the filter refuses (two tensors where one was
        negotiated) fails inside the fused step: the pipeline error names
        the filter in both fused tiers (the python tier's per-buffer
        validation says why; the xla tier's forward refuses the extra
        input)."""
        for tier in ("python", "xla"):
            p = pkg.parse_launch(
                f"appsrc caps={CAPS4} name=in ! identity ! "
                f"{MLP4.format(accel=pkg.accel)} ! tensor_sink name=out",
                pkg.Pipeline(fuse=tier))
            p.play()
            p.get("in").push_buffer(pkg.TensorBuffer(
                tensors=[np.zeros(4, np.float32)] * 2, pts=0))
            with pytest.raises(pkg.PipelineError) as ei:
                p.wait(timeout=30)
            p.stop()
            assert ei.value.element.name == "f"
            if tier == "python":
                assert "negotiated 1" in str(ei.value.cause)

    @pytest.mark.parametrize("tier", ["python", "xla"])
    def test_traced_counters_equal_interpreted(self, pkg, tier):
        reports = {}
        for fuse in (tier, "interpret"):
            p = pkg.parse_launch(
                f"appsrc caps={CAPS4} name=in ! identity name=i1 ! "
                "identity name=i2 ! tensor_sink name=out",
                pkg.Pipeline(fuse=fuse))
            tracer = p.enable_tracing()
            p.play()
            _feed(pkg, p.get("in"), 12)
            p.get("in").end_of_stream()
            p.wait(timeout=30)
            p.stop()
            reports[fuse] = tracer.report()
        for name in ("i1", "i2", "out"):
            assert reports[tier][name]["buffers"] == 12
            assert reports[tier][name]["buffers"] == \
                reports["interpret"][name]["buffers"]
            assert reports[tier][name]["proctime_ms"] >= 0


class TestPlanLifecycle:
    def test_renegotiation_invalidates_and_rebuilds(self, pkg):
        p = pkg.parse_launch(f"appsrc caps={CAPS4} name=in ! identity ! "
                             "identity ! tensor_sink name=out")
        got = _collector(p)
        p.play()
        src = p.get("in")
        _feed(pkg, src, 3)
        assert _await(lambda: bool(p.planner.plans()))
        epoch_before = p.planner.plans()[0]["epoch"]
        src.push_event(pkg.CapsEvent(pkg.Caps.from_string(CAPS8)))
        _feed(pkg, src, 3, dim=8, first=3)
        src.end_of_stream()
        p.wait(timeout=30)
        epoch_after = max(pl["epoch"] for pl in p.planner.plans())
        p.stop()
        assert [b.tensors[0].shape for b in got] == [(4,)] * 3 + [(8,)] * 3
        assert epoch_after > epoch_before

    def test_request_pad_link_after_play_rescans(self, pkg):
        p = pkg.parse_launch(f"appsrc caps={CAPS4} name=in ! identity ! "
                             "tee name=t t. ! identity ! tensor_sink name=a")
        got_a = _collector(p, "a")
        p.play()
        src = p.get("in")
        _feed(pkg, src, 3)
        assert _await(lambda: len(got_a) == 3)
        epoch0 = p.planner.epoch
        ident, sink_b = p.add(pkg.Identity("ib"), pkg.TensorSink("b"))
        ident.start()
        sink_b.start()
        ident._started = sink_b._started = True
        p.link(p.get("t"), ident, sink_b)
        assert p.planner.epoch > epoch0     # the link rescanned
        _feed(pkg, src, 3, first=3)
        src.end_of_stream()
        p.wait(timeout=30)
        heads = [pl["head"] for pl in p.planner.plans()]
        p.stop()
        assert [b.pts for b in got_a] == list(range(6))
        assert [b.pts for b in sink_b.results] == [3, 4, 5]
        assert len([h for h in heads if h.startswith("t.")]) == 2

    @pytest.mark.parametrize("tier", ["python", "xla"])
    def test_stop_restores_interpreted_dispatch(self, pkg, tier):
        p = pkg.parse_launch(f"appsrc caps={CAPS4} name=in ! identity ! "
                             "tensor_sink name=out", pkg.Pipeline(fuse=tier))
        p.play()
        _feed(pkg, p.get("in"), 2)
        p.get("in").end_of_stream()
        p.wait(timeout=30)
        pads = [pad for el in p.elements for pad in el.src_pads]
        assert any("push" in pad.__dict__ for pad in pads)
        p.stop()
        assert p.planner is None
        assert all("push" not in pad.__dict__
                   and "push_event" not in pad.__dict__ for pad in pads)


@pytest.mark.parametrize("tier", ["python", "xla"])
@pytest.mark.parametrize("launch", [
    f"appsrc caps={CAPS4} name=in ! identity name=a ! queue name=q ! "
    "tensor_transform mode=arithmetic option=add:1.0 name=t ! "
    "tensor_debug output=silent name=d ! tensor_sink name=out",
    f"appsrc caps={CAPS4} name=in ! capsfilter name=c ! "
    "tensor_transform mode=stand name=s ! identity sleep-us=1 name=z ! "
    "tensor_sink name=out",
    f"appsrc caps={CAPS4} name=in ! {MLP4} ! tensor_decoder "
    "mode=image_labeling name=dec ! tensor_sink name=out",
    f"appsrc caps={CAPS4} name=in ! tensor_debug output=console name=d ! "
    f"tee name=t t. ! {MLP4} ! tensor_sink name=out "
    "t. ! tensor_transform mode=typecast option=int32 name=tc ! "
    "fakesink name=fk",
], ids=["queue_debug", "fallback_reasons", "filter_decoder", "tee_branches"])
def test_same_plans_in_both_packages(launch, tier, capsys):
    """One launch string gives the same plan rows in both packages:
    heads, fused elements, tails, tier and fallback reasons."""
    rows = {}
    for key, pkg in PKGS.items():
        p = pkg.parse_launch(launch.format(accel=pkg.accel),
                             pkg.Pipeline(fuse=tier))
        p.play()
        _feed(pkg, p.get("in"), 3)
        p.get("in").end_of_stream()
        p.wait(timeout=60)
        rows[key] = _rows(p.planner.plans())
        p.stop()
    capsys.readouterr()         # tensor_debug output=console prints
    assert rows["torch"] == rows["jax"]
    assert rows["torch"]
