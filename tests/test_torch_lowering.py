"""The port's fuse-xla tier against the JAX package's, on the CPU.

On the CPU a lowered segment runs as one eager call (on the card, one CUDA
graph a signature).  The same launch strings run through both packages
(``PKGS``) and the three tiers:

- outputs byte-equal across the tiers of each package and against the
  JAX package's fuse-xla tier on the transform chains (f32, the uint8
  quant chain, typecast + dimchg), ``direct_video`` and the label
  decoder's indices; the MLP's logits equal across the port's tiers
  byte for byte and the JAX package's within 1e-5 (the two CPU matmuls
  sum in different orders), its labels equal;
- mixed fallback: the plan rows, with the element and the reason text,
  equal to the JAX package's;
- plan lifecycle: caps renegotiation, a model update and a QoS throttle
  rebuild the segment; a tracer attach keeps it warm;
- cross-stream buckets: exact row order, one executable for fills that
  pad alike; ``compiles`` and ``exec_cache_hits`` equal to the JAX rows
  for the same stream;
- the double buffer: ``NNS_FUSE_DEPTH`` 1 and 2, EOS flush, a quiescent
  stream, caps-event order;
- the CLI's ``--fuse`` and ``--no-fuse``.

The port's ``mlp`` loads the JAX model's weights for the same custom
properties (``jax_weights``), so both packages serve one model.  The
segment's CUDA graph is held to the python tier on the card by
``tests/test_torch_cuda.py::test_segment_graph_matches_the_python_tier``.
"""

import importlib
import time
import types

import numpy as np
import pytest
import torch

from nnstreamer_tpu.models import registry as jax_registry
from nnstreamer_tpu_torch.models import registry as port_registry
from nnstreamer_tpu_torch.models.mlp import mlp_params_from_jax

TIERS = ("interpret", "python", "xla")

F32_CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=64,"
            "types=float32,framerate=0/1")
U8_CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=64,"
           "types=uint8,framerate=0/1")
MLP = ("tensor_filter framework=xla model=mlp {accel}"
       "custom=in_dim:64,width:32,depth:1,out_dim:8 name=f")


def _namespace(key: str, root: str, accel: str):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    element = mod("pipeline.element")
    buffer = mod("tensor.buffer")
    return types.SimpleNamespace(
        key=key, accel=accel, parse_launch=mod("pipeline").parse_launch,
        Pipeline=mod("pipeline.graph").Pipeline,
        CapsEvent=element.CapsEvent, CustomEvent=element.CustomEvent,
        QoSEvent=element.QoSEvent, Caps=mod("pipeline.caps").Caps,
        TensorBuffer=buffer.TensorBuffer, XBatchMeta=buffer.XBatchMeta,
        ledger=mod("analysis.compileledger"))


PKGS = {"jax": _namespace("jax", "nnstreamer_tpu", ""),
        "torch": _namespace("torch", "nnstreamer_tpu_torch",
                            "accelerator=true:cpu ")}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


@pytest.fixture(autouse=True)
def jax_weights(monkeypatch):
    """The port's ``mlp`` builder loads the JAX model's weights for the
    same custom properties (seed included); the tiers from the default."""
    port_registry.list_models()          # loads the registry
    build = port_registry._MODELS["mlp"]

    def build_from_jax(custom, device=None):
        model = build(custom, device)
        params = jax_registry.get_model("mlp", dict(custom)).params
        model.module.load_state_dict(mlp_params_from_jax(params))
        return model

    monkeypatch.setitem(port_registry._MODELS, "mlp", build_from_jax)
    monkeypatch.delenv("NNS_FUSE", raising=False)
    monkeypatch.delenv("NNS_FUSE_DEPTH", raising=False)


def _run_tier(pkg, launch, tier, bufs, timeout=120):
    """Run ``launch`` under one tier, feed ``bufs``; returns (output
    buffers, plan rows)."""
    p = pkg.parse_launch(launch.format(accel=pkg.accel),
                         pkg.Pipeline(fuse=tier))
    got = []
    p.get("out").connect("new-data", lambda b: got.append(b))
    p.play()
    src = p.get("in")
    for buf in bufs:
        src.push_buffer(buf)
    src.end_of_stream()
    p.wait(timeout=timeout)
    plans = p.planner.plans() if p.planner is not None else []
    p.stop()
    return got, plans


def _frames(pkg, n, dim=64, dtype=np.float32, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if np.issubdtype(np.dtype(dtype), np.integer):
            arr = rng.integers(0, 200, dim).astype(dtype)
        else:
            arr = rng.standard_normal(dim).astype(dtype)
        out.append(pkg.TensorBuffer(tensors=[arr], pts=i))
    return out


def _host(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _sig(buf):
    arr = _host(buf.tensors[0])
    return arr.dtype.str, arr.shape, arr.tobytes()


def _await(cond, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


GOLDEN = {
    "arithmetic_f32": (
        f"appsrc caps={F32_CAPS} name=in ! tensor_transform "
        "mode=arithmetic option=mul:2.0,add:1.0 ! tensor_sink name=out",
        dict(n=6)),
    # the reference's quantized pre-processing: uint8 through mul/add and
    # a typecast back (operands inside f32-exact range)
    "uint8_quant_chain": (
        f"appsrc caps={U8_CAPS} name=in ! tensor_transform "
        "mode=arithmetic option=mul:0.5,add:3.0,typecast:uint8 ! "
        "tensor_sink name=out", dict(n=6, dtype=np.uint8)),
    "typecast_dimchg": (
        "appsrc caps=other/tensors,format=static,num_tensors=1,"
        "dimensions=4:3,types=uint8,framerate=0/1 name=in ! "
        "tensor_transform mode=typecast option=float32 ! tensor_transform "
        "mode=dimchg option=0:1 ! tensor_sink name=out",
        dict(n=5, dim=(3, 4), dtype=np.uint8)),
    "direct_video": (
        "appsrc caps=other/tensors,format=static,num_tensors=1,"
        "dimensions=3,types=uint8,framerate=0/1 name=in ! capsfilter ! "
        "tensor_decoder mode=direct_video ! tensor_sink name=out",
        dict(n=4, dim=3, dtype=np.uint8)),
    "filter_chain": (
        f"appsrc caps={F32_CAPS} name=in ! tensor_transform "
        f"mode=arithmetic option=mul:0.5 ! {MLP} ! tensor_sink name=out",
        dict(n=5)),
}


class TestGoldenEquivalence:
    @pytest.mark.parametrize("case", sorted(GOLDEN))
    def test_tiers_byte_equal_and_equal_to_jax(self, case):
        launch, spec = GOLDEN[case]
        sigs = {}
        for key, pkg in PKGS.items():
            for tier in TIERS:
                got, plans = _run_tier(pkg, launch, tier,
                                       _frames(pkg, **spec))
                assert [b.pts for b in got] == list(range(spec["n"]))
                sigs[key, tier] = [_sig(b) for b in got]
                if tier == "xla":
                    assert [pl["lowering"] for pl in plans] == ["xla"]
        for key in PKGS:
            assert sigs[key, "python"] == sigs[key, "interpret"]
            assert sigs[key, "xla"] == sigs[key, "interpret"], key
        if case != "filter_chain":
            assert sigs["torch", "xla"] == sigs["jax", "xla"]
            return
        for (dt, shape, a), (dt2, shape2, b) in zip(sigs["torch", "xla"],
                                                    sigs["jax", "xla"]):
            assert (dt, shape) == (dt2, shape2)
            np.testing.assert_allclose(np.frombuffer(a, np.float32),
                                       np.frombuffer(b, np.float32),
                                       rtol=1e-5, atol=1e-5)

    def test_decoder_argmax_labels(self):
        """image_labeling in the segment: the argmax pushed into the
        filter, the label lookup the host finisher; index and label equal
        over both packages and the three tiers."""
        launch = (f"appsrc caps={F32_CAPS} name=in ! {MLP} ! "
                  "tensor_decoder mode=image_labeling ! tensor_sink name=out")
        results = {}
        for key, pkg in PKGS.items():
            for tier in TIERS:
                got, plans = _run_tier(pkg, launch, tier,
                                       _frames(pkg, 8, seed=5))
                results[key, tier] = [(b.extra["index"], b.extra["label"])
                                      for b in got]
                if tier == "xla":
                    assert plans[0]["lowering"] == "xla"
        ref = results["jax", "xla"]
        assert len(ref) == 8 and len(set(ref)) > 1
        assert all(r == ref for r in results.values())


class TestMixedFallback:
    def test_non_lowerable_step_falls_back_named(self):
        """One non-lowerable element demotes the WHOLE segment to
        fuse-python; the plan rows (element and reason) are the JAX
        package's."""
        launch = (f"appsrc caps={F32_CAPS} name=in ! identity ! identity "
                  "sleep-us=1 name=slow ! tensor_transform mode=stand "
                  "name=st ! tensor_transform mode=arithmetic option=add:1.0 "
                  "name=ar ! tensor_sink name=out")
        rows = {}
        for key, pkg in PKGS.items():
            got, plans = _run_tier(pkg, launch, "xla", _frames(pkg, 4))
            assert [b.pts for b in got] == list(range(4))
            (plan,) = plans
            assert plan["lowering"] == "python"
            rows[key] = plan["fallback"]
        assert rows["torch"] == rows["jax"]
        fb = {row["element"]: row["reason"] for row in rows["torch"]}
        assert set(fb) == {"slow", "st"} and "sleep-us" in fb["slow"]
        assert "mode='stand'" in fb["st"]

    def test_console_debug_falls_back_but_silent_lowers(self, pkg):
        got, plans = _run_tier(
            pkg, f"appsrc caps={F32_CAPS} name=in ! tensor_debug "
                 "output=silent ! tensor_sink name=out", "xla",
            _frames(pkg, 3))
        assert len(got) == 3 and plans[0]["lowering"] == "xla"
        got, plans = _run_tier(
            pkg, f"appsrc caps={F32_CAPS} name=in ! tensor_debug "
                 "output=silent capture=true name=dbg ! tensor_sink name=out",
            "xla", _frames(pkg, 3))
        assert len(got) == 3 and plans[0]["lowering"] == "python"
        assert plans[0]["fallback"][0]["element"] == "dbg"


class TestPlanLifecycle:
    def test_caps_renegotiation_rebuilds_executables(self, pkg):
        caps8 = F32_CAPS.replace("dimensions=64", "dimensions=8")
        p = pkg.parse_launch(f"appsrc caps={F32_CAPS} name=in ! "
                             "tensor_transform mode=arithmetic option=mul:3.0 "
                             "! tensor_sink name=out", pkg.Pipeline(fuse="xla"))
        got = []
        p.get("out").connect("new-data", lambda b: got.append(b))
        p.play()
        src = p.get("in")
        for buf in _frames(pkg, 3):
            src.push_buffer(buf)
        assert _await(lambda: p.planner.plans()
                      and p.planner.plans()[0]["lowering"] == "xla")
        epoch0 = p.planner.plans()[0]["epoch"]
        src.push_event(pkg.CapsEvent(pkg.Caps.from_string(caps8)))
        for i in range(3):
            src.push_buffer(pkg.TensorBuffer(
                tensors=[np.full(8, i, np.float32)], pts=10 + i))
        src.end_of_stream()
        p.wait(timeout=60)
        plans = p.planner.plans()
        p.stop()
        assert [_host(b.tensors[0]).shape for b in got] \
            == [(64,)] * 3 + [(8,)] * 3
        for i, b in enumerate(got[3:]):
            np.testing.assert_array_equal(_host(b.tensors[0]),
                                          np.full(8, i * 3.0, np.float32))
        assert plans[0]["epoch"] > epoch0
        assert plans[0]["lowering"] == "xla"
        assert (plans[0]["compiles"], plans[0]["exec_cache_hits"]) == (1, 2)

    def test_model_update_rebuilds_the_segment(self, pkg):
        """tensor_filter_update_model mid-stream: the frames after the
        event are the new model's (a fresh pipeline on it), those before
        the old one's."""
        launch = (f"appsrc caps={F32_CAPS} name=in ! {MLP} "
                  "is-updatable=true ! tensor_sink name=out")
        launch = launch.replace("out_dim:8", "out_dim:8,seed:0")
        frames = _frames(pkg, 4, seed=11)
        p = pkg.parse_launch(launch.format(accel=pkg.accel),
                             pkg.Pipeline(fuse="xla"))
        got = []
        p.get("out").connect("new-data", lambda b: got.append(b))
        p.play()
        src = p.get("in")
        src.push_buffer(frames[0].copy())
        src.push_buffer(frames[1].copy())
        src.push_event(pkg.CustomEvent("tensor_filter_update_model",
                                       {"model": "mlp", "seed": "7"}))
        src.push_buffer(frames[2].copy())
        src.push_buffer(frames[3].copy())
        src.end_of_stream()
        p.wait(timeout=120)
        plans = p.planner.plans()
        p.stop()
        assert len(got) == 4 and plans[0]["lowering"] == "xla"
        ref, _ = _run_tier(pkg, launch.replace("seed:0", "seed:7"), "xla",
                           [f.copy() for f in frames])
        old, _ = _run_tier(pkg, launch, "xla", [f.copy() for f in frames])
        for i in (0, 1):
            assert _sig(got[i]) == _sig(old[i])
        for i in (2, 3):
            assert _sig(got[i]) == _sig(ref[i])
        assert _sig(got[2]) != _sig(old[2])

    def test_tracer_attach_keeps_warm_executables(self, pkg):
        p = pkg.parse_launch(
            f"appsrc caps={F32_CAPS} name=in ! tensor_transform "
            f"mode=arithmetic option=mul:0.5 name=t ! {MLP} ! "
            "tensor_sink name=out".format(accel=pkg.accel),
            pkg.Pipeline(fuse="xla"))
        got = []
        p.get("out").connect("new-data", lambda b: got.append(b))
        p.play()
        src = p.get("in")

        def feed(n, base):
            for buf in _frames(pkg, n, seed=base):
                src.push_buffer(buf)
            assert _await(lambda: len(got) >= base + n - 1)

        feed(6, 0)
        (plan,) = p.planner.plans()
        assert plan["lowering"] == "xla"
        compiles0, epoch0 = plan["compiles"], plan["epoch"]
        tracer = p.enable_tracing(spans=True)
        feed(6, 6)
        (plan,) = p.planner.plans()
        assert plan["compiles"] == compiles0 == 1
        assert plan["epoch"] == epoch0
        src.end_of_stream()
        p.wait(timeout=60)
        report = tracer.report()
        spans = tracer.ring.snapshot()
        p.stop()
        assert len(got) == 12
        assert report["t"]["buffers"] >= 5 and report["f"]["buffers"] >= 5
        assert any(s.name == "state:device-invoke" for s in spans)

    def test_qos_throttle_demotes_then_restores(self, pkg):
        p = pkg.parse_launch(f"appsrc caps={F32_CAPS} name=in ! {MLP} ! "
                             "tensor_sink name=out".format(accel=pkg.accel),
                             pkg.Pipeline(fuse="xla"))
        p.play()
        src = p.get("in")
        for buf in _frames(pkg, 2):
            src.push_buffer(buf)
        assert _await(lambda: p.planner.plans()
                      and p.planner.plans()[0]["lowering"] == "xla")
        p.get("out").sink_pad.push_upstream_event(
            pkg.QoSEvent(timestamp=0, jitter_ns=50_000_000, proportion=2.0))
        assert p.get("f")._throttle_ns > 0
        for buf in _frames(pkg, 2, seed=9):
            src.push_buffer(buf)
        src.end_of_stream()
        p.wait(timeout=60)
        plans = p.planner.plans()
        p.stop()
        assert plans[0]["lowering"] == "python"
        assert [row["reason"] for row in plans[0]["fallback"]] \
            == ["QoS throttling active: per-buffer drop state is host-side"]


def _bucket(pkg, rows, capacity, pts=0):
    buf = pkg.TensorBuffer(tensors=[rows], pts=pts)
    buf.extra["nns_xbatch"] = pkg.XBatchMeta(
        [{"cid": i} for i in range(rows.shape[0])],
        [pts] * rows.shape[0], capacity)
    return buf


STACKED = (f"appsrc caps={F32_CAPS} name=in ! tensor_transform "
           f"mode=arithmetic option=mul:2.0 ! {MLP} ! tensor_sink name=out")


class TestStackedBuckets:
    def test_full_bucket_exact_row_order(self, pkg):
        rows = np.random.default_rng(21).standard_normal(
            (8, 64)).astype(np.float32)
        got, plans = _run_tier(pkg, STACKED, "xla",
                               [_bucket(pkg, rows.copy(), 8)])
        ref, _ = _run_tier(pkg, STACKED, "python",
                           [_bucket(pkg, rows.copy(), 8)])
        solo, _ = _run_tier(pkg, STACKED, "xla",
                            [pkg.TensorBuffer(tensors=[rows[i]], pts=i)
                             for i in range(8)])
        out = _host(got[0].tensors[0])
        np.testing.assert_allclose(out, _host(ref[0].tensors[0]),
                                   rtol=1e-5, atol=1e-6)
        for i in range(8):      # row i is f(input row i)
            np.testing.assert_allclose(out[i], _host(solo[i].tensors[0]),
                                       rtol=1e-4, atol=1e-5)
        assert plans[0]["lowering"] == "xla"
        assert got[0].extra["nns_xbatch"].n == 8

    def test_partial_buckets_share_one_executable(self, pkg):
        """5 and 6 live rows both pad to 8 (pad_rows): one executable, the
        second bucket a hit; live rows equal the python tier's."""
        rng = np.random.default_rng(22)
        rows5 = rng.standard_normal((5, 64)).astype(np.float32)
        rows6 = rng.standard_normal((6, 64)).astype(np.float32)
        got, plans = _run_tier(pkg, STACKED, "xla",
                               [_bucket(pkg, rows5, 8, pts=0),
                                _bucket(pkg, rows6, 8, pts=1)])
        ref, _ = _run_tier(pkg, STACKED, "python",
                           [_bucket(pkg, rows5.copy(), 8)])
        np.testing.assert_allclose(_host(got[0].tensors[0])[:5],
                                   _host(ref[0].tensors[0])[:5],
                                   rtol=1e-5, atol=1e-6)
        assert _host(got[0].tensors[0]).shape == (8, 8)
        (plan,) = plans
        assert (plan["compiles"], plan["exec_cache_hits"]) == (1, 1)

    def test_post_finisher_bucket_runs_the_python_tier(self, pkg):
        """The reference's one named escape: a bucket whose tail carries
        a host post-finisher (the label lookup) runs fuse-python: it
        builds no executable, while the solo frame before it did."""
        launch = (f"appsrc caps={F32_CAPS} name=in ! {MLP} ! "
                  "tensor_decoder mode=image_labeling ! tensor_sink name=out")
        rows = np.random.default_rng(23).standard_normal(
            (4, 64)).astype(np.float32)
        got, plans = _run_tier(pkg, launch, "xla",
                               [pkg.TensorBuffer(tensors=[rows[0]], pts=0),
                                _bucket(pkg, rows.copy(), 4, pts=1)])
        assert len(got) == 2 and plans[0]["lowering"] == "xla"
        assert (plans[0]["dispatches"], plans[0]["compiles"],
                plans[0]["exec_cache_hits"]) == (2, 1, 0)
        solo, _ = _run_tier(pkg, launch, "python",
                            [pkg.TensorBuffer(tensors=[rows[0]], pts=0)])
        assert got[0].extra["index"] == solo[0].extra["index"]


def test_compiles_and_hits_equal_the_jax_rows():
    """One stream (frames, two buckets padding alike, a frame) gives the
    same plan counters, and the same compile-ledger events at
    ``pipeline.segment``, in both packages."""
    rows = {}
    ledgers = {}
    for key, pkg in PKGS.items():
        was = pkg.ledger.ENABLED
        pkg.ledger.configure(True)
        pkg.ledger.reset()
        try:
            rng = np.random.default_rng(31)
            bufs = _frames(pkg, 2) + [
                _bucket(pkg, rng.standard_normal((5, 64)).astype(
                    np.float32), 8, pts=2),
                _bucket(pkg, rng.standard_normal((7, 64)).astype(
                    np.float32), 8, pts=3)] + _frames(pkg, 1, seed=4)
            _, plans = _run_tier(pkg, STACKED, "xla", bufs)
            ledgers[key] = [(e.site, e.signature) for e in pkg.ledger.events()
                            if e.site == "pipeline.segment"]
        finally:
            pkg.ledger.configure(was)
            pkg.ledger.reset()
        (plan,) = plans
        rows[key] = (plan["compiles"], plan["exec_cache_hits"],
                     plan["dispatches"])
    assert rows["torch"] == rows["jax"] == (2, 3, 5)
    assert ledgers["torch"] == ledgers["jax"]


class TestDoubleBuffering:
    @pytest.mark.parametrize("depth", ["1", "2"])
    def test_depth_env_and_eos_flush(self, pkg, depth, monkeypatch):
        monkeypatch.setenv("NNS_FUSE_DEPTH", depth)
        got, plans = _run_tier(
            pkg, f"appsrc caps={F32_CAPS} name=in ! tensor_transform "
                 "mode=arithmetic option=add:1.0 ! tensor_sink name=out",
            "xla", _frames(pkg, 7))
        assert [b.pts for b in got] == list(range(7))
        assert plans[0]["lowering"] == "xla"

    def test_held_frames_keep_their_own_outputs(self, pkg):
        """Frames held in the slot are not overwritten by the next
        dispatch: every output equals its own input plus one."""
        frames = _frames(pkg, 9)
        want = [_host(f.tensors[0]) + np.float32(1.0) for f in frames]
        got, _ = _run_tier(
            pkg, f"appsrc caps={F32_CAPS} name=in ! tensor_transform "
                 "mode=arithmetic option=add:1.0 ! tensor_sink name=out",
            "xla", frames)
        for b, w in zip(got, want):
            np.testing.assert_array_equal(_host(b.tensors[0]), w)

    def test_single_buffer_flushes_on_eos(self, pkg):
        got, _ = _run_tier(
            pkg, f"appsrc caps={F32_CAPS} name=in ! tensor_transform "
                 "mode=arithmetic option=add:1.0 ! tensor_sink name=out",
            "xla", _frames(pkg, 1))
        assert len(got) == 1

    def test_quiescent_stream_never_strands_a_frame(self, pkg):
        p = pkg.parse_launch(
            f"appsrc caps={F32_CAPS} name=in ! tensor_transform "
            "mode=arithmetic option=add:1.0 ! tensor_sink name=out",
            pkg.Pipeline(fuse="xla"))
        got = []
        p.get("out").connect("new-data", lambda b: got.append(b))
        p.play()
        src = p.get("in")
        try:
            for i in range(3):      # one request at a time, stream open
                src.push_buffer(pkg.TensorBuffer(
                    tensors=[np.full(64, i, np.float32)], pts=i))
                assert _await(lambda: len(got) == i + 1, 10.0), \
                    f"reply {i} stranded in the held slot"
        finally:
            src.end_of_stream()
            p.wait(timeout=30)
            p.stop()
        assert [b.pts for b in got] == [0, 1, 2]

    def test_caps_event_flushes_held_frame_in_order(self, pkg):
        caps8 = F32_CAPS.replace("dimensions=64", "dimensions=8")
        p = pkg.parse_launch(
            f"appsrc caps={F32_CAPS} name=in ! tensor_transform "
            "mode=arithmetic option=add:0.0 ! tensor_sink name=out",
            pkg.Pipeline(fuse="xla"))
        got = []
        p.get("out").connect("new-data", lambda b: got.append(b))
        p.play()
        src = p.get("in")
        for buf in _frames(pkg, 3):
            src.push_buffer(buf)
        src.push_event(pkg.CapsEvent(pkg.Caps.from_string(caps8)))
        src.push_buffer(pkg.TensorBuffer(
            tensors=[np.zeros(8, np.float32)], pts=3))
        src.end_of_stream()
        p.wait(timeout=60)
        p.stop()
        assert [b.pts for b in got] == [0, 1, 2, 3]
        assert [_host(b.tensors[0]).shape for b in got] \
            == [(64,)] * 3 + [(8,)]


@pytest.mark.parametrize("flags,tier", [(["--fuse", "interpret"], "interpret"),
                                        (["--fuse", "python"], "python"),
                                        (["--fuse", "xla"], "xla"),
                                        (["--no-fuse"], "interpret")],
                         ids=["interpret", "python", "xla", "no-fuse"])
def test_cli_fuse_sets_the_tier(flags, tier, monkeypatch, capsys):
    """``--fuse``/``--no-fuse`` run the launch string under the tier, as
    the JAX CLI's do (through ``NNS_FUSE``)."""
    import signal

    from nnstreamer_tpu_torch import launch
    from nnstreamer_tpu_torch.pipeline.graph import Pipeline

    monkeypatch.setenv("NNS_FUSE", "1")     # restored after the test
    # the CLI installs its SIGTERM drain handler: restore the runner's
    monkeypatch.setattr(signal, "signal", lambda *a: None)
    seen = []
    play = Pipeline.play

    def spy(self):
        seen.append(self.fuse_tier)
        return play(self)

    monkeypatch.setattr(Pipeline, "play", spy)
    rc = launch.main([*flags, "videotestsrc num-buffers=3 ! "
                      "video/x-raw,format=RGB,width=8,height=8,"
                      "framerate=30/1 ! tensor_converter ! "
                      "tensor_sink name=out", "--print-sink", "out",
                      "--timeout", "60"])
    assert rc == 0
    assert seen == [tier]
    assert capsys.readouterr().out.count("pts=") == 3
