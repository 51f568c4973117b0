"""The port's static verifier (``analysis/verify.py``), its ``static_check``
hooks, ``--check`` and the fleet config against the JAX package's.

The same good and broken launch strings go through both packages'
verifiers and must give the same findings: severity, rule and element
path everywhere (a generated capsfilter name is masked: the two
packages number their elements differently), and the same message where
the hook's text is the JAX package's (caps messages print caps fields
in set order, so they are compared by rule and path).  ``--check`` gives
the same exit codes on the same strings and on the same fleet.json
files, and the port's ``play()`` runs the same preflight.
"""

import io
import json
import re

import pytest

from nnstreamer_tpu import launch as jax_launch
from nnstreamer_tpu import parse_launch as jax_parse_launch
from nnstreamer_tpu.analysis import verify as jax_verify
from nnstreamer_tpu.fleet import config as jax_fleet
from nnstreamer_tpu.pipeline import element as jax_element
from nnstreamer_tpu.pipeline.graph import Pipeline as JaxPipeline
from nnstreamer_tpu_torch import launch, parse_launch
from nnstreamer_tpu_torch.analysis import verify
from nnstreamer_tpu_torch.fleet import config as fleet
from nnstreamer_tpu_torch.pipeline import PipelineError, element
from nnstreamer_tpu_torch.pipeline.graph import Pipeline, VerifyError

CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
         "types=float32,framerate=0/1")
LLM_CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=67,"
            "types=int32,framerate=0/1")
LM = "vocab:64,dim:32,heads:2,head_dim:16,mlp:64,layers:2,experts:2"
VIDEO = ("videotestsrc name=v num-buffers=1 ! video/x-raw,format=RGB,"
         "width=8,height=8,framerate=30/1 ! tensor_converter name=c")
FILTER = (f"appsrc caps={CAPS4} name=in ! tensor_filter name=f "
          "framework=xla model=mlp {opts} ! tensor_sink name=out")
LLM = (f"appsrc caps={LLM_CAPS} name=in ! tensor_llm name=llm {{opts}} ! "
       "tensor_sink name=out")
SERVER = ("tensor_query_serversrc name=qs id=1 port=0 caps=" + CAPS4
          + " {opts} ! tensor_query_serversink name=qk id=1")

STRINGS = {
    "good": VIDEO + " ! queue name=q ! tensor_sink name=out",
    "caps_dead_end": ("videotestsrc name=v num-buffers=1 ! audio/x-raw ! "
                      "tensor_sink name=out"),
    "caps_dead_end_mid": VIDEO + " ! video/x-raw ! tensor_sink name=out",
    "filter_workers_batch": FILTER.format(opts="batch=4 workers=2"),
    "filter_clamped": FILTER.format(opts="batch=-1 workers=0"),
    "filter_mesh_no_batch": FILTER.format(opts="custom=mesh:dp=2"),
    "filter_inflight_deadline": FILTER.format(
        opts="inflight=4 batch-timeout-ms=5"),
    "filter_not_int": FILTER.format(opts="batch=x batch-timeout-ms=y"),
    "queue_zero": VIDEO + " ! queue name=q max-size-buffers=0 ! "
                          "tensor_sink name=out",
    "queue_not_int": VIDEO + " ! queue name=q max-size-buffers=abc ! "
                             "tensor_sink name=out",
    "tee_serialized": VIDEO + " ! tee name=t t. ! tensor_sink name=a "
                              "t. ! tensor_sink name=b",
    "server_deadline": SERVER.format(opts="batch-timeout-ms=5"),
    "server_bad_batch": SERVER.format(opts="batch=x"),
    "llm_slots_lt_batch": LLM.format(
        opts=f"custom={LM},max_seq:64 slots=2 batch=4"),
    "llm_no_max_seq": LLM.format(opts=f"custom={LM}"),
    "llm_pages": LLM.format(
        opts=f"custom={LM},max_seq:60 page-size=16 prefix-cache=1"),
    "llm_prefix_without_pages": LLM.format(
        opts=f"custom={LM},max_seq:64 prefix-cache=1"),
    "llm_step_prefill": LLM.format(
        opts=f"custom={LM},max_seq:64 prefill=step"),
    "llm_bad": LLM.format(opts=f"custom={LM},max_seq:64 prefill=bogus "
                               "slots=x page-size=-2"),
}
#: rules whose messages are the hooks' own text (equal across packages)
VERBATIM = ("misconfig", "unlinked-pad", "dead-branch", "thread-structure",
            "deadlock-cycle")


def _mask(text: str) -> str:
    return re.sub(r"capsfilter\d+", "capsfilter", text)


def _key(findings):
    return [(f.severity, f.rule, _mask(f.path),
             _mask(f.message) if f.rule in VERBATIM
             or f.rule.startswith("llm-") else None) for f in findings]


@pytest.mark.parametrize("name", sorted(STRINGS))
def test_findings_equal_jax(name):
    got = verify.verify_pipeline(parse_launch(STRINGS[name]))
    want = jax_verify.verify_pipeline(jax_parse_launch(STRINGS[name]))
    assert _key(got) == _key(want)
    errors = {f.rule for f in got if f.severity == "error"}
    assert bool(errors) == (name not in PLAYABLE), errors


#: the strings whose findings are warnings or notes only (they play)
PLAYABLE = ("good", "tee_serialized", "filter_workers_batch",
            "filter_clamped", "filter_inflight_deadline", "queue_zero",
            "server_deadline", "llm_step_prefill")


@pytest.mark.parametrize("name", ["good", "caps_dead_end", "queue_not_int",
                                  "llm_slots_lt_batch", "tee_serialized"])
def test_check_exit_codes_and_lines_equal_jax(name):
    out, jout = io.StringIO(), io.StringIO()
    rc = launch.check(STRINGS[name], out=out)
    jrc = jax_launch.check(STRINGS[name], out=jout)
    assert rc == jrc == (0 if name in ("good", "tee_serialized") else 1)

    def lines(text):   # caps messages print set-ordered fields
        return [_mask(ln.split(": ", 1)[0]) if "caps-mismatch" in ln
                else _mask(ln) for ln in text.splitlines()]

    assert lines(out.getvalue()) == lines(jout.getvalue())


def test_port_converter_refuses_audio_caps():
    """The port's ``tensor_converter`` takes the JAX package's media
    (audio, text, octet streams and flexible tensors as well as video),
    so the verifier refuses the same strings with the same findings: a
    source that cannot produce audio before the converter, and nothing
    of the converter's own."""
    desc = ("videotestsrc name=v num-buffers=1 ! audio/x-raw ! "
            "tensor_converter name=c ! tensor_sink name=out")
    got = _key(verify.verify_pipeline(parse_launch(desc)))
    want = _key(jax_verify.verify_pipeline(jax_parse_launch(desc)))
    assert got == want == [
        ("error", "caps-mismatch", "v -> capsfilter -> c -> out", None)]
    audio = ("audiotestsrc name=v num-buffers=1 ! audio/x-raw ! "
             "tensor_converter name=c ! tensor_sink name=out")
    assert _key(verify.verify_pipeline(parse_launch(audio))) == \
        _key(jax_verify.verify_pipeline(jax_parse_launch(audio))) == []


def test_check_rejects_a_parse_error():
    out = io.StringIO()
    assert launch.check("no_such_element_xyz ! tensor_sink", out=out) == 1
    assert "parse" in out.getvalue()


def test_thread_segments_equal_jax():
    desc = (VIDEO + " ! queue name=q ! tee name=t t. ! queue name=q2 ! "
            "tensor_sink name=a t. ! tensor_sink name=b")
    got = verify.thread_segments(parse_launch(desc))
    want = jax_verify.thread_segments(jax_parse_launch(desc))
    assert _mask(json.dumps(got)) == _mask(json.dumps(want))
    segs = {s["thread"]: s["elements"] for s in got}
    assert "c" in segs["src:v"] and segs["queue:q2"] == ["a"]


def _cycle_findings(pkg_element, pipeline_cls, vmod):
    class _Join(pkg_element.Element):
        FACTORY = "test_join"

        def _make_pads(self):
            self.add_sink_pad(pkg_element.Caps.any(), "sink_0")
            self.add_sink_pad(pkg_element.Caps.any(), "sink_1")
            self.add_src_pad(pkg_element.Caps.any(), "src")

    graph = __import__(pipeline_cls.__module__, fromlist=["AppSrc"])
    sink_mod = __import__(pipeline_cls.__module__.rsplit(".", 2)[0]
                          + ".elements", fromlist=["TensorSink"])
    p = pipeline_cls()
    src = graph.AppSrc("in", caps=CAPS4)
    join, tee = _Join("j"), graph.Tee("t")
    q, out = graph.Queue("q"), sink_mod.TensorSink("out")
    p.add(src, join, tee, q, out)
    p.link_pads(src, None, join, "sink_0")
    p.link(join, tee)
    p.link(tee, q)
    p.link_pads(q, None, join, "sink_1")
    p.link(tee, out)
    return vmod.verify_pipeline(p), p


def test_deadlock_cycle_equal_jax_and_rejected_at_play():
    got, p = _cycle_findings(element, Pipeline, verify)
    want, _ = _cycle_findings(jax_element, JaxPipeline, jax_verify)
    assert _key(got) == _key(want)
    errs = [f for f in got if f.rule == "deadlock-cycle"]
    assert errs and errs[0].severity == "error"
    assert "j" in errs[0].path and "t" in errs[0].path
    with pytest.raises(VerifyError, match="deadlock-cycle"):
        p.play()
    p.stop()


def test_unlinked_pad_and_dead_branch_equal_jax():
    from nnstreamer_tpu.elements.sink import TensorSink as JaxSink
    from nnstreamer_tpu.pipeline.graph import Queue as JaxQueue

    from nnstreamer_tpu_torch.elements import TensorSink
    from nnstreamer_tpu_torch.pipeline.graph import Queue

    def findings(pipeline_cls, queue_cls, sink_cls, vmod):
        p = pipeline_cls()
        q, s = p.add(queue_cls("q"), sink_cls("s"))
        p.link(q, s)
        return vmod.verify_pipeline(p)

    got = findings(Pipeline, Queue, TensorSink, verify)
    assert _key(got) == _key(findings(JaxPipeline, JaxQueue, JaxSink,
                                      jax_verify))
    assert {(f.severity, f.rule) for f in got} >= {
        ("error", "unlinked-pad"), ("warning", "dead-branch")}


def test_xla_fallback_warnings_equal_jax():
    desc = (VIDEO + " ! tensor_debug name=d output=console ! "
            "identity name=i sleep-us=5 ! tensor_sink name=out")
    got = verify.verify_pipeline(parse_launch(desc, Pipeline(fuse="xla")))
    want = jax_verify.verify_pipeline(jax_parse_launch(
        desc, JaxPipeline(fuse="xla")))
    rules = [(f.severity, f.rule, _mask(f.path)) for f in got]
    assert rules == [(f.severity, f.rule, _mask(f.path)) for f in want]
    assert [r for r in rules if r[1] == "xla-fallback"]
    # the python tier asks nothing of lowering
    assert not [f for f in verify.verify_pipeline(parse_launch(desc))
                if f.rule == "xla-fallback"]


def test_play_runs_the_preflight(monkeypatch):
    p = parse_launch(STRINGS["caps_dead_end"])
    with pytest.raises(VerifyError, match="caps-mismatch") as exc:
        p.play()
    p.stop()
    assert isinstance(exc.value, PipelineError)
    assert exc.value.findings and exc.value.element is not None
    assert p.verify() == exc.value.findings or p.verify()
    # NNS_VERIFY=0 opts out: the failure surfaces at negotiation instead
    monkeypatch.setenv("NNS_VERIFY", "0")
    q = parse_launch(STRINGS["caps_dead_end"])
    with pytest.raises(PipelineError) as exc:
        q.run(timeout=10)
    assert not isinstance(exc.value, VerifyError)


GOOD_FLEET = {
    "worker_launch": "tensor_query_serversrc port={port} caps=x ! "
                     "tensor_query_serversink",
    "min_workers": 2, "max_workers": 4,
    "drain_grace_s": 10.0, "worker_batch_timeout_ms": 30.0,
}
FLEETS = {
    "good": {},
    "zero_workers": {"min_workers": 0},
    "minmax": {"min_workers": 5, "max_workers": 2},
    "drain_grace": {"drain_grace_s": 0.02},
    "no_port": {"worker_launch": "tensor_query_serversrc port=5"},
    "cooldown": {"autoscaler": {"spawn_cooldown_s": -1.0}},
    "unknown_key": {"wat": 1},
}


@pytest.mark.parametrize("name", sorted(FLEETS))
def test_fleet_findings_and_check_equal_jax(name, tmp_path, capsys):
    doc = {**GOOD_FLEET, **FLEETS[name]}
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps(doc))
    got = verify.verify_fleet_config(str(path))
    want = jax_verify.verify_fleet_config(str(path))
    assert [(f.severity, f.rule, f.path, f.message.replace(
        "nnstreamer_tpu_torch", "nnstreamer_tpu")) for f in got] == \
        [(f.severity, f.rule, f.path, f.message) for f in want]
    rc = launch.main([str(path), "--check"])
    assert rc == jax_launch.main([str(path), "--check"])
    assert rc == (0 if name == "good" else 1)
    if name != "unknown_key":
        assert fleet.FleetConfig.from_dict(doc).validate() == \
            jax_fleet.FleetConfig.from_dict(doc).validate()
    capsys.readouterr()
