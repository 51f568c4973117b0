"""Stream composition on both packages: the sync engine
(``pipeline/clock.py``), ``tensor_mux``/``tensor_demux``,
``tensor_merge``/``tensor_split``, ``tensor_aggregator``, ``tensor_if``
(with ``tensor/data.py``), ``tensor_rate``, ``tensor_sparse_enc``/``dec``,
``tensor_reposink``/``reposrc``, ``join``, ``tensor_crop``,
``datareposrc`` and the filter's ``custom=mesh:dp=N``.

Each case runs the same launch string (or the same function on the same
seeded numpy inputs) through the JAX package and through the port and
compares what comes out: every tensor's dtype, shape and bytes, every
buffer's pts and duration, the caps the sinks saw, and the errors raised.
The cases mirror ``tests/test_elements.py`` (``TestMuxDemux`` through
``TestMuxEosSemantics``, ``TestCrop``, ``TestRepo*``, ``TestDataRepoSrc``);
the filters in them run on the CPU (``accelerator=true:cpu`` in the
port) and are held within ``atol=1e-3``.  Every wait is bounded.
"""

import importlib
import time
import types

import numpy as np
import pytest

from nnstreamer_tpu.filter.framework import FilterError as JaxFilterError
from nnstreamer_tpu_torch.filter.framework import FilterError


def _namespace(root: str, accel: str):
    """One package's surface, by the same names."""

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    graph = mod("pipeline.graph")
    return types.SimpleNamespace(
        root=root, accel=accel, parse_launch=mod("pipeline").parse_launch,
        Pipeline=graph.Pipeline, AppSrc=graph.AppSrc, Queue=graph.Queue,
        PipelineError=graph.PipelineError,
        TB=mod("tensor.buffer").TensorBuffer, el=mod("elements"),
        clock=mod("pipeline.clock"), repo=mod("elements.repo"),
        sparse=mod("elements.sparse"), data=mod("tensor.data"),
        tensor_if=mod("elements.tensor_if"), custom=mod(
            "filter.backends.custom"), info=mod("tensor.info"),
        types=mod("tensor.types"), verify=mod("analysis.verify"),
        FilterSingle=mod("filter").FilterSingle)


JAX = _namespace("nnstreamer_tpu", "")
PORT = _namespace("nnstreamer_tpu_torch", "accelerator=true:cpu ")


def caps(dims="4", types_="float32", n=1, rate="30/1"):
    return (f"other/tensors,format=static,num_tensors={n},"
            f"dimensions={dims},types={types_},framerate={rate}")


def sig(x):
    """A comparable record of ``x``: arrays by dtype, shape and bytes,
    buffers by pts, duration and tensors."""
    if hasattr(x, "tensors") and hasattr(x, "pts"):
        return ("buf", x.pts, x.duration,
                [sig(x.np(i)) for i in range(x.num_tensors)])
    if isinstance(x, (list, tuple)):
        return [sig(v) for v in x]
    if isinstance(x, dict):
        return {k: sig(v) for k, v in sorted(x.items())}
    if isinstance(x, np.generic) or (isinstance(x, np.ndarray)):
        a = np.ascontiguousarray(x)
        return ("a", a.dtype.str, a.shape, a.tobytes())
    return x


def sink_record(sink):
    return {"caps": str(sink.caps) if sink.caps is not None else None,
            "bufs": sig(sink.results)}


def play_feed(ns, launch, feeds, timeout=30, pause=0.0):
    """Play ``launch``, push ``feeds`` ((appsrc name, buffer or None for
    EOS), in order), wait for EOS; returns the pipeline (stopped)."""
    p = ns.parse_launch(launch)
    p.play()
    try:
        for name, buf in feeds:
            if buf is None:
                p.get(name).end_of_stream()
            else:
                p.get(name).push_buffer(buf)
            if pause:
                time.sleep(pause)
        p.wait(timeout=timeout)
    finally:
        p.stop()
    return p


def both(case, *args):
    """``case`` on each package; the two records must be equal."""
    got, want = case(PORT, *args), case(JAX, *args)
    assert got == want
    return got


# -- pipeline/clock.py ---------------------------------------------------

@pytest.mark.parametrize("option", [None, "", "0", "1:33333333", "0:0.",
                                    "0:33333333ns", "abc", "2:+17"])
def test_parse_sync_option_equal_jax(option):
    assert PORT.clock.parse_sync_option(option) == \
        JAX.clock.parse_sync_option(option)


def _collect_pads(ns, mode, seed, base_duration, base_pad):
    """A seeded interleaving of pushes and EOS over 3 pads: every frame
    set formed, the exhaustion answers and the final drain."""
    rng = np.random.default_rng(seed)
    cp = ns.clock.CollectPads(3, ns.clock.SyncMode.from_string(mode),
                              base_duration, base_pad=base_pad)
    pts = [0, 0, 0]
    out = []
    order = list(rng.integers(0, 3, 30))
    for i in order:
        pts[i] += int(rng.integers(1, 4)) * 10
        fs = cp.push(int(i), ns.TB(tensors=[np.full(1, i, np.int32)],
                                   pts=pts[i]))
        out.append(None if fs is None else [b.pts for b in fs])
        out.append(cp.exhausted())
    for i in (2, 0, 1):
        out.append(cp.set_eos(i))
    tail = cp.finalize()
    out.append(None if tail is None else [[b.pts for b in fs]
                                          for fs in tail])
    return out


@pytest.mark.parametrize("mode,base_duration,base_pad", [
    ("nosync", None, 0), ("slowest", None, 0), ("basepad", 20, 0),
    ("basepad", 0, 1), ("refresh", None, 0), ("refresh", None, 2)])
@pytest.mark.parametrize("seed", [0, 1])
def test_collect_pads_equal_jax(mode, base_duration, base_pad, seed):
    both(_collect_pads, mode, seed, base_duration, base_pad)


def test_sync_mode_spellings_equal_jax():
    for s in (None, "", "NOSYNC", " Slowest ", "basepad", "refresh"):
        assert PORT.clock.SyncMode.from_string(s).value == \
            JAX.clock.SyncMode.from_string(s).value
    with pytest.raises(ValueError):
        PORT.clock.SyncMode.from_string("fastest")


# -- tensor_mux / tensor_demux -------------------------------------------

def _mux_combines(ns, mode):
    option = " sync-option=0:50" if mode == "basepad" else ""
    p = play_feed(ns, (
        f"appsrc name=s1 caps={caps('2')} ! queue name=q1 ! m.sink_0 "
        f"appsrc name=s2 caps={caps('3')} ! queue name=q2 ! m.sink_1 "
        f"tensor_mux name=m sync-mode={mode}{option} ! "
        "tensor_sink name=out"),
        [f for i in range(3) for f in (
            ("s1", ns.TB(tensors=[np.full(2, i, np.float32)], pts=i * 100)),
            ("s2", ns.TB(tensors=[np.full(3, 10 + i, np.float32)],
                         pts=i * 100)))] + [("s1", None), ("s2", None)])
    return sink_record(p.get("out"))


@pytest.mark.parametrize("mode", ["slowest", "nosync", "basepad"])
def test_mux_combines_equal_jax(mode):
    rec = both(_mux_combines, mode)
    assert len(rec["bufs"]) == 3 and "2.3" in rec["caps"]


def _demux(ns, pick):
    prop = f" tensorpick={pick}" if pick else ""
    pads = "d.src_0 ! tensor_sink name=o1"
    if pick in (None, "1,0"):
        pads += " d.src_1 ! tensor_sink name=o2"
    p = play_feed(ns, (
        f"appsrc name=src caps={caps('2.3', 'float32.float32', 2)} ! "
        f"tensor_demux name=d{prop} {pads}"),
        [("src", ns.TB(tensors=[np.ones(2, np.float32),
                                np.arange(3, dtype=np.float32)], pts=0)),
         ("src", None)])
    names = ("o1", "o2") if " o2" in pads.replace("=", " ") else ("o1",)
    return {k: sink_record(p.get(k)) for k in names}


@pytest.mark.parametrize("pick", [None, "1", "1,0", "0:1"])
def test_demux_equal_jax(pick):
    both(_demux, pick)


def test_demux_passes_device_tensors_through():
    """Regrouping hands the payload handles on: a torch tensor leaves
    the demux as the same object (no copy, no host read)."""
    import torch

    p = PORT.parse_launch(
        f"appsrc name=src caps={caps('2.3', 'float32.float32', 2)} ! "
        "tensor_demux name=d d.src_0 ! tensor_sink name=o1 "
        "d.src_1 ! tensor_sink name=o2")
    a, b = torch.ones(2), torch.zeros(3)
    p.play()
    p.get("src").push_buffer(PORT.TB(tensors=[a, b], pts=0))
    p.get("src").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    assert p.get("o1").results[0].tensors[0] is a
    assert p.get("o2").results[0].tensors[0] is b


def _demux_check(ns, pick):
    p = ns.parse_launch(
        f"appsrc name=src caps={caps('2.3', 'float32.float32', 2)} ! "
        f"tensor_demux name=d tensorpick={pick} d.src_0 ! tensor_sink "
        "name=o1 d.src_1 ! tensor_sink name=o2")
    return [(f.severity, f.rule, f.message)
            for f in ns.verify.verify_pipeline(p)]


@pytest.mark.parametrize("pick", ["0", "x:y", "0,1"])
def test_demux_static_check_equal_jax(pick):
    both(_demux_check, pick)


def _refresh_nonbase_eos(ns):
    c = caps("2", rate="0/1")
    p = ns.parse_launch(
        "tensor_mux name=mux sync-mode=refresh ! tensor_sink name=out "
        f"appsrc name=a caps={c} ! mux.sink_0 "
        f"appsrc name=b caps={c} ! mux.sink_1")
    p.play()
    p.get("b").push_buffer(ns.TB(tensors=[np.full(2, 7.0, np.float32)],
                                 pts=0))
    p.get("b").end_of_stream()
    time.sleep(0.1)
    for i in range(3):
        p.get("a").push_buffer(ns.TB(
            tensors=[np.full(2, float(i), np.float32)], pts=i))
    p.get("a").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    return sink_record(p.get("out"))


def _refresh_drains_backlog(ns):
    c = caps("2", rate="0/1")
    p = ns.parse_launch(
        "tensor_mux name=mux sync-mode=refresh ! tensor_sink name=out "
        f"appsrc name=a caps={c} ! mux.sink_0 "
        f"appsrc name=b caps={c} ! mux.sink_1")
    p.play()
    for i in range(3):
        p.get("a").push_buffer(ns.TB(
            tensors=[np.full(2, float(i), np.float32)], pts=i))
    time.sleep(0.1)
    p.get("b").push_buffer(ns.TB(tensors=[np.full(2, 9.0, np.float32)],
                                 pts=0))
    p.get("b").end_of_stream()
    time.sleep(0.1)
    p.get("a").end_of_stream()
    p.wait(timeout=15)
    p.stop()
    return sink_record(p.get("out"))


def _ref_to_ref_link(ns):
    p = play_feed(ns, (
        f"appsrc name=a caps={caps('2.2', 'float32.float32', 2, '0/1')} ! "
        "tensor_demux name=d tensor_mux name=mux ! tensor_sink name=out "
        "d.src_1 ! mux.sink_0 d.src_0 ! mux.sink_1"),
        [("a", ns.TB(tensors=[np.full(2, 1.0, np.float32),
                              np.full(2, 2.0, np.float32)])), ("a", None)])
    return sink_record(p.get("out"))


def _mux_restart(ns):
    p = ns.parse_launch("appsrc name=a ! tensor_mux name=mux ! fakesink")
    mux = p.get("mux")
    mux.start()
    mux._sent_eos = True
    mux.start()
    return mux._sent_eos


def _named_pad_typo(ns):
    out = []
    with pytest.raises(ValueError, match="no pad named") as e1:
        ns.parse_launch("appsrc name=a ! tensor_mux name=mux ! fakesink "
                        "a2. ! mux.sinko_1 appsrc name=a2")
    out.append(str(e1.value))
    p = ns.parse_launch("appsrc name=a ! tensor_mux name=mux ! fakesink")
    with pytest.raises(ValueError, match="no pad named") as e2:
        p.link_pads(p.get("a"), None, p.get("mux"), "sinkz")
    out.append(str(e2.value))
    out.append(len(p.get("mux").sink_pads))
    return out


@pytest.mark.parametrize("case", [_refresh_nonbase_eos,
                                  _refresh_drains_backlog, _ref_to_ref_link,
                                  _mux_restart, _named_pad_typo],
                         ids=lambda c: c.__name__.strip("_"))
def test_mux_eos_semantics_equal_jax(case):
    both(case)


def _mux_plans(ns):
    """The segment compiler's plan rows on a string around a mux."""
    p = ns.parse_launch(
        f"appsrc name=a caps={caps('2')} ! identity name=i1 ! m.sink_0 "
        f"appsrc name=b caps={caps('2')} ! m.sink_1 "
        "tensor_mux name=m ! identity name=i2 ! tensor_demux name=d "
        "d.src_0 ! identity name=i3 ! tensor_sink name=o1 "
        "d.src_1 ! tensor_sink name=o2", ns.Pipeline(fuse="python"))
    p.play()
    for i in range(3):
        for name in ("a", "b"):
            p.get(name).push_buffer(ns.TB(
                tensors=[np.full(2, i, np.float32)], pts=i))
    for name in ("a", "b"):
        p.get(name).end_of_stream()
    p.wait(timeout=30)
    keep = ("head", "elements", "tail", "lowering", "fallback")
    rows = sorted(({k: r[k] for k in keep if k in r}
                   for r in p.planner.plans()), key=lambda r: r["head"])
    p.stop()
    return rows, sink_record(p.get("o1")), sink_record(p.get("o2"))


def test_mux_string_plans_equal_jax():
    rows, _, _ = both(_mux_plans)
    assert rows


XLA_STRINGS = {
    "if_aggregator": (f"appsrc name=s caps={caps('4')} ! tensor_if "
                      "name=tif ! tensor_aggregator name=agg frames-out=2 "
                      "! tensor_rate name=r framerate=15/1 ! "
                      "tensor_sink name=out"),
    "mux_merge": (f"appsrc name=a caps={caps('4')} ! m.sink_0 "
                  f"appsrc name=b caps={caps('4')} ! m.sink_1 "
                  "tensor_merge name=m ! tensor_split name=s tensorseg=4,4 "
                  "s.src_0 ! tensor_sink name=o1 s.src_1 ! "
                  "tensor_sparse_enc name=e ! tensor_sparse_dec name=d ! "
                  "tensor_sink name=o2"),
    "media": ("audiotestsrc name=a num-buffers=1 ! audio/x-raw,format=S16LE,"
              "channels=1,rate=16000 ! tensor_converter name=c ! "
              "filesink name=f location=/dev/null"),
    "repo": (f"appsrc name=s caps={caps('4')} ! tensor_reposink name=rs "
             f"slot-index=9 tensor_reposrc name=rr slot-index=9 "
             f"caps={caps('4')} ! tensor_sink name=out"),
}


def _xla_findings(ns, name):
    """The verifier's findings on a string planned under ``fuse=xla``:
    the new elements have no ``plan_step`` (segment boundaries, as in the
    JAX package, so no ``xla-fallback`` warning) and the repo slot's
    recurrence is a note."""
    p = ns.parse_launch(XLA_STRINGS[name], ns.Pipeline(fuse="xla"))
    return [(f.severity, f.rule, f.path, f.message)
            for f in ns.verify.verify_pipeline(p)]


@pytest.mark.parametrize("name", sorted(XLA_STRINGS))
def test_lowering_findings_equal_jax(name):
    got = both(_xla_findings, name)
    assert [rule for _, rule, _, _ in got] == (
        ["recurrent-topology"] if name == "repo" else [])


# -- tensor_merge / tensor_split -----------------------------------------

def _merge(ns, option, mode):
    so = " sync-option=0:0." if mode == "basepad" else ""
    c = caps("2") if option == 0 else caps("4", "uint8", rate="0/1")
    dtype = np.float32 if option == 0 else np.uint8
    n = 2 if option == 0 else 4
    p = play_feed(ns, (
        f"appsrc name=a caps={c} ! queue name=q1 ! m.sink_0 "
        f"appsrc name=b caps={c} ! queue name=q2 ! m.sink_1 "
        f"tensor_merge name=m mode=linear option={option} silent=true "
        f"sync-mode={mode}{so} ! tensor_sink name=out"),
        [f for i in range(2) for f in (
            ("a", ns.TB(tensors=[np.arange(n, dtype=dtype) + i],
                        pts=i * 10**8)),
            ("b", ns.TB(tensors=[np.arange(n, dtype=dtype) + 10 + i],
                        pts=i * 10**8)))] + [("a", None), ("b", None)])
    return sink_record(p.get("out"))


@pytest.mark.parametrize("option,mode", [(0, "slowest"), (2, "basepad"),
                                         (1, "nosync")])
def test_merge_equal_jax(option, mode):
    both(_merge, option, mode)


def _split(ns, segs, option, dims, shape):
    n = len(segs.split(","))
    tail = " ".join(f"s.src_{i} ! tensor_sink name=o{i}" for i in range(n))
    p = play_feed(ns, (
        f"appsrc name=src caps={caps(dims)} ! tensor_split name=s "
        f"tensorseg={segs} option={option} {tail}"),
        [("src", ns.TB(tensors=[np.arange(int(np.prod(shape)),
                                          dtype=np.float32).reshape(shape)],
                       pts=3)), ("src", None)])
    return [sink_record(p.get(f"o{i}")) for i in range(n)]


@pytest.mark.parametrize("segs,option,dims,shape", [
    ("2,3", 0, "5", (5,)), ("1,2,1", 0, "4:3", (3, 4)),
    ("2,1", 1, "4:3", (3, 4))])
def test_split_equal_jax(segs, option, dims, shape):
    both(_split, segs, option, dims, shape)


def test_merge_split_round_trip_keeps_device_split_on_host():
    """As in the JAX elements, merge and split compute on the host: a
    torch tensor in gives numpy arrays out, with the same values."""
    import torch

    p = PORT.parse_launch(
        f"appsrc name=src caps={caps('5')} ! tensor_split name=s "
        "tensorseg=2,3 s.src_0 ! tensor_sink name=o0 "
        "s.src_1 ! tensor_sink name=o1")
    p.play()
    p.get("src").push_buffer(PORT.TB(tensors=[torch.arange(5.)], pts=0))
    p.get("src").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    assert isinstance(p.get("o1").results[0].tensors[0], np.ndarray)
    np.testing.assert_array_equal(p.get("o1").results[0].np(0), [2, 3, 4])


# -- tensor_aggregator ---------------------------------------------------

def _aggregate(ns, props, dims, shape, n):
    rng = np.random.default_rng(7)
    bufs = [("src", ns.TB(tensors=[rng.standard_normal(shape).astype(
        np.float32)], pts=i * 100, duration=100)) for i in range(n)]
    p = play_feed(ns, f"appsrc name=src caps={caps(dims)} ! "
                  f"tensor_aggregator {props} ! tensor_sink name=out",
                  bufs + [("src", None)])
    return sink_record(p.get("out"))


@pytest.mark.parametrize("props,dims,shape,n", [
    ("frames-out=2", "3", (3,), 4),
    ("frames-out=2 frames-flush=1", "2", (2,), 3),
    ("frames-out=2 frames-dim=1", "3:4", (4, 3), 2),
    ("frames-in=2 frames-out=4 frames-dim=1", "3:2", (2, 3), 6),
    ("frames-out=3 frames-flush=2 frames-dim=2", "3:4", (4, 3), 7),
    ("frames-out=4", "1001", (1001,), 9)])
def test_aggregator_equal_jax(props, dims, shape, n):
    rec = both(_aggregate, props, dims, shape, n)
    assert rec["bufs"]


def _aggregator_start_errors(ns, props):
    el = ns.el.TensorAggregator("a", **props)
    with pytest.raises(ValueError) as e:
        el.start()
    return str(e.value)


@pytest.mark.parametrize("props", [{"frames-in": 2},
                                   {"frames-in": 2, "frames-out": 3,
                                    "frames-dim": 0},
                                   {"frames-in": 2, "frames-out": 4,
                                    "frames-flush": 3, "frames-dim": 0}])
def test_aggregator_start_errors_equal_jax(props):
    both(_aggregator_start_errors, props)


# -- tensor/data.py and tensor_if ----------------------------------------

@pytest.mark.parametrize("fn", ["average", "std", "average_per_channel",
                                "std_per_channel"])
@pytest.mark.parametrize("dtype", ["uint8", "float32", "int16"])
def test_tensor_data_equal_jax(fn, dtype):
    arr = (np.random.default_rng(3).standard_normal((4, 5, 3)) * 50
           + 60).astype(dtype)
    got, want = getattr(PORT.data, fn)(arr), getattr(JAX.data, fn)(arr)
    assert sig(np.asarray(got)) == sig(np.asarray(want))


def test_tensor_data_typecast_equal_jax():
    for name in ("uint8", "int32", "float32", "float64"):
        assert sig(PORT.data.typecast(
            300.7, PORT.types.TensorType.from_string(name))) == \
            sig(JAX.data.typecast(300.7, JAX.types.TensorType.from_string(
                name)))


IF_C = ("other/tensors,num_tensors=1,dimensions=2:2,types=uint8,"
        "format=static,framerate=0/1")


def _tensor_if_line(ns, line):
    p = play_feed(ns, f"appsrc name=s caps={IF_C} ! tensor_if name=tif "
                  f"{line} ! tensor_sink name=o",
                  [("s", ns.TB(tensors=[np.full((2, 2), v, np.uint8)],
                               pts=i)) for i, v in enumerate((5, 130, 60))]
                  + [("s", None)])
    return sink_record(p.get("o"))


@pytest.mark.parametrize("line", [
    "compared-value=A_VALUE compared-value-option=0:0:0:0,0 "
    "supplied-value=0,127 operator=RANGE_INCLUSIVE then=PASSTHROUGH "
    "else=SKIP",
    "compared-value=TENSOR_AVERAGE_VALUE compared-value-option=0 "
    "supplied-value=100 operator=LT then=PASSTHROUGH else=SKIP",
    "compared-value=TENSOR_AVERAGE_VALUE compared-value-option=0 "
    "supplied-value=1 operator=LT then=PASSTHROUGH else=SKIP",
    "compared-value=A_VALUE compared-value-option=1:1,0 supplied-value=60 "
    "operator=NE then=FILL_WITH_ZERO else=PASSTHROUGH",
    "compared-value=a-value supplied-value=10,100 "
    "operator=not-in-range-exclusive then=fill-zero else=passthrough",
    "compared-value=tensor-average supplied-value=60 operator=ge "
    "then=passthrough else=fill-zero",
    "operator=EQ supplied-value=130 then=PASSTHROUGH else=SKIP"])
def test_tensor_if_lines_equal_jax(line):
    both(_tensor_if_line, line)


def _tensor_if_two_pads(ns, then, else_):
    opts = ""
    if then == "tensorpick":
        opts = " then-option=1"
    if else_ == "tensorpick":
        opts += " else-option=0"
    p = play_feed(ns, (
        f"appsrc name=src caps={caps('2.3', 'float32.float32', 2)} ! "
        "tensor_if name=tif compared-value=tensor-average operator=ge "
        f"supplied-value=5 then={then} else={else_}{opts} "
        "tif.src_0 ! tensor_sink name=t tif.src_1 ! tensor_sink name=e"),
        [("src", ns.TB(tensors=[np.full(2, v, np.float32),
                                np.arange(3, dtype=np.float32)], pts=i))
         for i, v in enumerate((10, 1, 7))] + [("src", None)])
    return sink_record(p.get("t")), sink_record(p.get("e"))


@pytest.mark.parametrize("then,else_", [
    ("passthrough", "passthrough"), ("tensorpick", "tensorpick"),
    ("fill-zero", "skip")])
def test_tensor_if_two_pads_equal_jax(then, else_):
    both(_tensor_if_two_pads, then, else_)


def _tensor_if_custom(ns):
    ns.tensor_if.register_if_custom("odd_pts",
                                    lambda buf: (buf.pts or 0) % 2)
    p = play_feed(ns, (
        f"appsrc name=s caps={caps('1')} ! tensor_if compared-value=custom "
        "compared-value-option=odd_pts operator=eq supplied-value=1 "
        "then=passthrough else=skip ! tensor_sink name=o"),
        [("s", ns.TB(tensors=[np.zeros(1, np.float32)], pts=i))
         for i in range(4)] + [("s", None)])
    return sink_record(p.get("o"))


def _tensor_if_start_errors(ns):
    out = []
    for props in ({"compared-value": "AVERAGE_VALUE"},
                  {"operator": "BETWEEN"}, {"then": "DROP"}):
        with pytest.raises(ValueError) as e:
            ns.el.TensorIf("t", **props).start()
        out.append(str(e.value))
    return out


def _tensor_if_runtime_set(ns):
    el = ns.el.TensorIf("t", **{"operator": "GT", "supplied-value": "3"})
    el.start()
    out = [el._op(5, el._a, el._b)]
    el.set_property("operator", "LT")
    out.append(el._op(5, el._a, el._b))
    el.set_property("then", "TENSORPICK")
    el.set_property("supplied-value", "9")
    out += [el._then, el._a, el._op(5, el._a, el._b)]
    return out


@pytest.mark.parametrize("case", [_tensor_if_custom, _tensor_if_start_errors,
                                  _tensor_if_runtime_set],
                         ids=lambda c: c.__name__.strip("_"))
def test_tensor_if_cases_equal_jax(case):
    both(case)


def test_tensor_if_passthrough_keeps_device_tensors():
    """``passthrough`` and ``tensorpick`` hand the payload on: a torch
    tensor leaves as the same object; the compared value is read on the
    host, as in the JAX element."""
    import torch

    p = PORT.parse_launch(
        f"appsrc name=s caps={caps('2.3', 'float32.float32', 2)} ! "
        "tensor_if name=tif compared-value=tensor-average operator=gt "
        "supplied-value=0 then=tensorpick then-option=1 else=skip ! "
        "tensor_sink name=o")
    a, b = torch.ones(2), torch.zeros(3)
    p.play()
    p.get("s").push_buffer(PORT.TB(tensors=[a, b], pts=0))
    p.get("s").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    assert p.get("o").results[0].tensors == [b]


# -- tensor_rate -----------------------------------------------------------

def _rate(ns, target, throttle, n, qos):
    p = ns.parse_launch(f"appsrc name=s caps={caps('1')} ! tensor_rate "
                        f"name=r framerate={target} throttle={throttle} ! "
                        "tensor_sink name=out")
    p.play()
    r = p.get("r")
    for i in range(n):
        if qos and i == n // 2:
            ev = importlib.import_module(
                f"{ns.root}.pipeline.element").QoSEvent
            r.on_upstream_event(r.src_pad, ev(proportion=2.0,
                                              jitter_ns=1000,
                                              timestamp=i * 33_333_333))
        p.get("s").push_buffer(ns.TB(tensors=[np.full(1, i, np.float32)],
                                     pts=i * 33_333_333,
                                     duration=33_333_333))
    p.get("s").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    return sink_record(p.get("out")), r.dropped, str(r.effective_rate)


@pytest.mark.parametrize("target,throttle,n,qos", [
    ("15/1", "true", 10, False), ("10/1", "true", 12, False),
    ("60/1", "false", 6, False), ("30/1", "true", 12, True)])
def test_rate_equal_jax(target, throttle, n, qos):
    rec, dropped, _ = both(_rate, target, throttle, n, qos)
    assert rec["bufs"]


# -- tensor_sparse_enc / tensor_sparse_dec ---------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64", "uint8", "int32"])
def test_sparse_blob_equal_jax(dtype):
    rng = np.random.default_rng(5)
    arr = (rng.random((6, 7)) * 4).astype(dtype)
    arr[rng.random((6, 7)) < 0.6] = 0
    blob = PORT.sparse.sparse_encode(arr)
    assert blob == JAX.sparse.sparse_encode(arr)
    assert sig(PORT.sparse.sparse_decode(blob)) == sig(arr)


def _sparse_string(ns):
    p = ns.parse_launch(
        "videotestsrc num-buffers=2 pattern=checkers ! "
        "video/x-raw,format=GRAY8,width=16,height=16 ! tensor_converter ! "
        "tee name=t t. ! queue name=q1 ! tensor_sparse_enc name=e1 ! "
        "tensor_sink name=enc t. ! queue name=q2 ! tensor_sparse_enc "
        "name=e2 ! tensor_sparse_dec ! "
        "tensor_sink name=out")
    p.run(timeout=30)
    return sink_record(p.get("enc")), sink_record(p.get("out"))


def test_sparse_string_equal_jax():
    _, out = both(_sparse_string)
    assert len(out["bufs"]) == 2


# -- tensor_reposink / tensor_reposrc --------------------------------------

def _repo_loop(ns):
    ns.repo.repo.clear()
    p1 = ns.parse_launch(
        "videotestsrc num-buffers=3 ! "
        "video/x-raw,format=GRAY8,width=4,height=4 ! tensor_converter ! "
        "tensor_reposink slot-index=7")
    p2 = ns.parse_launch("tensor_reposrc slot-index=7 ! "
                         "tensor_sink name=out")
    p1.play()
    p2.play()
    p2.wait(timeout=10)
    p1.wait(timeout=10)
    p1.stop()
    p2.stop()
    ns.repo.repo.clear()
    return sink_record(p2.get("out"))


def _repo_slot_switch(ns):
    ns.repo.repo.clear()
    p = ns.Pipeline()
    src = ns.AppSrc("s", caps=caps("4", "uint8", rate="0/1"))
    sink = ns.el.TensorRepoSink("rs", **{"slot-index": 1})
    p.add(src, sink)
    p.link(src, sink)
    p.play()
    src.push(ns.TB(tensors=[np.full(4, 1, np.uint8)], pts=0))
    sink.set_property("slot-index", 2)
    src.push(ns.TB(tensors=[np.full(4, 2, np.uint8)], pts=1))
    src.end_of_stream()
    p.wait(timeout=10)
    p.stop()
    got = [sig(ns.repo.repo.slot(i).get(timeout=5)) for i in (1, 2)]
    ns.repo.repo.clear()
    return got


def _repo_rnn(ns):
    """tests/nnstreamer_repo_rnn's cycle: state' = state + input, fed
    back through reposink -> reposrc (``examples/recurrent_rnn.py``)."""
    ns.repo.repo.clear()
    info = ns.info.TensorsInfo([ns.info.TensorInfo(
        dtype=ns.types.TensorType.FLOAT32, dims=(4,))])
    pair = ns.info.TensorsInfo([ns.info.TensorInfo(
        dtype=ns.types.TensorType.FLOAT32, dims=(4,))] * 2)
    try:
        ns.custom.unregister_custom_easy("add_state")
    except Exception:
        pass
    ns.custom.register_custom_easy(
        "add_state", lambda ins: [np.asarray(ins[0], np.float32)
                                  + np.asarray(ins[1], np.float32)],
        pair, info)
    c = caps("4", rate="0/1")
    p = ns.parse_launch(
        "tensor_mux name=mux sync-mode=nosync ! "
        "tensor_filter framework=custom-easy model=add_state ! "
        "tee name=t ! queue name=q1 ! tensor_reposink slot-index=3 "
        f"appsrc name=in caps={c} ! mux.sink_0 "
        f"tensor_reposrc slot-index=3 caps={c} ! mux.sink_1 "
        "t. ! queue name=q2 ! tensor_sink name=out")
    p.play()
    rng = np.random.default_rng(11)
    for _ in range(5):
        p.get("in").push_buffer(ns.TB(tensors=[
            rng.standard_normal(4).astype(np.float32)]))
    p.get("in").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    ns.custom.unregister_custom_easy("add_state")
    ns.repo.repo.clear()
    return [sig(b.np(0)) for b in p.get("out").results]


@pytest.mark.parametrize("case", [_repo_loop, _repo_slot_switch, _repo_rnn],
                         ids=lambda c: c.__name__.strip("_"))
def test_repo_equal_jax(case):
    assert both(case)


def test_repo_recurrent_example_equal_jax():
    """``examples/recurrent_rnn.py``'s loop on the port: the running sum
    of the inputs, frame by frame."""
    got = _repo_rnn(PORT)
    rng = np.random.default_rng(11)
    acc = np.zeros(4, np.float32)
    for rec in got:
        acc = acc + rng.standard_normal(4).astype(np.float32)
        assert rec == sig(acc)
    assert len(got) == 5


def test_repo_tables_are_per_package():
    JAX.repo.repo.clear()
    PORT.repo.repo.clear()
    PORT.repo.repo.set_caps(5, "x")
    assert JAX.repo.repo.get_caps(5) is None
    PORT.repo.repo.clear()


# -- join, tensor_crop, datareposrc ----------------------------------------

def _join(ns):
    p = ns.parse_launch(
        f"appsrc name=a caps={caps('2')} ! j.sink_0 "
        f"appsrc name=b caps={caps('2')} ! j.sink_1 "
        "join name=j ! tensor_sink name=out")
    p.play()
    sink = p.get("out")
    for i, name in enumerate(("a", "b", "a", "b", "b")):
        p.get(name).push_buffer(ns.TB(tensors=[np.full(2, i, np.float32)],
                                      pts=i))
        # each appsrc streams on a thread of its own, so two buffers in
        # flight at once reach the join in either order: feed the next
        # only once the sink holds this one (bounded wait)
        deadline = time.monotonic() + 10
        while len(sink.results) <= i and time.monotonic() < deadline:
            time.sleep(0.001)
    p.get("a").end_of_stream()
    p.get("b").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    return sink_record(p.get("out"))


def _crop(ns, regions):
    p = ns.Pipeline()
    raw = ns.AppSrc("raw", caps=caps("3:8:8", "uint8"))
    info = ns.AppSrc("info", caps=caps(f"4:{len(regions)}", "int32"))
    crop = ns.el.TensorCrop("c")
    sink = ns.el.TensorSink("out")
    p.add(raw, info, crop, sink)
    raw.src_pad.link(crop.sink_pads[0])
    info.src_pad.link(crop.sink_pads[1])
    p.link(crop, sink)
    rng = np.random.default_rng(2)
    for i in range(2):
        raw.push_buffer(ns.TB(tensors=[rng.integers(
            0, 256, (8, 8, 3), dtype=np.uint8)], pts=i))
        info.push_buffer(ns.TB(tensors=[np.asarray(regions, np.int32)],
                               pts=i))
    raw.end_of_stream()
    info.end_of_stream()
    p.run(timeout=10)
    rec = sink_record(sink)
    rec["metas"] = [[(str(m.dtype), tuple(m.dims), str(m.format))
                     for m in b.metas] for b in sink.results]
    return rec


@pytest.mark.parametrize("case,args", [
    (_join, ()), (_crop, ([[2, 1, 4, 3]],)),
    (_crop, ([[0, 0, 8, 8], [5, 6, 3, 2], [1, 1, 1, 1]],))],
    ids=["join", "crop1", "crop3"])
def test_join_crop_equal_jax(case, args):
    both(case, *args)


def test_crop_equals_numpy_slices():
    rec = _crop(PORT, [[2, 1, 4, 3]])
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)
    assert rec["bufs"][0][3] == [sig(frame[1:4, 2:6])]


def _datarepo(ns, tmp, dims, types_, epochs):
    f = tmp / f"{ns.root}.raw"
    rng = np.random.default_rng(9)
    f.write_bytes(rng.integers(0, 256, 4 * 40, dtype=np.uint8).tobytes())
    p = ns.parse_launch(f"datareposrc location={f} input-dim={dims} "
                        f"input-type={types_} epochs={epochs} ! "
                        "tensor_sink name=out")
    p.run(timeout=10)
    return sink_record(p.get("out"))


@pytest.mark.parametrize("dims,types_,epochs", [
    ("4", "float32", 2), ("2:2,3", "uint8,int32", 1),
    ("3:2:2,1", "uint8,float32", 3)])
def test_datareposrc_equal_jax(tmp_path, dims, types_, epochs):
    got = _datarepo(PORT, tmp_path, dims, types_, epochs)
    assert got == _datarepo(JAX, tmp_path, dims, types_, epochs)
    assert got["bufs"]


def test_datareposrc_bad_location_equal_jax(tmp_path):
    def run(ns):
        p = ns.parse_launch(f"datareposrc location={tmp_path}/nope "
                            "input-dim=4 input-type=float32 ! fakesink")
        with pytest.raises(Exception) as e:
            p.run(timeout=10)
        return "bad location" in str(e.value)

    assert both(run)


def test_repo_reader_native_and_fallback_agree(tmp_path, monkeypatch):
    from nnstreamer_tpu_torch import native

    f = tmp_path / "d.raw"
    f.write_bytes(bytes(range(60)))
    assert native.available()
    r = native.RepoReader(str(f), 8, wrap=True)
    assert r.is_native and r.num_frames == 7
    got = [r.next_frame() for _ in range(9)]
    r.close()
    monkeypatch.setattr(native, "_load", lambda: None)
    r = native.RepoReader(str(f), 8, wrap=True)
    assert not r.is_native
    want = [r.next_frame() for _ in range(9)]
    r.close()
    assert [(i, sig(a)) for i, a in got] == [(i, sig(a)) for i, a in want]


# -- custom=mesh:dp=N --------------------------------------------------------

MLP4 = "in_dim:4,width:8,depth:1,out_dim:4,seed:1"


def _mesh_string(ns, mesh):
    custom = MLP4 + (f",mesh:{mesh}" if mesh else "")
    rng = np.random.default_rng(4)
    p = play_feed(ns, (
        f"appsrc name=s caps={caps('4', rate='0/1')} ! tensor_filter "
        f"framework=xla model=mlp {ns.accel}batch=4 custom={custom} ! "
        "tensor_sink name=out"),
        [("s", ns.TB(tensors=[rng.standard_normal(4).astype(np.float32)],
                     pts=i)) for i in range(8)] + [("s", None)])
    return [(b.pts, np.asarray(b.np(0))) for b in p.get("out").results]


@pytest.mark.parametrize("ns", [PORT, JAX], ids=["port", "jax"])
def test_mesh_dp1_is_the_plain_filter(ns):
    """In each package ``mesh:dp=1`` serves exactly what the plain
    filter serves (the packages' MLP draws differ, so each is held to
    its own plain run)."""
    plain = _mesh_string(ns, None)
    assert [sig(x) for x in _mesh_string(ns, "dp=1")] == \
        [sig(x) for x in plain]
    assert [p for p, _ in plain] == list(range(8))


@pytest.mark.parametrize("spec", ["tp=2", "dp=x", "dp=0", "dp=-3"])
def test_mesh_spec_errors_equal_jax(spec):
    from nnstreamer_tpu.filter.backends._jitexec import JitExecMixin
    from nnstreamer_tpu_torch.filter.backends._torchexec import \
        TorchExecMixin

    props = types.SimpleNamespace(custom_properties={"mesh": spec})
    with pytest.raises(JaxFilterError) as want:
        JitExecMixin._resolve_mesh(props, None)
    with pytest.raises(FilterError) as got:
        TorchExecMixin._resolve_mesh(props, __import__("torch").device(
            "cpu"))
    assert str(got.value) == str(want.value)


def test_mesh_needs_as_many_devices_as_dp(jax_cpu_devices):
    """The port sees one CPU device where the JAX tests see 8 virtual
    ones (ROADMAP §C): dp=2 opens on the JAX package and is refused by
    the port with the JAX package's message, as dp=9 is by the JAX
    package."""
    import torch

    from nnstreamer_tpu.filter.backends._jitexec import JitExecMixin
    from nnstreamer_tpu_torch.filter.backends._torchexec import \
        TorchExecMixin

    def props(spec):
        return types.SimpleNamespace(custom_properties={"mesh": spec})

    assert JitExecMixin._resolve_mesh(props("dp=2"),
                                      jax_cpu_devices[0]) is not None
    with pytest.raises(JaxFilterError) as want:
        JitExecMixin._resolve_mesh(props("dp=9"), jax_cpu_devices[0])
    with pytest.raises(FilterError) as got:
        TorchExecMixin._resolve_mesh(props("dp=2"), torch.device("cpu"))
    assert str(want.value) == \
        "mesh:dp=9 but only 8 cpu device(s) visible"
    assert str(got.value) == "mesh:dp=2 but only 1 cpu device(s) visible"
    with pytest.raises(FilterError, match="only 1 cpu device"):
        PORT.FilterSingle(framework="xla", model="mlp",
                          custom=MLP4 + ",mesh:dp=2",
                          accelerator="true:cpu").start()


def test_mesh_without_batch_is_refused_equal_jax():
    def findings(ns):
        p = ns.parse_launch(
            f"appsrc name=s caps={caps('4', rate='0/1')} ! tensor_filter "
            f"name=f framework=xla model=mlp {ns.accel}"
            f"custom={MLP4},mesh:dp=2 ! tensor_sink name=out")
        return [(f.severity, f.rule, f.message)
                for f in ns.verify.verify_pipeline(p)]

    got = both(findings)
    assert any("requires micro-batching" in m for _, _, m in got)
