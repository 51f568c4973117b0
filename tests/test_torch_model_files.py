"""The port's model-file filter backends against the JAX package's, on
the CPU.

Every model file is written at test time by ``tests/torch_model_files.py``
from seeded numpy (TorchScript: a trace of the port's own seeded
MobileNetV2), and goes through the JAX package's ``FilterSingle`` and the
port's (``accelerator=true:cpu``) on the same seeded inputs:
``get_model_info`` must be equal and the outputs within these bounds:

- float32 graphs (TFLite float, TensorFlow, Caffe2, MXNet, TorchScript):
  ``F32_ATOL`` absolute on softmax probabilities and logits of unit
  scale;
- quantized TFLite in float emulation, ``w8`` and native ``int8``: the
  uint8 outputs EQUAL (a requantization that lands on a rounding
  boundary may move one step: at most ``QUANT_STEP_SHARE`` of the
  elements by one step, none by more);
- bf16 (``compute:bfloat16``): the port's f32 path within
  0.05 + 0.05*|x|, external dtypes and shapes unchanged.

Then the conformance suite of ``tests/test_backend_conformance.py``
stamped over the port's backends, and ``framework=auto``'s resolution.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from nnstreamer_tpu.filter.single import FilterSingle as JaxSingle
from nnstreamer_tpu_torch.filter.framework import (Accelerator, FilterError,
                                                   FilterProperties,
                                                   detect_framework,
                                                   find_filter)
from nnstreamer_tpu_torch.filter.single import FilterSingle
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsInfo
from nnstreamer_tpu_torch.tensor.types import TensorType

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_model_files as mf  # noqa: E402

F32_ATOL = 2e-5
QUANT_STEP_SHARE = 0.02

#: the small MobileNetV2 of these tests: 3 stages (one residual ADD),
#: width 0.35, 32x32 frames, 11 classes
MNV2_SMALL = dict(width=0.35, size=32, classes=11, stages=3)


def _info(*specs):
    return TensorsInfo([TensorInfo(name=n, dtype=TensorType.from_string(d),
                                   dims=dims) for n, d, dims in specs])


def _jax_info(*specs):
    from nnstreamer_tpu.tensor.info import TensorInfo as JI
    from nnstreamer_tpu.tensor.info import TensorsInfo as JIs
    from nnstreamer_tpu.tensor.types import TensorType as JT

    return JIs([JI(name=n, dtype=JT.from_string(d), dims=dims)
                for n, d, dims in specs])


def _run_both(framework, model, xs, specs=None, custom=None,
              out_specs=None):
    """(jax outputs, port outputs, jax info, port info) on the CPU."""
    kw = {}
    jkw = {}
    if specs:
        kw["input_info"] = _info(*specs)
        jkw["input_info"] = _jax_info(*specs)
    if out_specs:
        kw["output_info"] = _info(*out_specs)
        jkw["output_info"] = _jax_info(*out_specs)
    with JaxSingle(framework=framework, model=model, custom=custom,
                   accelerator="true:cpu", **jkw) as j:
        jo = [np.asarray(o) for o in j.invoke(xs)]
        jinfo = (str(j.input_info), str(j.output_info))
    with FilterSingle(framework=framework, model=model, custom=custom,
                      accelerator="true:cpu", **kw) as p:
        po = p.invoke(xs)
        pinfo = (str(p.input_info), str(p.output_info))
    return jo, po, jinfo, pinfo


def _frames(n, size, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def mnv2_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("mnv2")
    return {
        "quant": mf.mobilenet_v2_tflite(str(d / "q.tflite"), True,
                                        **MNV2_SMALL),
        "float": mf.mobilenet_v2_tflite(str(d / "f.tflite"), False,
                                        **MNV2_SMALL),
    }


def _assert_quant_close(jo, po):
    a = jo.astype(np.int32)
    b = po.astype(np.int32)
    diff = np.abs(a - b)
    assert diff.max() <= 1, f"max quant-step diff {diff.max()}"
    assert (diff > 0).mean() <= QUANT_STEP_SHARE


class TestTFLiteMobileNetV2:
    def test_float_file_matches_jax(self, mnv2_files):
        x = _frames(1, MNV2_SMALL["size"])
        jo, po, ji, pi = _run_both("tensorflow-lite", mnv2_files["float"],
                                   [x[0][None]], custom="compute:float32")
        assert ji == pi
        assert po[0].dtype == np.float32 and po[0].shape == (1, 11)
        np.testing.assert_allclose(po[0], jo[0], atol=F32_ATOL)

    @pytest.mark.parametrize("mode", ["float32", "int8", "w8"])
    def test_quant_file_matches_jax(self, mnv2_files, mode):
        x = _frames(1, MNV2_SMALL["size"], seed=3)
        jo, po, ji, pi = _run_both("tensorflow-lite", mnv2_files["quant"],
                                   [x[0][None]], custom=f"compute:{mode}")
        assert ji == pi
        assert po[0].dtype == np.uint8
        _assert_quant_close(jo[0], po[0])

    def test_int8_routes_cover_every_product(self, mnv2_files):
        with FilterSingle(framework="tflite", model=mnv2_files["quant"],
                          custom="compute:int8",
                          accelerator="true:cpu") as p:
            routes = p.fw.routes
        kinds = {(k, r) for _, k, r in routes}
        # stem and depthwise in f32, every 1x1 and the head as int_mm
        assert ("conv", "f32") in kinds and ("dw", "f32") in kinds
        assert ("conv", "int_mm") in kinds
        layers = mf.mnv2_layers(MNV2_SMALL["width"], MNV2_SMALL["classes"],
                                MNV2_SMALL["stages"])
        assert len(routes) == sum(1 for layer in layers
                                  if layer["kind"] in ("conv", "dw", "head"))

    def test_batched_equals_per_frame(self, mnv2_files):
        """A bucket through the batched forward (vmap over the frame axis
        and the native products' folded batch) equals each frame's own
        invoke: int8 exactly, f32 within F32_ATOL."""
        from nnstreamer_tpu_torch.filter.backends.tflite import TFLiteFilter

        x = _frames(5, MNV2_SMALL["size"], seed=9)
        for path, mode in ((mnv2_files["quant"], "int8"),
                           (mnv2_files["float"], "float32")):
            fw = TFLiteFilter()
            fw.open(FilterProperties(
                framework="tflite", model=path,
                accelerators=[Accelerator.CPU],
                custom_properties={"compute": mode}))
            try:
                handle = fw.invoke_batched([[f[None]] for f in x], 8)
                rows = handle.wait()
                for i, f in enumerate(x):
                    one = fw.invoke([f[None]])[0].numpy()
                    if mode == "int8":
                        np.testing.assert_array_equal(rows[i][0], one)
                    else:
                        np.testing.assert_allclose(rows[i][0], one,
                                                   atol=F32_ATOL)
            finally:
                fw.close()

    @pytest.mark.parametrize("batch", [1, 8])
    def test_flagship_string_compiles_once_a_signature(self, mnv2_files,
                                                       batch):
        """The flagship string with the filter swapped: the converter's
        frames reach the filter in the model's declared shape, so the
        stream dispatches only the signatures of the open and of the
        pushdown (per frame and batched), not one more for the frames'
        own shape."""
        from nnstreamer_tpu_torch import parse_launch
        from nnstreamer_tpu_torch.analysis import compileledger

        size = MNV2_SMALL["size"]
        stage = (f"tensor_filter framework=tensorflow-lite "
                 f"model={mnv2_files['quant']} accelerator=true:cpu "
                 f"custom=compute:int8"
                 + (f" batch={batch} ! queue" if batch > 1 else ""))
        p = parse_launch(
            f"videotestsrc num-buffers=16 pattern=random seed=1 ! "
            f"video/x-raw,format=RGB,width={size},height={size},"
            f"framerate=30/1 ! tensor_converter ! {stage} ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")
        was = compileledger.ENABLED
        compileledger.configure(True)
        compileledger.reset()
        try:
            p.run(timeout=120)
            ledger = compileledger.snapshot()
        finally:
            compileledger.configure(was)
        assert len(p.get("out").results) == 16
        if batch == 1:
            assert ledger == {"filter.jitexec.invoke": 2}
        else:
            # the pushdown takes over between buckets, so a short stream
            # may end before it does: one or two signatures a site, never
            # one a bucket shape the open did not compile
            assert set(ledger) == {"filter.jitexec.invoke",
                                   "filter.jitexec.vmap"}
            assert all(n <= 2 for n in ledger.values()), ledger

    def test_bf16_keeps_contract(self, mnv2_files):
        x = _frames(1, MNV2_SMALL["size"], seed=4)
        with FilterSingle(framework="tflite", model=mnv2_files["float"],
                          custom="compute:float32",
                          accelerator="true:cpu") as p:
            ref = p.invoke([x[0][None]])[0]
        with FilterSingle(framework="tflite", model=mnv2_files["float"],
                          custom="compute:bfloat16",
                          accelerator="true:cpu") as p:
            got = p.invoke([x[0][None]])[0]
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.all(np.abs(got - ref) <= 0.05 + 0.05 * np.abs(ref))

    def test_auto_on_cpu_is_float32(self, mnv2_files):
        from nnstreamer_tpu_torch.filter.backends.tflite import (
            QUANT_AUTO_GPU, TFLiteFilter)

        fw = TFLiteFilter.__new__(TFLiteFilter)
        fw._graph = type("G", (), {"tensors": [type(
            "T", (), {"quantized": True})()]})()
        props = FilterProperties(framework="tflite", model="x")
        assert fw._compute_mode(props, torch.device("cpu")) == \
            (None, False, False)
        assert fw._compute_mode(props, torch.device("cuda")) == \
            (None, True, False)
        assert QUANT_AUTO_GPU == "int8"

    def test_unknown_compute_mode_errors(self, mnv2_files):
        with pytest.raises(FilterError, match="unknown compute dtype"):
            FilterSingle(framework="tflite", model=mnv2_files["float"],
                         custom="compute:fp8",
                         accelerator="true:cpu").start()


class TestLeNetFormats:
    """TensorFlow GraphDef, Caffe2 NetDef and MXNet symbol+params of one
    seeded LeNet-5 through both packages; the three agree with each
    other too (same weights, same function)."""

    @pytest.fixture(scope="class")
    def files(self, tmp_path_factory):
        d = tmp_path_factory.mktemp("lenet")
        return {"pb": mf.lenet_graphdef(str(d / "lenet.pb")),
                "caffe2": mf.lenet_caffe2(str(d)),
                "mxnet": mf.lenet_mxnet(str(d))}

    def _x(self, nchw):
        x = np.random.default_rng(5).random((1, 28, 28, 1), np.float32)
        return x.transpose(0, 3, 1, 2).copy() if nchw else x

    def test_tensorflow(self, files):
        jo, po, ji, pi = _run_both("tensorflow", files["pb"],
                                   [self._x(False)],
                                   custom="compute:float32")
        assert ji == pi
        np.testing.assert_allclose(po[0], jo[0], atol=F32_ATOL)

    def test_caffe2(self, files):
        spec = [("data", "float32", (28, 28, 1, 1))]
        jo, po, ji, pi = _run_both("caffe2", files["caffe2"],
                                   [self._x(True)], specs=spec,
                                   custom="compute:float32")
        assert ji == pi
        np.testing.assert_allclose(po[0], jo[0], atol=F32_ATOL)

    def test_mxnet(self, files):
        spec = [("data", "float32", (28, 28, 1, 1))]
        jo, po, ji, pi = _run_both("mxnet", files["mxnet"], [self._x(True)],
                                   specs=spec, custom="compute:float32")
        assert ji == pi
        np.testing.assert_allclose(po[0], jo[0], atol=F32_ATOL)

    def test_formats_agree(self, files):
        outs = []
        for fw, model, nchw in (("tensorflow", files["pb"], False),
                                ("caffe2", files["caffe2"], True),
                                ("mxnet", files["mxnet"], True)):
            kw = {}
            if nchw:
                kw["input_info"] = _info(("data", "float32", (28, 28, 1, 1)))
            with FilterSingle(framework=fw, model=model,
                              accelerator="true:cpu", **kw) as p:
                outs.append(p.invoke([self._x(nchw)])[0].reshape(-1))
        for o in outs[1:]:
            np.testing.assert_allclose(o, outs[0], atol=F32_ATOL)

    @pytest.mark.parametrize("fw", ["tensorflow", "caffe2", "mxnet"])
    def test_bf16_keeps_contract(self, files, fw):
        nchw = fw != "tensorflow"
        model = files["pb" if fw == "tensorflow" else fw]
        kw = {"input_info": _info(("data", "float32", (28, 28, 1, 1)))} \
            if nchw else {}
        res = {}
        for mode in ("float32", "bfloat16"):
            with FilterSingle(framework=fw, model=model, custom=f"compute:"
                              f"{mode}", accelerator="true:cpu", **kw) as p:
                res[mode] = p.invoke([self._x(nchw)])[0]
        ref, got = res["float32"], res["bfloat16"]
        assert got.dtype == ref.dtype == np.float32
        assert got.shape == ref.shape
        assert np.all(np.abs(got - ref) <= 0.05 + 0.05 * np.abs(ref))


def _unsupported_files(d):
    """One graph per format whose only op no backend lowers."""
    pb = str(d / "bad.pb")
    with open(pb, "wb") as f:
        f.write(mf.pb_graph(
            mf.pb_node("x", "Placeholder", (), dtype=("type", 1),
                       shape=("shape", (1, 4))),
            mf.pb_node("y", "FancyOp", ("x",))))
    init, pred = str(d / "bad_init.pb"), str(d / "bad_pred.pb")
    with open(init, "wb") as f:
        f.write(mf._c2_net("init", []))
    with open(pred, "wb") as f:
        f.write(mf._c2_net("pred", [mf._c2_op("FancyOp", ["data"],
                                              ["y"])], ["data"], ["y"]))
    sym = d / "bad.json"
    sym.write_text(json.dumps({"nodes": [
        {"op": "null", "name": "data", "attrs": {}, "inputs": []},
        {"op": "FancyOp", "name": "y", "attrs": {}, "inputs": [[0, 0, 0]]}],
        "heads": [[1, 0, 0]]}))
    from nnstreamer_tpu_torch.filter.backends.mxnet import save_params

    save_params(str(d / "bad.params"), {})
    spec = [("data", "float32", (4, 1))]
    return {"tensorflow": (pb, None), "caffe2": (f"{init},{pred}", spec),
            "mxnet": (str(sym), spec)}


def test_audio_front_end_matches_jax(tmp_path):
    """AudioSpectrogram -> Mfcc (``ops/audio.py``) as a GraphDef through
    both packages on one seeded second of audio: f32 within F32_ATOL
    times the largest coefficient (the FFTs differ in summation
    order)."""
    pb = str(tmp_path / "mfcc.pb")
    with open(pb, "wb") as f:
        f.write(mf.pb_graph(
            mf.pb_node("audio", "Placeholder", (), dtype=("type", 1),
                       shape=("shape", (16000, 1))),
            mf.pb_node("spec", "AudioSpectrogram", ("audio",),
                       window_size=("i", 480), stride=("i", 160),
                       magnitude_squared=("b", True)),
            mf.pb_node("mfcc", "Mfcc", ("spec",),
                       dct_coefficient_count=("i", 13))))
    x = (np.random.default_rng(8).random((16000, 1), np.float32) - 0.5)
    jo, po, ji, pi = _run_both("tensorflow", pb, [x],
                               custom="compute:float32")
    assert ji == pi
    scale = float(np.abs(jo[0]).max())
    np.testing.assert_allclose(po[0], jo[0], atol=F32_ATOL * scale)


def test_decode_wav_hoist_matches_jax(tmp_path):
    """DecodeWav -> AudioSpectrogram -> Mfcc on a wav file's bytes: the
    decode runs on the host before the forward, as in the JAX package."""
    import struct

    rng = np.random.default_rng(9)
    pcm = rng.integers(-8000, 8000, 16000).astype(np.int16)
    data = pcm.tobytes()
    wav = (b"RIFF" + struct.pack("<I", 36 + len(data)) + b"WAVE"
           + b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, 16000, 32000, 2,
                                   16)
           + b"data" + struct.pack("<I", len(data)) + data)
    pb = str(tmp_path / "wav.pb")
    with open(pb, "wb") as f:
        f.write(mf.pb_graph(
            mf.pb_node("wav", "Placeholder", (), dtype=("type", 7)),
            mf.pb_node("decode", "DecodeWav", ("wav",),
                       desired_channels=("i", 1),
                       desired_samples=("i", 16000)),
            mf.pb_node("spec", "AudioSpectrogram", ("decode:0",),
                       window_size=("i", 480), stride=("i", 160),
                       magnitude_squared=("b", True)),
            mf.pb_node("mfcc", "Mfcc", ("spec", "decode:1"))))
    blob = np.frombuffer(wav, np.uint8).copy()
    jo, po, ji, pi = _run_both("tensorflow", pb, [blob],
                               specs=[("wav", "uint8", (len(wav),))],
                               custom="compute:float32")
    assert ji == pi
    scale = float(np.abs(jo[0]).max())
    np.testing.assert_allclose(po[0], jo[0], atol=F32_ATOL * scale)


@pytest.mark.parametrize("fw", ["tensorflow", "caffe2", "mxnet"])
def test_unsupported_op_same_message(tmp_path, fw):
    model, spec = _unsupported_files(tmp_path)[fw]
    msgs = []
    for single, info in ((JaxSingle, _jax_info), (FilterSingle, _info)):
        kw = {"input_info": info(*spec)} if spec else {}
        with pytest.raises(Exception) as err:
            single(framework=fw, model=model, accelerator="true:cpu",
                   **kw).start()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert "FancyOp" in msgs[1]


class TestTorchScript:
    def test_mobilenet_trace_matches_jax_and_the_xla_model(self, tmp_path):
        """The traced port MobileNetV2 through ``framework=pytorch``: the
        JAX backend's lowering and the port's native run agree, and both
        equal the port's registry model at the same seed."""
        path = mf.mobilenet_v2_torchscript(str(tmp_path / "m.pt"),
                                           width=1.0, size=32, classes=11)
        x = _frames(1, 32, seed=6)[0]
        spec = [("frame", "uint8", (3, 32, 32))]
        jo, po, ji, pi = _run_both("pytorch", path, [x], specs=spec)
        assert ji == pi
        np.testing.assert_allclose(po[0], jo[0], atol=1e-4)
        with FilterSingle(framework="xla", model="mobilenet_v2",
                          custom="seed:0,num_classes:11,input_size:32",
                          accelerator="true:cpu") as p:
            ref = p.invoke([x])[0]
        np.testing.assert_allclose(po[0], ref, atol=1e-4)

    def test_executor_torch_runs_on_the_filters_device(self, tmp_path):
        mod = torch.jit.script(torch.nn.Linear(4, 2))
        path = str(tmp_path / "tiny.pt")
        mod.save(path)
        info = _info(("x", "float32", (4, 1)))
        x = np.arange(4, dtype=np.float32)[None]
        outs = {}
        for custom in (None, "executor:torch"):
            with FilterSingle(framework="pytorch", model=path,
                              input_info=info, custom=custom,
                              accelerator="true:cpu") as p:
                outs[custom] = p.invoke([x])[0]
                assert p.fw.executor == ("torch" if custom else "torchexec")
                assert p.fw.fallback_reason == ""
        np.testing.assert_array_equal(outs[None], outs["executor:torch"])

    def test_declared_output_mismatch_raises_and_reprobe(self, tmp_path):
        mod = torch.jit.script(torch.nn.Linear(4, 2))
        path = str(tmp_path / "tiny.pt")
        mod.save(path)
        with pytest.raises(FilterError, match="declared output"):
            FilterSingle(framework="pytorch", model=path,
                         input_info=_info(("x", "float32", (4, 1))),
                         output_info=_info(("y", "float32", (3, 1))),
                         accelerator="true:cpu").start()
        with FilterSingle(framework="pytorch", model=path,
                          input_info=_info(("x", "float32", (4, 1))),
                          accelerator="true:cpu") as p:
            out = p.set_input_info(_info(("x", "float32", (4, 3))))
            assert out[0].np_shape == (3, 2)

    def test_requires_input_info(self, tmp_path):
        mod = torch.jit.script(torch.nn.Linear(4, 2))
        path = str(tmp_path / "tiny.pt")
        mod.save(path)
        with pytest.raises(FilterError, match="input_info required"):
            FilterSingle(framework="pytorch", model=path,
                         accelerator="true:cpu").start()

    def test_constant_pinned_to_another_device_is_refused(self):
        """A graph constant on another device than the filter's is
        refused by node, never run there unseen."""
        from nnstreamer_tpu_torch.filter.backends.pytorch import check_device
        from nnstreamer_tpu_torch.filter.torchscript import \
            UnsupportedTorchOp

        class Pinned(torch.nn.Module):
            def forward(self, x):
                return x + torch.ones(4, device=torch.device("cpu"))

        graph = torch.jit.freeze(torch.jit.script(Pinned()).eval()).graph
        check_device(graph, torch.device("cpu"))
        with pytest.raises(UnsupportedTorchOp, match="pins cpu"):
            check_device(graph, torch.device("cuda"))

    def test_scalar_shape_constants_of_a_cpu_trace_are_allowed(self,
                                                                tmp_path):
        """The CPU trace of MobileNetV2 records its SAME-padding
        arithmetic with 0-dim host tensors: scalars to any device's ops,
        which pin nothing; a host tensor of data or a host device does."""
        from nnstreamer_tpu_torch.filter.backends.pytorch import \
            pinned_elsewhere

        path = mf.mobilenet_v2_torchscript(str(tmp_path / "m.pt"),
                                           width=0.35, size=32, classes=11)
        graph = torch.jit.freeze(
            torch.jit.load(path, map_location="cpu").eval()).graph
        values = [n.output().toIValue()
                  for n in graph.findAllNodes("prim::Constant")
                  if isinstance(n.output().type(), torch._C.TensorType)]
        scalars = [v for v in values
                   if isinstance(v, torch.Tensor) and v.dim() == 0]
        assert scalars
        cuda = torch.device("cuda")
        assert all(pinned_elsewhere(v, cuda) is None for v in scalars)
        assert pinned_elsewhere(torch.ones(4), cuda) == torch.device("cpu")
        assert pinned_elsewhere(torch.device("cpu"), cuda) == \
            torch.device("cpu")
        assert pinned_elsewhere(torch.ones(4), torch.device("cpu")) is None


# ---------------------------------------------------------------------------
# the conformance suite over the port's backends
# ---------------------------------------------------------------------------

def _case_xla(tmp_path):
    return FilterProperties(framework="xla", model="mlp",
                            custom_properties={"features": "4",
                                               "classes": "2"})


def _case_tflite(tmp_path):
    path = str(tmp_path / "add.tflite")
    buf = np.asarray([2.0, 2.0, 2.0, 2.0], np.float32)
    data = mf.tflite_bytes(
        [{"shape": (1, 4), "dtype": np.float32, "name": "x"},
         {"shape": (1, 4), "dtype": np.float32, "buffer": 1},
         {"shape": (1, 4), "dtype": np.float32, "name": "y"}],
        [{"code": 0, "inputs": [0, 1], "outputs": [2]}], [0], [2],
        [b"", buf.tobytes()])
    with open(path, "wb") as f:
        f.write(data)
    return FilterProperties(framework="tensorflow-lite", model=path)


def _case_tensorflow(tmp_path):
    path = str(tmp_path / "lenet.pb")
    mf.lenet_graphdef(path)
    return FilterProperties(framework="tensorflow", model=path)


def _case_pytorch(tmp_path):
    mod = torch.jit.script(torch.nn.Linear(4, 2))
    path = str(tmp_path / "tiny.pt")
    mod.save(path)
    return FilterProperties(framework="pytorch", model=path,
                            input_info=_info(("x", "float32", (4, 1))))


def _case_caffe2(tmp_path):
    return FilterProperties(
        framework="caffe2", model=mf.lenet_caffe2(str(tmp_path)),
        input_info=_info(("data", "float32", (28, 28, 1, 1))))


def _case_mxnet(tmp_path):
    return FilterProperties(
        framework="mxnet", model=mf.lenet_mxnet(str(tmp_path)),
        input_info=_info(("data", "float32", (28, 28, 1, 1))))


def _case_python(tmp_path):
    script = tmp_path / "passthrough.py"
    script.write_text(
        "import numpy as np\n"
        "class CustomFilter:\n"
        "    def getInputDim(self):\n"
        "        return [((4, 1), 'float32')]\n"
        "    def getOutputDim(self):\n"
        "        return [((4, 1), 'float32')]\n"
        "    def invoke(self, inputs):\n"
        "        return [inputs[0]]\n")
    return FilterProperties(framework="python", model=str(script))


def _case_custom_easy(tmp_path):
    from nnstreamer_tpu_torch.filter.backends.custom import (
        register_custom_easy, unregister_custom_easy)

    name = "torch_conformance_easy"
    unregister_custom_easy(name)
    register_custom_easy(
        name, lambda ins: [np.asarray(ins[0]) * 2.0],
        _info(("x", "float32", (4, 1))), _info(("y", "float32", (4, 1))))
    return FilterProperties(framework="custom-easy", model=name)


def _case_lua(tmp_path):
    script = tmp_path / "pass.lua"
    script.write_text(
        "inputTensorsInfo = {num=1, dim={{4, 1}}, type={'float32'}}\n"
        "outputTensorsInfo = {num=1, dim={{4, 1}}, type={'float32'}}\n"
        "function nnstreamer_invoke()\n"
        "  input = input_tensor(1)\n"
        "  output = output_tensor(1)\n"
        "  for i=1,4 do output[i] = input[i] end\n"
        "end\n")
    return FilterProperties(framework="lua", model=str(script))


def _case_dummy(tmp_path):
    return FilterProperties(
        framework="dummy",
        input_info=_info(("x", "float32", (4, 1))),
        output_info=_info(("y", "float32", (4, 1))))


CASES = {
    "xla": _case_xla,
    "tensorflow-lite": _case_tflite,
    "tensorflow": _case_tensorflow,
    "pytorch": _case_pytorch,
    "caffe2": _case_caffe2,
    "mxnet": _case_mxnet,
    "python": _case_python,
    "lua": _case_lua,
    "custom-easy": _case_custom_easy,
    "custom-dummy": _case_dummy,
}

#: device backends take the CPU only when asked
_CPU = {"xla", "tensorflow-lite", "tensorflow", "pytorch", "caffe2",
        "mxnet"}


def _make(tmp_path, backend):
    from nnstreamer_tpu_torch.filter.framework import Accelerator

    props = CASES[backend](tmp_path)
    if backend in _CPU:
        props = dataclasses.replace(props, accelerators=[Accelerator.CPU])
    return find_filter(props.framework)(), props


@pytest.fixture(params=sorted(CASES))
def backend(request):
    return request.param


class TestPortBackendConformance:
    def test_lifecycle_and_invoke(self, tmp_path, backend):
        fw, props = _make(tmp_path, backend)
        fw.open(props)
        try:
            in_info, out_info = fw.get_model_info()
            assert in_info.num_tensors >= 1 and out_info.num_tensors >= 1
            assert in_info.is_valid() and out_info.is_valid()
            zeros = [np.zeros(i.np_shape, i.np_dtype) for i in in_info]
            outs = fw.invoke(zeros)
            assert len(outs) == out_info.num_tensors
            for o, oi in zip(outs, out_info):
                assert tuple(o.shape) == oi.np_shape
        finally:
            fw.close()

    def test_reopen_after_close(self, tmp_path, backend):
        fw, props = _make(tmp_path, backend)
        fw.open(props)
        fw.close()
        fw.close()  # idempotent
        fw.open(props)
        try:
            in_info, _ = fw.get_model_info()
            fw.invoke([np.zeros(i.np_shape, i.np_dtype) for i in in_info])
        finally:
            fw.close()

    def test_model_info_before_open_errors(self, tmp_path, backend):
        fw, _ = _make(tmp_path, backend)
        with pytest.raises((FilterError, Exception)):
            in_info, out_info = fw.get_model_info()
            assert in_info is not None and in_info.num_tensors >= 1

    def test_invalid_model_errors(self, tmp_path, backend):
        if backend == "custom-dummy":
            with pytest.raises(FilterError):
                _make(tmp_path, backend)[0].open(
                    FilterProperties(framework="dummy"))
            return
        fw, props = _make(tmp_path, backend)
        if backend in ("custom-easy", "xla"):
            bad_model = "no-such-registered-model"
        else:
            bad_model = str(tmp_path / ("nope.lua" if backend == "lua"
                                        else "nope.model"))
        with pytest.raises(FilterError):
            type(fw)().open(dataclasses.replace(props, model=bad_model))

    BF16_BACKENDS = ("tensorflow-lite", "tensorflow", "caffe2", "mxnet")

    def test_bf16_compute_mode_preserves_contract(self, tmp_path, backend):
        if backend not in self.BF16_BACKENDS:
            pytest.skip("compute prop applies to model-file backends")
        fw, props = _make(tmp_path, backend)
        fw.open(props)
        try:
            ii, _ = fw.get_model_info()
            rng = np.random.default_rng(0)
            xs = [(rng.random(i.np_shape) * 2 - 1).astype(i.np_dtype)
                  for i in ii]
            ref = [o.numpy() for o in fw.invoke(xs)]
        finally:
            fw.close()
        props2 = dataclasses.replace(
            props, custom_properties=dict(props.custom_properties,
                                          compute="bfloat16"))
        fw2 = type(fw)()
        fw2.open(props2)
        try:
            outs = [o.numpy() for o in fw2.invoke(xs)]
            for o, r in zip(outs, ref):
                assert o.dtype == r.dtype and o.shape == r.shape
                assert np.all(np.abs(o - r) <= 0.05 + 0.05 * np.abs(r))
        finally:
            fw2.close()


class TestAutoDetect:
    """``framework=auto`` resolves the same models to the same names in
    both packages."""

    def test_same_names(self, tmp_path):
        from nnstreamer_tpu.filter.backends.custom import \
            register_custom_easy as jax_register
        from nnstreamer_tpu.filter.backends.custom import \
            unregister_custom_easy as jax_unregister
        from nnstreamer_tpu.filter.framework import \
            detect_framework as jax_detect
        from nnstreamer_tpu_torch.filter.backends.custom import (
            register_custom_easy, unregister_custom_easy)

        (tmp_path / "m.params").write_bytes(b"")
        paths = ["m.tflite", "m.pt", "m.pth", "m.pb", "a.pb,b.pb",
                 str(tmp_path / "m.json"), "m.py", "m.lua",
                 "mobilenet_v2"]
        register_custom_easy("auto_easy", lambda x: x, _info(
            ("x", "float32", (1,))), _info(("x", "float32", (1,))))
        jax_register("auto_easy", lambda x: x, _jax_info(
            ("x", "float32", (1,))), _jax_info(("x", "float32", (1,))))
        try:
            for model in paths + ["auto_easy", lambda xs: xs]:
                assert detect_framework(model) == jax_detect(model), model
        finally:
            unregister_custom_easy("auto_easy")
            jax_unregister("auto_easy")
        assert detect_framework("m.tflite") == "tensorflow-lite"
        assert detect_framework("a.pb,b.pb") == "caffe2"
        assert detect_framework(str(tmp_path / "m.json")) == "mxnet"

    def test_same_registry_as_jax(self):
        from nnstreamer_tpu.filter.framework import \
            list_filters as jax_list
        from nnstreamer_tpu_torch.filter.framework import list_filters

        assert list_filters() == jax_list()
        assert len(list_filters()) == 13

    def test_unknown_framework_is_gone_for_tflite(self):
        assert find_filter("tensorflow-lite").NAME == "tensorflow-lite"
        assert find_filter("tflite").NAME == "tflite"
        assert find_filter("tensorflow2-lite").NAME == "tensorflow2-lite"
