"""The zoo's decoders — bounding_boxes (every scheme), image_segment,
pose_estimation, direct_video, octet_stream, font — on both packages.

Each case runs one launch string through the JAX package and through the
port on the CPU, on the same numpy tensors: the decoded objects, class
maps, keypoints and RGBA canvases must agree.  A decoder's device
reduction pushdown (fused into the upstream filter's forward; mapped over
the bucket under ``torch.func.vmap`` at ``batch>1``) is held to its host
decode (``pushdown=false``) on the same tensors, and the last cases run
the three zoo models themselves, the port carrying the JAX weights.
"""

import numpy as np
import pytest
import torch

import nnstreamer_tpu
import nnstreamer_tpu_torch
from nnstreamer_tpu.models import registry as jax_registry
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu.tensor.info import TensorInfo as JaxInfo
from nnstreamer_tpu.tensor.info import TensorsInfo as JaxInfos
from nnstreamer_tpu.tensor.types import TensorType as JaxType
from nnstreamer_tpu_torch.decoders import find_decoder, list_decoders
from nnstreamer_tpu_torch.models import registry as port_registry
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsInfo
from nnstreamer_tpu_torch.tensor.types import TensorType
from tests.test_torch_vision_zoo import jax_zoo_model, port_zoo_model

CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
        "types=float32,framerate=0/1")
#: decoded floats (scores, corners, keypoints) of the two packages, and of
#: a pushdown against its host decode: f32 device math vs numpy's f64
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# fixed-output models: x (4,) f32 → each base tensor times x[0]
# ---------------------------------------------------------------------------

class _Scaled(torch.nn.Module):
    def __init__(self, bases):
        super().__init__()
        for i, b in enumerate(bases):
            self.register_buffer(f"b{i}", torch.tensor(b))
        self.n = len(bases)

    def forward(self, x):
        return tuple(getattr(self, f"b{i}") * x[0] for i in range(self.n))


def _dims(shape):
    return tuple(reversed(shape))


def register_scaled(name, bases):
    """``name`` in both registries: each output is its base tensor times
    the input's first element (the product is exact in f32 on both)."""
    import jax.numpy as jnp

    bases = [np.asarray(b, np.float32) for b in bases]

    def build_jax(custom):
        def forward(params, x):
            return tuple(jnp.asarray(b) * jnp.asarray(x, jnp.float32)[0]
                         for b in params)

        return jax_registry.Model(
            name=name, forward=forward, params=bases,
            in_info=JaxInfos([JaxInfo(JaxType.FLOAT32, (4,))]),
            out_info=JaxInfos([JaxInfo(JaxType.FLOAT32, _dims(b.shape))
                               for b in bases]))

    def build_port(custom, device=None):
        device = torch.device(device or "cpu")
        return port_registry.Model(
            name=name, module=_Scaled(bases).to(device), device=device,
            in_info=TensorsInfo([TensorInfo(TensorType.FLOAT32, (4,))]),
            out_info=TensorsInfo([TensorInfo(TensorType.FLOAT32,
                                             _dims(b.shape))
                                  for b in bases]))

    jax_registry.register_model(name)(build_jax)
    port_registry._ensure_loaded()
    port_registry.register_model(name)(build_port)


def unregister(*names):
    for name in names:
        jax_registry._MODELS.pop(name, None)
        port_registry._MODELS.pop(name, None)


#: the first input element of each pushed frame: scales every output
SCALES = (1.0, 0.97, 1.03, 0.9, 1.1)


def run(pkg, launch, feeds):
    """Play ``launch`` on package ``pkg``, push ``feeds`` (lists of numpy
    tensors) through ``appsrc name=in``, return the sink's buffers."""
    buffer = JaxBuffer if pkg is nnstreamer_tpu else TensorBuffer
    p = pkg.parse_launch(launch)
    got = []
    p.get("out").connect("new-data", got.append)
    p.play()
    try:
        src = p.get("in")
        for tensors in feeds:
            src.push_buffer(buffer(tensors=list(tensors)))
        src.end_of_stream()
        p.wait(timeout=120)
    finally:
        p.stop()
    assert len(got) == len(feeds)
    return got, p


def filter_launch(model, decoder, batch=1, accel=""):
    return (f"appsrc caps={CAPS} name=in ! tensor_filter framework=xla "
            f"model={model} name=f {accel}batch={batch} ! "
            f"tensor_decoder {decoder} ! tensor_sink name=out")


def scaled_feeds():
    return [[np.array([s, 0, 0, 0], np.float32)] for s in SCALES]


def objects(buf):
    return [(o.class_id, o.label, o.score, o.ymin, o.xmin, o.ymax, o.xmax)
            for o in buf.extra["objects"]]


def assert_objects_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(g[2:], w[2:], atol=TOL, rtol=0)


def run_four(model, decoder, pushdown_form):
    """The string through the JAX package (pushdown on) and the port
    (pushdown on at batch 1 and 4, off at batch 1).  Returns the three
    port runs and the JAX run; checks the port's fused filter announced
    ``pushdown_form`` tensors."""
    jax_run, _ = run(nnstreamer_tpu,
                     filter_launch(model, decoder + " pushdown=true"),
                     scaled_feeds())
    port = {}
    for batch, pd in ((1, "true"), (4, "true"), (1, "false")):
        port[(batch, pd)], p = run(
            nnstreamer_tpu_torch,
            filter_launch(model, f"{decoder} pushdown={pd}", batch,
                          "accelerator=true:cpu "),
            scaled_feeds())
        if pd == "true":
            caps = p.get("f").src_pad.caps.first()
            assert caps.get("num_tensors") == pushdown_form
    return port, jax_run


# ---------------------------------------------------------------------------
# bounding_boxes
# ---------------------------------------------------------------------------

N_SSD, C_SSD = 120, 6


@pytest.fixture(scope="module")
def ssd_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("ssd")
    rng = np.random.default_rng(0)
    priors = d / "priors.txt"
    rows = (rng.random(N_SSD), rng.random(N_SSD), np.full(N_SSD, 0.2),
            np.full(N_SSD, 0.2))
    priors.write_text("".join(" ".join(f"{v:.6f}" for v in r) + "\n"
                              for r in rows))
    labels = d / "labels.txt"
    labels.write_text("".join(f"label{i}\n" for i in range(C_SSD)))
    return str(priors), str(labels)


@pytest.fixture(scope="module")
def ssd_model():
    rng = np.random.default_rng(1)
    boxes = (rng.standard_normal((N_SSD, 4)) * 0.5).astype(np.float32)
    scores = rng.random((N_SSD, C_SSD)).astype(np.float32)
    register_scaled("zoo_ssd", [boxes, scores])
    yield
    unregister("zoo_ssd")


@pytest.mark.parametrize("with_priors", [True, False])
def test_mobilenet_ssd_pushdown(ssd_model, ssd_files, with_priors):
    """mobilenet-ssd: with priors the whole tail (prior decode, threshold,
    top-K, NMS) runs in the filter's forward (4 tensors out), without
    them the per-anchor top class (3 tensors); both equal the host
    decode and the JAX package's, labels and canvases included."""
    priors, labels = ssd_files
    opts = (f"mode=bounding_boxes option1=mobilenet-ssd option2={labels} "
            f"option4=64:48 option5=64:48 option6=0.6"
            + (f" option3={priors}" if with_priors else ""))
    port, jax_run = run_four("zoo_ssd", opts, 4 if with_priors else 3)
    for i in range(len(SCALES)):
        want = objects(jax_run[i])
        assert want                      # something above 0.6 each frame
        for key, bufs in port.items():
            assert_objects_equal(objects(bufs[i]), want)
        np.testing.assert_array_equal(port[(1, "true")][i].np(0),
                                      jax_run[i].np(0))
        np.testing.assert_array_equal(port[(4, "true")][i].np(0),
                                      jax_run[i].np(0))


@pytest.fixture(scope="module")
def yolo_model():
    rng = np.random.default_rng(3)
    pred = rng.random((40, 5 + 3)).astype(np.float32)
    pred[:, :4] *= 80.0     # boxes in input pixels
    register_scaled("zoo_yolo", [pred])
    yield
    unregister("zoo_yolo")


def test_yolov5_pushdown(yolo_model):
    opts = ("mode=bounding_boxes option1=yolov5 option4=100:100 "
            "option5=100:100")
    port, jax_run = run_four("zoo_yolo", opts, 4)
    for i in range(len(SCALES)):
        want = objects(jax_run[i])
        assert want
        for bufs in port.values():
            assert_objects_equal(objects(bufs[i]), want)
        np.testing.assert_array_equal(port[(4, "true")][i].np(0),
                                      jax_run[i].np(0))


@pytest.fixture(scope="module")
def palm_model():
    from nnstreamer_tpu_torch.decoders.boundingbox import BoundingBoxDecoder

    probe = BoundingBoxDecoder()
    probe.set_option(1, "mp-palm-detection")
    n = len(probe._palm_anchor_table())
    rng = np.random.default_rng(4)
    boxes = (rng.standard_normal((n, 18)) * 20).astype(np.float32)
    logits = np.full(n, -10.0, np.float32)
    hot = rng.choice(n, 25, replace=False)
    logits[hot] = rng.standard_normal(25).astype(np.float32) * 2 + 1
    register_scaled("zoo_palm", [boxes, logits])
    yield
    unregister("zoo_palm")


def test_mp_palm_pushdown(palm_model):
    """The palm scheme's sigmoid is computed by each framework's own exp:
    its scores agree within TOL, not bit for bit."""
    opts = ("mode=bounding_boxes option1=mp-palm-detection "
            "option4=100:100 option5=192:192")
    port, jax_run = run_four("zoo_palm", opts, 4)
    for i in range(len(SCALES)):
        want = objects(jax_run[i])
        assert want
        for bufs in port.values():
            assert_objects_equal(objects(bufs[i]), want)


def decode_both(caps, props, tensors):
    """One buffer through ``appsrc ! tensor_decoder ! tensor_sink`` on
    both packages; returns (port buffer, JAX buffer)."""
    opts = " ".join(f"{k}={v}" for k, v in props.items())
    launch = (f"appsrc caps={caps} name=in ! tensor_decoder {opts} ! "
              "tensor_sink name=out")
    (got,), _ = run(nnstreamer_tpu_torch, launch, [tensors])
    (want,), _ = run(nnstreamer_tpu, launch, [tensors])
    return got, want


def tcaps(dims, types, n=1):
    return (f"other/tensors,format=static,num_tensors={n},dimensions={dims},"
            f"types={types},framerate=30/1")


def _host_scheme_cases():
    ssd_pp = [np.array([2.0], np.float32),
              np.array([7, 3, 0], np.float32),
              np.array([0.9, 0.2, 0.0], np.float32),
              np.array([[0.1, 0.2, 0.5, 0.6], [0.0, 0.0, 1.0, 1.0],
                        [0, 0, 0, 0]], np.float32)]
    ov = np.zeros((200, 7), np.float32)
    ov[0] = [0, 1, 0.95, 0.1, 0.2, 0.4, 0.6]
    ov[1] = [0, 1, 0.5, 0.0, 0.0, 1.0, 1.0]
    ov[2] = [0, 1, 0.85, 0.5, 0.5, 0.9, 0.9]
    ov[3] = [-1, 0, 0, 0, 0, 0, 0]
    ov[4] = [0, 1, 0.99, 0.0, 0.0, 1.0, 1.0]
    rng = np.random.default_rng(7)
    raw = np.concatenate([rng.integers(0, 3, (30, 1)),
                          rng.random((30, 1)),
                          rng.random((30, 2)) * 0.5,
                          0.5 + rng.random((30, 2)) * 0.5],
                         axis=1).astype(np.float32)
    return {
        "mobilenet-ssd-postprocess": (
            tcaps("1.3.3.4:3", "float32.float32.float32.float32", n=4),
            {"option3": ",50", "option4": "100:100"}, ssd_pp),
        "tf-ssd": (
            tcaps("1.3.3.4:3", "float32.float32.float32.float32", n=4),
            {"option4": "64:64"}, ssd_pp),
        "ov-person-detection": (tcaps("7:200", "float32"),
                                {"option4": "64:64"}, [ov]),
        "ov-face-detection": (tcaps("7:200", "float32"),
                              {"option4": "64:64", "option6": "0.9"}, [ov]),
        "raw": (tcaps("6:30", "float32"), {"option4": "80:60"}, [raw]),
    }


@pytest.mark.parametrize("scheme", sorted(_host_scheme_cases()))
def test_host_schemes_match_jax(scheme, ssd_files):
    """The schemes decoded on the host (no pushdown): objects and RGBA
    canvases equal to the JAX package's, labels drawn above the boxes."""
    caps, props, tensors = _host_scheme_cases()[scheme]
    props = dict(props, mode="bounding_boxes", option1=scheme,
                 option2=ssd_files[1])
    got, want = decode_both(caps, props, tensors)
    assert objects(got) == objects(want) and objects(want)
    np.testing.assert_array_equal(got.np(0), want.np(0))


def test_decoders_registered():
    assert list_decoders() == ["bounding_boxes", "direct_video",
                               "flatbuf", "flexbuf", "font",
                               "image_labeling", "image_segment",
                               "octet_stream", "pose_estimation",
                               "protobuf", "python3"]
    for alias, scheme in [("tflite-ssd", "mobilenet-ssd"),
                          ("tf-ssd", "mobilenet-ssd-postprocess"),
                          ("ov-face-detection", "ov-person-detection")]:
        dec = find_decoder("bounding_boxes")()
        dec.set_option(1, alias)
        assert dec.scheme == scheme


def test_ssd_device_buffer_without_pushdown(ssd_files):
    """A device (torch) buffer that reaches the decoder unreduced is
    reduced where it lies; the objects equal the numpy buffer's, and
    leading unit dims are stripped on both."""
    rng = np.random.default_rng(9)
    boxes = (rng.standard_normal((1, N_SSD, 4)) * 0.5).astype(np.float32)
    scores = rng.random((1, N_SSD, C_SSD)).astype(np.float32)
    dec = find_decoder("bounding_boxes")()
    dec.set_option(3, ssd_files[0])
    host = dec.decode(TensorBuffer(tensors=[boxes, scores]), None)
    dev = dec.decode(TensorBuffer(tensors=[torch.from_numpy(boxes),
                                           torch.from_numpy(scores)]), None)
    assert objects(host) and objects(dev) == objects(host)
    np.testing.assert_array_equal(dev.np(0), host.np(0))


# ---------------------------------------------------------------------------
# image_segment and pose_estimation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seg_model():
    rng = np.random.default_rng(11)
    scores = rng.standard_normal((9, 7, 5)).astype(np.float32)
    scores[0, 0, :] = 0.5                      # an exact tie: class 0 wins
    register_scaled("zoo_seg", [scores])
    yield scores
    unregister("zoo_seg")


def test_image_segment_pushdown(seg_model):
    """The class-axis argmax in the filter's forward (an int32 (9, 7) map
    crosses): class maps and canvases equal the host decode's and the
    JAX package's exactly, the first maximal class winning a tie."""
    port, jax_run = run_four("zoo_seg", "mode=image_segment", 1)
    for i, s in enumerate(SCALES):
        want = jax_run[i].extra["class_map"]
        np.testing.assert_array_equal(
            want, np.argmax(seg_model * np.float32(s), axis=-1))
        for bufs in port.values():
            assert bufs[i].extra["class_map"].dtype == np.int32
            np.testing.assert_array_equal(bufs[i].extra["class_map"], want)
            np.testing.assert_array_equal(bufs[i].np(0), jax_run[i].np(0))
    assert (port[(1, "true")][0].extra["class_map"][0, 0]) == 0


def test_image_segment_device_buffer_and_classmap():
    """A torch score buffer (leading unit dim) is argmaxed where it lies;
    an integer map passes as a class map; both as the numpy buffers."""
    rng = np.random.default_rng(12)
    scores = rng.standard_normal((1, 6, 4, 3)).astype(np.float32)
    dec = find_decoder("image_segment")()
    host = dec.decode(TensorBuffer(tensors=[scores]), None)
    dev = dec.decode(TensorBuffer(tensors=[torch.from_numpy(scores)]), None)
    np.testing.assert_array_equal(dev.extra["class_map"],
                                  host.extra["class_map"])
    np.testing.assert_array_equal(dev.np(0), host.np(0))
    cmap = torch.from_numpy(host.extra["class_map"])
    out = dec.decode(TensorBuffer(tensors=[cmap]), None)
    np.testing.assert_array_equal(out.np(0), host.np(0))


@pytest.fixture(scope="module")
def pose_model():
    rng = np.random.default_rng(13)
    heat = rng.random((9, 7, 17)).astype(np.float32)
    offs = (rng.standard_normal((9, 7, 34)) * 4).astype(np.float32)
    register_scaled("zoo_pose", [heat, offs])
    yield
    unregister("zoo_pose")


def test_pose_pushdown(pose_model):
    """Heatmap argmax and offset refinement in the filter's forward (a
    (17, 3) table crosses): keypoints within TOL of the host decode and
    of the JAX package's, canvases equal."""
    opts = ("mode=pose_estimation option1=64:48 option2=65:65 "
            "option4=0.5")
    port, jax_run = run_four("zoo_pose", opts, 1)
    for i in range(len(SCALES)):
        want = np.array(jax_run[i].extra["keypoints"])
        assert want.shape == (17, 3)
        for bufs in port.values():
            np.testing.assert_allclose(np.array(bufs[i].extra["keypoints"]),
                                       want, atol=TOL, rtol=0)
            np.testing.assert_array_equal(bufs[i].np(0), jax_run[i].np(0))


# ---------------------------------------------------------------------------
# direct_video, octet_stream, font
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("channels,fmt", [(1, "GRAY8"), (3, "RGB"),
                                          (4, "RGBA")])
def test_direct_video_matches_jax(channels, fmt):
    frame = np.random.default_rng(channels).integers(
        0, 256, (6, 5, channels), np.uint8)
    got, want = decode_both(tcaps(f"{channels}:5:6", "uint8"),
                            {"mode": "direct_video"}, [frame])
    np.testing.assert_array_equal(got.np(0), want.np(0))
    np.testing.assert_array_equal(got.np(0), frame)


def test_direct_video_rejects_float():
    with pytest.raises(Exception, match="uint8"):
        decode_both(tcaps("3:5:6", "float32"), {"mode": "direct_video"},
                    [np.zeros((6, 5, 3), np.float32)])


def test_octet_stream_matches_jax():
    a = np.arange(6, dtype=np.uint8).reshape(2, 3)
    b = np.arange(4, dtype=np.float32)
    for caps, tensors in [(tcaps("3:2", "uint8"), [a]),
                          (tcaps("3:2.4", "uint8.float32", n=2), [a, b])]:
        got, want = decode_both(caps, {"mode": "octet_stream"}, tensors)
        np.testing.assert_array_equal(got.np(0), want.np(0))
        assert got.np(0).dtype == np.uint8


def test_font_matches_jax():
    text = np.frombuffer(b"Hello, zoo 0123!", np.uint8)
    got, want = decode_both(tcaps(f"{text.size}", "uint8"),
                            {"mode": "font", "option1": "120:12"}, [text])
    assert got.extra["text"] == want.extra["text"] == "Hello, zoo 0123!"
    assert got.np(0).shape == (12, 120, 1) and got.np(0).any()
    np.testing.assert_array_equal(got.np(0), want.np(0))


# ---------------------------------------------------------------------------
# the three zoo models through both packages
# ---------------------------------------------------------------------------

def priors_file(path, n):
    """Synthetic box priors (cy cx h w rows x n): the JAX benchmark's
    recipe (bench.py ``_ssd_priors_file``)."""
    rng = np.random.default_rng(0)
    rows = (rng.random(n), rng.random(n), np.full(n, 0.2), np.full(n, 0.2))
    path.write_text("".join(" ".join(f"{v:.6f}" for v in r) + "\n"
                            for r in rows))
    return str(path)


ZOO_SIZE = {"ssd_mobilenet_v2": 75, "deeplab_v3": 65, "posenet": 65}


@pytest.fixture(scope="module")
def zoo_models():
    """Each zoo model at its small size, the same variables in both
    registries."""
    saved = {}
    for name, size in ZOO_SIZE.items():
        custom = {"input_size": str(size), "dtype": "float32"}
        jax_model = jax_zoo_model(name, custom, seed=size)
        port_model = port_zoo_model(name, custom, jax_model.params)
        saved[name] = (jax_registry._MODELS.get(name),
                       port_registry._MODELS.get(name))
        jax_registry._MODELS[name] = lambda c, m=jax_model: m
        port_registry._MODELS[name] = lambda c, d=None, m=port_model: m
    yield
    for name, (jax_build, port_build) in saved.items():
        jax_registry._MODELS[name] = jax_build
        port_registry._MODELS[name] = port_build


def zoo_launch(name, decoder, batch=1, accel=""):
    size = ZOO_SIZE[name]
    return (f"videotestsrc num-buffers=4 pattern=random seed=3 ! "
            f"video/x-raw,format=RGB,width={size},height={size},"
            "framerate=30/1 ! tensor_converter ! "
            f"tensor_filter framework=xla model={name} "
            f"custom=input_size:{size},dtype:float32 {accel}batch={batch} ! "
            f"tensor_decoder {decoder} ! tensor_sink name=out")


def zoo_runs(name, decoder):
    """JAX per frame, the port per frame and at batch 2."""
    jax_p = nnstreamer_tpu.parse_launch(zoo_launch(name, decoder))
    jax_p.run(timeout=300)
    runs = []
    for batch in (1, 2):
        p = nnstreamer_tpu_torch.parse_launch(
            zoo_launch(name, decoder, batch, "accelerator=true:cpu "))
        p.run(timeout=300)
        runs.append(p.get("out").results)
    want = jax_p.get("out").results
    assert len(want) == 4 and all(len(r) == 4 for r in runs)
    return runs, want


def test_ssd_string_matches_jax(zoo_models, tmp_path):
    """bench.py's ssd decoder options on SSD-MobileNetV2 at 75x75 (159
    anchors): the objects, nearly every anchor a candidate on random
    weights, equal; canvases equal."""
    priors = priors_file(tmp_path / "priors.txt", 159)
    runs, want = zoo_runs("ssd_mobilenet_v2",
                          f"mode=bounding_boxes option1=mobilenet-ssd "
                          f"option3={priors} option4=75:75 option5=75:75")
    for got in runs:
        for g, w in zip(got, want):
            assert objects(w)
            assert_objects_equal(objects(g), objects(w))
            np.testing.assert_array_equal(g.np(0), w.np(0))


def test_deeplab_string_matches_jax(zoo_models):
    runs, want = zoo_runs("deeplab_v3", "mode=image_segment")
    for got in runs:
        for g, w in zip(got, want):
            assert g.extra["class_map"].shape == (65, 65)
            np.testing.assert_array_equal(g.extra["class_map"],
                                          w.extra["class_map"])
            np.testing.assert_array_equal(g.np(0), w.np(0))


def test_posenet_string_matches_jax(zoo_models):
    runs, want = zoo_runs("posenet", "mode=pose_estimation option1=65:65 "
                                     "option2=65:65")
    for got in runs:
        for g, w in zip(got, want):
            np.testing.assert_allclose(np.array(g.extra["keypoints"]),
                                       np.array(w.extra["keypoints"]),
                                       atol=TOL, rtol=0)
            np.testing.assert_array_equal(g.np(0), w.np(0))
