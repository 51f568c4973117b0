"""The PyTorch port stands alone.

It imports nothing of JAX or of the JAX package (the observability and
SLO tier included), its element registry holds the JAX package's
factories (every element is ported), and its entry points refuse to run
on the CPU unless the caller asks for it.
"""

import ast
import os
import subprocess
import sys

import pytest
import torch

import nnstreamer_tpu_torch
from nnstreamer_tpu_torch.device import DeviceError
from nnstreamer_tpu_torch.filter import FilterError, FilterSingle
from nnstreamer_tpu_torch.models.registry import get_model
from nnstreamer_tpu_torch.pipeline import PipelineError, list_factories

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.dirname(nnstreamer_tpu_torch.__file__)
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "nnstreamer_tpu"}

#: every factory of the JAX package's registry (nnstreamer_tpu/elements/
#: and the query, transport and LLM elements): the flagship pipeline's
#: elements, appsrc, fakesink, tee and queue, identity and tensor_debug,
#: tensor_trainer, the query plane, the among-device transports (shm,
#: edge with its reference spellings, MQTT, gRPC), tensor_llm,
#: tensor_transform, and the composition, media and file elements
SLICE_ELEMENTS = ["appsrc", "audiotestsrc", "capsfilter", "datareposrc",
                  "edge_sink", "edge_src", "edgesink", "edgesrc",
                  "fakesink", "filesink", "filesrc", "identity", "join",
                  "mqttsink", "mqttsrc", "multifilesink", "multifilesrc",
                  "pngdec", "pnmdec", "queue", "tee", "tensor_aggregator",
                  "tensor_converter", "tensor_crop", "tensor_debug",
                  "tensor_decoder", "tensor_demux", "tensor_filter",
                  "tensor_if", "tensor_llm", "tensor_merge", "tensor_mux",
                  "tensor_query_client", "tensor_query_serversink",
                  "tensor_query_serversrc", "tensor_rate",
                  "tensor_reposink", "tensor_reposrc", "tensor_shm_sink",
                  "tensor_shm_src", "tensor_sink", "tensor_sink_grpc",
                  "tensor_sparse_dec", "tensor_sparse_enc", "tensor_split",
                  "tensor_src_grpc", "tensor_src_iio", "tensor_trainer",
                  "tensor_transform", "videotestsrc", "wavparse"]
#: the query plane's modules (the among-device transports and their wire
#: codecs too), the CLI, the native binding and the LLM serving tier,
#: imported in a fresh interpreter
QUERY_MODULES = ["nnstreamer_tpu_torch.query", "nnstreamer_tpu_torch.launch",
                 "nnstreamer_tpu_torch.query.shm",
                 "nnstreamer_tpu_torch.query.edge",
                 "nnstreamer_tpu_torch.query.mqtt",
                 "nnstreamer_tpu_torch.query.grpc_service",
                 "nnstreamer_tpu_torch.decoders.serialize",
                 "nnstreamer_tpu_torch.utils.protowire",
                 "nnstreamer_tpu_torch.utils.flatbuf",
                 "nnstreamer_tpu_torch.utils.tensor_flatbuf",
                 "nnstreamer_tpu_torch.utils.nns_python_compat",
                 "nnstreamer_tpu_torch.utils.ntp",
                 "nnstreamer_tpu_torch.native",
                 "nnstreamer_tpu_torch.obs.metrics",
                 "nnstreamer_tpu_torch.obs.span",
                 "nnstreamer_tpu_torch.pipeline.tracing",
                 "nnstreamer_tpu_torch.llm",
                 "nnstreamer_tpu_torch.llm.element",
                 "nnstreamer_tpu_torch.llm.client",
                 "nnstreamer_tpu_torch.obs.timeseries"]

#: the vision zoo's models, decoders, ops and tensor_transform
ZOO_MODULES = ["nnstreamer_tpu_torch.models.ssd",
               "nnstreamer_tpu_torch.models.deeplab_v3",
               "nnstreamer_tpu_torch.models.posenet",
               "nnstreamer_tpu_torch.ops", "nnstreamer_tpu_torch.ops.nms",
               "nnstreamer_tpu_torch.decoders.boundingbox",
               "nnstreamer_tpu_torch.decoders.imagesegment",
               "nnstreamer_tpu_torch.decoders.pose",
               "nnstreamer_tpu_torch.decoders.directvideo",
               "nnstreamer_tpu_torch.decoders.font",
               "nnstreamer_tpu_torch.decoders.rasterfont",
               "nnstreamer_tpu_torch.elements.transform"]

#: the observability and SLO tier: the metrics endpoint, attribution,
#: the profiler, federation, the dashboard, the SLO harness, the fleet
#: (config, ring, router, pool, autoscaler, soak) and the analysis tier
#: (verifier, lock hierarchy, sanitizer, capture audit, lint)
OBS_MODULES = ["nnstreamer_tpu_torch.obs.httpd",
               "nnstreamer_tpu_torch.obs.attrib",
               "nnstreamer_tpu_torch.obs.profile",
               "nnstreamer_tpu_torch.obs.federation",
               "nnstreamer_tpu_torch.obs.dashboard",
               "nnstreamer_tpu_torch.slo",
               "nnstreamer_tpu_torch.slo.spec",
               "nnstreamer_tpu_torch.slo.evaluator",
               "nnstreamer_tpu_torch.slo.flightrec",
               "nnstreamer_tpu_torch.slo.loadgen",
               "nnstreamer_tpu_torch.fleet.config",
               "nnstreamer_tpu_torch.analysis.verify",
               "nnstreamer_tpu_torch.fleet",
               "nnstreamer_tpu_torch.fleet.ring",
               "nnstreamer_tpu_torch.fleet.router",
               "nnstreamer_tpu_torch.fleet.pool",
               "nnstreamer_tpu_torch.fleet.autoscaler",
               "nnstreamer_tpu_torch.fleet.soak",
               "nnstreamer_tpu_torch.analysis.lockorder",
               "nnstreamer_tpu_torch.analysis.sanitizer",
               "nnstreamer_tpu_torch.analysis.jitaudit",
               "nnstreamer_tpu_torch.analysis.lint"]

LAUNCH = ("videotestsrc num-buffers=2 ! "
          "video/x-raw,format=RGB,width=32,height=32,framerate=30/1 ! "
          "tensor_converter ! tensor_filter framework=xla model=mobilenet_v2 "
          "{accel}custom=input_size:32,use_pallas:1 ! "
          "tensor_decoder mode=image_labeling ! tensor_sink name=out")


def _sources():
    for dirpath, _, files in os.walk(PORT):
        for name in sorted(files):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)
    yield os.path.join(ROOT, "chip_smoke.py")
    # the fixture writers chip_smoke.py imports
    yield os.path.join(ROOT, "tests", "torch_model_files.py")
    # the kernels' timing harness (checkouts compared in turns)
    yield os.path.join(ROOT, "tools", "torch_flash_turns.py")


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", list(_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_pipeline_runs_without_loading_jax():
    """A fresh interpreter imports the port and runs the pipeline on the
    CPU; no module of JAX or the JAX package gets loaded on the way."""
    code = (
        "import sys\n"
        f"bad = {sorted(FORBIDDEN)!r}\n"
        "def loaded():\n"
        "    return {m for m in sys.modules if m.split('.')[0] in bad}\n"
        "before = loaded()\n"
        "import nnstreamer_tpu_torch as n\n"
        f"p = n.parse_launch({LAUNCH.format(accel='accelerator=true:cpu ')!r})\n"
        "p.run(timeout=120)\n"
        "assert len(p.get('out').results) == 2\n"
        "print(sorted(loaded() - before))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_query_modules_load_without_jax():
    """Each query-plane module, the CLI, the native binding and the LLM
    tier's modules, imported in a fresh interpreter (and the CRC library
    built and loaded), load no module of JAX or of the JAX package."""
    code = (
        "import importlib, sys\n"
        f"bad = {sorted(FORBIDDEN)!r}\n"
        f"for name in {QUERY_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "from nnstreamer_tpu_torch import native\n"
        "native.available()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_transports_run_without_loading_jax():
    """A fresh interpreter streams frames over the port's shm ring, edge
    broker and MQTT broker (its own brokers, the native ring built and
    loaded) and loads no module of JAX or of the JAX package."""
    code = (
        "import os, sys, time\n"
        f"bad = {sorted(FORBIDDEN)!r}\n"
        "import nnstreamer_tpu_torch as n\n"
        "from nnstreamer_tpu_torch import native\n"
        "from nnstreamer_tpu_torch.query.edge import get_broker\n"
        "from nnstreamer_tpu_torch.query.mqtt import MqttBroker\n"
        "assert native.available()\n"
        "edge, mqtt = get_broker(), MqttBroker()\n"
        "ring = f'iso-{os.getpid()}'\n"
        "src = ('videotestsrc num-buffers=3 ! video/x-raw,format=RGB,'\n"
        "       'width=8,height=8,framerate=30/1 ! tensor_converter ! ')\n"
        "ends = [(f'edge_sink port={edge.port} topic=t',\n"
        "         f'edge_src port={edge.port} topic=t num-buffers=3'),\n"
        "        (f'mqttsink port={mqtt.port} pub-topic=t',\n"
        "         f'mqttsrc port={mqtt.port} sub-topic=t num-buffers=3'),\n"
        "        (f'tensor_shm_sink path={ring}',\n"
        "         f'tensor_shm_src path={ring} timeout=30')]\n"
        "for sink, source in ends:\n"
        "    rx = n.parse_launch(source + ' ! tensor_sink name=out')\n"
        "    rx.play()\n"
        "    while source.startswith('edge') and not edge._subs.get('t'):\n"
        "        time.sleep(0.005)\n"
        "    n.parse_launch(src + sink).run(timeout=60)\n"
        "    rx.wait(timeout=60)\n"
        "    rx.stop()\n"
        "    assert len(rx.get('out').results) == 3, sink\n"
        "mqtt.close()\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_zoo_modules_load_without_jax():
    """The vision zoo's modules, imported in a fresh interpreter, and an
    SSD string with its device NMS run on the CPU, load no module of JAX
    or of the JAX package."""
    launch = ("videotestsrc num-buffers=1 pattern=random ! "
              "video/x-raw,format=RGB,width=33,height=33,framerate=30/1 ! "
              "tensor_converter ! tensor_transform mode=typecast "
              "option=uint8 ! tensor_filter framework=xla "
              "model=ssd_mobilenet_v2 accelerator=true:cpu "
              "custom=input_size:33 ! tensor_decoder mode=bounding_boxes "
              "option1=mobilenet-ssd option3={priors} ! tensor_sink name=out")
    code = (
        "import importlib, sys, tempfile\n"
        f"bad = {sorted(FORBIDDEN)!r}\n"
        f"for name in {ZOO_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import nnstreamer_tpu_torch as n\n"
        "from nnstreamer_tpu_torch.models.ssd import anchor_count\n"
        "k = anchor_count(33)\n"
        "f = tempfile.NamedTemporaryFile('w', suffix='.txt', delete=False)\n"
        "f.write(('0.5 ' * k + '\\n') * 2 + ('0.2 ' * k + '\\n') * 2)\n"
        "f.close()\n"
        f"p = n.parse_launch({launch!r}.format(priors=f.name))\n"
        "p.run(timeout=120)\n"
        "assert 'objects' in p.get('out').results[0].extra\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_observability_modules_load_without_jax():
    """The observability and SLO tier's modules, imported in a fresh
    interpreter, then a profiled pipeline with the metrics endpoint
    scraped, the verifier and an SLO evaluator run on the CPU, load no
    module of JAX or of the JAX package."""
    code = (
        "import importlib, sys, urllib.request\n"
        f"bad = {sorted(FORBIDDEN)!r}\n"
        f"for name in {OBS_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import nnstreamer_tpu_torch as n\n"
        "from nnstreamer_tpu_torch.obs.httpd import start_metrics_server\n"
        "from nnstreamer_tpu_torch.obs.profile import Profiler\n"
        "from nnstreamer_tpu_torch.slo import Evaluator, demo_spec\n"
        "srv = start_metrics_server(0)\n"
        f"p = n.parse_launch({LAUNCH.format(accel='accelerator=true:cpu ')!r})\n"
        "assert not [f for f in p.verify() if f.severity == 'error']\n"
        "prof = Profiler(p)\n"
        "ev = Evaluator(demo_spec(10.0))\n"
        "ev.tick()\n"
        "p.run(timeout=120)\n"
        "ev.tick()\n"
        "assert prof.report()['blame']['frames'] == 2\n"
        "url = f'http://127.0.0.1:{srv.server_address[1]}/metrics'\n"
        "assert 'nns_' in urllib.request.urlopen(url).read().decode()\n"
        "assert ev.verdict()['pass']\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_registry_knows_only_the_slice_elements():
    assert list_factories() == SLICE_ELEMENTS


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_filter_without_cpu_request_raises(no_gpu):
    single = FilterSingle(framework="xla", model="mobilenet_v2",
                          custom="input_size:32")
    with pytest.raises(FilterError, match="no CUDA device"):
        single.start()
    assert single.fw is None


def test_pipeline_without_cpu_request_raises(no_gpu):
    p = nnstreamer_tpu_torch.parse_launch(LAUNCH.format(accel=""))
    with pytest.raises(PipelineError, match="no CUDA device"):
        p.run(timeout=60)
    assert p.get("out").results == []


def test_query_server_without_cpu_request_raises(no_gpu):
    """A serving pipeline whose filter did not ask for the CPU refuses
    to start without a card; the same pipeline with the CPU asked for
    serves."""
    from nnstreamer_tpu_torch.query import QueryConnection, shutdown_server
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    serve = ("tensor_query_serversrc name=q id={sid} port=0 "
             "caps=other/tensors,format=static,num_tensors=1,dimensions=8,"
             "types=float32,framerate=0/1 ! tensor_filter framework=xla "
             "model=mlp {accel}custom=in_dim:8,width:16,depth:1,out_dim:4 ! "
             "tensor_query_serversink id={sid}")
    p = nnstreamer_tpu_torch.parse_launch(serve.format(sid=1960, accel=""))
    try:
        with pytest.raises(PipelineError, match="no CUDA device"):
            p.play()
    finally:
        p.stop()
        shutdown_server(1960)
    p = nnstreamer_tpu_torch.parse_launch(
        serve.format(sid=1961, accel="accelerator=true:cpu "))
    p.play()
    try:
        conn = QueryConnection("127.0.0.1", p.get("q").bound_port,
                               timeout=10.0)
        conn.connect()
        import numpy as np

        out = conn.query(TensorBuffer(tensors=[np.ones(8, np.float32)]))
        conn.close()
        assert out.np(0).shape == (4,)
    finally:
        p.stop()
        shutdown_server(1961)


def test_model_builder_without_device_raises(no_gpu):
    with pytest.raises(DeviceError):
        get_model("mobilenet_v2", {"input_size": "32"})
    assert get_model("mobilenet_v2", {"input_size": "32"},
                     device="cpu").device == torch.device("cpu")


def test_filter_on_cpu_request_runs(no_gpu):
    import numpy as np

    with FilterSingle(framework="xla", model="mobilenet_v2",
                      accelerator="true:cpu",
                      custom="input_size:32,num_classes:10") as single:
        logits, = single.invoke([np.zeros((32, 32, 3), np.uint8)])
    assert logits.shape == (10,) and logits.dtype == np.float32


#: the training tier: checkpoints, the multi-rank layer and the trainer
TRAIN_MODULES = ["nnstreamer_tpu_torch.parallel",
                 "nnstreamer_tpu_torch.parallel.multihost",
                 "nnstreamer_tpu_torch.parallel.mesh",
                 "nnstreamer_tpu_torch.parallel.collectives",
                 "nnstreamer_tpu_torch.parallel.ring_attention",
                 "nnstreamer_tpu_torch.parallel.ulysses",
                 "nnstreamer_tpu_torch.parallel.pipeline_parallel",
                 "nnstreamer_tpu_torch.parallel.train_step",
                 "nnstreamer_tpu_torch.parallel.vision_train",
                 "nnstreamer_tpu_torch.models.registry",
                 "nnstreamer_tpu_torch.elements.trainer"]


def test_training_modules_load_without_jax(tmp_path):
    """The training tier's modules, imported in a fresh interpreter, then
    MobileNetV2 trained a step with ``model-save-path`` and its checkpoint
    served by the flagship string on the CPU, load no module of JAX or of
    the JAX package."""
    ckpt = str(tmp_path / "mnv2.pt")
    served = LAUNCH.format(accel="accelerator=true:cpu ").replace(
        "use_pallas:1", f"use_pallas:1,checkpoint:{ckpt}")
    code = (
        "import importlib, sys\n"
        "import numpy as np\n"
        f"bad = {sorted(FORBIDDEN)!r}\n"
        f"for name in {TRAIN_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import nnstreamer_tpu_torch as n\n"
        "from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer\n"
        "p = n.parse_launch('appsrc name=src caps=other/tensors,"
        "format=static,num_tensors=2,dimensions=3:32:32:2.2,"
        "types=uint8.int32,framerate=0/1 ! tensor_trainer "
        f"framework=mesh-vision model-save-path={ckpt} "
        "custom=model:mobilenet_v2,input_size:32,use_pallas:1,"
        "device:cpu ! tensor_sink name=out')\n"
        "p.play()\n"
        "p.get('src').push_buffer(TensorBuffer(tensors=["
        "np.zeros((2, 32, 32, 3), np.uint8), np.zeros(2, np.int32)]))\n"
        "p.get('src').end_of_stream()\n"
        "p.wait(timeout=120)\n"
        "p.stop()\n"
        f"q = n.parse_launch({served!r})\n"
        "q.run(timeout=120)\n"
        "assert len(q.get('out').results) == 2\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


#: the model-file filter backends and what they stand on
BACKEND_MODULES = ["nnstreamer_tpu_torch.filter.backends.tflite",
                   "nnstreamer_tpu_torch.filter.backends.pytorch",
                   "nnstreamer_tpu_torch.filter.backends.tensorflow",
                   "nnstreamer_tpu_torch.filter.backends.caffe2",
                   "nnstreamer_tpu_torch.filter.backends.mxnet",
                   "nnstreamer_tpu_torch.filter.backends.python",
                   "nnstreamer_tpu_torch.filter.backends.lua",
                   "nnstreamer_tpu_torch.filter.backends.custom",
                   "nnstreamer_tpu_torch.filter.torchscript",
                   "nnstreamer_tpu_torch.utils.minilua",
                   "nnstreamer_tpu_torch.ops.audio"]

#: the JAX package's thirteen filter names (its filter/backends/)
FILTER_NAMES = ["caffe2", "custom", "custom-easy", "dummy", "lua", "mxnet",
                "python", "pytorch", "tensorflow", "tensorflow-lite",
                "tensorflow2-lite", "tflite", "xla"]


def test_port_registers_the_thirteen_filter_names():
    from nnstreamer_tpu_torch.filter.framework import list_filters

    assert list_filters() == FILTER_NAMES


def test_backend_modules_load_without_jax(tmp_path):
    """The model-file backends' modules, imported in a fresh interpreter,
    then the flagship string with ``tensor_filter
    framework=tensorflow-lite`` on a quantized MobileNetV2 file run on the
    CPU in native int8, load no module of JAX or of the JAX package."""
    model = str(tmp_path / "mnv2_quant.tflite")
    launch = ("videotestsrc num-buffers=2 ! "
              "video/x-raw,format=RGB,width=32,height=32,framerate=30/1 ! "
              "tensor_converter ! tensor_filter framework=tensorflow-lite "
              f"model={model} accelerator=true:cpu custom=compute:int8 ! "
              "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    code = (
        "import importlib, sys\n"
        f"sys.path.insert(0, {os.path.join(ROOT, 'tests')!r})\n"
        f"bad = {sorted(FORBIDDEN)!r}\n"
        f"for name in {BACKEND_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import torch_model_files as mf\n"
        f"mf.mobilenet_v2_tflite({model!r}, True, width=0.35, size=32,\n"
        "                       classes=11, stages=2)\n"
        "import nnstreamer_tpu_torch as n\n"
        f"p = n.parse_launch({launch!r})\n"
        "p.run(timeout=120)\n"
        "assert len(p.get('out').results) == 2\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"



#: the stream-composition, media, file and sensor modules, the converter
#: subplugins and the sync engine
COMPOSE_MODULES = ["nnstreamer_tpu_torch.pipeline.clock",
                   "nnstreamer_tpu_torch.elements.mux",
                   "nnstreamer_tpu_torch.elements.merge_split",
                   "nnstreamer_tpu_torch.elements.aggregator",
                   "nnstreamer_tpu_torch.tensor.data",
                   "nnstreamer_tpu_torch.elements.tensor_if",
                   "nnstreamer_tpu_torch.elements.rate",
                   "nnstreamer_tpu_torch.elements.sparse",
                   "nnstreamer_tpu_torch.elements.repo",
                   "nnstreamer_tpu_torch.elements.misc",
                   "nnstreamer_tpu_torch.utils.mediadec",
                   "nnstreamer_tpu_torch.elements.mediadec",
                   "nnstreamer_tpu_torch.elements.src",
                   "nnstreamer_tpu_torch.elements.sink",
                   "nnstreamer_tpu_torch.elements.converter",
                   "nnstreamer_tpu_torch.converters",
                   "nnstreamer_tpu_torch.converters.flatbuf",
                   "nnstreamer_tpu_torch.converters.flexbuf",
                   "nnstreamer_tpu_torch.converters.protobuf",
                   "nnstreamer_tpu_torch.converters.python",
                   "nnstreamer_tpu_torch.elements.srciio"]


def test_registry_equals_the_jax_packages():
    from nnstreamer_tpu.pipeline import list_factories as jax_factories

    assert list_factories() == jax_factories()


def test_compose_modules_load_without_jax(tmp_path):
    """The composition and media modules, imported in a fresh
    interpreter, then an ensemble of two filters through tee, mux and
    demux, a merge/split, tensor_if, the aggregator, tensor_rate, the
    sparse codec and a PNG file through multifilesrc and pngdec, load no
    module of JAX or of the JAX package."""
    img = tmp_path / "f_000.png"
    launch = (
        "videotestsrc num-buffers=4 pattern=random ! "
        "video/x-raw,format=RGB,width=16,height=16,framerate=30/1 ! "
        "tensor_converter ! tee name=t "
        "t. ! queue name=q1 ! tensor_filter name=f1 framework=xla "
        "model=mobilenet_v2 accelerator=true:cpu "
        "custom=input_size:16,use_pallas:1 ! m.sink_0 "
        "t. ! queue name=q2 ! tensor_filter name=f2 framework=xla "
        "model=mobilenet_v2 "
        "accelerator=true:cpu custom=input_size:16,seed:1 ! m.sink_1 "
        "tensor_mux name=m sync-mode=slowest ! tensor_demux name=d "
        "d.src_0 ! queue name=q3 ! tensor_if "
        "compared-value=TENSOR_AVERAGE_VALUE "
        "operator=GT supplied-value=-100 then=PASSTHROUGH else=SKIP ! "
        "tensor_aggregator frames-out=2 ! tensor_sink name=a "
        "d.src_1 ! queue name=q4 ! tensor_rate framerate=15/1 ! "
        "tensor_sparse_enc "
        "! tensor_sparse_dec ! tensor_sink name=b")
    code = (
        "import importlib, sys\n"
        f"bad = {sorted(FORBIDDEN)!r}\n"
        f"for name in {COMPOSE_MODULES!r}:\n"
        "    importlib.import_module(name)\n"
        "import numpy as np, zlib, struct\n"
        "img = np.zeros((4, 4, 3), np.uint8)\n"
        "raw = b''.join(b'\\0' + img[r].tobytes() for r in range(4))\n"
        "def chunk(t, d):\n"
        "    c = zlib.crc32(t + d)\n"
        "    return struct.pack('>I', len(d)) + t + d + struct.pack('>I', c)\n"
        "png = (b'\\x89PNG\\r\\n\\x1a\\n'\n"
        "       + chunk(b'IHDR', struct.pack('>IIBBBBB', 4, 4, 8, 2, 0, 0, 0))\n"
        "       + chunk(b'IDAT', zlib.compress(raw)) + chunk(b'IEND', b''))\n"
        f"open({str(img)!r}, 'wb').write(png)\n"
        "import nnstreamer_tpu_torch as n\n"
        f"p = n.parse_launch({launch!r})\n"
        "p.run(timeout=120)\n"
        "assert len(p.get('a').results) == 2, len(p.get('a').results)\n"
        "assert len(p.get('b').results) in (2, 3)\n"
        f"loc = {str(tmp_path / 'f_%03d.png')!r}\n"
        "q = n.parse_launch(f'multifilesrc location={loc} ! pngdec ! '\n"
        "                   'tensor_converter ! tensor_sink name=o')\n"
        "q.run(timeout=60)\n"
        "assert q.get('o').results[0].np(0).shape == (4, 4, 3)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in bad))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
