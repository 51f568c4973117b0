"""The PyTorch port stands alone.

It imports nothing of JAX or of the JAX package (the observability and
SLO tier included), its element registry
holds only the elements of the ported pipeline, and its entry points
refuse to run on the CPU unless the caller asks for it.
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

#: the flagship pipeline's elements, plus appsrc (the pipeline module's
#: programmatic source), fakesink, the training slice's tensor_trainer,
#: the query plane's three elements, the LLM tier's tensor_llm, the
#: vision zoo's tensor_transform, the scheduling slice's tee, identity
#: and tensor_debug, and the among-device transports (shm, edge with
#: its reference spellings, MQTT, gRPC)
SLICE_ELEMENTS = ["appsrc", "capsfilter", "edge_sink", "edge_src",
                  "edgesink", "edgesrc", "fakesink", "identity",
                  "mqttsink", "mqttsrc", "queue",
                  "tee", "tensor_converter", "tensor_debug",
                  "tensor_decoder", "tensor_filter",
                  "tensor_llm", "tensor_query_client",
                  "tensor_query_serversink",
                  "tensor_query_serversrc", "tensor_shm_sink",
                  "tensor_shm_src", "tensor_sink", "tensor_sink_grpc",
                  "tensor_src_grpc", "tensor_trainer",
                  "tensor_transform", "videotestsrc"]
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
