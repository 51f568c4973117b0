"""The PyTorch port stands alone.

It imports nothing of JAX or of the JAX package, its element registry
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
#: programmatic source), fakesink, the training slice's tensor_trainer
#: and the query plane's three elements
SLICE_ELEMENTS = ["appsrc", "capsfilter", "fakesink", "queue",
                  "tensor_converter", "tensor_decoder", "tensor_filter",
                  "tensor_query_client", "tensor_query_serversink",
                  "tensor_query_serversrc", "tensor_sink", "tensor_trainer",
                  "videotestsrc"]
#: the query plane's modules, the CLI and the native binding, each
#: imported alone in a fresh interpreter
QUERY_MODULES = ["nnstreamer_tpu_torch.query", "nnstreamer_tpu_torch.launch",
                 "nnstreamer_tpu_torch.native",
                 "nnstreamer_tpu_torch.obs.metrics",
                 "nnstreamer_tpu_torch.obs.span",
                 "nnstreamer_tpu_torch.pipeline.tracing"]

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
    """Each query-plane module, the CLI and the native binding, imported
    in a fresh interpreter (and the CRC library built and loaded), load
    no module of JAX or of the JAX package."""
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
