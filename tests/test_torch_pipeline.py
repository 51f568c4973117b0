"""The flagship image-labeling pipeline on both packages.

The README's launch string (``use_pallas:1``) runs through the JAX
package's ``parse_launch`` and through the PyTorch port's, at 32x32 on
the CPU, with the port's model carrying the JAX model's parameters
(``params_from_flax``).  Both sources draw the same seeded random frames,
so the labels must agree frame for frame.
"""

import jax
import numpy as np
import pytest
import torch

import nnstreamer_tpu
import nnstreamer_tpu_torch
from nnstreamer_tpu.models.registry import get_model as jax_get_model
from nnstreamer_tpu_torch.models import registry as torch_registry
from nnstreamer_tpu_torch.models.mobilenet_v2 import load_flax


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Tier-1 runs several test files side by side: keep torch's intra-op
    pool off the other workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


SIZE = 32
FRAMES = 8
CUSTOM = f"input_size:{SIZE},dtype:float32,use_pallas:1"


def _launch(accelerator: str = "") -> str:
    return (f"videotestsrc num-buffers={FRAMES} pattern=random seed=7 ! "
            f"video/x-raw,format=RGB,width={SIZE},height={SIZE},"
            "framerate=30/1 ! tensor_converter ! "
            f"tensor_filter name=f framework=xla model=mobilenet_v2 "
            f"{accelerator}custom={CUSTOM} ! "
            "tensor_decoder mode=image_labeling ! tensor_sink name=out")


@pytest.fixture
def port_with_jax_params(monkeypatch):
    """Make the port's ``mobilenet_v2`` builder load the JAX model's
    parameters (same seed and custom properties) into its module."""
    custom = dict(kv.split(":") for kv in CUSTOM.split(","))
    variables = jax.tree_util.tree_map(
        np.asarray, jax_get_model("mobilenet_v2", custom).params)
    torch_registry.get_model("mobilenet_v2", custom, device="cpu")
    build = torch_registry._MODELS["mobilenet_v2"]

    def build_from_jax(custom_props, device=None):
        model = build(custom_props, device)
        load_flax(model.module, variables)
        return model

    monkeypatch.setitem(torch_registry._MODELS, "mobilenet_v2",
                        build_from_jax)


def test_labels_match_jax_frame_for_frame(port_with_jax_params):
    jax_p = nnstreamer_tpu.parse_launch(_launch())
    jax_p.run(timeout=120)
    want = [(b.extra["label"], b.extra["index"])
            for b in jax_p.get("out").results]

    port = nnstreamer_tpu_torch.parse_launch(
        _launch("accelerator=true:cpu "))
    port.play()
    try:
        port.wait(timeout=120)
        got = [(b.extra["label"], b.extra["index"])
               for b in port.get("out").results]
        # top-1 pushdown: the decoder's argmax runs inside the filter's
        # forward, so one (1,) int32 leaves the model per frame
        filt = port.get("f")
        assert filt._pushdown is not None
        out, = filt.fw.invoke(
            [np.zeros((SIZE, SIZE, 3), np.uint8)])
        assert tuple(out.shape) == (1,) and str(out.dtype) == "torch.int32"
        info = filt._out_config.info
        assert info.num_tensors == 1 and info[0].np_shape == (1,)
        assert info[0].np_dtype == np.int32
    finally:
        port.stop()
    assert len(want) == FRAMES
    assert got == want


def test_unnamed_elements_have_distinct_names():
    """Unnamed elements of one factory never share a name, however many
    are alive at once: a name from the low 16 bits of the element's id
    repeats within a few thousand live elements, and a launch string with
    two unnamed elements of one factory then fails to parse."""
    from nnstreamer_tpu_torch.pipeline.graph import Queue

    queues = [Queue() for _ in range(5000)]
    assert len({q.name for q in queues}) == len(queues)
    p = nnstreamer_tpu_torch.parse_launch(
        "videotestsrc num-buffers=1 ! " + "queue ! " * 16 +
        "tensor_sink name=out")
    assert len({e.name for e in p.elements}) == len(p.elements) == 18
