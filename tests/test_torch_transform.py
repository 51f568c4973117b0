"""tensor_transform on both packages.

Every mode runs on the same numpy tensor through the JAX package's
element (its numpy path, and its jnp path on a device array) and through
the port's (its numpy path, and its torch path on a tensor): the port's
numpy path must equal the JAX numpy path, values and dtype, and its torch
path the jnp path.  The launch strings then run through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu
import nnstreamer_tpu_torch
from nnstreamer_tpu.elements.transform import TensorTransform as JaxTransform
from nnstreamer_tpu.tensor.info import TensorInfo as JaxInfo
from nnstreamer_tpu.tensor.types import TensorType as JaxType
from nnstreamer_tpu_torch.elements.transform import TensorTransform
from nnstreamer_tpu_torch.tensor.info import TensorInfo
from nnstreamer_tpu_torch.tensor.types import TensorType

#: (mode, option, input numpy dtype); the inputs are (2, 3, 4) — (H, W, C)
#: as numpy sees a video tensor, reference dims 4:3:2
CASES = [
    ("typecast", "float32", "uint8"),
    ("typecast", "int16", "float32"),
    ("typecast", "uint8", "float32"),
    ("arithmetic", "typecast:float32,add:-127.5,div:127.5", "uint8"),
    ("arithmetic", "add:0.5", "uint8"),
    ("arithmetic", "mul:2.5", "int32"),
    ("arithmetic", "div:3", "float32"),
    ("arithmetic", "sub:1.25,mul:0.5", "float32"),
    ("arithmetic", "add:1,2,3,4", "float32"),
    ("arithmetic", "add:0.5,1.5,2.5,3.5", "uint8"),
    ("arithmetic", "per-channel:true@0,add:10@1", "uint8"),
    ("arithmetic", "per-channel:true@0,mul:1.5@2,add:-3@0", "float32"),
    ("arithmetic", "per-channel:true@1,div:2@2", "int32"),
    ("arithmetic", "per-channel:true@2,add:5@1", "uint8"),
    ("arithmetic", "per-channel:true@3,add:7@0", "uint8"),
    ("arithmetic", "per-channel:true@3,add:7@1", "float32"),
    ("arithmetic", "per-channel:true@0,add:9@9", "uint8"),
    ("arithmetic", "per-channel:true@0,add:300@1", "uint8"),
    ("arithmetic", "per-channel:true@1,mul:-2@0", "uint8"),
    ("arithmetic", "typecast:int32,mul:3,typecast:uint8", "float32"),
    ("transpose", "1:0:2:3", "uint8"),
    ("transpose", "2:0:1:3", "float32"),
    ("transpose", "0:2:1", "int16"),
    ("dimchg", "0:2", "uint8"),
    ("dimchg", "2:0", "float32"),
    ("dimchg", "0:3", "uint8"),
    ("stand", "default", "uint8"),
    ("stand", "default:per-channel", "float32"),
    ("stand", "dc-average", "int32"),
    ("stand", "dc-average:per-channel", "uint8"),
    ("clamp", "10:200", "uint8"),
    ("clamp", "-0.5:0.5", "float32"),
    ("clamp", "-3:3", "int32"),
]


def _input(dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "f":
        return (rng.standard_normal((2, 3, 4)) * 60 + 100).astype(dtype)
    return rng.integers(0, 80, (2, 3, 4)).astype(dtype)


def _element(cls, info_cls, type_cls, mode, option, dtype):
    el = cls("t", mode=mode, option=option)
    el.start()
    info = info_cls(type_cls.from_string(np.dtype(dtype).name), (4, 3, 2))
    return el, el._transform_info(info)


def _jax_outputs(mode, option, arr):
    el, info = _element(JaxTransform, JaxInfo, JaxType, mode, option,
                        arr.dtype)
    return (np.asarray(el._transform(arr, info.dtype)),
            np.asarray(el._transform(jnp.asarray(arr), info.dtype)), info)


@pytest.mark.parametrize("mode,option,dtype", CASES,
                         ids=[f"{m}-{o}-{d}" for m, o, d in CASES])
def test_mode_matches_jax(mode, option, dtype):
    arr = _input(dtype)
    want_np, want_dev, jinfo = _jax_outputs(mode, option, arr)
    el, info = _element(TensorTransform, TensorInfo, TensorType, mode,
                        option, dtype)
    assert info.dims == jinfo.dims and info.dtype.value == jinfo.dtype.value
    got_np = el._transform(arr, info.dtype)
    assert isinstance(got_np, np.ndarray)
    assert got_np.dtype == want_np.dtype and got_np.shape == want_np.shape
    np.testing.assert_array_equal(got_np, want_np)
    got_dev = el._transform(torch.from_numpy(arr), info.dtype)
    assert isinstance(got_dev, torch.Tensor)
    got_dev = got_dev.numpy()
    assert got_dev.dtype == want_dev.dtype and got_dev.shape == want_dev.shape
    if mode == "stand":
        # mean and std summed in different orders in f32
        np.testing.assert_allclose(got_dev, want_dev, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_array_equal(got_dev, want_dev)


def test_clamp_of_integers_follows_the_jax_paths():
    """The JAX package's clamp announces the input type but, by its
    numpy and jnp promotion, emits f64 and f32 for an integer tensor;
    the port's two paths emit the same (pinned here)."""
    arr = _input("uint8")
    want_np, want_dev, info = _jax_outputs("clamp", "10:20", arr)
    assert info.dtype.value == "uint8"
    assert (want_np.dtype, want_dev.dtype) == (np.float64, np.float32)


CAPS = ("other/tensors,format=static,num_tensors=2,dimensions=4:3:2.5,"
        "types=uint8.float32,framerate=0/1")


@pytest.mark.parametrize("props", [
    "mode=arithmetic option=typecast:float32,add:-127.5,div:127.5",
    "mode=typecast option=int32 apply=1",
    "mode=transpose option=1:0:2:3 apply=0",
    "mode=clamp option=0:50 acceleration=false",
])
def test_launch_string_matches_jax(props):
    """``appsrc ! tensor_transform ! tensor_sink`` on both packages: the
    caps each announces and every tensor, host and device input alike."""
    rng = np.random.default_rng(1)
    frames = [[rng.integers(0, 256, (2, 3, 4)).astype(np.uint8),
               rng.standard_normal(5).astype(np.float32) * 9]
              for _ in range(3)]
    launch = (f"appsrc caps={CAPS} name=in ! tensor_transform {props} ! "
              "tensor_sink name=out")

    def run(pkg, to_device):
        from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer
        from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

        buffer = JaxBuffer if pkg is nnstreamer_tpu else TensorBuffer
        p = pkg.parse_launch(launch)
        p.play()
        try:
            for f in frames:
                p.get("in").push_buffer(buffer(tensors=[to_device(a)
                                                        for a in f]))
            p.get("in").end_of_stream()
            p.wait(timeout=60)
        finally:
            p.stop()
        sink = p.get("out")
        return sink.caps.first(), [[b.np(i) for i in range(b.num_tensors)]
                                   for b in sink.results]

    want_caps, want = run(nnstreamer_tpu, jnp.asarray)
    for to_device in (np.asarray, torch.from_numpy):
        got_caps, got = run(nnstreamer_tpu_torch, to_device)
        for key in ("dimensions", "types", "num_tensors"):
            assert got_caps.get(key) == want_caps.get(key)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_transform_registered():
    from nnstreamer_tpu_torch.pipeline import list_factories

    assert "tensor_transform" in list_factories()
    with pytest.raises(ValueError, match="permutation"):
        TensorTransform("t", mode="transpose", option="0:0:1").start()
