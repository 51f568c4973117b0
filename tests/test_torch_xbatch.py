"""Cross-stream buckets, device cascades and batched models on both
packages.

- ``CrossStreamBatcher``: the JAX package's cases
  (``tests/test_xbatch.py``) run against both packages' classes;
- ``invoke_stacked``: fills padded to a bounded set of shapes, one
  compile-ledger event (site ``filter.jitexec.vmap``) a pad shape and
  none on a second pass — counted from both packages' backends in the
  same test — and a hand-fed cross-stream buffer through each package's
  ``tensor_filter``;
- ``output-device`` cascades (``tests/test_device_resident.py``):
  ``BatchView`` payloads between two batched filters, on the CPU, within
  rtol 1e-5 of the port's host path and 1e-3 of the JAX package's (its
  own cascade tolerance: 192-term f32 sums of pixel values);
- each registry model's batched forward against the JAX package's
  ``jax.vmap`` of its forward, with the weights carried across, in f32:
  within 1e-4 abs and rel (the two sum in different orders).

The JAX side runs on the CPU; its Pallas kernels in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu
import nnstreamer_tpu_torch
from nnstreamer_tpu.analysis import compileledger as jax_ledger
from nnstreamer_tpu.elements.filter_elem import \
    CrossStreamBatcher as JaxBatcher
from nnstreamer_tpu.filter.framework import FilterProperties as JaxProps
from nnstreamer_tpu.filter.framework import open_backend as jax_open
from nnstreamer_tpu.models import registry as jax_registry
from nnstreamer_tpu.models import streamformer_lm as JLM
from nnstreamer_tpu.parallel import train_step as JT
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu.tensor.buffer import XBatchMeta as JaxXBatchMeta
from nnstreamer_tpu.tensor.info import TensorInfo as JaxInfo
from nnstreamer_tpu.tensor.info import TensorsInfo as JaxInfos
from nnstreamer_tpu.tensor.types import TensorType as JaxType
from nnstreamer_tpu_torch.analysis import compileledger as port_ledger
from nnstreamer_tpu_torch.elements.filter_elem import CrossStreamBatcher
from nnstreamer_tpu_torch.filter.backends._torchexec import (
    BatchHandle, CastingHandle, TorchExecMixin)
from nnstreamer_tpu_torch.filter.framework import (Accelerator,
                                                   FilterProperties,
                                                   open_backend)
from nnstreamer_tpu_torch.models import mobilenet_v2 as port_mnv2
from nnstreamer_tpu_torch.models import registry as port_registry
from nnstreamer_tpu_torch.models import streamformer_lm as TLM
from nnstreamer_tpu_torch.models import vit as port_vit
from nnstreamer_tpu_torch.models.mlp import mlp_params_from_jax
from nnstreamer_tpu_torch.parallel import train_step as TT
from nnstreamer_tpu_torch.query.overload import bucket_budget
from nnstreamer_tpu_torch.tensor.buffer import (BatchView, TensorBuffer,
                                                XBatchMeta, is_device_array)
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsInfo
from nnstreamer_tpu_torch.tensor.types import TensorType

ATOL = RTOL = 1e-4
VMAP = "filter.jitexec.vmap"


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# CrossStreamBatcher
# ---------------------------------------------------------------------------

BATCHERS = pytest.mark.parametrize("cls", [CrossStreamBatcher, JaxBatcher],
                                   ids=["port", "jax"])


class TestCrossStreamBatcher:
    @BATCHERS
    def test_fill_and_full(self, cls):
        b = cls(3, 1.0, clock=lambda: 0.0)
        assert not b.add("a") and b.fill == 1
        assert not b.add("b")
        assert b.add("c") and b.full()
        assert b.take() == ["a", "b", "c"]
        assert b.fill == 0 and b.opened_at() is None

    @BATCHERS
    def test_min_deadline_over_budgets(self, cls):
        now = [0.0]
        b = cls(8, 1.0, clock=lambda: now[0])
        b.add("bronze", budget_s=1.0)
        now[0] = 0.2
        b.add("gold", budget_s=0.25)   # pulls the deadline IN
        assert b.deadline() == pytest.approx(0.45)
        now[0] = 0.4
        assert not b.expired()
        assert b.remaining() == pytest.approx(0.05)
        now[0] = 0.46
        assert b.expired()

    @BATCHERS
    def test_greedy_budget_expires_immediately(self, cls):
        now = [5.0]
        b = cls(8, 0.0, clock=lambda: now[0])
        b.add("x")          # default budget = timeout_s = 0
        assert b.expired() and b.remaining() == 0.0

    @BATCHERS
    def test_take_resets_deadline(self, cls):
        now = [0.0]
        b = cls(2, 1.0, clock=lambda: now[0])
        b.add("a")
        b.take()
        assert b.deadline() is None and not b.expired()
        assert b.remaining() == float("inf")

    def test_qos_budgets(self):
        assert bucket_budget("gold", 1.0) == pytest.approx(0.25)
        assert bucket_budget("silver", 1.0) == pytest.approx(0.5)
        assert bucket_budget("bronze", 1.0) == pytest.approx(1.0)
        assert bucket_budget(None, 1.0) == pytest.approx(0.5)  # silver
        assert bucket_budget("gold", 0.0) == 0.0  # greedy: never wait


# ---------------------------------------------------------------------------
# invoke_stacked and the cross-stream buffer
# ---------------------------------------------------------------------------

MLP = {"in_dim": "8", "width": "16", "depth": "1", "out_dim": "4",
       "seed": "3"}


@pytest.fixture
def ledgers():
    """Both compile ledgers on and empty; restored afterwards."""
    was = (jax_ledger.ENABLED, port_ledger.ENABLED)
    for ledger in (jax_ledger, port_ledger):
        ledger.configure(True)
        ledger.reset()
    yield
    jax_ledger.configure(was[0])
    port_ledger.configure(was[1])
    jax_ledger.reset()
    port_ledger.reset()


@pytest.fixture
def mlp_pair(monkeypatch):
    """The port's ``mlp`` builder loads the JAX model's weights; both
    backends open on the CPU."""
    jax_params = jax.tree_util.tree_map(
        np.asarray, jax_registry.get_model("mlp", dict(MLP)).params)
    port_registry.list_models()          # loads the registry
    build = port_registry._MODELS["mlp"]

    def build_from_jax(custom, device=None):
        model = build(custom, "cpu")
        model.module.load_state_dict(mlp_params_from_jax(jax_params))
        return model

    monkeypatch.setitem(port_registry._MODELS, "mlp", build_from_jax)
    jfw = jax_open(JaxProps(framework="xla", model="mlp",
                            custom_properties=dict(MLP)))
    pfw = open_backend(FilterProperties(framework="xla", model="mlp",
                                        accelerators=[Accelerator.CPU],
                                        custom_properties=dict(MLP)))
    yield jfw, pfw
    jfw.close()
    pfw.close()


class TestFilterXBatch:
    def test_invoke_stacked_pads_to_one_executable(self, ledgers, mlp_pair):
        """Fills 1/3/5/8 at capacity 8 pad to 1/4/8/8 rows: exactly 3
        batched compiles (one a pad shape) on each package, none on a
        second pass; the live rows equal per-row invokes and the JAX
        package's rows."""
        jfw, pfw = mlp_pair
        rng = np.random.default_rng(0)
        fills = ((1, 1), (3, 4), (5, 8), (8, 8))
        batches = {n: rng.standard_normal((n, 8)).astype(np.float32)
                   for n, _ in fills}
        for n, want_pad in fills:
            rows = batches[n]
            got = pfw.invoke_stacked([rows], n, capacity=8)[0]
            want = jfw.invoke_stacked([rows], n, capacity=8)[0]
            assert got.shape[0] == np.asarray(want).shape[0] == want_pad
            per_row = np.stack([pfw.invoke([rows[i]])[0].numpy()
                                for i in range(n)])
            np.testing.assert_allclose(got.numpy()[:n], per_row,
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=ATOL, atol=ATOL)
        assert port_ledger.count(VMAP) == jax_ledger.count(VMAP) == 3
        for n, _ in fills:
            pfw.invoke_stacked([batches[n]], n, capacity=8)
            jfw.invoke_stacked([batches[n]], n, capacity=8)
        assert port_ledger.count(VMAP) == jax_ledger.count(VMAP) == 3
        assert [e.signature for e in port_ledger.events(VMAP)] == \
            [e.signature for e in jax_ledger.events(VMAP)]

    @pytest.mark.parametrize("capacity,shapes", [(8, 4), (32, 7)])
    def test_warmup_stacked_compiles_every_pad_shape_once(
            self, ledgers, mlp_pair, capacity, shapes):
        jfw, pfw = mlp_pair
        pfw.warmup_stacked(capacity)
        jfw.warmup_stacked(capacity)
        assert port_ledger.count(VMAP) == jax_ledger.count(VMAP) == shapes
        rng = np.random.default_rng(1)
        for n in range(1, capacity + 1):
            rows = rng.standard_normal((n, 8)).astype(np.float32)
            out = pfw.invoke_stacked([rows], n, capacity=capacity)[0]
            assert out.shape[0] == TorchExecMixin.pad_rows(n, capacity)
        assert port_ledger.count(VMAP) == shapes      # no fill recompiles

    def _xbatch_run(self, port, n, capacity, framework="xla model=mlp "
                    "custom=in_dim:8,width:16,depth:1,out_dim:4,seed:3"):
        """One hand-fed cross-stream buffer of ``n`` stacked rows through
        a filter, then EOS; the filter and the sink's buffers."""
        pkg = nnstreamer_tpu_torch if port else nnstreamer_tpu
        accel = "accelerator=true:cpu " if port and "xla" in framework \
            else ""
        p = pkg.parse_launch(
            "appsrc name=in caps=other/tensors,format=static,num_tensors=1,"
            "dimensions=8,types=float32,framerate=0/1 ! tensor_filter "
            f"{accel}framework={framework} name=f ! tensor_sink name=out")
        rows = np.random.default_rng(2).standard_normal(
            (n, 8)).astype(np.float32)
        meta_cls = XBatchMeta if port else JaxXBatchMeta
        buf_cls = TensorBuffer if port else JaxBuffer
        buf = buf_cls(tensors=[rows], pts=0)
        buf.extra["nns_xbatch"] = meta_cls(
            [{"client": i} for i in range(n)], list(range(n)), capacity)
        p.play()
        try:
            p.get("in").push_buffer(buf)
            p.get("in").end_of_stream()
            p.wait(timeout=60)
            return p.get("f"), p.get("out").results, rows
        finally:
            p.stop()

    def test_cross_stream_buffer_through_the_filter(self, mlp_pair):
        f, got, rows = self._xbatch_run(True, 5, 8)
        jf, jgot, _ = self._xbatch_run(False, 5, 8)
        assert len(got) == len(jgot) == 1
        out = got[0].np(0)
        assert out.shape == np.asarray(jgot[0].tensors[0]).shape == (8, 4)
        np.testing.assert_allclose(out, np.asarray(jgot[0].tensors[0]),
                                   rtol=ATOL, atol=ATOL)
        assert got[0].extra["nns_xbatch"].n == 5
        assert (f._xb_invokes, f._xb_frames, f._xb_warm) == \
            (jf._xb_invokes, jf._xb_frames, jf._xb_warm) == (1, 5, 8)

    def test_cross_stream_buffer_row_loop_without_batching(self,
                                                           echo_backend):
        f, got, rows = self._xbatch_run(True, 3, 4, framework="echo "
                                        "model=x")
        np.testing.assert_array_equal(got[0].np(0), rows * 2.0)
        assert (f._xb_invokes, f._xb_frames) == (1, 3)


class _Echo(nnstreamer_tpu_torch.filter.framework.FilterFramework):
    NAME = "echo"
    INFO = TensorsInfo([TensorInfo(TensorType.FLOAT32, (8,))])

    def get_model_info(self):
        return self.INFO, self.INFO

    def invoke(self, inputs):
        return [np.asarray(inputs[0]) * 2.0]


@pytest.fixture
def echo_backend():
    from nnstreamer_tpu_torch.filter.framework import _FILTERS, \
        register_filter

    register_filter(_Echo)
    yield
    _FILTERS.pop("echo", None)


# ---------------------------------------------------------------------------
# output-device cascades (tests/test_device_resident.py)
# ---------------------------------------------------------------------------

VIDEO_CAPS = "video/x-raw,format=RGB,width=8,height=8,framerate=30/1"
#: cascade outputs across the packages (tests/test_device_resident.py
#: holds its cascades to its host path within the same)
CASCADE_RTOL = 1e-3
W_PIXEL = np.linspace(-1.0, 1.0, 8 * 8 * 3 * 8,
                      dtype=np.float32).reshape(8 * 8 * 3, 8)
W_HEAD = np.linspace(1.0, -1.0, 8 * 3, dtype=np.float32).reshape(8, 3)


class _Pixel(torch.nn.Module):
    """(8, 8, 3) u8 → (8,) f32; a batch ``(B, 8, 8, 3)`` → ``(B, 8)``."""

    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.tensor(W_PIXEL))

    def forward(self, x):
        return (x.float().flatten(-3) @ self.w,)


class _Head(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("w", torch.tensor(W_HEAD))

    def forward(self, x):
        return (x.float() @ self.w,)


@pytest.fixture
def cascade_models():
    def jax_model(name, w, in_shape, in_type, out):
        def build(custom):
            def forward(params, x):
                return (jnp.asarray(x, jnp.float32).reshape(-1) @ params,)

            return jax_registry.Model(
                name=name, forward=forward, params=w,
                in_info=JaxInfos([JaxInfo(in_type, in_shape)]),
                out_info=JaxInfos([JaxInfo(JaxType.FLOAT32, (out,))]))
        return build

    def port_model(name, module, in_shape, in_type, out, batched):
        def build(custom, device=None):
            m = module().to(device)
            return port_registry.Model(
                name=name, module=m, device=torch.device(device),
                in_info=TensorsInfo([TensorInfo(in_type, in_shape)]),
                out_info=TensorsInfo([TensorInfo(TensorType.FLOAT32,
                                                 (out,))]),
                batched=m if batched else None)
        return build

    jax_registry.register_model("pixel8")(jax_model(
        "pixel8", W_PIXEL, (3, 8, 8), JaxType.UINT8, 8))
    jax_registry.register_model("head3")(jax_model(
        "head3", W_HEAD, (8,), JaxType.FLOAT32, 3))
    # the pixel model has its own batched forward, the head goes through
    # torch.func.vmap
    port_registry.register_model("pixel8")(port_model(
        "pixel8", _Pixel, (3, 8, 8), TensorType.UINT8, 8, True))
    port_registry.register_model("head3")(port_model(
        "head3", _Head, (8,), TensorType.FLOAT32, 3, False))
    yield
    for name in ("pixel8", "head3"):
        jax_registry._MODELS.pop(name, None)
        port_registry._MODELS.pop(name, None)


def _collect(line, n, port=True):
    pkg = nnstreamer_tpu_torch if port else nnstreamer_tpu
    got = []
    p = pkg.parse_launch(line)
    p.get("out").connect("new-data",
                         lambda b: got.append(np.asarray(b.tensors[0])))
    p.run(timeout=60)
    assert len(got) == n
    return got


def _cascade(n, a_batch, b_batch, a_dev="output-device=true", port=True):
    accel = "accelerator=true:cpu " if port else ""
    return (f"videotestsrc num-buffers={n} pattern=random seed=9 "
            f"cache-frames=4 ! {VIDEO_CAPS} ! tensor_converter ! "
            f"tensor_filter framework=xla {accel}model=pixel8 "
            f"batch={a_batch} {a_dev} name=a ! "
            f"tensor_filter framework=xla {accel}model=head3 "
            f"batch={b_batch} name=b ! tensor_sink name=out")


class TestDeviceCascade:
    @pytest.mark.parametrize("n,a_batch,b_batch", [
        (12, 4, 4), (12, 4, 8), (12, 8, 4), (12, 4, 1), (12, 1, 4),
        (9, 8, 4),    # 8-frame batch + a 1-frame flush tail into B
    ])
    def test_cascade_matches_host_path(self, cascade_models, n, a_batch,
                                       b_batch):
        dev = _collect(_cascade(n, a_batch, b_batch), n)
        host = _collect(_cascade(n, a_batch, b_batch, a_dev=""), n)
        jax_dev = _collect(_cascade(n, a_batch, b_batch, port=False), n,
                           port=False)
        for h, d, j in zip(host, dev, jax_dev):
            np.testing.assert_allclose(d, h, rtol=1e-5)
            # 192-term f32 dot products of pixel values: the JAX
            # package's own cascade tolerance
            np.testing.assert_allclose(d, j, rtol=CASCADE_RTOL)

    def test_intermediate_payloads_are_batchviews(self, cascade_models):
        got = []
        p = nnstreamer_tpu_torch.parse_launch(
            "videotestsrc num-buffers=8 pattern=random seed=9 "
            f"cache-frames=4 ! {VIDEO_CAPS} ! tensor_converter ! "
            "tensor_filter framework=xla accelerator=true:cpu model=pixel8 "
            "batch=4 output-device=true name=a ! tensor_sink name=out")
        p.get("out").connect("new-data", lambda b: got.append(b.tensors[0]))
        p.run(timeout=60)
        assert len(got) == 8
        assert all(isinstance(t, BatchView) and is_device_array(t)
                   for t in got)
        # sibling views share one underlying batch; materialization is a
        # cached one-shot per batch
        assert got[0].batch is got[3].batch
        assert got[0].batch is not got[4].batch
        a = np.asarray(got[1])
        assert a.shape == got[1].shape == (8,) and a.dtype == np.float32
        assert got[1]._cache["host"] is got[2]._host_batch()
        np.testing.assert_array_equal(a, got[1].device_slice().numpy())

    def test_stage_rejoins_contiguous_views(self, cascade_models):
        with _Opened("head3") as fw:
            batch = torch.arange(32, dtype=torch.float32).reshape(4, 8)
            views = [BatchView(batch, i, {}) for i in range(4)]
            # 1:1 with the upstream batch: no op, the batch itself
            assert fw._stage_batch(views, 4) is batch
            # a partial run pads by repeating its last row
            staged = fw._stage_batch(views[1:3], 4)
            assert torch.equal(staged, batch[[1, 2, 2, 2]])
            # two batches' runs are joined
            other = batch + 100
            mixed = views[2:] + [BatchView(other, 0, {})]
            assert torch.equal(fw._stage_batch(mixed, 4),
                               torch.stack([batch[2], batch[3], other[0],
                                            other[0]]))


class _Opened:
    """A port ``xla`` backend on the CPU, closed on exit."""

    def __init__(self, model, custom=""):
        self.fw = open_backend(FilterProperties(
            framework="xla", model=model, accelerators=[Accelerator.CPU],
            custom_properties=FilterProperties.parse_custom(custom)))

    def __enter__(self):
        return self.fw

    def __exit__(self, *exc):
        self.fw.close()


def test_handles_slice_padding_and_cast():
    outs = [torch.arange(12, dtype=torch.float32).reshape(4, 3)]
    handle = BatchHandle(outs, 3)
    rows = handle.wait()
    assert len(rows) == 3
    np.testing.assert_array_equal(rows[2][0], [6.0, 7.0, 8.0])
    views = BatchHandle(outs, 3, emit_device=True).views()
    assert [v[0].index for v in views] == [0, 1, 2]
    cast = CastingHandle(BatchHandle(outs, 2), [np.int64]).wait()
    assert cast[1][0].dtype == np.int64 and list(cast[1][0]) == [3, 4, 5]


# ---------------------------------------------------------------------------
# batched registry models against the JAX package's vmapped forwards
# ---------------------------------------------------------------------------

def _frames(b, size, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, size, size, 3),
                                                np.uint8)


def _jax_vmapped(model, batch):
    fwd = jax.jit(jax.vmap(model.forward, in_axes=(None, 0)))
    return [np.asarray(o) for o in fwd(model.params, batch)]


def _port_batched(model, batch):
    with torch.inference_mode():
        return [o.numpy() for o in model.batched(torch.from_numpy(batch))]


def _port_per_frame(model, batch):
    with torch.inference_mode():
        return np.stack([model.module(torch.from_numpy(x))[0].numpy()
                         for x in batch])


def test_batched_mobilenet_matches_jax_vmap():
    custom = {"input_size": "32", "num_classes": "10", "dtype": "float32",
              "use_pallas": "1"}
    jm = jax_registry.get_model("mobilenet_v2", custom)
    tm = port_registry.get_model("mobilenet_v2", custom, device="cpu")
    port_mnv2.load_flax(tm.module, jax.tree_util.tree_map(np.asarray,
                                                          jm.params))
    batch = _frames(4, 32)
    got, = _port_batched(tm, batch)
    want, = _jax_vmapped(jm, batch)
    assert got.shape == (4, 10)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _port_per_frame(tm, batch), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("attn", ["flash", "naive"])
def test_batched_vit_matches_jax_vmap(attn):
    custom = {"input_size": "32", "patch": "16", "dim": "64", "depth": "2",
              "heads": "2", "num_classes": "10", "dtype": "float32",
              "attn": attn}
    jm = jax_registry.get_model("vit", custom)
    tm = port_registry.get_model("vit", custom, device="cpu")
    port_vit.load_flax(tm.module, jax.tree_util.tree_map(np.asarray,
                                                         jm.params))
    batch = _frames(3, 32, seed=1)
    got, = _port_batched(tm, batch)
    want, = _jax_vmapped(jm, batch)
    assert got.shape == (3, 10)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, _port_per_frame(tm, batch), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("flash", [True, False])
def test_batched_lm_matches_jax_vmap(flash):
    sizes = dict(vocab=61, dim=32, heads=4, head_dim=8, mlp=64, layers=2,
                 experts=2, max_seq=48)
    jc = JT.StreamFormerConfig(**sizes, dtype=jnp.float32)
    tc = TT.StreamFormerConfig(**sizes, dtype=torch.float32)
    jp = JT.init_params(jc, 0)
    tp = TLM.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), tc,
                             device="cpu")
    toks = np.random.default_rng(0).integers(0, 61, (3, 24)).astype(np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda t: JLM.forward_logits(jp, t, jc, flash=False)))(toks))
    module = TLM.StreamFormerLM(tp, tc)
    with torch.inference_mode():
        got = TLM.forward_logits(tp, torch.from_numpy(toks), tc,
                                 flash=flash).numpy()
        per_row = np.stack([module(torch.from_numpy(t))[0].numpy()
                            for t in toks])
    assert got.shape == (3, 24, 61)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got, per_row, atol=ATOL, rtol=RTOL)


def test_batched_mlp_matches_jax_vmap():
    jm = jax_registry.get_model("mlp", dict(MLP))
    tm = port_registry.get_model("mlp", dict(MLP), device="cpu")
    tm.module.load_state_dict(mlp_params_from_jax(
        jax.tree_util.tree_map(np.asarray, jm.params)))
    rows = np.random.default_rng(4).standard_normal((5, 8)).astype(
        np.float32)
    with torch.inference_mode():
        got = tm.batched(torch.from_numpy(rows))[0].numpy()
    want, = _jax_vmapped(jm, rows)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


#: each registry model at a CPU-sized width
SMALL = {
    "mlp": MLP,
    "mobilenet_v2": {"input_size": "32", "num_classes": "10"},
    "vit": {"input_size": "32", "dim": "64", "depth": "1", "heads": "2",
            "num_classes": "10"},
    "streamformer_lm": {"vocab": "61", "dim": "32", "heads": "4",
                        "head_dim": "8", "mlp": "64", "layers": "1",
                        "experts": "2", "seq": "16"},
}


def test_no_registry_model_goes_through_vmap(monkeypatch):
    """Every registry model supplies its own batched forward: with
    ``torch.func.vmap`` unavailable each still serves a padded batch
    through the backend, equal to its per-frame invokes."""
    assert sorted(port_registry.list_models()) == sorted(SMALL)

    def no_vmap(*args, **kwargs):
        raise AssertionError("torch.func.vmap reached")

    monkeypatch.setattr(torch.func, "vmap", no_vmap)
    for name, custom in SMALL.items():
        assert port_registry.get_model(name, custom,
                                       device="cpu").batched is not None
        custom = ",".join(f"{k}:{v}" for k, v in custom.items())
        with _Opened(name, custom) as fw:
            assert fw._batched_fn is fw._model.batched
            in_info, _ = fw.get_model_info()
            rng = np.random.default_rng(0)
            frames = [[(rng.integers(0, 61, i.np_shape) if i.np_dtype.kind
                        in "iu" else rng.standard_normal(i.np_shape))
                       .astype(i.np_dtype) for i in in_info]
                      for _ in range(3)]
            rows = fw.invoke_batched(frames, 4).wait()
            for frame, row in zip(frames, rows):
                want = fw.invoke(frame)[0].numpy()
                np.testing.assert_allclose(row[0], want, atol=ATOL,
                                           rtol=RTOL)

