"""Micro-batched tensor_filter on both packages.

The port's ``batch``/``inflight``/``batch-timeout-ms``/``workers``
machinery, case for case against the JAX package's tests
(``tests/test_batch.py``, the deadline cases of ``tests/test_hotpath.py``,
the worker cases of ``tests/test_schedule.py``): the same frames go
through the same launch string on both packages (the port's with
``accelerator=true:cpu``), and through the port's batch=1 path, which
must give the same outputs, order, timestamps and EOS.  A tiny f32
matmul model stands in for a network; it has no batched forward of its
own, so the port serves its batches through ``torch.func.vmap``.

Tolerances: f32 outputs within rtol 1e-5 of each other (a batched and a
per-frame product may sum in another order); labels exactly.
"""

import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nnstreamer_tpu
import nnstreamer_tpu_torch
from nnstreamer_tpu.models import registry as jax_registry
from nnstreamer_tpu.pipeline.element import CustomEvent as JaxCustomEvent
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu.tensor.info import TensorInfo as JaxInfo
from nnstreamer_tpu.tensor.info import TensorsInfo as JaxInfos
from nnstreamer_tpu.tensor.types import TensorType as JaxType
from nnstreamer_tpu_torch.filter.framework import (FilterFramework,
                                                   FilterStatistics,
                                                   _FILTERS, register_filter)
from nnstreamer_tpu_torch.models import registry as port_registry
from nnstreamer_tpu_torch.pipeline.element import CustomEvent
from nnstreamer_tpu_torch.pipeline.graph import PipelineError
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
from nnstreamer_tpu_torch.tensor.info import TensorInfo, TensorsInfo
from nnstreamer_tpu_torch.tensor.types import TensorType

CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
        "types=float32,framerate=0/1")
W = np.arange(32, dtype=np.float32).reshape(4, 8)


class _MatMul(torch.nn.Module):
    def __init__(self, w):
        super().__init__()
        self.register_buffer("w", torch.tensor(w))

    def forward(self, x):
        return (x.float() @ self.w,)


def _register(name, w):
    """``name`` in both registries: ``x @ w``, (4,) f32 in, (w.shape[1],)
    f32 out, with no batched forward in the port."""
    out = w.shape[1]

    def build_jax(custom):
        def forward(params, x):
            return (jnp.asarray(x, jnp.float32) @ params,)

        return jax_registry.Model(
            name=name, forward=forward, params=w,
            in_info=JaxInfos([JaxInfo(JaxType.FLOAT32, (4,))]),
            out_info=JaxInfos([JaxInfo(JaxType.FLOAT32, (out,))]))

    def build_port(custom, device=None):
        device = torch.device(device or "cpu")
        return port_registry.Model(
            name=name, module=_MatMul(w).to(device), device=device,
            in_info=TensorsInfo([TensorInfo(TensorType.FLOAT32, (4,))]),
            out_info=TensorsInfo([TensorInfo(TensorType.FLOAT32, (out,))]))

    jax_registry.register_model(name)(build_jax)
    port_registry.register_model(name)(build_port)


def _unregister(*names):
    for name in names:
        jax_registry._MODELS.pop(name, None)
        port_registry._MODELS.pop(name, None)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def tiny_model():
    _register("tiny_batch", W)
    yield W
    _unregister("tiny_batch")


def _launch(filt, tail="tensor_sink name=out", port=True):
    accel = "accelerator=true:cpu " if port else ""
    return (f"appsrc caps={CAPS} name=in ! tensor_filter framework=xla "
            f"{accel}{filt} name=f ! {tail}")


def _run(filt, feeds, pts=None, port=True, tail="tensor_sink name=out",
         events=None):
    """Push ``feeds`` (and ``events``: index -> event pushed before that
    frame) through one package's pipeline; the sink's buffers."""
    pkg = nnstreamer_tpu_torch if port else nnstreamer_tpu
    buf_cls = TensorBuffer if port else JaxBuffer
    p = pkg.parse_launch(_launch(filt, tail, port))
    got = []
    p.get("out").connect("new-data", got.append)
    p.play()
    try:
        src = p.get("in")
        for i, arr in enumerate(feeds):
            if events and i in events:
                src.push_event(events[i](port))
            src.push_buffer(buf_cls(tensors=[arr],
                                    pts=None if pts is None else pts[i]))
        src.end_of_stream()
        p.wait(timeout=60)
    finally:
        p.stop()
    return got


def _feeds(n):
    rng = np.random.default_rng(7)
    return [rng.standard_normal(4).astype(np.float32) for _ in range(n)]


def _assert_same(got, ref, n, pts=True):
    assert len(got) == len(ref) == n
    for i, (g, r) in enumerate(zip(got, ref)):
        if pts:
            assert g.pts == r.pts == i * 1000
        np.testing.assert_allclose(g.np(0), np.asarray(r.np(0)), rtol=1e-5)


def _wait_for(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.01)
    return cond()


class TestBatchedInvoke:
    @pytest.mark.parametrize("n,batch", [
        (12, 4),   # exact multiple: 3 full batches
        (10, 4),   # EOS flush pads the 2-frame remainder
        (3, 4),    # stream shorter than one batch
        (7, 16),   # batch larger than whole stream
        (33, 32),  # 1-frame EOS tail at a big bucket: the per-frame flush
        (2, 64),   # whole stream goes through the flush path
    ])
    def test_matches_unbatched_and_preserves_order(self, tiny_model, n,
                                                   batch):
        feeds = _feeds(n)
        pts = [i * 1000 for i in range(n)]
        ref = _run("model=tiny_batch batch=1", feeds, pts)
        got = _run(f"model=tiny_batch batch={batch}", feeds, pts)
        jax_got = _run(f"model=tiny_batch batch={batch}", feeds, pts,
                       port=False)
        _assert_same(got, ref, n)
        _assert_same(got, jax_got, n)

    def test_double_buffering_defers_exactly_one_batch(self, tiny_model):
        """Batch k is pushed only when batch k+1 dispatches (or at EOS)."""
        p = nnstreamer_tpu_torch.parse_launch(
            _launch("model=tiny_batch batch=4"))
        got = []
        p.get("out").connect("new-data", got.append)
        p.play()
        try:
            src, f = p.get("in"), p.get("f")
            feeds = _feeds(8)
            for arr in feeds[:4]:
                src.push_buffer(TensorBuffer(tensors=[arr]))
            assert _wait_for(lambda: f._inflight)
            assert len(f._inflight) == 1 and len(got) == 0
            for arr in feeds[4:]:
                src.push_buffer(TensorBuffer(tensors=[arr]))
            src.end_of_stream()
            p.wait(timeout=60)
        finally:
            p.stop()
        assert len(got) == 8

    @pytest.mark.parametrize("n,batch,depth", [
        (24, 4, 3),   # 6 full batches through a 3-deep queue
        (10, 4, 3),   # EOS flush drains a part-full queue + remainder
        (8, 4, 8),    # depth larger than the whole stream: EOS drains all
        (33, 8, 2),   # 1-frame EOS tail behind a 2-deep queue
    ])
    def test_inflight_depth_matches_unbatched(self, tiny_model, n, batch,
                                              depth):
        feeds = _feeds(n)
        pts = [i * 1000 for i in range(n)]
        ref = _run("model=tiny_batch", feeds, pts)
        filt = f"model=tiny_batch batch={batch} inflight={depth}"
        _assert_same(_run(filt, feeds, pts), ref, n)
        _assert_same(_run(filt, feeds, pts, port=False), ref, n)

    def test_inflight_queue_holds_depth_batches(self, tiny_model):
        p = nnstreamer_tpu_torch.parse_launch(
            _launch("model=tiny_batch batch=4 inflight=2"))
        got = []
        p.get("out").connect("new-data", got.append)
        p.play()
        try:
            src, f = p.get("in"), p.get("f")
            feeds = _feeds(12)
            for arr in feeds[:8]:
                src.push_buffer(TensorBuffer(tensors=[arr]))
            assert _wait_for(lambda: len(f._inflight) >= 2)
            # two dispatched batches queued, nothing surfaced yet
            assert len(f._inflight) == 2 and len(got) == 0
            for arr in feeds[8:]:
                src.push_buffer(TensorBuffer(tensors=[arr]))
            src.end_of_stream()
            p.wait(timeout=60)
        finally:
            p.stop()
        assert len(got) == 12

    def test_inflight_drains_midstream_on_model_update(self, tiny_model):
        """Every frame pushed before a model update flushes through the
        OLD weights in stream order, every frame after runs the NEW."""
        w2 = np.full((4, 8), 2.0, np.float32)
        _register("tiny_batch_b", w2)
        try:
            feeds = _feeds(20)
            filt = "model=tiny_batch batch=4 inflight=3 is-updatable=true"

            def update(port):
                cls = CustomEvent if port else JaxCustomEvent
                return cls("tensor_filter_update_model",
                           {"model": "tiny_batch_b"})

            for port in (True, False):
                got = _run(filt, feeds, port=port, events={10: update})
                assert len(got) == 20
                for i, (f_in, g) in enumerate(zip(feeds, got)):
                    want = f_in @ (W if i < 10 else w2)
                    np.testing.assert_allclose(np.asarray(g.np(0)), want,
                                               rtol=1e-5)
        finally:
            _unregister("tiny_batch_b")

    def _reload_labels(self, second_model, port):
        filt = ("model=tiny_batch batch=4 inflight=2 is-updatable=true")
        onehots = [np.eye(4, dtype=np.float32)[i % 4] for i in range(16)]

        def update(port):
            cls = CustomEvent if port else JaxCustomEvent
            return cls("tensor_filter_update_model", {"model": second_model})

        pkg = nnstreamer_tpu_torch if port else nnstreamer_tpu
        buf_cls = TensorBuffer if port else JaxBuffer
        p = pkg.parse_launch(_launch(
            filt, "tensor_decoder mode=image_labeling ! tensor_sink "
                  "name=out", port))
        got = []
        p.get("out").connect("new-data",
                             lambda b: got.append(b.extra["index"]))
        p.play()
        try:
            f, src = p.get("f"), p.get("in")
            # the pushdown must be fused BEFORE the reload, or the test
            # passes vacuously on the host-decode path
            assert _wait_for(lambda: f.fw.has_postprocess())
            for i, arr in enumerate(onehots):
                if i == 8:
                    src.push_event(update(port))
                src.push_buffer(buf_cls(tensors=[arr]))
            src.end_of_stream()
            p.wait(timeout=60)
            fused = f.fw.has_postprocess()
        finally:
            p.stop()
        return got, fused

    def test_model_name_reload_with_pushdown_decoder(self):
        """A model-NAME reload behind a pushdown-fused decoder: the swap
        drops the backend's fused reduction and the element re-applies it
        (A routes one-hot i -> i, B routes i -> 7-i)."""
        w_a = np.eye(4, 8, dtype=np.float32) * 10.0
        w_b = np.fliplr(np.eye(4, 8, dtype=np.float32) * 10.0).copy()
        _register("tiny_batch", w_a)
        _register("tiny_batch_c", w_b)
        try:
            want = [i % 4 for i in range(8)] + [7 - i % 4 for i in range(8)]
            for port in (True, False):
                got, fused = self._reload_labels("tiny_batch_c", port)
                assert got == want and fused
        finally:
            _unregister("tiny_batch", "tiny_batch_c")

    def test_same_model_reload_does_not_double_fuse(self, tiny_model):
        """A reload of the same model re-applies the reduction once: an
        argmax of the argmax would label every frame 0."""
        for port in (True, False):
            got, fused = self._reload_labels("tiny_batch", port)
            # x @ arange(32): one-hot i selects row i, argmax column 7
            assert got == [7] * 16 and fused

    def test_inflight_without_batching_is_clamped(self, tiny_model):
        p = nnstreamer_tpu_torch.parse_launch(
            _launch("model=tiny_batch inflight=4"))
        p.play()
        try:
            assert p.get("f")._inflight_depth == 1
            src = p.get("in")
            for arr in _feeds(5):
                src.push_buffer(TensorBuffer(tensors=[arr]))
            src.end_of_stream()
            p.wait(timeout=60)
            assert len(p.get("out").results) == 5
        finally:
            p.stop()

    def test_batched_with_output_combination(self, tiny_model):
        feeds = _feeds(6)
        filt = "model=tiny_batch batch=4 output-combination=0/0"
        for port in (True, False):
            got = _run(filt, feeds, port=port)
            assert len(got) == 6
            for f_in, g in zip(feeds, got):
                assert g.num_tensors == 2
                np.testing.assert_allclose(g.np(0), f_in, rtol=1e-6)
                np.testing.assert_allclose(g.np(1), f_in @ W, rtol=1e-5)

    def test_batch_ignored_for_nonbatching_backend(self, echo_backend):
        """A backend without SUPPORTS_BATCHING runs per frame."""
        p = nnstreamer_tpu_torch.parse_launch(
            f"appsrc caps={CAPS} name=in ! tensor_filter framework=echo "
            "model=x batch=4 name=f ! tensor_sink name=out")
        p.play()
        try:
            assert p.get("f")._batch == 1
            src = p.get("in")
            for arr in _feeds(5):
                src.push_buffer(TensorBuffer(tensors=[arr]))
            src.end_of_stream()
            p.wait(timeout=60)
            assert len(p.get("out").results) == 5
        finally:
            p.stop()

    def test_batched_pushdown_fusion(self, tiny_model):
        """The decoder's reduction is fused into the batched forward."""
        feeds = [np.eye(4, dtype=np.float32)[i % 4] for i in range(9)]
        tail = "tensor_decoder mode=image_labeling ! tensor_sink name=out"
        p = nnstreamer_tpu_torch.parse_launch(
            _launch("model=tiny_batch batch=4", tail))
        got = []
        p.get("out").connect("new-data", got.append)
        p.play()
        try:
            src = p.get("in")
            for arr in feeds:
                src.push_buffer(TensorBuffer(tensors=[arr]))
            src.end_of_stream()
            p.wait(timeout=60)
            assert p.get("f").fw.has_postprocess()
        finally:
            p.stop()
        jax_got = _run("model=tiny_batch batch=4", feeds, port=False,
                       tail=tail)
        assert [g.extra["index"] for g in got] == \
            [g.extra["index"] for g in jax_got] == \
            [int(np.argmax(f @ W)) for f in feeds]


# ---------------------------------------------------------------------------
# the deadline coalescer (tests/test_hotpath.py TestBatchTimeout)
# ---------------------------------------------------------------------------

class TestBatchTimeout:
    def _play(self, filt):
        p = nnstreamer_tpu_torch.parse_launch(_launch(filt))
        got = []
        p.get("out").connect("new-data", got.append)
        p.play()
        return p, got

    def test_deadline_dispatches_partial_bucket(self, tiny_model):
        p, got = self._play("model=tiny_batch batch=4 batch-timeout-ms=80")
        try:
            src = p.get("in")
            for i in range(2):
                src.push_buffer(TensorBuffer(
                    tensors=[np.full(4, i, np.float32)], pts=i))
            # 2 frames < batch=4: only the deadline can dispatch them
            assert _wait_for(lambda: len(got) == 2)
            for i in range(2, 6):
                src.push_buffer(TensorBuffer(
                    tensors=[np.full(4, i, np.float32)], pts=i))
            src.end_of_stream()
            p.wait(timeout=30)
        finally:
            p.stop()
        assert [b.pts for b in got] == list(range(6))
        for i, b in enumerate(got):
            np.testing.assert_allclose(b.np(0), np.full(4, i, np.float32)
                                       @ W)

    def test_deadline_flush_preserves_inflight_overlap(self, tiny_model):
        p, got = self._play(
            "model=tiny_batch batch=2 inflight=2 batch-timeout-ms=80")
        try:
            src = p.get("in")
            for i in range(5):
                src.push_buffer(TensorBuffer(
                    tensors=[np.full(4, i, np.float32)], pts=i))
            assert _wait_for(lambda: len(got) == 5)
            src.end_of_stream()
            p.wait(timeout=30)
        finally:
            p.stop()
        assert [b.pts for b in got] == list(range(5))

    def test_timeout_without_batching_is_ignored(self, tiny_model):
        p, got = self._play("model=tiny_batch batch-timeout-ms=50")
        try:
            assert p.get("f")._batch_deadline == 0.0
            src = p.get("in")
            src.push_buffer(TensorBuffer(tensors=[np.ones(4, np.float32)],
                                         pts=0))
            src.end_of_stream()
            p.wait(timeout=30)
        finally:
            p.stop()
        assert len(got) == 1

    def test_full_buckets_do_not_wait_for_deadline(self, tiny_model):
        p, got = self._play("model=tiny_batch batch=2 "
                            "batch-timeout-ms=5000")
        try:
            src = p.get("in")
            for i in range(8):
                src.push_buffer(TensorBuffer(
                    tensors=[np.full(4, i, np.float32)], pts=i))
            assert _wait_for(lambda: len(got) >= 6)
            src.end_of_stream()
            p.wait(timeout=30)
        finally:
            p.stop()
        assert [b.pts for b in got] == list(range(8))

    def test_deadline_error_is_a_pipeline_error(self, tiny_model):
        """A failed deadline dispatch is posted as a pipeline error."""
        p, _ = self._play("model=tiny_batch batch=4 batch-timeout-ms=20")
        try:
            f = p.get("f")

            def boom(*args, **kwargs):
                raise RuntimeError("dispatch boom")

            f.fw.invoke_batched = boom
            p.get("in").push_buffer(TensorBuffer(
                tensors=[np.ones(4, np.float32)]))
            with pytest.raises(PipelineError, match="dispatch boom"):
                p.wait(timeout=30)
            assert not f._deadline_thread.is_alive()
        finally:
            p.stop()


# ---------------------------------------------------------------------------
# the invoke pool (tests/test_schedule.py TestFilterWorkers)
# ---------------------------------------------------------------------------

class _Echo(FilterFramework):
    """x -> 2x on the host, after a jittered sleep; not thread-safe, so
    each worker opens its own instance."""

    NAME = "echo"
    INFO = TensorsInfo([TensorInfo(TensorType.FLOAT32, (4,))])
    fail_at = None

    def __init__(self):
        super().__init__()
        self.stats = FilterStatistics()
        self._rng = np.random.default_rng(1234)
        self.calls = 0

    def get_model_info(self):
        return self.INFO, self.INFO

    def invoke(self, inputs):
        self.calls += 1
        if self.calls == self.fail_at:
            raise RuntimeError("worker boom")
        time.sleep(self._rng.uniform(0.002, 0.01))
        return [np.asarray(inputs[0]) * 2.0]


@pytest.fixture()
def echo_backend():
    register_filter(_Echo)
    yield _Echo
    _FILTERS.pop("echo", None)
    _Echo.fail_at = None


def _pts_feed(p, n):
    src = p.get("in")
    for i in range(n):
        src.push_buffer(TensorBuffer(tensors=[np.full(4, i, np.float32)],
                                     pts=i))
    src.end_of_stream()


class TestFilterWorkers:
    def test_ordering_exact_under_jittered_invoke_latency(self,
                                                          echo_backend):
        p = nnstreamer_tpu_torch.parse_launch(
            f"appsrc caps={CAPS} name=in ! tensor_filter framework=echo "
            "model=x workers=4 name=f ! tensor_sink name=out")
        p.play()
        try:
            f = p.get("f")
            others = [fw for fw in f._wk_backends if fw is not f.fw]
            assert f._workers_n == 4 and len(others) == 3
            _pts_feed(p, 40)
            p.wait(timeout=60)
            got = p.get("out").results
        finally:
            p.stop()
        assert not any(fw.opened for fw in others)   # private, closed
        assert [b.pts for b in got] == list(range(40))
        for b in got:
            np.testing.assert_allclose(b.np(0), np.full(4, b.pts * 2.0))

    def test_workers_share_the_torch_backend(self, tiny_model):
        """The torch engine serializes its dispatches on a lock, so four
        workers share ONE instance; results equal the per-frame path, in
        order, under a short switch interval."""
        feeds = _feeds(48)
        pts = [i * 1000 for i in range(48)]
        ref = _run("model=tiny_batch", feeds, pts)
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            p = nnstreamer_tpu_torch.parse_launch(
                _launch("model=tiny_batch workers=4"))
            p.play()
            try:
                f = p.get("f")
                assert f._workers_n == 4
                assert all(fw is f.fw for fw in f._wk_backends)
                src = p.get("in")
                for arr, ts in zip(feeds, pts):
                    src.push_buffer(TensorBuffer(tensors=[arr], pts=ts))
                src.end_of_stream()
                p.wait(timeout=60)
                got = p.get("out").results
            finally:
                p.stop()
        finally:
            sys.setswitchinterval(interval)
        _assert_same(got, ref, 48)
        assert not any(t.is_alive() for t in f._wk_threads)

    def test_workers_forced_serial_with_batching(self, tiny_model):
        p = nnstreamer_tpu_torch.parse_launch(
            _launch("model=tiny_batch batch=4 workers=8"))
        p.play()
        try:
            assert p.get("f")._workers_n == 1
            _pts_feed(p, 8)
            p.wait(timeout=60)
            assert [b.pts for b in p.get("out").results] == list(range(8))
        finally:
            p.stop()

    def test_worker_error_posts_pipeline_error(self, echo_backend):
        _Echo.fail_at = 3
        p = nnstreamer_tpu_torch.parse_launch(
            f"appsrc caps={CAPS} name=in ! tensor_filter framework=echo "
            "model=x workers=2 name=f ! tensor_sink name=out")
        p.play()
        try:
            _pts_feed(p, 8)
            with pytest.raises(PipelineError, match="worker boom"):
                p.wait(timeout=60)
        finally:
            p.stop()


# ---------------------------------------------------------------------------
# queue (tests/test_pushdown.py; pipeline/graph.py Queue)
# ---------------------------------------------------------------------------

class TestQueue:
    def test_order_pts_and_eos_across_the_thread_boundary(self, tiny_model):
        feeds = _feeds(30)
        pts = [i * 1000 for i in range(30)]
        ref = _run("model=tiny_batch", feeds, pts)
        for port in (True, False):
            got = _run("model=tiny_batch batch=4", feeds, pts, port=port,
                       tail="queue max-size-buffers=3 ! tensor_sink "
                            "name=out")
            _assert_same(got, ref, 30)

    def test_pushdown_through_queue(self, tiny_model):
        feeds = [np.eye(4, dtype=np.float32)[i % 4] for i in range(5)]
        tail = ("queue ! tensor_decoder mode=image_labeling ! "
                "tensor_sink name=out")
        got = _run("model=tiny_batch", feeds, tail=tail)
        assert [g.extra["index"] for g in got] == [7] * 5

    def test_batched_pushdown_through_tiny_queue_no_deadlock(self,
                                                             tiny_model):
        """The fused re-warm is owed to the producer's chain(), not taken
        on the queue's drain thread: a batched filter through a 2-buffer
        queue completes, with the fusion engaged."""
        feeds = [np.array([2.0, 0, 0, 0], np.float32)] * 40
        tail = ("queue max-size-buffers=2 ! tensor_decoder "
                "mode=image_labeling ! tensor_sink name=out")
        p = nnstreamer_tpu_torch.parse_launch(
            _launch("model=tiny_batch batch=4", tail))
        p.play()
        try:
            src = p.get("in")
            for arr in feeds:
                src.push_buffer(TensorBuffer(tensors=[arr]))
            src.end_of_stream()
            p.wait(timeout=60)
            got = p.get("out").results
            f = p.get("f")
            fcaps = f.src_pad.caps.first()
            assert fcaps.get("types") == "int32"
            assert fcaps.get("dimensions") == "1"
            assert f._rewarm is False
        finally:
            p.stop()
        jax_got = _run("model=tiny_batch batch=4", feeds, port=False,
                       tail=tail)
        assert [g.extra["index"] for g in got] == \
            [g.extra["index"] for g in jax_got] == [7] * 40

    def test_one_slot_queue_backpressure_keeps_every_frame(self):
        """A one-buffer queue in front of a slow consumer: the producer
        blocks on the bound, nothing is dropped, order holds, and the
        drain thread ends at EOS."""
        p = nnstreamer_tpu_torch.parse_launch(
            f"appsrc caps={CAPS} name=in ! queue max-size-buffers=1 "
            "name=q ! tensor_sink name=out")
        p.get("out").connect("new-data", lambda b: time.sleep(0.01))
        p.play()
        try:
            _pts_feed(p, 12)
            p.wait(timeout=30)
            got = p.get("out").results
            assert _wait_for(lambda: not p.get("q")._worker.is_alive())
        finally:
            p.stop()
        assert [b.pts for b in got] == list(range(12))
