"""The port's among-device transports against the JAX package's, on the
CPU: the shared-memory ring, edge pub/sub, MQTT, HYBRID discovery of
the query pair and SNTP epochs.

Each transport carries bytes and does no arithmetic, so frames are held
byte for byte:

- shm: a ring made by either package (native ``tw_shm_*`` from the
  port's ``_build`` library or the JAX package's ``native/libnnstw.so``,
  or the Python mmap fallback) is read by the other, in one process and
  across two; the ring's late-consumer, prefetch, header-safety and
  no-producer behaviours (``tests/test_shm.py``);
- MQTT: the 1024-byte header packs the same bytes (trace trailer too);
  either package's client uses the other's broker; a ``mqttsink`` of
  each package feeds a ``mqttsrc`` of the other through either broker;
  QoS-1 publishes and retained records (``tests/test_mqtt.py``);
- edge: an ``edge_sink`` of each package feeds an ``edge_src`` of the
  other through either package's broker, over TCP and HYBRID; idle
  subscriptions, the reference spellings, PTS re-basing
  (``tests/test_query.py``, ``tests/test_ntp.py``);
- HYBRID query: a client of each package finds the other's serversrc
  through either package's MQTT broker;
- SNTP: both packages read the same epoch and offset from a local fake
  responder.

Every broker listens on port 0, every ring name carries the pid and a
clock stamp, and every ring is unlinked even when a test fails.
"""

import contextlib
import os
import socket
import struct
import subprocess
import sys
import threading
import time
import types

import numpy as np
import pytest

from nnstreamer_tpu import native as jax_native
from nnstreamer_tpu_torch import native as port_native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
        "types=float32,framerate=0/1")
CAPS2 = ("other/tensors,format=static,num_tensors=2,dimensions=4:3.2,"
         "types=float32.uint8,framerate=30/1")


def _namespace(root: str):
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    return types.SimpleNamespace(
        root=root, parse_launch=mod("pipeline").parse_launch,
        shm=mod("query.shm"), edge=mod("query.edge"), mqtt=mod("query.mqtt"),
        protocol=mod("query.protocol"), client=mod("query.client"),
        server=mod("query.server"), ntp=mod("utils.ntp"),
        span=mod("obs.span"), TensorBuffer=mod("tensor.buffer").TensorBuffer,
        make_element=mod("pipeline.registry").make_element)


PKGS = {"jax": _namespace("nnstreamer_tpu"),
        "torch": _namespace("nnstreamer_tpu_torch")}
OTHER = {"jax": "torch", "torch": "jax"}
PORT = PKGS["torch"]
#: (writer, reader) package pairs where at least one end is the port's
CROSS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]


@pytest.fixture(scope="module", autouse=True)
def settled_native():
    """Both packages' native libraries settled before any test: a ring
    opened while a library still builds takes the Python fallback."""
    jax_native.available()
    port_native.available()


@pytest.fixture(autouse=True)
def no_leftover_brokers():
    yield
    for pkg in PKGS.values():
        pkg.edge.shutdown_brokers()


@pytest.fixture
def rings():
    """Ring names for a test, unlinked at teardown whatever happened."""
    names = []

    def make(tag):
        name = f"t-{tag}-{os.getpid()}-{time.monotonic_ns()}"
        names.append(name)
        return name

    yield make
    for name in names:
        with contextlib.suppress(OSError):
            os.unlink(f"/dev/shm/{name}")


def both_native():
    if not (jax_native.available() and port_native.available()):
        pytest.skip("a native library is unavailable")


def wait_until(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return cond()


def ring(pkg, name, create, native=True, **kw):
    """A ShmRing of ``pkg``, native or (``native=False``) with that
    package's library masked out."""
    mod = PKGS[pkg].shm
    if native:
        both_native()
        r = mod.ShmRing(name, create, **kw)
        assert r.is_native
        return r
    orig = mod._native_lib
    mod._native_lib = lambda: None
    try:
        r = mod.ShmRing(name, create, **kw)
    finally:
        mod._native_lib = orig
    assert not r.is_native
    return r


def frames_of(n, seed=5):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(4).astype(np.float32) for _ in range(n)]


def feed(pipeline, frames):
    """Push ``frames`` (an array, or a tuple of arrays, a buffer) into the
    pipeline's ``appsrc name=in`` with pts 0, 1000, ..., then EOS."""
    root = type(pipeline).__module__.split(".")[0]
    buffer = PKGS["torch" if root == PORT.root else "jax"].TensorBuffer
    src = pipeline.get("in")
    for i, f in enumerate(frames):
        src.push_buffer(buffer(tensors=list(f) if isinstance(f, tuple)
                               else [f], pts=i * 1000))
    src.end_of_stream()


def collect(p, name="out"):
    got = []
    p.get(name).connect("new-data", lambda b: got.append(b))
    return got


def assert_frames(got, frames):
    assert len(got) == len(frames)
    for b, f in zip(got, frames):
        want = list(f) if isinstance(f, tuple) else [f]
        assert b.num_tensors == len(want)
        for i, w in enumerate(want):
            assert b.np(i).dtype == w.dtype
            assert b.np(i).tobytes() == w.tobytes()


# ---------------------------------------------------------------------------
# shm ring
# ---------------------------------------------------------------------------

class TestRing:
    PAYLOADS = [b"\x01", bytes(range(100)), bytes(range(256)) * 256]

    def _roundtrip(self, prod, cons):
        for i, p in enumerate(self.PAYLOADS):
            prod.push(p, pts=i * 10)
        for i, p in enumerate(self.PAYLOADS):
            got, pts = cons.pop()
            assert got == p and pts == i * 10
        prod.eos()
        assert cons.pop() is None

    @pytest.mark.parametrize("cons_native", [True, False],
                             ids=["cons_native", "cons_py"])
    @pytest.mark.parametrize("prod_native", [True, False],
                             ids=["prod_native", "prod_py"])
    @pytest.mark.parametrize("writer,reader", CROSS)
    def test_round_trip(self, writer, reader, prod_native, cons_native,
                        rings):
        """One region layout: a ring made by either package, native (each
        package's own library) or fallback, is read by the other."""
        name = rings("rt")
        prod = ring(writer, name, True, prod_native, slot_bytes=1 << 17,
                    n_slots=4, caps="other/tensors,format=static")
        cons = ring(reader, name, False, cons_native)
        try:
            assert cons.caps() == "other/tensors,format=static"
            assert cons.slot_bytes == 1 << 17
            self._roundtrip(prod, cons)
        finally:
            cons.close()
            prod.close()

    def test_port_library_binds_the_ring(self):
        """The port's library holds the ring (``shmring.cc``) beside the
        CRC and links librt, as ``native/Makefile`` does."""
        both_native()
        lib = port_native._load()
        assert hasattr(lib, "tw_shm_push2") and hasattr(lib, "tw_crc32c")
        assert "-lrt" in port_native.LINK_FLAGS
        assert any(s.endswith("shmring.cc") for s in port_native.SOURCES)
        assert PORT.shm._native_lib() is lib

    @pytest.mark.parametrize("native", [True, False], ids=["native", "py"])
    def test_backpressure_full_ring_times_out(self, native, rings):
        prod = ring("torch", rings("full"), True, native, slot_bytes=256,
                    n_slots=2)
        try:
            prod.push(b"a", 0)
            prod.push(b"b", 1)
            with pytest.raises(TimeoutError):
                prod.push(b"c", 2, timeout=0.2)
        finally:
            prod.close(unlink=True)

    @pytest.mark.parametrize("native", [True, False], ids=["native", "py"])
    def test_oversize_record_rejected(self, native, rings):
        prod = ring("torch", rings("big"), True, native, slot_bytes=64,
                    n_slots=2)
        try:
            with pytest.raises(ValueError, match="exceeds slot"):
                prod.push(b"x" * 65, 0)
        finally:
            prod.close(unlink=True)

    @pytest.mark.parametrize("reader", ["jax", "torch"])
    def test_blocked_producer_resumes_when_consumer_drains(self, reader,
                                                           rings):
        """A full fallback ring of the port resumes when a consumer of
        either package pops (the JAX one meets it at the timed
        re-check: the wakeup conditions are each package's own)."""
        name = rings("drain")
        prod = ring("torch", name, True, False, slot_bytes=256, n_slots=2)
        cons = ring(reader, name, False, False)
        try:
            prod.push(b"a", 0)
            prod.push(b"b", 1)
            t = threading.Thread(target=lambda: (time.sleep(0.2),
                                                 cons.pop()))
            t.start()
            prod.push(b"c", 2, timeout=5.0)
            t.join(timeout=10)
            assert not t.is_alive()
            assert cons.pop()[0] == b"b"
            assert cons.pop()[0] == b"c"
        finally:
            cons.close()
            prod.close()


class TestLateConsumer:
    @pytest.mark.parametrize("writer,reader", CROSS)
    def test_producer_done_before_consumer_opens(self, writer, reader,
                                                 rings):
        """The producer closing does not unlink the ring: a consumer of
        either package attaching after the producer is gone drains every
        record, then sees EOS."""
        name = rings("late")
        prod = ring(writer, name, True, slot_bytes=4096, n_slots=8,
                    caps="other/tensors")
        for i in range(5):
            prod.push(f"rec{i}".encode(), i)
        prod.eos()
        prod.close()
        cons = ring(reader, name, False)
        try:
            assert cons.caps() == "other/tensors"
            for i in range(5):
                assert cons.pop() == (f"rec{i}".encode(), i)
            assert cons.pop() is None
        finally:
            cons.close()


_SHM_PRODUCER = r"""
import sys
from {root} import parse_launch
p = parse_launch(
    "videotestsrc num-buffers=16 pattern=gradient ! "
    "video/x-raw,format=RGB,width=24,height=24,framerate=60/1 ! "
    "tensor_converter ! tensor_shm_sink path={name}")
p.run(timeout=60)
print("producer done", flush=True)
"""


class TestShmPipeline:
    @pytest.mark.parametrize("writer,reader", CROSS)
    def test_two_process_pipeline_over_shm(self, writer, reader, rings):
        """A producer pipeline of one package in a child process, a
        consumer pipeline of the other here; caps negotiate through the
        ring header; all 16 frames arrive in order, byte-equal to the
        same source run here."""
        name = rings("pipe")
        prod = subprocess.Popen(
            [sys.executable, "-c", _SHM_PRODUCER.format(
                root=PKGS[writer].root, name=name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        try:
            p = PKGS[reader].parse_launch(
                f"tensor_shm_src path={name} timeout=60 ! "
                "tensor_sink name=out")
            got = collect(p)
            p.run(timeout=90)
            _, err = prod.communicate(timeout=90)
            assert prod.returncode == 0, err[-1500:]
        finally:
            if prod.poll() is None:
                prod.kill()
                prod.communicate(timeout=30)
        ref = PKGS[writer].parse_launch(
            "videotestsrc num-buffers=16 pattern=gradient ! "
            "video/x-raw,format=RGB,width=24,height=24,framerate=60/1 ! "
            "tensor_converter ! tensor_sink name=out")
        want = collect(ref)
        ref.run(timeout=60)
        assert [b.pts for b in got] == [b.pts for b in want]
        assert_frames(got, [b.np(0) for b in want])


class TestPrefetch:
    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_prefetch_drains_ahead_of_consumer(self, writer, rings):
        """prefetch=1 on the port's src: its reader drains a 4-slot ring
        of either package into a local fifo, so 12 records pass without
        a ring-full timeout; frames, order and pts equal the on-demand
        path's."""
        name = rings("prefetch")
        w = PKGS[writer]
        prod = ring(writer, name, True, slot_bytes=4096, n_slots=4,
                    caps="other/tensors,format=static,num_tensors=1,"
                         "dimensions=8,types=uint8,framerate=0/1")
        try:
            p = PORT.parse_launch(
                f"tensor_shm_src path={name} timeout=30 prefetch=1 ! "
                "queue max-size-buffers=64 ! tensor_sink name=out")
            got = []
            p.get("out").connect("new-data",
                                 lambda b: got.append((b.pts, b.np(0))))
            p.play()
            try:
                for i in range(12):
                    buf = w.TensorBuffer(tensors=[np.full(8, i, np.uint8)],
                                         pts=i)
                    prod.push_parts(w.protocol.tensor_parts(buf), i,
                                    timeout=10)
                prod.eos()
                p.wait(timeout=30)
            finally:
                p.stop()
            assert [pts for pts, _ in got] == list(range(12))
            for i, (_, arr) in enumerate(got):
                assert arr.tobytes() == np.full(8, i, np.uint8).tobytes()
        finally:
            prod.close(unlink=False)


class TestHeaderSafety:
    @pytest.mark.parametrize("native", [True, False], ids=["native", "py"])
    def test_oversized_caps_rejected(self, native, rings):
        name = rings("caps")
        with pytest.raises(ValueError, match="caps"):
            ring("torch", name, True, native, slot_bytes=1 << 12,
                 n_slots=2, caps="x" * 5000)

    def test_py_version_mismatch_surfaces_as_version_error(self, rings):
        name = rings("ver")
        prod = ring("torch", name, True, False, slot_bytes=1 << 12,
                    n_slots=2)
        try:
            prod._mm[0:8] = struct.pack("<II", 0x4E545352, 99)
            t0 = time.monotonic()
            with pytest.raises(ConnectionError, match="version"):
                ring("torch", name, False, False, timeout=10.0)
            assert time.monotonic() - t0 < 5, "spun to the deadline"
        finally:
            prod.close(unlink=True)

    def test_sink_caps_renegotiation_raises(self, rings):
        sink = PORT.make_element("tensor_shm_sink", path=rings("reneg"))
        sink.start()
        try:
            caps1 = "other/tensors,num_tensors=1,dimensions=3:4,types=uint8"
            caps2 = "other/tensors,num_tensors=1,dimensions=5:6,types=uint8"
            sink.set_caps(None, caps1)
            sink.set_caps(None, caps1)
            with pytest.raises(RuntimeError, match="renegotiation"):
                sink.set_caps(None, caps2)
        finally:
            sink.stop()

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_trace_context_rides_the_slot(self, writer, rings):
        """A sink's frame carries its trace context as the trailer after
        the tensors; the other package's ring reader finds it, and its
        tensor decode ignores it."""
        w, r = PKGS[writer], PKGS[OTHER[writer]]
        name = rings("trace")
        sink = w.make_element("tensor_shm_sink", path=name)
        sink.start()
        try:
            sink.set_caps(None, CAPS)
            buf = w.TensorBuffer(tensors=[np.arange(4, dtype=np.float32)],
                                 pts=7)
            buf.extra["nns_trace"] = w.span.TraceContext(11, 22, 33)
            sink.chain(None, buf)
            cons = ring(OTHER[writer], name, False)
            try:
                payload, pts = cons.pop()
            finally:
                cons.close()
        finally:
            sink.stop()
        assert pts == 7
        assert tuple(r.span.unpack_ctx_trailer(payload)) == (11, 22, 33)
        (arr,) = r.protocol.decode_tensors(payload)
        assert arr.tobytes() == np.arange(4, dtype=np.float32).tobytes()


class TestNoProducer:
    def test_missing_ring_fails_cleanly_within_timeout(self, rings):
        p = PORT.parse_launch(f"tensor_shm_src path={rings('none')} "
                              "timeout=1 ! tensor_sink name=out")
        t0 = time.monotonic()
        with pytest.raises(Exception, match="open"):
            p.run(timeout=30)
        assert time.monotonic() - t0 < 20


# ---------------------------------------------------------------------------
# MQTT
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def mqtt_broker(pkg):
    broker = PKGS[pkg].mqtt.MqttBroker()
    try:
        yield broker
    finally:
        broker.close()


class TestHeaderLayout:
    def test_exact_reference_offsets(self):
        m = PORT.mqtt
        hdr = m.pack_header([100, 200], 111, 222, 5, None, 777, "caps!")
        assert len(hdr) == m.HDR_LEN == 1024
        assert struct.unpack_from("<I", hdr, 0)[0] == 2
        assert struct.unpack_from("<Q", hdr, 8)[0] == 100
        assert struct.unpack_from("<Q", hdr, 16)[0] == 200
        assert struct.unpack_from("<q", hdr, 136)[0] == 111
        assert struct.unpack_from("<q", hdr, 144)[0] == 222
        assert struct.unpack_from("<Q", hdr, 152)[0] == 5
        assert struct.unpack_from("<Q", hdr, 160)[0] == m.CLOCK_NONE
        assert struct.unpack_from("<Q", hdr, 168)[0] == 777
        assert hdr[176:176 + 5] == b"caps!"

    @pytest.mark.parametrize("traced", [False, True],
                             ids=["plain", "trace_trailer"])
    def test_pack_bytes_equal(self, traced):
        rng = np.random.default_rng(21)
        for _ in range(8):
            n = int(rng.integers(0, 17))
            args = ([int(v) for v in rng.integers(0, 2**40, n)],
                    int(rng.integers(-2**40, 2**40)),
                    int(rng.integers(0, 2**50)), None,
                    int(rng.integers(0, 2**40)), int(rng.integers(0, 2**60)),
                    "other/tensors,x=" + "y" * int(rng.integers(0, 400)))
            ctx = (111, 222, 333) if traced else None
            port = PORT.mqtt.pack_header(
                *args, ctx=ctx and PORT.span.TraceContext(*ctx))
            jax = PKGS["jax"].mqtt.pack_header(
                *args, ctx=ctx and PKGS["jax"].span.TraceContext(*ctx))
            assert port == jax
            assert PORT.mqtt.unpack_header(jax) == \
                PKGS["jax"].mqtt.unpack_header(port)
            got = PORT.mqtt.header_trace_ctx(jax)
            assert (got is None) if ctx is None else tuple(got) == ctx

    def test_too_many_memories_or_caps_refused(self):
        with pytest.raises(ValueError, match="memories"):
            PORT.mqtt.pack_header([1] * 17, 0, 0, None, None, None, "")
        with pytest.raises(ValueError, match="caps"):
            PORT.mqtt.pack_header([1], 0, 0, None, None, None, "c" * 512)


class TestWireProtocol:
    @pytest.mark.parametrize("client,broker", [("torch", "jax"),
                                               ("jax", "torch"),
                                               ("torch", "torch")])
    def test_pub_sub_through_broker(self, client, broker):
        c = PKGS[client].mqtt
        with mqtt_broker(broker) as b:
            sub = c.MqttClient(b.host, b.port, "sub1")
            sub.subscribe("t/1")
            pub = c.MqttClient(b.host, b.port, "pub1")
            pub.publish("t/1", b"hello")
            pub.publish("t/other", b"nope")
            pub.publish("t/1", b"world")
            assert sub.recv_publish() == ("t/1", b"hello")
            assert sub.recv_publish() == ("t/1", b"world")
            pub.close()
            sub.close()

    @pytest.mark.parametrize("client", ["jax", "torch"])
    def test_retained_message_for_late_subscriber(self, client):
        with mqtt_broker("torch") as b:
            pub = PKGS[OTHER[client]].mqtt.MqttClient(b.host, b.port, "p")
            pub.publish("r/1", b"state", retain=True)
            got = PKGS[client].mqtt.fetch_retained_record(
                b.host, b.port, "r/1", 5.0, "s")
            assert got == b"state"
            pub.publish("r/1", b"", retain=True)   # clears the record
            assert wait_until(lambda: PKGS[client].mqtt.fetch_retained_record(
                b.host, b.port, "r/1", 0.3, "s2") is None)
            pub.close()

    def test_keepalive_pings_a_foreign_broker(self):
        with mqtt_broker("jax") as b:
            c = PORT.mqtt.MqttClient(b.host, b.port, "ka", keepalive=1,
                                     publish_only=True)
            try:
                assert wait_until(lambda: c.pings_sent >= 2, timeout=5)
            finally:
                c.close()


class TestQoS1Interop:
    @pytest.mark.parametrize("broker", ["jax", "torch"])
    def test_qos1_publish_downgraded_cleanly(self, broker):
        """An external QoS-1 publisher gets a PUBACK from the port's
        broker, and a port subscriber receives the payload without the
        packet-id bytes."""
        m = PORT.mqtt
        with mqtt_broker(broker) as b:
            sub = m.MqttClient(b.host, b.port, "s")
            sub.subscribe("q")
            raw = socket.create_connection((b.host, b.port), timeout=10)
            var = m._mqtt_str("MQTT") + bytes([4, 2]) + struct.pack(">H", 0)
            pay = m._mqtt_str("ext")
            raw.sendall(bytes([0x10]) + m._remaining_len(len(var) + len(pay))
                        + var + pay)
            assert m._read_packet(raw)[0] >> 4 == 2
            body = m._mqtt_str("q") + struct.pack(">H", 0x1234) + b"payload!"
            raw.sendall(bytes([0x32]) + m._remaining_len(len(body)) + body)
            ptype, ack = m._read_packet(raw)
            assert ptype >> 4 == 4 and struct.unpack(">H", ack)[0] == 0x1234
            assert sub.recv_publish() == ("q", b"payload!")
            raw.close()
            sub.close()


def _frames2(n):
    rng = np.random.default_rng(3)
    return [(rng.standard_normal((3, 4)).astype(np.float32),
             rng.integers(0, 255, (2,), dtype=np.uint8)) for _ in range(n)]


class TestMqttElements:
    @pytest.mark.parametrize("sink,broker", [("jax", "jax"), ("jax", "torch"),
                                             ("torch", "jax"),
                                             ("torch", "torch")])
    def test_sink_feeds_the_other_packages_src(self, sink, broker):
        """A ``mqttsink`` of one package feeds a ``mqttsrc`` of the other
        through either package's broker: frames byte-equal, pts kept,
        caps carried in the header's caps string."""
        src = OTHER[sink]
        with mqtt_broker(broker) as b:
            rx = PKGS[src].parse_launch(
                f"mqttsrc port={b.port} sub-topic=bench num-buffers=3 "
                "name=rx ! tensor_sink name=out")
            got = collect(rx)
            rx.play()
            tx = PKGS[sink].parse_launch(
                f"appsrc caps={CAPS2} name=in ! "
                f"mqttsink port={b.port} pub-topic=bench")
            frames = _frames2(3)
            try:
                tx.play()
                feed(tx, frames)
                rx.wait(timeout=30)
                tx.wait(timeout=30)
            finally:
                rx.stop()
                tx.stop()
        assert_frames(got, frames)
        assert [g.pts for g in got] == [0, 1000, 2000]
        assert rx.get("rx").src_pad.caps.first().get("types") == \
            "float32.uint8"

    def test_sync_pts_rebase(self):
        with mqtt_broker("torch") as b:
            rx = PORT.parse_launch(
                f"mqttsrc port={b.port} sub-topic=ts num-buffers=1 "
                "sync-pts=true name=rx ! tensor_sink name=out")
            got = collect(rx)
            rx.play()
            rx.get("rx")._base_epoch_us = 500_000
            tx = PKGS["jax"].parse_launch(
                f"appsrc caps={CAPS} name=in ! "
                f"mqttsink port={b.port} pub-topic=ts name=tx")
            try:
                tx.play()
                tx.get("tx")._base_epoch_us = 2_000_000
                tx.get("in").push_buffer(PKGS["jax"].TensorBuffer(
                    tensors=[np.zeros(4, np.float32)], pts=100_000_000))
                tx.get("in").end_of_stream()
                rx.wait(timeout=30)
            finally:
                tx.stop()
                rx.stop()
        # 0.1 s + (2 s - 0.5 s) in the receiver's running time
        assert [g.pts for g in got] == [1_600_000_000]


# ---------------------------------------------------------------------------
# edge pub/sub
# ---------------------------------------------------------------------------

def wait_subscribed(broker, topic):
    assert wait_until(lambda: bool(broker._subs.get(topic))), \
        f"no subscription on {topic}"


class TestEdgePubSub:
    @pytest.mark.parametrize("sink,broker", [("jax", "jax"), ("jax", "torch"),
                                             ("torch", "jax"),
                                             ("torch", "torch")])
    def test_sink_feeds_the_other_packages_src(self, sink, broker):
        src = OTHER[sink]
        b = PKGS[broker].edge.get_broker()
        rx = PKGS[src].parse_launch(
            f"edge_src port={b.port} topic=t1 num-buffers=3 name=rx ! "
            "tensor_sink name=out")
        got = collect(rx)
        tx = PKGS[sink].parse_launch(
            f"appsrc caps={CAPS2} name=in ! "
            f"edge_sink port={b.port} topic=t1")
        frames = _frames2(3)
        try:
            rx.play()
            wait_subscribed(b, "t1")
            tx.play()
            feed(tx, frames)
            rx.wait(timeout=30)
            tx.wait(timeout=30)
        finally:
            rx.stop()
            tx.stop()
        assert_frames(got, frames)
        assert [g.pts for g in got] == [0, 1000, 2000]
        assert rx.get("rx").src_pad.caps.first().get("types") == \
            "float32.uint8"

    def test_subscriber_before_publisher_gets_retained_caps(self):
        b = PORT.edge.get_broker()
        sub = PORT.parse_launch(
            f"edge_src port={b.port} topic=t-late num-buffers=1 ! "
            "tensor_sink name=out")
        got = collect(sub)
        sub.play()
        pub = PKGS["jax"].parse_launch(
            "appsrc name=in caps=other/tensors,format=static,num_tensors=1,"
            "dimensions=2,types=int32,framerate=0/1 ! "
            f"edge_sink port={b.port} topic=t-late")
        try:
            pub.play()
            wait_subscribed(b, "t-late")
            feed(pub, [np.array([7, 9], np.int32)])
            sub.wait(timeout=10)
        finally:
            pub.stop()
            sub.stop()
        assert_frames(got, [np.array([7, 9], np.int32)])


class TestEdgeHybrid:
    @pytest.mark.parametrize("sink,broker", [("jax", "torch"),
                                             ("torch", "jax"),
                                             ("torch", "torch")])
    def test_hybrid_discovery_then_tcp_stream(self, sink, broker):
        """``connect-type=hybrid``: a sink of one package advertises its
        TCP broker as a retained record on either package's MQTT broker;
        a src of the other package, given only the MQTT broker, finds it
        and streams."""
        src = OTHER[sink]
        tcp = PKGS[sink].edge.get_broker()
        with mqtt_broker(broker) as mq:
            tx = PKGS[sink].parse_launch(
                f"appsrc caps={CAPS} name=in ! edge_sink host=127.0.0.1 "
                f"port={tcp.port} topic=hy connect-type=hybrid "
                f"mqtt-port={mq.port}")
            rx = PKGS[src].parse_launch(
                f"edge_src topic=hy connect-type=hybrid mqtt-port={mq.port} "
                "num-buffers=2 name=rx ! tensor_sink name=out")
            got = collect(rx)
            frames = frames_of(2)
            try:
                tx.play()
                rx.play()
                wait_subscribed(tcp, "hy")
                feed(tx, frames)
                rx.wait(timeout=30)
                tx.wait(timeout=30)
            finally:
                rx.stop()
                tx.stop()
            assert rx.get("rx").port == tcp.port   # discovered
            # the sink cleared its record at stop
            assert PKGS[src].mqtt.fetch_retained_record(
                "127.0.0.1", mq.port, "nns/edge/hy", 0.3, "chk") is None
        assert_frames(got, frames)


class TestEdgeIdleSubscription:
    def test_subscriber_survives_idle_before_first_publish(self):
        """The connect timeout must not persist as an idle-read timeout:
        a port subscriber idle past it still receives the caps a JAX
        publisher announces."""
        edge = PORT.edge
        broker = PKGS["jax"].edge.get_broker()
        real_cc = socket.create_connection

        def shrunk(addr, timeout=None, **kw):
            return real_cc(addr, timeout=0.2 if timeout else timeout, **kw)

        orig = edge.socket.create_connection
        edge.socket.create_connection = shrunk
        try:
            src = edge.EdgeSrc("idle", port=broker.port, topic="idle-t")
            src.start()
        finally:
            edge.socket.create_connection = orig
        try:
            time.sleep(0.6)
            pub = socket.create_connection((broker.host, broker.port),
                                           timeout=10)
            PKGS["jax"].protocol.send_msg(pub, PKGS["jax"].protocol.Message(
                PKGS["jax"].protocol.T_HELLO,
                payload=f"pub:idle-t|{CAPS}".encode()))
            assert src._caps_evt.wait(timeout=5)
            pub.close()
        finally:
            src.stop()


class TestReferenceEdgeSpellings:
    def test_verbatim_edge_lines_round_trip(self):
        tcp = PORT.edge.get_broker()
        tx = PORT.parse_launch(
            f"appsrc caps={CAPS} name=in ! "
            "edgesink port=0 connect-type=TCP dest-host=127.0.0.1 "
            f"dest-port={tcp.port} topic=tempTopic async=false")
        rx = PORT.parse_launch(
            f"edgesrc dest-port={tcp.port} topic=tempTopic "
            "num-buffers=2 name=rx ! tensor_sink name=out")
        frames = frames_of(2)
        try:
            tx.play()
            rx.play()
            wait_subscribed(tcp, "tempTopic")
            feed(tx, frames)
            rx.wait(timeout=30)
            tx.wait(timeout=30)
        finally:
            rx.stop()
            tx.stop()
        assert_frames(rx.get("out").results, frames)

    def test_aitt_is_a_named_drop(self):
        el = PORT.edge.EdgeSink("e", **{"connect-type": "AITT",
                                        "dest-host": "127.0.0.1",
                                        "dest-port": 1, "topic": "t"})
        with pytest.raises(ValueError, match="AITT"):
            el.start()

    def test_verbatim_hybrid_edge_lines(self):
        """Both halves configure only the MQTT broker (dest-*): the
        port's sink starts an in-process data broker and advertises it,
        the JAX src discovers it by topic."""
        with mqtt_broker("torch") as mq:
            tx = PORT.parse_launch(
                f"appsrc caps={CAPS} name=in ! "
                "edgesink port=0 connect-type=HYBRID dest-host=127.0.0.1 "
                f"dest-port={mq.port} topic=hvbt async=false name=tx")
            rx = PKGS["jax"].parse_launch(
                "edgesrc port=0 connect-type=HYBRID dest-host=127.0.0.1 "
                f"dest-port={mq.port} topic=hvbt num-buffers=2 name=rx ! "
                "tensor_sink name=out")
            frames = frames_of(2)
            try:
                tx.play()
                rx.play()
                data = PORT.edge.get_broker(int(tx.get("tx").port))
                wait_subscribed(data, "hvbt")
                feed(tx, frames)
                rx.wait(timeout=30)
                tx.wait(timeout=30)
            finally:
                rx.stop()
                tx.stop()
        assert_frames(rx.get("out").results, frames)

    def test_edge_dest_host_without_port_tcp_is_loud(self):
        el = PORT.edge.EdgeSrc("e", **{"connect-type": "TCP",
                                       "dest-host": "10.0.0.2",
                                       "topic": "t"})
        with pytest.raises(ValueError, match="dest-port"):
            el.start()


class TestEdgePTSRebase:
    @pytest.mark.parametrize("sink", ["jax", "torch"])
    def test_sync_pts_shifts_by_epoch_delta(self, sink):
        """The port's subscriber re-bases a publisher's PTS (either
        package's) onto its own stream origin."""
        b = PORT.edge.get_broker()
        pub = PKGS[sink].parse_launch(
            f"appsrc caps={CAPS} name=in ! "
            f"edge_sink port={b.port} topic=t-sync name=es")
        sub = PORT.parse_launch(
            f"edge_src port={b.port} topic=t-sync num-buffers=1 "
            "sync-pts=true name=er ! tensor_sink name=out")
        try:
            pub.play()
            pub.get("es")._base_epoch_us = 2_000_000
            sub.play()
            sub.get("er")._base_epoch_us = 500_000
            wait_subscribed(b, "t-sync")
            pub.get("in").push_buffer(PKGS[sink].TensorBuffer(
                tensors=[np.zeros(4, np.float32)], pts=100_000_000))
            pub.get("in").end_of_stream()
            sub.wait(timeout=10)
        finally:
            pub.stop()
            sub.stop()
        assert [r.pts for r in sub.get("out").results] == [1_600_000_000]


# ---------------------------------------------------------------------------
# HYBRID discovery of the query pair
# ---------------------------------------------------------------------------

def hybrid_echo_server(pkg, sid, broker_port, topic):
    """A serversrc that advertises itself on the MQTT broker, echoing
    each request (no filter: the reply's bytes are the request's)."""
    p = PKGS[pkg].parse_launch(
        f"tensor_query_serversrc name=qsrc id={sid} port=0 caps={CAPS} "
        f"connect-type=HYBRID dest-host=127.0.0.1 dest-port={broker_port} "
        f"topic={topic} ! tensor_query_serversink id={sid}")
    p.play()
    return p


@pytest.mark.parametrize("server,client,broker",
                         [("jax", "torch", "jax"), ("jax", "torch", "torch"),
                          ("torch", "jax", "jax"), ("torch", "jax", "torch")])
def test_hybrid_query_across_packages(server, client, broker):
    """A client of one package, given only the MQTT broker and a topic,
    finds the other package's serversrc through either package's broker;
    every reply is its request, byte for byte; the server clears its
    record at stop."""
    sid = 1970 if server == "jax" else 1971
    frames = frames_of(5, seed=8)
    with mqtt_broker(broker) as mq:
        srv = hybrid_echo_server(server, sid, mq.port, "echo")
        try:
            c = PKGS[client].parse_launch(
                f"appsrc name=in caps={CAPS} ! tensor_query_client "
                f"connect-type=HYBRID dest-host=127.0.0.1 "
                f"dest-port={mq.port} topic=echo timeout=20 name=qc ! "
                "tensor_sink name=out")
            got = collect(c)
            c.play()
            try:
                feed(c, frames)
                c.wait(timeout=60)
                assert c.get("qc")._server_address() == \
                    ("127.0.0.1", srv.get("qsrc").bound_port)
            finally:
                c.stop()
        finally:
            srv.stop()
            PKGS[server].server.shutdown_server(sid)
        assert PKGS[client].mqtt.fetch_retained_record(
            "127.0.0.1", mq.port, "nns/query/echo", 0.3, "chk") is None
    assert_frames(got, frames)
    assert [g.pts for g in got] == [i * 1000 for i in range(5)]


def test_hybrid_needs_a_topic_and_a_record():
    """As in the JAX package: HYBRID without a topic is refused on both
    ends; a client finding no record fails loudly."""
    src = PORT.server.TensorQueryServerSrc("qs", id=1972, caps=CAPS,
                                           **{"connect-type": "hybrid"})
    with pytest.raises(ValueError, match="requires topic"):
        src.start()
    PORT.server.shutdown_server(1972)
    qc = PORT.client.TensorQueryClient("qc", **{"connect-type": "HYBRID"})
    with pytest.raises(ValueError, match="requires topic"):
        qc._server_address()
    with mqtt_broker("torch") as mq:
        qc = PORT.client.TensorQueryClient("qc", **{
            "connect-type": "HYBRID", "dest-port": mq.port, "topic": "none",
            "timeout": 0.3})
        with pytest.raises(ConnectionError, match="no retained discovery"):
            qc._server_address()


# ---------------------------------------------------------------------------
# SNTP epochs
# ---------------------------------------------------------------------------

def fake_response(unix_sec: float, delta: int) -> bytes:
    ntp_sec = int(unix_sec) + delta
    frac = int((unix_sec % 1.0) * (1 << 32))
    resp = bytearray(48)
    struct.pack_into(">II", resp, 40, ntp_sec, frac)
    return bytes(resp)


@contextlib.contextmanager
def sntp_responder(unix_sec: float):
    """A local SNTP server on 127.0.0.1 (port 0) answering every client
    packet with a transmit timestamp of ``unix_sec``; yields its port and
    the client packets it saw."""
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(0.1)
    seen, stop = [], threading.Event()
    reply = fake_response(unix_sec, PORT.ntp.NTP_TIMESTAMP_DELTA)

    def serve():
        while not stop.is_set():
            try:
                data, addr = sock.recvfrom(512)
            except socket.timeout:
                continue
            seen.append(data)
            sock.sendto(reply, addr)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    try:
        yield sock.getsockname()[1], seen
    finally:
        stop.set()
        t.join(timeout=5)
        sock.close()


class TestSNTP:
    def test_both_read_the_same_epoch_from_a_local_responder(self):
        with sntp_responder(1_700_000_000.25) as (port, seen):
            got = [PKGS[k].ntp.get_epoch_us(["127.0.0.1"], [port],
                                            timeout=2.0)
                   for k in ("jax", "torch")]
        assert got == [1_700_000_000_250_000] * 2
        assert len(seen) == 2 and seen[0] == seen[1]
        assert seen[0][0] == 0x23 and len(seen[0]) == 48

    def test_both_read_the_same_offset(self):
        with sntp_responder(12.0) as (port, _):
            offsets = []
            for k in ("jax", "torch"):
                sync = PKGS[k].ntp.WallClockSync(
                    hosts=["127.0.0.1"], ports=[port],
                    _local_us=lambda: 5_000_000)
                offsets.append((sync.offset_us(), sync.now_us(),
                                sync.synced))
        assert offsets == [(7_000_000, 12_000_000, True)] * 2

    def test_parse_agrees_and_rejects_alike(self):
        rng = np.random.default_rng(4)
        for sec in rng.uniform(1, 2e9, 20):
            resp = fake_response(float(sec), PORT.ntp.NTP_TIMESTAMP_DELTA)
            assert PORT.ntp.parse_xmit_epoch_us(resp) == \
                PKGS["jax"].ntp.parse_xmit_epoch_us(resp)
        for bad in (b"\x00" * 12, b"\x00" * 48):
            for k in ("jax", "torch"):
                with pytest.raises(PKGS[k].ntp.NTPError):
                    PKGS[k].ntp.parse_xmit_epoch_us(bad)

    def test_fallback_order_and_local_clock(self):
        calls = []

        def query(host, port, packet, timeout):
            calls.append(host)
            if host == "bad":
                raise OSError("unreachable")
            return fake_response(123.0, PORT.ntp.NTP_TIMESTAMP_DELTA)

        assert PORT.ntp.get_epoch_us(["bad", "good"], [1, 1],
                                     _query=query) == 123_000_000
        assert calls == ["bad", "good"]

        def down(host, port, packet, timeout):
            raise OSError("zero egress")

        sync = PORT.ntp.WallClockSync(hosts=["x"], _query=down,
                                      _local_us=lambda: 42_000_000)
        assert sync.now_us() == 42_000_000 and not sync.synced
