"""The query plane of the port against the JAX package's, on the CPU.

- wire parity: seeded messages and buffers (uint8 frames, f32, several
  tensors, every meta format) give the same bytes from ``pack``,
  ``encode_tensors`` and the joined ``tensor_parts`` of both packages;
  each package's ``decode_tensors`` reads the other's bytes; CRC-32C is
  equal when both native libraries load and 0 on both sides without
  them;
- live round trips across packages in one process, on the MLP (f32,
  CPU): a port client against a JAX ``serversrc ! tensor_filter !
  serversink`` and a JAX client against the port's; replies equal the
  serving package's own forward within 1e-5;
- the behaviours of ``tests/test_query.py``, ``test_resilience.py`` and
  ``test_xbatch.py`` this slice ports, run against both packages where
  the test is the same: codec, CRC corruption, wire fuzz, loud
  addressing, shed with retry-after, ping/pong, breaker open/half-open,
  heartbeat failover across ``dest-hosts``, server batching (coalesces,
  equals per frame), EOS and drain flushing a resident bucket, a
  disconnect mid-bucket, the pipeline drain hook and the T_TRACE span
  piggyback.

Every socket, wait and join is bounded.
"""

import gc
import queue as _queue
import socket
import struct
import threading
import time
import types
import warnings

import numpy as np
import pytest
import torch

from nnstreamer_tpu import native as jax_native
from nnstreamer_tpu.models import registry as jax_registry
from nnstreamer_tpu.testing.faults import ChaosProxy
from nnstreamer_tpu_torch import _cuda
from nnstreamer_tpu_torch import native as port_native
from nnstreamer_tpu_torch.models import registry as port_registry

SERVER_CAPS = ("other/tensors,format=static,num_tensors=1,dimensions={dims},"
               "types={types},framerate=0/1")
MLP = "in_dim:8,width:16,depth:1,out_dim:4,seed:3"
MLP_CUSTOM = dict(kv.split(":") for kv in MLP.split(","))


def tcaps(dims="4", types="float32"):
    return SERVER_CAPS.format(dims=dims, types=types)


def _namespace(key: str, root: str, accel: str):
    """One package's query-plane surface, by the same names."""
    import importlib

    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    query = mod("query")
    graph = mod("pipeline.graph")
    return types.SimpleNamespace(
        key=key, accel=accel, parse_launch=mod("pipeline").parse_launch,
        protocol=mod("query.protocol"), query=query,
        server=mod("query.server"), overload=mod("query.overload"),
        resilience=mod("query.resilience"),
        TensorBuffer=mod("tensor.buffer").TensorBuffer,
        default_pool=mod("tensor.buffer").default_pool,
        Pipeline=graph.Pipeline, AppSrc=graph.AppSrc,
        TensorSink=mod("elements").TensorSink)


PKGS = {"jax": _namespace("jax", "nnstreamer_tpu", ""),
        "torch": _namespace("torch", "nnstreamer_tpu_torch",
                            "accelerator=true:cpu ")}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


def wait_until(cond, timeout=10.0, step=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def join_all(threads, timeout=60.0):
    deadline = time.monotonic() + timeout
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    assert not any(t.is_alive() for t in threads), "a client thread hung"


def native_crc_both():
    if not (jax_native.available() and port_native.available()):
        pytest.skip("a native CRC library is unavailable")


@pytest.fixture(scope="module", autouse=True)
def settled_native():
    """Both packages' CRC libraries settled before any test of the file:
    ``available()`` joins a background build still in flight.  Until a
    build lands its package frames with CRC 0 ("unchecked"), so on a
    fresh tree one package could frame a message with its CRC and the
    other without, and the byte comparisons below would differ."""
    jax_native.available()
    port_native.available()


# ---------------------------------------------------------------------------
# wire parity
# ---------------------------------------------------------------------------

def _messages():
    """Seeded messages of every type, with fixed header fields (epoch,
    trace ids and origin are clock- or random-dependent in live use)."""
    rng = np.random.default_rng(7)
    out = []
    for typ in range(1, 11):
        out.append(dict(type=typ, client_id=int(rng.integers(0, 2**63)),
                        seq=int(rng.integers(0, 2**63)),
                        pts=int(rng.integers(-2**31, 2**62)),
                        epoch_us=int(rng.integers(0, 2**62)),
                        trace_id=int(rng.integers(0, 2**63)),
                        span_id=int(rng.integers(0, 2**63)),
                        origin_us=int(rng.integers(0, 2**62)),
                        payload=rng.bytes(int(rng.integers(0, 600)))))
    return out


def _buffers():
    rng = np.random.default_rng(11)
    return {
        "uint8_frame": [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)],
        "f32": [rng.standard_normal((5, 7)).astype(np.float32)],
        "several": [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8),
                    rng.standard_normal(16).astype(np.float32),
                    rng.integers(-9, 9, (2, 3, 4), dtype=np.int32),
                    rng.standard_normal((3, 1)).astype(np.float64),
                    np.arange(6, dtype=np.int16).reshape(2, 3)],
        "scalar_and_strided": [np.array([3.5], np.float32),
                               rng.standard_normal((6, 6)).astype(
                                   np.float32)[:, ::2]],
    }


BUFFERS = _buffers()


class TestWireParity:
    @pytest.mark.parametrize("fields", _messages(),
                             ids=lambda f: f"type{f['type']}")
    def test_pack_bytes_equal(self, fields):
        jp, tp = PKGS["jax"].protocol, PKGS["torch"].protocol
        assert tp.pack(tp.Message(**fields)) == jp.pack(jp.Message(**fields))
        assert tp.HEADER.size == jp.HEADER.size == 69
        assert tp.MAGIC == jp.MAGIC == 0x4E4E5356

    @pytest.mark.parametrize("name", sorted(BUFFERS))
    def test_encode_and_parts_bytes_equal(self, name):
        tensors = BUFFERS[name]
        jax, port = PKGS["jax"], PKGS["torch"]
        jbuf = jax.TensorBuffer(tensors=list(tensors), pts=9)
        tbuf = port.TensorBuffer(tensors=list(tensors), pts=9)
        blob = port.protocol.encode_tensors(tbuf)
        assert blob == jax.protocol.encode_tensors(jbuf)
        joined = b"".join(bytes(p) for p in
                          port.protocol.tensor_parts(tbuf))
        assert joined == b"".join(bytes(p) for p in
                                  jax.protocol.tensor_parts(jbuf)) == blob

    def test_device_payload_encodes_like_host(self):
        """A torch tensor payload (the port's filter output) frames as
        its host array does."""
        port = PKGS["torch"]
        arr = BUFFERS["f32"][0]
        assert port.protocol.encode_tensors(port.TensorBuffer(
            tensors=[torch.from_numpy(arr.copy())])) == \
            port.protocol.encode_tensors(port.TensorBuffer(tensors=[arr]))

    @pytest.mark.parametrize("fmt", ["STATIC", "FLEXIBLE", "SPARSE"])
    def test_meta_headers_equal(self, fmt):
        from nnstreamer_tpu.tensor import info as jinfo
        from nnstreamer_tpu.tensor import meta as jmeta
        from nnstreamer_tpu.tensor import types as jtypes
        from nnstreamer_tpu_torch.tensor import info as tinfo
        from nnstreamer_tpu_torch.tensor import meta as tmeta
        from nnstreamer_tpu_torch.tensor import types as ttypes

        arr = BUFFERS["several"][2]
        a = tmeta.TensorMetaInfo.from_info(
            tinfo.TensorInfo.from_np(arr), getattr(ttypes.TensorFormat, fmt))
        b = jmeta.TensorMetaInfo.from_info(
            jinfo.TensorInfo.from_np(arr), getattr(jtypes.TensorFormat, fmt))
        assert a.to_bytes() == b.to_bytes()
        assert len(a.to_bytes()) == tmeta.META_HEADER_SIZE

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    @pytest.mark.parametrize("name", sorted(BUFFERS))
    def test_decode_reads_the_other_packages_bytes(self, writer, name):
        reader = PKGS["torch" if writer == "jax" else "jax"]
        w = PKGS[writer]
        tensors = BUFFERS[name]
        blob = w.protocol.encode_tensors(w.TensorBuffer(tensors=tensors))
        back = reader.protocol.decode_tensors(blob)
        assert len(back) == len(tensors)
        for got, want in zip(back, tensors):
            assert got.dtype == want.dtype and not got.flags.writeable
            np.testing.assert_array_equal(got, want)

    def test_crc_equal_when_both_native_libraries_load(self):
        native_crc_both()
        jp, tp = PKGS["jax"].protocol, PKGS["torch"].protocol
        for fields in _messages():
            a = tp.pack(tp.Message(**fields))
            b = jp.pack(jp.Message(**fields))
            crc = struct.unpack_from("<I", a, 61)[0]
            assert a == b
            assert (crc != 0) == bool(fields["payload"])
        data = BUFFERS["uint8_frame"][0].tobytes()
        assert port_native.crc32c_fn()(data) == jax_native.crc32c(data)

    def test_crc_zero_on_both_sides_without_native(self, monkeypatch):
        jp, tp = PKGS["jax"].protocol, PKGS["torch"].protocol
        monkeypatch.setattr(jp, "_CRC_FN", False)
        monkeypatch.setattr(tp, "_CRC_FN", False)
        fields = _messages()[1]
        a = tp.pack(tp.Message(**fields))
        assert a == jp.pack(jp.Message(**fields))
        assert struct.unpack_from("<I", a, 61)[0] == 0


# ---------------------------------------------------------------------------
# live round trips across packages
# ---------------------------------------------------------------------------

def mlp_server(pkg, sid, batch=""):
    p = pkg.parse_launch(
        f"tensor_query_serversrc name=qsrc id={sid} port=0 {batch} "
        f"caps={tcaps('8')} ! tensor_filter framework=xla model=mlp "
        f"{pkg.accel}custom={MLP} name=f ! tensor_query_serversink id={sid}")
    p.play()
    return p, p.get("qsrc").bound_port


def own_forward(pkg_name, x):
    if pkg_name == "jax":
        model = jax_registry.get_model("mlp", dict(MLP_CUSTOM))
        return np.asarray(model.forward(model.params, x)[0])
    model = port_registry.get_model("mlp", dict(MLP_CUSTOM), device="cpu")
    with torch.inference_mode():
        return model.module(torch.from_numpy(x))[0].numpy()


@pytest.mark.parametrize("server,client", [("jax", "torch"),
                                           ("torch", "jax")])
def test_cross_package_round_trip(server, client):
    """One package's client pipeline offloads to the other's MLP server;
    every reply equals the serving package's own forward within 1e-5."""
    srv, cli = PKGS[server], PKGS[client]
    sid = 1901 if server == "jax" else 1902
    p, port = mlp_server(srv, sid)
    rng = np.random.default_rng(5)
    xs = [rng.standard_normal(8).astype(np.float32) for _ in range(6)]
    try:
        c = cli.Pipeline("client")
        src = cli.AppSrc("src", caps=tcaps("8"))
        qc = cli.query.TensorQueryClient("qc", port=port, timeout=20.0)
        out = cli.TensorSink("out")
        c.add(src, qc, out)
        c.link(src, qc, out)
        for i, x in enumerate(xs):
            src.push_buffer(cli.TensorBuffer(tensors=[x], pts=i))
        src.end_of_stream()
        c.play()
        try:
            c.wait(timeout=60)
            # the server's caps arrived over the other package's handshake
            assert qc.conn.server_caps == tcaps("8")
        finally:
            c.stop()
        assert [b.pts for b in out.results] == list(range(len(xs)))
        for b, x in zip(out.results, xs):
            np.testing.assert_allclose(b.np(0), own_forward(server, x),
                                       rtol=1e-5, atol=1e-5)
    finally:
        p.stop()
        srv.server.shutdown_server(sid)


# ---------------------------------------------------------------------------
# the JAX package's query behaviours, on both packages
# ---------------------------------------------------------------------------

def test_codec_round_trip(pkg):
    buf = pkg.TensorBuffer(tensors=[
        np.arange(6, dtype=np.float32).reshape(2, 3),
        np.array([1, 2, 3], np.uint8)], pts=123)
    back = pkg.protocol.decode_tensors(pkg.protocol.encode_tensors(buf))
    assert len(back) == 2
    np.testing.assert_array_equal(back[0], buf.np(0))
    np.testing.assert_array_equal(back[1], buf.np(1))


def _feed(sock, data):
    def run():
        try:
            sock.sendall(data)
        finally:
            sock.close()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def test_crc_detects_corruption(pkg):
    native_crc_both()
    proto = pkg.protocol
    wire = bytearray(proto.pack(proto.Message(proto.T_DATA, seq=5,
                                              payload=b"x" * 64)))
    wire[-1] ^= 0xFF            # flip one payload byte
    a, b = socket.socketpair()
    b.settimeout(10)
    t = _feed(a, bytes(wire))
    with pytest.raises(ValueError, match="CRC mismatch"):
        proto.recv_msg(b)
    b.close()
    t.join(timeout=10)


def test_zero_crc_means_unchecked(pkg):
    proto = pkg.protocol
    wire = bytearray(proto.pack(proto.Message(proto.T_DATA,
                                              payload=b"hello")))
    struct.pack_into("<I", wire, 61, 0)      # the crc field
    wire[-1] ^= 0xFF            # corrupt; crc=0 disables the check
    a, b = socket.socketpair()
    b.settimeout(10)
    t = _feed(a, bytes(wire))
    got = proto.recv_msg(b)
    assert got is not None and got.payload != b"hello"
    b.close()
    t.join(timeout=10)


def test_wire_fuzz_round_trips(pkg):
    """Seeded arbitrary messages survive pack -> socket -> recv byte for
    byte (CRC verified where the native library loaded)."""
    proto = pkg.protocol
    rng = np.random.default_rng(123)
    msgs = [proto.Message(
        type=int(rng.integers(1, 6)),
        client_id=int(rng.integers(0, 2**63)),
        seq=int(rng.integers(0, 2**63)),
        pts=int(rng.integers(-2**31, 2**62)),
        epoch_us=int(rng.integers(-2**31, 2**62)),
        payload=rng.bytes(int(rng.integers(0, 4096)))) for _ in range(50)]
    a, b = socket.socketpair()
    b.settimeout(10)
    t = _feed(a, b"".join(proto.pack(m) for m in msgs))
    try:
        for m in msgs:
            got = proto.recv_msg(b)
            assert got is not None
            assert (got.type, got.client_id, got.seq, got.pts,
                    got.epoch_us, got.payload) == \
                (m.type, m.client_id, m.seq, m.pts, m.epoch_us, m.payload)
    finally:
        b.close()
        t.join(timeout=10)


def test_dest_host_without_port_is_loud(pkg):
    qc = pkg.query.TensorQueryClient("qc", **{"dest-host": "10.0.0.5"})
    with pytest.raises(ValueError, match="dest-port"):
        qc._server_address()


def test_hybrid_connect_type_waits_for_mqtt():
    """HYBRID discovery goes through an MQTT broker (``query/mqtt.py``):
    a client waits there for the record the serversrc advertises, finds
    its address, and finds none once the server stopped."""
    from nnstreamer_tpu_torch.query.mqtt import MqttBroker

    port = PKGS["torch"]
    broker = MqttBroker()
    hybrid = {"connect-type": "HYBRID", "dest-host": "127.0.0.1",
              "dest-port": broker.port, "topic": "t"}
    try:
        qc = port.query.TensorQueryClient("qc", timeout=0.3, **hybrid)
        with pytest.raises(ConnectionError, match="no retained discovery"):
            qc._server_address()
        src = port.query.TensorQueryServerSrc("qs", id=1903, caps=tcaps(),
                                              **hybrid)
        src.start()
        try:
            assert qc._server_address() == ("127.0.0.1", src.bound_port)
        finally:
            src.stop()
            port.server.shutdown_server(1903)
        with pytest.raises(ConnectionError, match="no retained discovery"):
            qc._server_address()
    finally:
        broker.close()


class _AlwaysShed:
    """A shed policy that refuses everything."""

    def __init__(self, retry_after_s):
        self.retry_after_s = retry_after_s

    def decide(self, qos, depth, capacity):
        return self.retry_after_s


def echo_server(pkg, scale=2.0, gate=None, **kw):
    """A ``QueryServer`` whose consumer thread replies with the tensors
    times ``scale`` (``gate``: consumption waits while it is clear)."""
    srv = pkg.server.QueryServer(**kw)
    srv.set_caps_string(tcaps())

    def run():
        while not srv._stop.is_set():
            if gate is not None and not gate.wait(timeout=0.1):
                continue
            try:
                buf = srv.incoming.get(timeout=0.1)
            except _queue.Empty:
                continue
            out = pkg.TensorBuffer(
                tensors=[np.asarray(buf.tensors[0]) * scale], pts=buf.pts)
            out.extra.update(buf.extra)
            srv.reply(out)

    threading.Thread(target=run, daemon=True, name="echo").start()
    return srv


def test_shed_answered_with_retry_after(pkg):
    srv = pkg.server.QueryServer(
        queue_depth=8, admission=pkg.overload.AdmissionController(
            policy=_AlwaysShed(0.123)))
    srv.set_caps_string(tcaps())
    conn = pkg.query.QueryConnection("127.0.0.1", srv.port, timeout=5.0,
                                     qos="bronze")
    conn.connect()
    try:
        with pytest.raises(pkg.overload.ShedError) as exc:
            conn.query(pkg.TensorBuffer(tensors=[np.ones(4, np.float32)]))
        assert exc.value.retry_after_s == pytest.approx(0.123)
        assert exc.value.qos == "bronze"
        counters = srv.counters()
        assert counters["shed"]["bronze"] == 1
        assert sum(counters["admitted"].values()) == 0
    finally:
        conn.close()
        srv.close()


def test_ping_pong_heartbeat(pkg):
    srv = echo_server(pkg)
    conn = pkg.query.QueryConnection("127.0.0.1", srv.port, timeout=5.0)
    conn.connect()
    try:
        rtts = [conn.ping(timeout=5.0) for _ in range(3)]
        assert all(0 < r < 5.0 for r in rtts)
        # the pong's wall stamp fed the clock-offset estimator
        assert conn.offset.samples == 3 and conn.offset.rtt_us is not None
        out = conn.query(pkg.TensorBuffer(
            tensors=[np.arange(4, dtype=np.float32)], pts=5))
        np.testing.assert_array_equal(out.np(0), [0, 2, 4, 6])
        assert out.pts == 5 and conn.server_caps == tcaps()
    finally:
        conn.close()
        srv.close()


@pytest.mark.chaos
def test_breaker_open_then_half_open_recovery(pkg):
    res = pkg.resilience
    srv = echo_server(pkg)
    proxy = ChaosProxy(("127.0.0.1", srv.port))
    conn = pkg.query.FailoverConnection(
        [("127.0.0.1", proxy.port)], timeout=0.4,
        retry=res.RetryPolicy(max_attempts=1, base_delay=0.01, jitter=0.0),
        breaker_failures=2, breaker_cooldown=0.25)
    buf = pkg.TensorBuffer(tensors=[np.array([1.0], np.float32)])
    try:
        base = res.STATS.snapshot()
        proxy.refuse = True      # the dial "succeeds", the link dies
        for _ in range(2):       # two failures reach the threshold
            with pytest.raises((ConnectionError, TimeoutError)):
                conn.query(buf)
        assert conn.breakers[0].state == res.CircuitBreaker.OPEN
        t0 = time.monotonic()
        with pytest.raises(res.CircuitOpenError):
            conn.query(buf)
        assert time.monotonic() - t0 < 0.1      # fails fast
        proxy.refuse = False
        time.sleep(0.3)          # past the cooldown: a half-open trial
        np.testing.assert_array_equal(conn.query(buf).np(0), [2.0])
        assert conn.breakers[0].state == res.CircuitBreaker.CLOSED
        d = res.STATS.delta(base)
        assert d.get("breaker.open", 0) >= 1, d
        assert d.get("breaker.half_open", 0) >= 1, d
        assert d.get("breaker.closed", 0) >= 1, d
    finally:
        conn.close()
        proxy.close()
        srv.close()


@pytest.mark.chaos
def test_heartbeat_failover_across_dest_hosts(pkg):
    res = pkg.resilience
    srv_a, srv_b = echo_server(pkg, 2.0), echo_server(pkg, 3.0)
    proxy = ChaosProxy(("127.0.0.1", srv_a.port))
    p = pkg.Pipeline("client")
    src = pkg.AppSrc("src", caps=tcaps())
    qc = pkg.query.TensorQueryClient("qc", **{
        "dest-hosts": f"127.0.0.1:{proxy.port},127.0.0.1:{srv_b.port}",
        "timeout": 3.0, "fallback": "error",
        "retry": "attempts=3,base=0.02,jitter=0",
        "heartbeat-interval": 0.08, "heartbeat-max-missed": 2})
    sink = pkg.TensorSink("out")
    p.add(src, qc, sink)
    p.link(src, qc, sink)
    key_a = f"127.0.0.1:{proxy.port}"
    try:
        p.play()
        src.push_buffer(pkg.TensorBuffer(
            tensors=[np.full(4, 1.0, np.float32)], pts=0))
        assert wait_until(lambda: len(sink.results) == 1)
        np.testing.assert_array_equal(sink.results[0].np(0),
                                      np.full(4, 2.0, np.float32))
        base = res.STATS.snapshot()
        proxy.blackhole = True   # pings vanish: A goes dead
        assert wait_until(lambda: (
            qc.conn.monitor.health(key_a) is not None
            and qc.conn.monitor.health(key_a).state
            == res.EndpointHealth.DEAD), 5.0)
        t0 = time.monotonic()
        src.push_buffer(pkg.TensorBuffer(
            tensors=[np.full(4, 1.0, np.float32)], pts=1))
        assert wait_until(lambda: len(sink.results) == 2)
        assert time.monotonic() - t0 < 2.0      # not a reply timeout
        np.testing.assert_array_equal(sink.results[1].np(0),
                                      np.full(4, 3.0, np.float32))
        assert qc.conn.active_endpoint == ("127.0.0.1", srv_b.port)
        d = res.STATS.delta(base)
        assert d.get("heartbeat.endpoint_down", 0) >= 1, d
        assert d.get("query.failovers", 0) >= 1, d
        src.end_of_stream()
        p.wait(timeout=10)
    finally:
        p.stop()
        proxy.close()
        srv_a.close()
        srv_b.close()


def test_graceful_drain_answers_inflight_and_sheds_new(pkg):
    gate = threading.Event()
    srv = echo_server(pkg, gate=gate, queue_depth=16)
    results, conns = {}, []

    def one(i):
        c = pkg.query.QueryConnection("127.0.0.1", srv.port, timeout=10.0,
                                      qos="gold")
        c.connect()
        conns.append(c)
        out = c.query(pkg.TensorBuffer(tensors=[np.full(4, i, np.float32)]))
        results[i] = out.np(0).tolist()

    workers = [threading.Thread(target=one, args=(i,), daemon=True)
               for i in range(3)]
    for w in workers:
        w.start()
    assert wait_until(lambda: srv._inflight == 3)
    drained = {}
    dt = threading.Thread(
        target=lambda: drained.update(ok=srv.drain(deadline=10)),
        daemon=True)
    dt.start()
    assert wait_until(lambda: srv.draining)
    late = pkg.query.QueryConnection("127.0.0.1", srv.port, timeout=5.0,
                                     qos="gold")
    late.connect()
    with pytest.raises(pkg.overload.ShedError) as exc:
        late.query(pkg.TensorBuffer(tensors=[np.ones(4, np.float32)]))
    assert exc.value.retry_after_s > 0
    late.close()
    gate.set()
    join_all([dt, *workers], timeout=20)
    assert drained.get("ok") is True
    assert results == {i: [2.0 * i] * 4 for i in range(3)}
    for c in conns:
        c.close()


def test_pipeline_drain_hooks_serversrc(pkg):
    sid = 1904
    p = pkg.parse_launch(f"tensor_query_serversrc name=qsrc id={sid} "
                         f"port=0 caps={tcaps()} ! "
                         f"tensor_query_serversink id={sid}")
    p.play()
    try:
        assert p.health_state() == "serving"
        srv = p.get("qsrc").server
        srv._draining.set()
        assert p.health_state() == "draining"
        srv._draining.clear()
        p.drain(deadline=2.0)
        assert srv._stop.is_set()
        assert sid not in pkg.server._SERVERS     # table entry reaped
        assert p.health_state() == "draining"
    finally:
        p.stop()
        pkg.server.shutdown_server(sid)


# ---------------------------------------------------------------------------
# cross-stream buckets in the server
# ---------------------------------------------------------------------------

class RawClient:
    """A wire-level client that pipelines requests (many seqs in flight
    on one connection)."""

    def __init__(self, pkg, port):
        self.proto = pkg.protocol
        self.pkg = pkg
        self.sock = socket.create_connection(("127.0.0.1", port),
                                             timeout=10)
        self.events, self.replies = [], {}
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def send(self, seq, arr):
        self.proto.send_tensors(self.sock, self.proto.T_DATA,
                                self.pkg.TensorBuffer(tensors=[arr]),
                                seq=seq)

    def _read(self):
        while True:
            try:
                msg = self.proto.recv_msg(self.sock)
            except (OSError, ValueError):
                return
            if msg is None:
                return
            if msg.type in (self.proto.T_REPLY, self.proto.T_SHED):
                self.events.append((msg.type, msg.seq))
                if msg.type == self.proto.T_REPLY:
                    self.replies[msg.seq] = [
                        np.array(t) for t in
                        self.proto.decode_tensors(msg.payload)]

    def answered(self):
        return len(self.events)

    def close(self):
        try:
            self.proto.send_msg(self.sock, self.proto.Message(
                self.proto.T_BYE))
        except OSError:
            pass
        self.sock.close()
        self._reader.join(timeout=5)


def echo_pipeline(pkg, sid, extra):
    p = pkg.parse_launch(f"tensor_query_serversrc name=qsrc id={sid} "
                         f"port=0 {extra} caps={tcaps()} ! "
                         f"tensor_query_serversink id={sid}")
    p.play()
    return p, p.get("qsrc").bound_port


def test_server_batching_coalesces_and_equals_per_frame(pkg):
    """Four synchronous clients against ``batch=4 batch-timeout-ms=20``
    in front of the MLP: buckets form, and every reply equals the
    package's own per-frame forward (1e-5)."""
    sid = 1905
    p, port = mlp_server(pkg, sid, "batch=4 batch-timeout-ms=20")
    errs = []

    def run(i):
        conn = pkg.query.QueryConnection("127.0.0.1", port, timeout=20.0)
        conn.connect()
        try:
            rng = np.random.default_rng(100 + i)
            for _ in range(6):
                x = rng.standard_normal(8).astype(np.float32)
                out = conn.query(pkg.TensorBuffer(tensors=[x]))
                if not np.allclose(out.np(0), own_forward(pkg.key, x),
                                   rtol=1e-5, atol=1e-5):
                    errs.append(i)
        except Exception as exc:  # noqa: BLE001 - surfaced below
            errs.append(repr(exc))
        finally:
            conn.close()

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(4)]
    try:
        for t in threads:
            t.start()
        join_all(threads, timeout=120)
        qsrc, filt = p.get("qsrc"), p.get("f")
        assert not errs, errs[:3]
        assert qsrc._m_xb_batched.value > 0
        assert qsrc._m_xb_frames.value + qsrc._m_xb_solo.value == 24
        assert filt._xb_invokes == qsrc._m_xb_batched.value
        assert filt._xb_frames == qsrc._m_xb_frames.value
    finally:
        p.stop()
        pkg.server.shutdown_server(sid)


@pytest.mark.parametrize("card", [False, True])
def test_bucket_pins_its_stack_only_for_a_card_filter(monkeypatch, card):
    """The serversrc stacks a bucket's frames into pinned memory only
    where the filter it feeds runs on the card (the filter's backend
    decides); a filter that asked for the CPU gets a pageable stack."""
    from nnstreamer_tpu_torch.elements.filter_elem import TensorFilter

    pkg, sid, pins = PKGS["torch"], 1920 + card, []
    stack_host = _cuda.stack_host

    def record(arrs, rows=0, pin=False):
        pins.append(pin)
        return stack_host(arrs, rows)

    monkeypatch.setattr(_cuda, "stack_host", record)
    if card:
        monkeypatch.setattr(TensorFilter, "pins_host_input",
                            lambda self: True)
    p, port = mlp_server(pkg, sid, "batch=4 batch-timeout-ms=2000")
    clients = []
    try:
        assert p.get("f").pins_host_input() is card
        clients = [RawClient(pkg, port) for _ in range(4)]
        deadline = time.monotonic() + 10
        while (len(p.get("qsrc").server._clients) < 4
               and time.monotonic() < deadline):
            time.sleep(0.01)
        rng = np.random.default_rng(7)
        xs = rng.standard_normal((4, 8)).astype(np.float32)
        for c, x in zip(clients, xs):
            c.send(1, x)
        deadline = time.monotonic() + 30
        while (sum(c.answered() for c in clients) < 4
               and time.monotonic() < deadline):
            time.sleep(0.01)
        for c, x in zip(clients, xs):
            np.testing.assert_allclose(c.replies[1][0],
                                       own_forward("torch", x),
                                       rtol=1e-5, atol=1e-5)
        assert p.get("qsrc")._m_xb_batched.value == 1
        assert pins == [card]
    finally:
        for c in clients:
            c.close()
        p.stop()
        pkg.server.shutdown_server(sid)


def test_single_client_takes_solo_path(pkg):
    sid = 1906
    p, port = echo_pipeline(pkg, sid, "batch=8 batch-timeout-ms=50")
    conn = pkg.query.QueryConnection("127.0.0.1", port, timeout=10.0)
    conn.connect()
    try:
        t0 = time.monotonic()
        for k in range(5):
            x = np.arange(4, dtype=np.float32) + k
            np.testing.assert_array_equal(conn.query(pkg.TensorBuffer(
                tensors=[x])).np(0), x)
        # fill target = min(batch, connected clients) = 1: no fill wait
        assert time.monotonic() - t0 < 5 * 0.05 + 1.0
        qsrc = p.get("qsrc")
        assert (qsrc._m_xb_solo.value, qsrc._m_xb_batched.value) == (5, 0)
    finally:
        conn.close()
        p.stop()
        pkg.server.shutdown_server(sid)


@pytest.mark.parametrize("how", ["eos", "drain"])
def test_stop_flushes_resident_bucket(pkg, how):
    """Frames resident in a collecting bucket are dispatched, not
    dropped, when the source halts (EOS) or the server drains; a huge
    fill window must not stall either."""
    sid = 1907 if how == "eos" else 1908
    p, port = echo_pipeline(pkg, sid, "batch=8 batch-timeout-ms=10000")
    # idle peers raise the fill target, so the frames sit resident
    idle = [RawClient(pkg, port) for _ in range(5)]
    cli = RawClient(pkg, port)
    try:
        for seq in (1, 2, 3):
            cli.send(seq, np.full(4, seq, np.float32))
        srv = pkg.server.get_server(sid)
        assert wait_until(lambda: srv._inflight == 3, timeout=5)
        if pkg.key == "jax" and how == "eos":
            # the JAX package drops admitted frames a halt finds still
            # queued (the port takes them in): its case halts only once
            # they are resident in the bucket
            qsrc = p.get("qsrc")
            assert wait_until(lambda: qsrc._xb_bucket.fill == 3, timeout=5)
        t0 = time.monotonic()
        if how == "drain":
            assert srv.drain(deadline=10.0)
        else:
            p.get("qsrc")._halted.set()
        assert wait_until(lambda: cli.answered() == 3, timeout=5)
        assert time.monotonic() - t0 < 8.0
        assert [s for t, s in cli.events
                if t == pkg.protocol.T_REPLY] == [1, 2, 3]
        for seq in (1, 2, 3):
            np.testing.assert_array_equal(cli.replies[seq][0],
                                          np.full(4, seq, np.float32))
    finally:
        cli.close()
        for c in idle:
            c.close()
        p.stop()
        pkg.server.shutdown_server(sid)


def test_halt_dispatches_admitted_frames_still_queued():
    """Frames admitted but not yet dequeued into a bucket when the source
    halts are still dispatched and answered in order (the JAX package
    drops them)."""
    pkg, sid = PKGS["torch"], 1922
    p, port = echo_pipeline(pkg, sid, "batch=8 batch-timeout-ms=10000")
    srv = pkg.server.get_server(sid)
    get = srv.incoming.get

    def held(block=True, timeout=None):
        # the bucket thread's waits find nothing, so the frames stay
        # queued until the halt's non-blocking takes
        if not block:
            return get(block=False)
        time.sleep(min(timeout or 0.0, 0.05))
        raise _queue.Empty

    srv.incoming.get = held
    time.sleep(0.2)          # a wait begun before the patch has ended
    cli = RawClient(pkg, port)
    try:
        for seq in (1, 2, 3):
            cli.send(seq, np.full(4, seq, np.float32))
        assert wait_until(lambda: srv._inflight == 3, timeout=5)
        assert srv.incoming.qsize() == 3
        p.get("qsrc")._halted.set()
        assert wait_until(lambda: cli.answered() == 3, timeout=5)
        assert [s for t, s in cli.events
                if t == pkg.protocol.T_REPLY] == [1, 2, 3]
        assert p.get("qsrc")._m_xb_batched.value == 1
    finally:
        cli.close()
        p.stop()
        pkg.server.shutdown_server(sid)


@pytest.mark.chaos
def test_disconnect_mid_bucket(pkg):
    """A client that vanishes while its frame sits in a collecting
    bucket: the bucket still dispatches, the dead client's reply drops,
    peers are served and no pooled slab leaks."""
    sid = 1909
    p, port = echo_pipeline(pkg, sid, "batch=8 batch-timeout-ms=300")
    idle = [RawClient(pkg, port) for _ in range(5)]
    proxy = ChaosProxy(("127.0.0.1", port))
    doomed = RawClient(pkg, proxy.port)
    try:
        doomed.send(1, np.full(4, 7, np.float32))
        srv = pkg.server.get_server(sid)
        assert wait_until(lambda: srv._inflight >= 1, timeout=5)
        proxy.kill_connections()
        survivor = pkg.query.QueryConnection("127.0.0.1", port,
                                             timeout=10.0)
        survivor.connect()
        for k in range(5):
            x = np.arange(4, dtype=np.float32) + k
            np.testing.assert_array_equal(survivor.query(pkg.TensorBuffer(
                tensors=[x])).np(0), x)
        survivor.close()
        assert wait_until(lambda: srv._inflight == 0, timeout=10)
    finally:
        doomed.close()
        proxy.close()
        for c in idle:
            c.close()
        p.stop()
        pkg.server.shutdown_server(sid)
    gc.collect()
    assert pkg.default_pool().stats["pending"] == 0


# ---------------------------------------------------------------------------
# the port's own staging and tracing
# ---------------------------------------------------------------------------

def test_read_only_frames_stage_with_one_copy():
    """A decoded frame is a read-only view over the payload; the port
    stages it into one new host tensor (pinned where the caller asks)
    without PyTorch's non-writable warning, and stacks a bucket's frames
    into one tensor, padding by repeating the last."""
    port = PKGS["torch"]
    rows = [np.full((2, 3), i, np.uint8) for i in range(3)]
    blob = port.protocol.encode_tensors(port.TensorBuffer(tensors=rows))
    views = port.protocol.decode_tensors(blob)
    assert not any(v.flags.writeable for v in views)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        one = _cuda.host_tensor(views[1])
        stacked = _cuda.stack_host(views, 5)
    assert one.dtype == torch.uint8 and torch.equal(
        one, torch.full((2, 3), 1, dtype=torch.uint8))
    assert stacked.shape == (5, 2, 3)
    np.testing.assert_array_equal(stacked.numpy(),
                                  np.stack(rows + [rows[-1]] * 2))
    assert not np.shares_memory(stacked.numpy(), np.frombuffer(
        blob, np.uint8))


def test_server_spans_ride_t_trace_to_the_client(pkg):
    """A span-recording server pipeline sends its spans after each reply
    (T_TRACE); a traced client merges them under the server's process."""
    sid = 1910
    p = pkg.parse_launch(f"tensor_query_serversrc name=qsrc id={sid} "
                         f"port=0 caps={tcaps()} ! "
                         f"tensor_query_serversink id={sid}")
    p.enable_tracing(spans=True)
    p.play()
    port = p.get("qsrc").bound_port
    try:
        c = pkg.Pipeline("client")
        src = pkg.AppSrc("src", caps=tcaps())
        qc = pkg.query.TensorQueryClient("qc", port=port, timeout=10.0)
        out = pkg.TensorSink("out")
        c.add(src, qc, out)
        c.link(src, qc, out)
        tracer = c.enable_tracing(spans=True)
        for i in range(3):
            src.push_buffer(pkg.TensorBuffer(
                tensors=[np.full(4, i, np.float32)], pts=i))
        src.end_of_stream()
        c.run(timeout=30)
        assert len(out.results) == 3
        doc = tracer.chrome_trace()
        remote = {e["pid"] for e in doc["traceEvents"]
                  if e.get("ph") == "X" and e["pid"] != 1}
        assert remote, "no server spans merged into the client timeline"
        assert tracer.report()["qc"]["buffers"] == 3
    finally:
        p.stop()
        pkg.server.shutdown_server(sid)


def test_async_replies_stop(pkg, monkeypatch):
    """``async-replies=true`` moves the bucket split onto a pusher
    thread; the replies stay exact.  At stop the port's pusher ends
    cleanly, while the JAX package's re-reads the queue attribute its
    stop has cleared and dies with an AttributeError (pinned here; the
    port keeps its own reference to the queue)."""
    died = []
    monkeypatch.setattr(threading, "excepthook",
                        lambda args: died.append(args.exc_type))
    sid = 1911
    p, port = echo_pipeline(pkg, sid, "batch=4 batch-timeout-ms=10000")
    p.get("qsrc").src_pad.peer.element.async_replies = True
    clients = [RawClient(pkg, port) for _ in range(4)]
    try:
        # four connections, one frame each: the fill target is 4, so
        # they form one cross-stream bucket, which starts the pusher
        for i, c in enumerate(clients):
            c.send(1, np.full(4, i, np.float32))
        assert wait_until(lambda: all(c.answered() == 1 for c in clients))
        for i, c in enumerate(clients):
            np.testing.assert_array_equal(c.replies[1][0],
                                          np.full(4, i, np.float32))
        sink = p.get("qsrc").src_pad.peer.element
        pusher = sink._rthread
        assert pusher is not None and pusher.is_alive()
    finally:
        for c in clients:
            c.close()
        p.stop()
        pkg.server.shutdown_server(sid)
    pusher.join(timeout=5)
    assert not pusher.is_alive()
    assert died == ([] if pkg.key == "torch" else [AttributeError])
