"""The port's gRPC tensor service against the JAX package's, on the CPU.

``tensor_src_grpc`` and ``tensor_sink_grpc`` of each package pair with
the other's in all four server/client pairings (a sink dialing a src's
service, a src pulling from a sink's service), over both IDLs
(``protobuf``: ``nnstreamer.proto`` through ``encode_tensors_proto``;
``flatbuf``: ``nnstreamer.fbs`` through ``tensor_flatbuf``); frames are
held byte for byte.  The protobuf frames are also held against message
classes built from the reference schema with the protobuf runtime, and a
client-mode src redialing under ``retry`` stops without waiting out its
backoff.
"""

import os
import subprocess
import sys
import threading
import time
from fractions import Fraction

import numpy as np
import pytest

pytest.importorskip("grpc")

from nnstreamer_tpu import parse_launch as jax_parse_launch  # noqa: E402
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer  # noqa: E402
from nnstreamer_tpu_torch import parse_launch as port_parse_launch  # noqa: E402
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer as PortBuffer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARSE = {"jax": jax_parse_launch, "torch": port_parse_launch}
BUFFER = {"jax": JaxBuffer, "torch": PortBuffer}
CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=4:3,"
        "types=float32,framerate=30/1")
#: (sender, receiver) pairs where at least one end is the port's
CROSS = [("jax", "torch"), ("torch", "jax"), ("torch", "torch")]


def _frames(n, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((3, 4)).astype(np.float32)
            for _ in range(n)]


def _feed(p, pkg, frames):
    src = p.get("in")
    for f in frames:
        src.push_buffer(BUFFER[pkg](tensors=[f]))
    src.end_of_stream()


def _collect(p):
    got = []
    p.get("out").connect("new-data", lambda b: got.append(b))
    return got


def _assert_frames(got, frames):
    assert len(got) == len(frames)
    for b, f in zip(got, frames):
        assert b.np(0).dtype == f.dtype and b.np(0).shape == f.shape
        assert b.np(0).tobytes() == f.tobytes()


class TestRoundTrip:
    @pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
    @pytest.mark.parametrize("sender,receiver", CROSS)
    def test_sink_client_to_src_server(self, sender, receiver, idl):
        """A sink dials the other package's src service (SendTensors)."""
        rx = PARSE[receiver](
            f"tensor_src_grpc server=true port=0 idl={idl} num-buffers=5 "
            "name=rx ! tensor_sink name=out")
        got = _collect(rx)
        rx.play()
        tx = PARSE[sender](
            f"appsrc caps={CAPS} name=in ! tensor_sink_grpc server=false "
            f"host=127.0.0.1 port={rx.get('rx').port} idl={idl}")
        frames = _frames(5)
        try:
            tx.play()
            _feed(tx, sender, frames)
            tx.wait(timeout=30)
            rx.wait(timeout=30)
        finally:
            tx.stop()
            rx.stop()
        _assert_frames(got, frames)

    @pytest.mark.parametrize("idl", ["protobuf", "flatbuf"])
    @pytest.mark.parametrize("sender,receiver", CROSS)
    def test_src_client_pulls_from_sink_server(self, sender, receiver, idl):
        """A src pulls the other package's sink service (RecvTensors)."""
        tx = PARSE[sender](
            f"appsrc caps={CAPS} name=in ! tensor_sink_grpc server=true "
            f"port=0 idl={idl} name=sg")
        tx.play()
        rx = PARSE[receiver](
            f"tensor_src_grpc server=false host=127.0.0.1 "
            f"port={tx.get('sg').port} idl={idl} num-buffers=4 name=rx ! "
            "tensor_sink name=out")
        got = _collect(rx)
        frames = _frames(4)
        try:
            rx.play()
            service = tx.get("sg")._grpc_server.service
            deadline = time.monotonic() + 10
            while not service._subs and time.monotonic() < deadline:
                time.sleep(0.005)      # RecvTensors subscribed first
            _feed(tx, sender, frames)
            rx.wait(timeout=30)
            tx.wait(timeout=30)
        finally:
            rx.stop()
            tx.stop()
        _assert_frames(got, frames)

    def test_caps_override_and_derived_match(self):
        rx = port_parse_launch(
            f"tensor_src_grpc server=true port=0 caps={CAPS} num-buffers=2 "
            "name=rx ! tensor_sink name=out")
        rx.play()
        tx = jax_parse_launch(
            f"appsrc caps={CAPS} name=in ! tensor_sink_grpc server=false "
            f"host=127.0.0.1 port={rx.get('rx').port}")
        try:
            tx.play()
            _feed(tx, "jax", _frames(2))
            rx.wait(timeout=30)
        finally:
            tx.stop()
            rx.stop()
        caps = rx.get("rx").src_pad.caps.first()
        assert caps.get("dimensions") == "4:3"
        assert caps.get("types") == "float32"

    def test_out_counter_rejects_writes(self):
        from nnstreamer_tpu_torch.query.grpc_service import GrpcTensorSrc

        el = GrpcTensorSrc(name="g")
        with pytest.raises(ValueError, match="read-only"):
            el.set_property("out", 5)
        assert el.get_property("out") == 0


def test_client_src_stop_does_not_wait_out_a_redial():
    """A client-mode src redialing a dead service under ``retry`` (2 s
    backoffs) stops at once, and its pull thread ends with it."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]
    rx = port_parse_launch(
        f"tensor_src_grpc server=false host=127.0.0.1 port={dead} "
        f"caps={CAPS} retry=attempts=50,base=2,cap=2,jitter=0 name=rx ! "
        "tensor_sink name=out")
    rx.play()
    time.sleep(0.5)          # the first dial has failed, a backoff runs
    t0 = time.monotonic()
    rx.stop()
    pullers = [t for t in threading.enumerate()
               if t.name == "grpc-src:rx"]
    for t in pullers:
        t.join(timeout=5)
    assert time.monotonic() - t0 < 1.5
    assert not any(t.is_alive() for t in pullers)


# ---------------------------------------------------------------------------
# the reference IDL, through the protobuf runtime
# ---------------------------------------------------------------------------

TYPES = ["NNS_INT32", "NNS_UINT32", "NNS_INT16", "NNS_UINT16", "NNS_INT8",
         "NNS_UINT8", "NNS_FLOAT64", "NNS_FLOAT32", "NNS_INT64",
         "NNS_UINT64", "NNS_FLOAT16", "NNS_BFLOAT16"]


@pytest.fixture(scope="module")
def pb():
    """Message classes of the reference's ``nnstreamer.proto`` (Tensor:
    name 1, type 2, repeated uint32 dimension 3, data 4; Tensors:
    num_tensor 1, frame_rate fr 2, repeated Tensor tensor 3, format 4),
    built with the protobuf runtime from a descriptor (no protoc)."""
    pytest.importorskip("google.protobuf")
    from google.protobuf import descriptor_pb2, descriptor_pool
    from google.protobuf import message_factory

    F = descriptor_pb2.FieldDescriptorProto
    fd = descriptor_pb2.FileDescriptorProto(
        name="nnstreamer_port_test.proto", package="nnstreamer.protobuf",
        syntax="proto3")
    tensor = fd.message_type.add(name="Tensor")
    enum = tensor.enum_type.add(name="Tensor_type")
    for i, name in enumerate(TYPES):
        enum.value.add(name=name, number=i)
    for name, num, typ, label, tname in (
            ("name", 1, F.TYPE_STRING, F.LABEL_OPTIONAL, None),
            ("type", 2, F.TYPE_ENUM, F.LABEL_OPTIONAL,
             ".nnstreamer.protobuf.Tensor.Tensor_type"),
            ("dimension", 3, F.TYPE_UINT32, F.LABEL_REPEATED, None),
            ("data", 4, F.TYPE_BYTES, F.LABEL_OPTIONAL, None)):
        field = tensor.field.add(name=name, number=num, type=typ,
                                 label=label)
        if tname:
            field.type_name = tname
    tensors = fd.message_type.add(name="Tensors")
    fr = tensors.nested_type.add(name="frame_rate")
    fr.field.add(name="rate_n", number=1, type=F.TYPE_INT32,
                 label=F.LABEL_OPTIONAL)
    fr.field.add(name="rate_d", number=2, type=F.TYPE_INT32,
                 label=F.LABEL_OPTIONAL)
    fmt = tensors.enum_type.add(name="Tensor_format")
    for i, name in enumerate(["NNS_TENSOR_FORMAT_STATIC",
                              "NNS_TENSOR_FORMAT_FLEXIBLE",
                              "NNS_TENSOR_FORMAT_SPARSE"]):
        fmt.value.add(name=name, number=i)
    for name, num, typ, label, tname in (
            ("num_tensor", 1, F.TYPE_UINT32, F.LABEL_OPTIONAL, None),
            ("fr", 2, F.TYPE_MESSAGE, F.LABEL_OPTIONAL,
             ".nnstreamer.protobuf.Tensors.frame_rate"),
            ("tensor", 3, F.TYPE_MESSAGE, F.LABEL_REPEATED,
             ".nnstreamer.protobuf.Tensor"),
            ("format", 4, F.TYPE_ENUM, F.LABEL_OPTIONAL,
             ".nnstreamer.protobuf.Tensors.Tensor_format")):
        field = tensors.field.add(name=name, number=num, type=typ,
                                  label=label)
        if tname:
            field.type_name = tname
    pool = descriptor_pool.DescriptorPool()
    pool.Add(fd)
    get = getattr(message_factory, "GetMessageClass", None)
    if get is None:
        pytest.skip("protobuf runtime without GetMessageClass")
    return {"Tensors": get(pool.FindMessageTypeByName(
        "nnstreamer.protobuf.Tensors"))}


class TestWireOracle:
    def test_port_encode_parses_with_protobuf(self, pb):
        from nnstreamer_tpu_torch.decoders.serialize import \
            encode_tensors_proto

        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        blob = encode_tensors_proto(PortBuffer(tensors=[arr]),
                                    rate=Fraction(30, 1))
        msg = pb["Tensors"]()
        msg.ParseFromString(blob)
        assert msg.num_tensor == 1
        assert (msg.fr.rate_n, msg.fr.rate_d) == (30, 1)
        t = msg.tensor[0]
        assert t.type == TYPES.index("NNS_FLOAT32")
        assert list(t.dimension) == [4, 3]          # innermost first
        assert t.data == arr.tobytes()

    def test_protobuf_encode_decodes_with_port_codec(self, pb):
        from nnstreamer_tpu_torch.decoders.serialize import \
            decode_tensors_proto

        arr = np.arange(8, dtype=np.uint8).reshape(2, 4)
        msg = pb["Tensors"](num_tensor=1)
        msg.fr.rate_n, msg.fr.rate_d = 0, 1
        t = msg.tensor.add()
        t.type = TYPES.index("NNS_UINT8")
        t.dimension.extend([4, 2])            # packed, as the C++ runtime
        t.data = arr.tobytes()
        (got,) = decode_tensors_proto(msg.SerializeToString())
        assert got.dtype == np.uint8 and got.tobytes() == arr.tobytes()
        assert got.shape == (2, 4)


CHILD_SENDER = r"""
import sys
import numpy as np
from {root} import parse_launch
from {root}.tensor.buffer import TensorBuffer

port = int(sys.argv[1])
caps = ("other/tensors,format=static,num_tensors=1,dimensions=4:3,"
        "types=float32,framerate=30/1")
p = parse_launch(f"appsrc caps={{caps}} name=in ! "
                 f"tensor_sink_grpc server=false host=127.0.0.1 port={{port}}")
p.play()
rng = np.random.default_rng(99)
for _ in range(3):
    p.get("in").push_buffer(TensorBuffer(
        tensors=[rng.standard_normal((3, 4)).astype(np.float32)]))
p.get("in").end_of_stream()
p.wait(timeout=30)
p.stop()
"""


@pytest.mark.parametrize("sender,receiver", [("torch", "jax"),
                                             ("jax", "torch")])
def test_two_process_round_trip(sender, receiver):
    """The receiver here, the other package's sender in a child process."""
    rx = PARSE[receiver](
        "tensor_src_grpc server=true port=0 num-buffers=3 name=rx ! "
        "tensor_sink name=out")
    got = _collect(rx)
    rx.play()
    try:
        root = "nnstreamer_tpu_torch" if sender == "torch" else \
            "nnstreamer_tpu"
        proc = subprocess.run(
            [sys.executable, "-c", CHILD_SENDER.format(root=root),
             str(rx.get("rx").port)], capture_output=True, text=True,
            timeout=120, cwd=ROOT, env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert proc.returncode == 0, proc.stderr[-2000:]
        rx.wait(timeout=30)
    finally:
        rx.stop()
    _assert_frames(got, _frames(3, seed=99))
