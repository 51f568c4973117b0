"""The port's wire codecs and serialization decoders against the JAX
package's, on the CPU.

Nothing here is floating-point arithmetic, so the tolerance is byte
equality throughout:

- ``utils/tensor_flatbuf.encode_tensors`` (the ``nnstreamer.fbs`` tensor
  frames gRPC's ``idl=flatbuf`` sends) and ``decoders/serialize``'s
  ``encode_tensors_proto`` (``idl=protobuf``) give the same bytes in
  both packages for the same seeded arrays, a bf16 torch tensor of the
  port included; each package decodes the other's bytes;
- ``utils/protowire`` of both packages reads those frames into the same
  fields;
- the ``flexbuf``, ``flatbuf``, ``protobuf`` and ``python3`` decoders give
  the same frames through ``tensor_decoder`` pipelines of each package;
- the ``nnstreamer_python`` shim converts tensor infos alike;
- the trace-context trailer the shm ring and the MQTT header carry packs
  the same bytes, and each package reads the other's.
"""

from fractions import Fraction

import ml_dtypes
import numpy as np
import pytest
import torch

from nnstreamer_tpu import parse_launch as jax_parse_launch
from nnstreamer_tpu.decoders import serialize as jax_serialize
from nnstreamer_tpu.obs import span as jax_span
from nnstreamer_tpu.tensor.buffer import TensorBuffer as JaxBuffer
from nnstreamer_tpu.utils import nns_python_compat as jax_compat
from nnstreamer_tpu.utils import protowire as jax_protowire
from nnstreamer_tpu.utils import tensor_flatbuf as jax_flatbuf
from nnstreamer_tpu_torch import parse_launch as port_parse_launch
from nnstreamer_tpu_torch.decoders import serialize as port_serialize
from nnstreamer_tpu_torch.obs import span as port_span
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer as PortBuffer
from nnstreamer_tpu_torch.utils import nns_python_compat as port_compat
from nnstreamer_tpu_torch.utils import protowire as port_protowire
from nnstreamer_tpu_torch.utils import tensor_flatbuf as port_flatbuf

FLATBUF = {"jax": jax_flatbuf, "torch": port_flatbuf}
SERIALIZE = {"jax": jax_serialize, "torch": port_serialize}
PROTOWIRE = {"jax": jax_protowire, "torch": port_protowire}
BUFFER = {"jax": JaxBuffer, "torch": PortBuffer}
PARSE = {"jax": jax_parse_launch, "torch": port_parse_launch}
SPAN = {"jax": jax_span, "torch": port_span}
OTHER = {"jax": "torch", "torch": "jax"}


def _frames():
    """Seeded frames of every nnstreamer.fbs tensor type, several
    shapes, one to three tensors each."""
    rng = np.random.default_rng(17)
    ints = ["int32", "uint32", "int16", "uint16", "int8", "uint8", "int64",
            "uint64"]
    out = {}
    for name in ints:
        info = np.iinfo(name)
        out[name] = [rng.integers(max(info.min, -1000), min(info.max, 1000),
                                  (3, 5), dtype=name)]
    for name in ("float32", "float64"):
        out[name] = [rng.standard_normal((2, 3, 4)).astype(name)]
    out["frame"] = [rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)]
    out["logits"] = [rng.standard_normal(1001).astype(np.float32)]
    out["several"] = [rng.integers(0, 256, (4, 4, 3), dtype=np.uint8),
                      rng.standard_normal(7).astype(np.float32),
                      np.arange(6, dtype=np.int32).reshape(1, 2, 3)]
    return out


FRAMES = _frames()


def _buf(pkg, tensors, pts=None):
    return BUFFER[pkg](tensors=list(tensors), pts=pts)


class TestFlatbufParity:
    @pytest.mark.parametrize("rate", [None, Fraction(30, 1)],
                             ids=["no_rate", "30fps"])
    @pytest.mark.parametrize("name", sorted(FRAMES))
    def test_encode_bytes_equal(self, name, rate):
        arrays = FRAMES[name]
        names = [f"t{i}" for i in range(len(arrays))]
        assert port_flatbuf.encode_tensors(arrays, rate=rate, names=names) \
            == jax_flatbuf.encode_tensors(arrays, rate=rate, names=names)
        assert port_flatbuf.encode_tensors(arrays) == \
            jax_flatbuf.encode_tensors(arrays)

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    @pytest.mark.parametrize("name", sorted(FRAMES))
    def test_each_decodes_the_others(self, writer, name):
        arrays = FRAMES[name]
        blob = FLATBUF[writer].encode_tensors(
            arrays, rate=Fraction(15, 2), names=["a"] * len(arrays))
        got, rate, names = FLATBUF[OTHER[writer]].decode_tensors(blob)
        assert rate == Fraction(15, 2) and names == ["a"] * len(arrays)
        assert len(got) == len(arrays)
        for g, want in zip(got, arrays):
            assert g.dtype == want.dtype and g.shape == want.shape
            assert g.tobytes() == want.tobytes()

    def test_dtype_outside_the_schema_is_refused_alike(self):
        arr = np.zeros(3, np.float16)
        for fb in (jax_flatbuf, port_flatbuf):
            with pytest.raises(ValueError, match="Tensor_type"):
                fb.encode_tensors([arr])


class TestProtoParity:
    @pytest.mark.parametrize("rate", [None, Fraction(30, 1)],
                             ids=["no_rate", "30fps"])
    @pytest.mark.parametrize("name", sorted(FRAMES))
    def test_encode_bytes_equal(self, name, rate):
        arrays = FRAMES[name]
        assert port_serialize.encode_tensors_proto(
            _buf("torch", arrays), rate=rate) == \
            jax_serialize.encode_tensors_proto(_buf("jax", arrays), rate=rate)

    def test_card_payloads_encode_like_host_arrays(self):
        """A torch tensor in a port buffer (a filter's output) encodes as
        its host array does in the JAX package, bf16 included (type 11,
        the bytes of ``ml_dtypes.bfloat16``)."""
        rng = np.random.default_rng(3)
        f32 = rng.standard_normal((4, 6)).astype(np.float32)
        bf16 = torch.from_numpy(f32).to(torch.bfloat16)
        jax_bf16 = bf16.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        port = port_serialize.encode_tensors_proto(
            _buf("torch", [torch.from_numpy(f32), bf16]))
        jax = jax_serialize.encode_tensors_proto(_buf("jax",
                                                      [f32, jax_bf16]))
        assert port == jax
        back = jax_serialize.decode_tensors_proto(port)
        assert back[1].dtype == np.dtype(ml_dtypes.bfloat16)
        assert back[1].tobytes() == jax_bf16.tobytes()

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    @pytest.mark.parametrize("name", sorted(FRAMES))
    def test_each_decodes_the_others(self, writer, name):
        arrays = FRAMES[name]
        blob = SERIALIZE[writer].encode_tensors_proto(_buf(writer, arrays))
        got = SERIALIZE[OTHER[writer]].decode_tensors_proto(blob)
        assert len(got) == len(arrays)
        for g, want in zip(got, arrays):
            assert g.dtype == want.dtype and g.shape == want.shape
            assert g.tobytes() == want.tobytes()

    @pytest.mark.parametrize("name", sorted(FRAMES))
    def test_protowire_reads_the_same_fields(self, name):
        """Each package's protowire walks either package's frame into the
        same fields: num_tensor, framerate, and per tensor the type id,
        the dims (innermost first) and the data bytes."""
        arrays = FRAMES[name]
        blob = port_serialize.encode_tensors_proto(
            _buf("torch", arrays), rate=Fraction(30, 1))
        seen = []
        for pw in (jax_protowire, port_protowire):
            top = pw.fields_dict(blob)
            fr = pw.fields_dict(pw.first(top, 2))
            tensors = []
            for t in pw.repeated(top, 3):
                f = pw.fields_dict(t)
                tensors.append((pw.first(f, 2),
                                pw.packed_or_repeated_varints(f.get(3, [])),
                                bytes(pw.first(f, 4))))
            seen.append((pw.first(top, 1), pw.first(fr, 1),
                         pw.first(fr, 2), tensors))
        assert seen[0] == seen[1]
        n, rate_n, rate_d, tensors = seen[0]
        assert (n, rate_n, rate_d) == (len(arrays), 30, 1)
        for (_, dims, data), arr in zip(tensors, arrays):
            assert dims == list(reversed(arr.shape))
            assert data == arr.tobytes()

    def test_varint_and_zigzag_agree(self):
        rng = np.random.default_rng(9)
        for n in [0, 1, 127, 128, 300, 2**31, 2**63 - 1,
                  *rng.integers(0, 2**62, 20).tolist()]:
            blob = port_serialize._varint(int(n))
            assert blob == jax_serialize._varint(int(n))
            assert port_protowire.read_varint(blob, 0) == \
                jax_protowire.read_varint(blob, 0) == (n, len(blob))
            assert port_protowire.zigzag(int(n)) == \
                jax_protowire.zigzag(int(n))


# ---------------------------------------------------------------------------
# the serialization decoders through tensor_decoder
# ---------------------------------------------------------------------------

def _caps(arrays, rate="30/1"):
    dims = ".".join(":".join(str(d) for d in reversed(a.shape))
                    for a in arrays)
    types = ".".join(a.dtype.name for a in arrays)
    return (f"other/tensors,format=static,num_tensors={len(arrays)},"
            f"dimensions={dims},types={types},framerate={rate}")


def _decode(pkg, mode, frames, options=""):
    p = PARSE[pkg](f"appsrc name=src caps={_caps(frames[0])} ! "
                   f"tensor_decoder mode={mode} {options}! "
                   "tensor_sink name=out")
    p.play()
    try:
        src = p.get("src")
        for i, arrays in enumerate(frames):
            src.push_buffer(_buf(pkg, arrays, pts=i))
        src.end_of_stream()
        p.wait(timeout=60)
    finally:
        p.stop()
    return p.get("out").results


PY_DECODER = '''
import numpy as np


class CustomDecoder:
    def get_out_caps(self, config):
        return "other/tensors,format=static,num_tensors=1,dimensions=4," \\
               "types=float64,framerate=0/1"

    def decode(self, tensors, config):
        return np.array([t.astype(np.float64).sum() for t in tensors]
                        + [0.0] * (4 - len(tensors)))
'''

REF_PY_DECODER = '''
import nnstreamer_python as nns
import numpy as np


class CustomDecoder:
    def getOutCaps(self):
        return b"other/octet-stream"

    def decode(self, raw_data, in_info, rate_n, rate_d):
        dims = [list(s.getDims()) for s in in_info]
        head = np.array([rate_n, rate_d, len(raw_data)] + sum(dims, []),
                        np.int64)
        return head.tobytes() + b"".join(bytes(r) for r in raw_data)
'''


@pytest.mark.parametrize("name", ["frame", "several", "logits", "int16"])
@pytest.mark.parametrize("mode", ["flexbuf", "flatbuf", "protobuf"])
def test_decoders_give_the_same_frames(mode, name):
    frames = [FRAMES[name], [a[::-1].copy() for a in FRAMES[name]]]
    got = {pkg: _decode(pkg, mode, frames) for pkg in ("jax", "torch")}
    assert len(got["torch"]) == len(got["jax"]) == 2
    for a, b in zip(got["torch"], got["jax"]):
        assert a.num_tensors == b.num_tensors == 1
        assert a.pts == b.pts
        assert a.np(0).dtype == b.np(0).dtype == np.uint8
        assert a.np(0).tobytes() == b.np(0).tobytes()


@pytest.mark.parametrize("script", ["native", "reference"])
def test_python3_decoder_gives_the_same_frames(script, tmp_path):
    """A user's decoder script (the framework's own contract, and the
    reference's ``nnstreamer_python`` one) gives the same frames through
    both packages."""
    path = tmp_path / f"{script}_decoder.py"
    path.write_text(PY_DECODER if script == "native" else REF_PY_DECODER)
    frames = [FRAMES["several"], [a[::-1].copy() for a in
                                  FRAMES["several"]]]
    got = {pkg: _decode(pkg, "python3", frames, f"option1={path} ")
           for pkg in ("jax", "torch")}
    for a, b in zip(got["torch"], got["jax"]):
        assert a.np(0).dtype == b.np(0).dtype
        assert a.np(0).tobytes() == b.np(0).tobytes()
    assert len(got["torch"]) == len(got["jax"]) == 2


def test_decoder_modes_registered():
    from nnstreamer_tpu_torch.decoders import list_decoders

    assert {"flexbuf", "flatbuf", "protobuf", "python3"} <= \
        set(list_decoders())


class TestPythonShim:
    def test_tensor_infos_convert_alike(self):
        from nnstreamer_tpu.tensor.info import TensorInfo as JInfo
        from nnstreamer_tpu.tensor.info import TensorsInfo as JInfos
        from nnstreamer_tpu_torch.tensor.info import TensorInfo as TInfo
        from nnstreamer_tpu_torch.tensor.info import TensorsInfo as TInfos

        arrays = FRAMES["several"]
        port = port_compat.from_tensors_info(
            TInfos([TInfo.from_np(a) for a in arrays]))
        jax = jax_compat.from_tensors_info(
            JInfos([JInfo.from_np(a) for a in arrays]))
        assert [(s.getDims(), s.getType()) for s in port] == \
            [(s.getDims(), s.getType()) for s in jax]
        back = port_compat.to_tensors_info(port)
        assert [i.to_string() for i in back] == \
            [i.to_string() for i in jax_compat.to_tensors_info(jax)]

    def test_shape_is_live_and_rank_limited(self):
        s = port_compat.TensorShape(list(range(1, 12)), "float32")
        dims = s.getDims()
        dims[0] = 99
        assert s.getDims()[0] == 99 and len(dims) == 8
        assert s.getType() == np.float32


class TestTraceTrailer:
    CTX = (0x1234_5678_9ABC_DEF0 & 0x7FFFFFFFFFFFFFFF, 42, 1_700_000_000)

    def test_trailer_bytes_equal(self):
        port = port_span.pack_ctx_trailer(port_span.TraceContext(*self.CTX))
        jax = jax_span.pack_ctx_trailer(jax_span.TraceContext(*self.CTX))
        assert port == jax
        assert len(port) == port_span.TRAILER_SIZE == jax_span.TRAILER_SIZE

    @pytest.mark.parametrize("writer", ["jax", "torch"])
    def test_each_reads_the_others(self, writer):
        span = SPAN[writer]
        payload = b"tensor bytes" + span.pack_ctx_trailer(
            span.TraceContext(*self.CTX))
        ctx = SPAN[OTHER[writer]].unpack_ctx_trailer(payload)
        assert tuple(ctx) == self.CTX
        assert SPAN[OTHER[writer]].unpack_ctx_trailer(b"no trailer " * 4) \
            is None
