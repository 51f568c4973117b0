"""Media and file ingest on both packages: the media decoders
(``utils/mediadec.py``, ``pngdec``/``pnmdec``/``wavparse``), the sources
``audiotestsrc``/``filesrc``/``multifilesrc`` and sinks
``filesink``/``multifilesink``, ``tensor_converter``'s audio, text,
octet-stream and flexible media, the converter subplugins
(``converters/``: flatbuf, flexbuf, protobuf, python3; ``mode=custom-code:``
and the ``sub-plugins`` property) and ``tensor_src_iio`` over simulated
sysfs trees.

Each case runs the same launch string, or the same function on the same
seeded inputs, through the JAX package and through the port, and compares
the outputs (dtype, shape, bytes), pts, durations, caps and errors
exactly.  The cases mirror ``tests/test_mediadec.py``,
``tests/test_iio_buffer.py``, ``tests/test_serialize_iio.py`` and the
file cases of ``tests/test_elements.py``; the simulated IIO trees are the
same, built in ``tmp_path``.
"""

import importlib
import io
import logging
import os
import struct
import types
import wave

import numpy as np
import pytest

PIL_Image = pytest.importorskip("PIL.Image")


def _namespace(root: str):
    def mod(name):
        return importlib.import_module(f"{root}.{name}")

    graph = mod("pipeline.graph")
    return types.SimpleNamespace(
        root=root, parse_launch=mod("pipeline").parse_launch,
        Pipeline=graph.Pipeline, AppSrc=graph.AppSrc,
        PipelineError=graph.PipelineError,
        TB=mod("tensor.buffer").TensorBuffer, el=mod("elements"),
        mediadec=mod("utils.mediadec"), srciio=mod("elements.srciio"),
        converters=mod("converters"), serialize=mod("decoders.serialize"),
        tflat=mod("utils.tensor_flatbuf"), src=mod("elements.src"),
        sink=mod("elements.sink"), logger=root)


JAX = _namespace("nnstreamer_tpu")
PORT = _namespace("nnstreamer_tpu_torch")


def caps(dims, types_, n=1, rate="30/1"):
    return (f"other/tensors,format=static,num_tensors={n},"
            f"dimensions={dims},types={types_},framerate={rate}")


def sig(x):
    if hasattr(x, "tensors") and hasattr(x, "pts"):
        return ("buf", x.pts, x.duration,
                [sig(x.np(i)) for i in range(x.num_tensors)])
    if isinstance(x, (list, tuple)):
        return [sig(v) for v in x]
    if isinstance(x, np.ndarray) or isinstance(x, np.generic):
        a = np.ascontiguousarray(x)
        return ("a", a.dtype.str, a.shape, a.tobytes())
    return x


def run_record(ns, launch, sinks=("out",), timeout=30):
    p = ns.parse_launch(launch)
    p.run(timeout=timeout)
    return {k: {"caps": str(p.get(k).caps), "bufs": sig(p.get(k).results)}
            for k in sinks}


def both(case, *args):
    got, want = case(PORT, *args), case(JAX, *args)
    assert got == want
    return got


def per_package(tmp_path, ns):
    d = tmp_path / ns.root
    d.mkdir(exist_ok=True)
    return d


# -- utils/mediadec.py -------------------------------------------------------

def _png_bytes(arr, mode):
    buf = io.BytesIO()
    PIL_Image.fromarray(arr.squeeze() if mode == "L" else arr,
                        mode).save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("shape,mode", [((13, 7, 3), "RGB"),
                                        ((8, 9, 1), "L"),
                                        ((6, 5, 4), "RGBA"),
                                        ((5, 11, 2), "LA")])
@pytest.mark.parametrize("seed", [0, 1])
def test_png_decode_equal_jax(shape, mode, seed):
    arr = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    data = _png_bytes(arr, mode)
    got = PORT.mediadec.decode_png(data)
    assert sig(got) == sig(JAX.mediadec.decode_png(data))
    np.testing.assert_array_equal(got, arr[..., :3] if mode == "RGBA"
                                  else arr[..., :1] if mode == "LA"
                                  else arr)


def test_png_palette_equal_jax():
    arr = np.random.default_rng(2).integers(0, 256, (9, 4, 3), np.uint8)
    buf = io.BytesIO()
    PIL_Image.fromarray(arr).convert("P").save(buf, "PNG")
    assert sig(PORT.mediadec.decode_png(buf.getvalue())) == \
        sig(JAX.mediadec.decode_png(buf.getvalue()))


@pytest.mark.parametrize("data,fn", [(b"not a png", "decode_png"),
                                     (b"P3\n1 1\n255\n", "decode_pnm"),
                                     (b"RIFF0000WAVX", "parse_wav")])
def test_decoders_reject_equal_jax(data, fn):
    with pytest.raises(ValueError) as want:
        getattr(JAX.mediadec, fn)(data)
    with pytest.raises(ValueError) as got:
        getattr(PORT.mediadec, fn)(data)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("magic,ch", [(b"P6", 3), (b"P5", 1)])
def test_pnm_equal_jax(magic, ch):
    arr = np.random.default_rng(3).integers(0, 256, (4, 6, ch), np.uint8)
    data = magic + b"\n# comment\n6 4\n255\n" + arr.tobytes()
    got = PORT.mediadec.decode_pnm(data)
    assert sig(got) == sig(JAX.mediadec.decode_pnm(data))
    np.testing.assert_array_equal(got, arr)
    assert PORT.mediadec.pnm_length(data + b"tail") == len(data)
    assert PORT.mediadec.pnm_length(data[:-1]) is None


def _wav_bytes(fmt, bits, channels, rate, body):
    hdr = b"RIFF" + struct.pack("<I", 36 + len(body)) + b"WAVE"
    block = channels * bits // 8
    fmt_chunk = b"fmt " + struct.pack("<IHHIIHH", 16, fmt, channels, rate,
                                      rate * block, block, bits)
    return hdr + fmt_chunk + b"data" + struct.pack("<I", len(body)) + body


WAVS = {
    "f32": (3, 32, 1, 8000, np.linspace(-1, 1, 32, dtype=np.float32)),
    "s16x2": (1, 16, 2, 16000, np.random.default_rng(4).integers(
        -2000, 2000, 64).astype(np.int16)),
    "u8": (1, 8, 1, 8000, np.arange(40, dtype=np.uint8)),
    "s32": (1, 32, 1, 22050, np.random.default_rng(5).integers(
        -10**6, 10**6, 16).astype(np.int32)),
}


@pytest.mark.parametrize("name", sorted(WAVS))
def test_wav_equal_jax(name):
    fmt, bits, ch, rate, pcm = WAVS[name]
    data = _wav_bytes(fmt, bits, ch, rate, pcm.tobytes())
    got, grate = PORT.mediadec.parse_wav(data)
    want, wrate = JAX.mediadec.parse_wav(data)
    assert (sig(got), grate) == (sig(want), wrate) and grate == rate
    np.testing.assert_array_equal(got.ravel(), pcm)


def test_wav_stdlib_writer_equal_jax():
    pcm = np.random.default_rng(6).integers(-300, 300, 200).astype(np.int16)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    got, _ = PORT.mediadec.parse_wav(buf.getvalue())
    assert sig(got) == sig(JAX.mediadec.parse_wav(buf.getvalue())[0])


# -- pngdec / pnmdec / wavparse in pipelines ---------------------------------

def _write_images(d, n, seed=0, size=(8, 6)):
    rng = np.random.default_rng(seed)
    imgs = [rng.integers(0, 256, size + (3,), dtype=np.uint8)
            for _ in range(n)]
    for i, im in enumerate(imgs):
        (d / f"f_{i:03d}.png").write_bytes(_png_bytes(im, "RGB"))
        (d / f"f_{i:03d}.ppm").write_bytes(
            f"P6\n{size[1]} {size[0]}\n255\n".encode() + im.tobytes())
    return imgs


def _one_image(ns, tmp_path, ext, dec, blocksize):
    d = per_package(tmp_path, ns)
    _write_images(d, 1, seed=8)
    return run_record(ns, f"filesrc location={d}/f_000.{ext} "
                      f"blocksize={blocksize} ! {dec} ! tensor_converter ! "
                      "tensor_sink name=out")


@pytest.mark.parametrize("ext,dec", [("png", "pngdec"), ("ppm", "pnmdec")])
@pytest.mark.parametrize("blocksize", [-1, 7, 4096])
def test_image_file_string_equal_jax(tmp_path, ext, dec, blocksize):
    rec = both(_one_image, tmp_path, ext, dec, blocksize)
    assert len(rec["out"]["bufs"]) == 1


def test_gray_png_string_equal_jax(tmp_path):
    def case(ns):
        d = per_package(tmp_path, ns)
        arr = np.random.default_rng(1).integers(0, 256, (5, 7, 1), np.uint8)
        (d / "g.png").write_bytes(_png_bytes(arr, "L"))
        return run_record(ns, f"filesrc location={d}/g.png ! pngdec ! "
                          "tensor_converter ! tensor_sink name=out")

    rec = both(case)
    assert "dimensions=1:7:5" in rec["out"]["caps"]


@pytest.mark.parametrize("ext,dec", [("png", "pngdec"), ("ppm", "pnmdec")])
def test_multifile_images_decode_each_image(tmp_path, ext, dec):
    """A multifilesrc stream carries an image a file: the port decodes
    each (the reference's decoders do), where the JAX package decodes
    once at EOS and gives one frame, the first (ROADMAP §C)."""
    recs = {}
    for ns in (PORT, JAX):
        d = per_package(tmp_path, ns)
        imgs = _write_images(d, 4, seed=9)
        recs[ns.root] = run_record(
            ns, f"multifilesrc location={d}/f_%03d.{ext} ! {dec} ! "
            "tensor_converter ! tensor_sink name=out")["out"]["bufs"]
    got, want = recs["nnstreamer_tpu_torch"], recs["nnstreamer_tpu"]
    assert [b[3] for b in got] == [[sig(im)] for im in imgs]
    assert got[:1] == want and len(want) == 1


def _wavparse(ns, tmp_path, fpt):
    d = per_package(tmp_path, ns)
    pcm = np.random.default_rng(7).integers(-500, 500, 3200).astype(np.int16)
    (d / "a.wav").write_bytes(_wav_bytes(1, 16, 1, 16000, pcm.tobytes()))
    return run_record(ns, f"filesrc location={d}/a.wav blocksize=-1 ! "
                      f"wavparse ! tensor_converter frames-per-tensor={fpt} "
                      "! tensor_sink name=out")


@pytest.mark.parametrize("fpt", [1, 1600, 1000])
def test_wavparse_string_equal_jax(tmp_path, fpt):
    both(_wavparse, tmp_path, fpt)


# -- audiotestsrc, filesrc, multifilesrc, filesink, multifilesink -------------

@pytest.mark.parametrize("fmt,channels,fpt", [
    ("S16LE", 1, 1), ("U8", 2, 1), ("F32LE", 1, 150), ("S16LE", 2, 300)])
def test_audiotestsrc_string_equal_jax(fmt, channels, fpt):
    both(lambda ns: run_record(
        ns, "audiotestsrc num-buffers=4 samplesperbuffer=100 freq=700 ! "
        f"audio/x-raw,format={fmt},channels={channels},rate=16000 ! "
        f"tensor_converter frames-per-tensor={fpt} ! tensor_sink name=out"))


def _filesrc(ns, tmp_path, blocksize, dim, payload):
    d = per_package(tmp_path, ns)
    (d / "blob.bin").write_bytes(payload)
    return run_record(
        ns, f"filesrc location={d}/blob.bin blocksize={blocksize} ! "
        "application/octet-stream ! "
        f"tensor_converter input-dim={dim} input-type=uint8 ! "
        "tensor_sink name=out")


@pytest.mark.parametrize("blocksize,dim,payload", [
    (-1, "1024", bytes(range(256)) * 4), (256, "256", bytes(1024)),
    (100, "48", bytes(range(200)) * 2), (64, "2:3:4", bytes(range(240)))])
def test_filesrc_string_equal_jax(tmp_path, blocksize, dim, payload):
    both(_filesrc, tmp_path, blocksize, dim, payload)


def test_filesrc_errors_equal_jax(tmp_path):
    def case(ns):
        p = ns.parse_launch(f"filesrc location={tmp_path}/nope ! "
                            "application/octet-stream ! tensor_converter "
                            "input-dim=4 input-type=uint8 ! fakesink")
        with pytest.raises(Exception, match="no such file"):
            p.run(timeout=30)
        (tmp_path / "b.bin").write_bytes(bytes(16))
        ns.parse_launch(f"filesrc location={tmp_path}/b.bin blocksize=-1 "
                        "! fakesink").run(timeout=30)
        return True

    both(case)


def _multifile_round_trip(ns, tmp_path, stop):
    d = per_package(tmp_path, ns)
    ns.parse_launch(
        "videotestsrc num-buffers=3 pattern=13 ! "
        "video/x-raw,format=RGB,width=4,height=4,framerate=30/1 ! "
        "tensor_converter ! "
        f"multifilesink async=false location={d}/result_%1d.log"
    ).run(timeout=30)
    files = sorted(os.listdir(d))
    rec = run_record(ns, (
        f"multifilesrc location={d}/result_%1d.log start-index=0 "
        f"stop-index={stop} caps=application/octet-stream ! "
        "tensor_converter input-dim=3:4:4 input-type=uint8 ! "
        "tensor_sink name=o"), sinks=("o",))
    return files, rec


@pytest.mark.parametrize("stop", [2, -1, 1])
def test_multifile_round_trip_equal_jax(tmp_path, stop):
    files, rec = both(_multifile_round_trip, tmp_path, stop)
    assert files == ["result_0.log", "result_1.log", "result_2.log"]
    assert rec["o"]["bufs"]


def test_multifile_bad_pattern_equal_jax(tmp_path):
    def case(ns):
        out = []
        for cls in (ns.sink.MultiFileSink, ns.src.MultiFileSrc):
            with pytest.raises(ValueError, match="index directive") as e:
                cls("m", location=str(tmp_path / "flat.log")).start()
            out.append(str(e.value))
        return out

    both(case)


def _filesink(ns, tmp_path):
    d = per_package(tmp_path, ns)
    ns.parse_launch(
        "videotestsrc num-buffers=3 pattern=random ! "
        "video/x-raw,format=RGB,width=5,height=3,framerate=30/1 ! "
        "tensor_converter ! tensor_transform mode=typecast option=float32 "
        f"! filesink location={d}/out.raw").run(timeout=30)
    return (d / "out.raw").read_bytes()


def test_filesink_bytes_equal_jax(tmp_path):
    data = both(_filesink, tmp_path)
    assert len(data) == 3 * 5 * 3 * 3 * 4


def test_filesink_writes_device_tensors(tmp_path):
    import torch

    p = PORT.parse_launch(f"appsrc name=s caps={caps('3', 'float32')} ! "
                          f"filesink location={tmp_path}/t.raw")
    p.play()
    p.get("s").push_buffer(PORT.TB(tensors=[torch.arange(3.)]))
    p.get("s").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    assert (tmp_path / "t.raw").read_bytes() == \
        np.arange(3, dtype=np.float32).tobytes()


# -- tensor_converter: audio, text, octet, flexible ---------------------------

def _appsrc_convert(ns, src_caps, props, chunks):
    p = ns.parse_launch(f"appsrc name=s caps={src_caps} ! tensor_converter "
                        f"{props} ! tensor_sink name=out")
    p.play()
    try:
        for arr, pts in chunks:
            p.get("s").push_buffer(ns.TB(tensors=[arr], pts=pts))
        p.get("s").end_of_stream()
        p.wait(timeout=30)
    finally:
        p.stop()      # a failed stream must not stay registered in /healthz
    return {"caps": str(p.get("out").caps), "bufs": sig(p.get("out").results)}


AUDIO = "audio/x-raw,format={fmt},channels={ch},rate=16000"


@pytest.mark.parametrize("fmt,dtype,ch,fpt,sizes", [
    ("S16LE", np.int16, 1, 1, (100, 100, 100)),
    ("S16LE", np.int16, 2, 1, (50, 30, 90, 10)),
    ("F32LE", np.float32, 1, 64, (100, 37, 91)),
    ("U8", np.uint8, 1, 40, (17, 200, 3)),
    ("S32LE", np.int32, 2, 25, (60, 60))])
def test_converter_audio_equal_jax(fmt, dtype, ch, fpt, sizes):
    rng = np.random.default_rng(10)
    chunks, pts = [], 0
    for n in sizes:
        chunks.append(((rng.random((n, ch)) * 100).astype(dtype),
                       pts if len(chunks) % 2 == 0 else None))
        pts += n * 62_500
    both(_appsrc_convert, AUDIO.format(fmt=fmt, ch=ch),
         f"frames-per-tensor={fpt}", chunks)


@pytest.mark.parametrize("props,texts", [
    ("", [b"hello", b"a much longer line of text " * 20]),
    ("input-dim=8", [b"abc", b"0123456789abc"]),
    ("input-dim=4 frames-per-tensor=3", [b"ab", b"cdef", b"ghijk", b"l"])])
def test_converter_text_equal_jax(props, texts):
    both(_appsrc_convert, "text/x-raw,format=utf8", props,
         [(np.frombuffer(t, np.uint8), i * 10) for i, t in enumerate(texts)])


@pytest.mark.parametrize("props,sizes", [
    ("input-dim=4 input-type=float32", (16, 32, 8, 8)),
    ("input-dim=2:3 input-type=int16", (5, 19, 12)),
    ("input-dim=6 input-type=uint8 frames-per-tensor=2", (12, 24)),
    ("input-dim=4 input-type=uint8 set-timestamp=false", (4, 8))])
def test_converter_octet_equal_jax(props, sizes):
    rng = np.random.default_rng(11)
    both(_appsrc_convert, "application/octet-stream,framerate=10/1", props,
         [(rng.integers(0, 256, n, dtype=np.uint8), i * 10**8)
          for i, n in enumerate(sizes)])


def test_converter_octet_needs_dims_equal_jax():
    def case(ns):
        with pytest.raises(Exception, match="input-dim") as e:
            _appsrc_convert(ns, "application/octet-stream", "",
                            [(np.zeros(4, np.uint8), 0)])
        return type(e.value).__name__

    both(case)


def test_converter_flexible_equal_jax():
    def case(ns):
        meta = importlib.import_module(f"{ns.root}.tensor.meta")
        info = importlib.import_module(f"{ns.root}.tensor.info")
        p = ns.parse_launch("appsrc name=s caps=other/tensors,format="
                            "flexible,framerate=0/1 ! tensor_converter ! "
                            "tensor_sink name=out")
        p.play()
        for i in range(2):
            arr = np.full((2, 3), i, np.float32)
            b = ns.TB(tensors=[arr], pts=i)
            b.metas = [meta.TensorMetaInfo.from_info(
                info.TensorInfo.from_np(arr))]
            p.get("s").push_buffer(b)
        p.get("s").end_of_stream()
        p.wait(timeout=30)
        p.stop()
        return str(p.get("out").caps), sig(p.get("out").results)

    both(case)


# -- converter subplugins -------------------------------------------------------

def test_converter_registry_equal_jax():
    assert PORT.converters.list_converters() == \
        JAX.converters.list_converters()
    c = PORT.el.TensorConverter("c")
    assert c.get_property("sub-plugins") == \
        JAX.el.TensorConverter("c").get_property("sub-plugins") == \
        "flatbuf,flexbuf,protobuf,python3"
    with pytest.raises(KeyError, match="unknown converter"):
        PORT.converters.find_converter("nope")


ROUND_TRIP = {
    "protobuf": ("4", "float32", [np.array([1, 2, 3, 4], np.float32)]),
    "flexbuf": ("3:2", "float32",
                [np.arange(6, dtype=np.float32).reshape(2, 3)]),
    "flatbuf": ("3:2", "float32",
                [np.arange(6, dtype=np.float32).reshape(2, 3)]),
}


def _codec_loop(ns, mode):
    """decoder mode=<m> → tensor_converter mode=custom-code:<m>, through a
    launch string (the reference's decoder/converter pairs)."""
    dims, types_, tensors = ROUND_TRIP[mode]
    p = ns.parse_launch(
        f"appsrc name=s caps={caps(dims, types_)} ! tensor_decoder "
        f"mode={mode} ! tensor_converter mode=custom-code:{mode} ! "
        "tensor_sink name=out")
    p.play()
    for i in range(2):
        p.get("s").push_buffer(ns.TB(tensors=[t + i for t in tensors],
                                     pts=i * 7))
    p.get("s").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    conv = ns.converters.find_converter(mode)
    blob = {"protobuf": lambda: ns.serialize.encode_tensors_proto(
                ns.TB(tensors=tensors)),
            "flatbuf": lambda: ns.tflat.encode_tensors(tensors),
            "flexbuf": None}[mode]
    direct = None
    if blob is not None:
        direct = sig(conv.convert(ns.TB(tensors=[np.frombuffer(
            blob(), np.uint8)])).np(0))
    return str(p.get("out").caps), sig(p.get("out").results), direct


@pytest.mark.parametrize("mode", sorted(ROUND_TRIP))
def test_converter_subplugin_loop_equal_jax(mode):
    _, bufs, _ = both(_codec_loop, mode)
    dims, types_, tensors = ROUND_TRIP[mode]
    assert bufs[0][3] == [sig(t) for t in tensors]


def _python_converter(ns, tmp_path):
    d = per_package(tmp_path, ns)
    script = d / "conv.py"
    script.write_text(
        "import numpy as np\n"
        "import nnstreamer_python as nns\n"
        "class CustomConverter:\n"
        "    def convert(self, input_array):\n"
        "        a = np.asarray(input_array[0]).astype(np.float32) * 2\n"
        "        shape = nns.TensorShape([len(a), 1], np.float32)\n"
        "        return ([shape], [a.view(np.uint8)], 15, 1)\n")
    p = ns.parse_launch(
        "appsrc name=s caps=application/octet-stream,framerate=0/1 ! "
        f"tensor_converter mode=custom-script:{script} ! "
        "tensor_sink name=out")
    p.play()
    p.get("s").push_buffer(ns.TB(tensors=[np.arange(3, dtype=np.uint8)],
                                 pts=5))
    p.get("s").end_of_stream()
    p.wait(timeout=30)
    p.stop()
    return sig(p.get("out").results)


@pytest.fixture
def own_shim():
    """Each package's script imports ``nnstreamer_python`` as that
    package's shim (the first ``install()`` of a process wins): drop the
    entry around each run and put back what was there."""
    import sys

    saved = sys.modules.pop("nnstreamer_python", None)

    def fresh():
        sys.modules.pop("nnstreamer_python", None)

    yield fresh
    sys.modules.pop("nnstreamer_python", None)
    if saved is not None:
        sys.modules["nnstreamer_python"] = saved


def test_python_converter_equal_jax(tmp_path, own_shim):
    def case(ns, path):
        own_shim()
        return _python_converter(ns, path)

    bufs = both(case, tmp_path)
    assert bufs[0][3][0][3] == np.array([0, 2, 4], np.float32).tobytes()


# -- tensor_src_iio ---------------------------------------------------------------

@pytest.mark.parametrize("spec", ["le:s12/16>>4", "be:u10/16>>0",
                                  "le:s32/32", "le:u8/8"])
def test_iio_type_spec_equal_jax(spec):
    assert PORT.srciio.parse_type_spec(spec) == \
        JAX.srciio.parse_type_spec(spec)


@pytest.mark.parametrize("bad", ["xx:s12/16", "le:q12/16", "le:s12/12",
                                 "le:s33/32"])
def test_iio_type_spec_rejects_equal_jax(bad):
    with pytest.raises(ValueError) as want:
        JAX.srciio.parse_type_spec(bad)
    with pytest.raises(ValueError) as got:
        PORT.srciio.parse_type_spec(bad)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec,word", [("le:s12/16>>4", 0xFFF0),
                                       ("le:s12/16>>4", 0x0010),
                                       ("le:u12/16>>4", 0xFFF0),
                                       ("be:s16/16", 0x8001)])
def test_iio_extract_sample_equal_jax(spec, word):
    assert PORT.srciio.extract_sample(
        word, PORT.srciio.parse_type_spec(spec)) == \
        JAX.srciio.extract_sample(word, JAX.srciio.parse_type_spec(spec))


def buffered_tree(root):
    """The simulated sysfs + chardev of ``tests/test_iio_buffer.py``: 2
    channels (s12/16>>4 le, u8/8), 4 samples, 3 bytes a frame."""
    sys_root = root / "sys"
    dev = sys_root / "iio:device0"
    se = dev / "scan_elements"
    se.mkdir(parents=True)
    (dev / "name").write_text("buf-accel\n")
    (dev / "in_voltage0_scale").write_text("0.5\n")
    (dev / "in_voltage0_offset").write_text("1\n")
    (dev / "in_voltage1_scale").write_text("2.0\n")
    (se / "in_voltage0_type").write_text("le:s12/16>>4\n")
    (se / "in_voltage0_index").write_text("0\n")
    (se / "in_voltage0_en").write_text("0\n")
    (se / "in_voltage1_type").write_text("le:u8/8\n")
    (se / "in_voltage1_index").write_text("1\n")
    (se / "in_voltage1_en").write_text("0\n")
    (dev / "buffer").mkdir()
    (dev / "buffer" / "enable").write_text("0\n")
    (dev / "buffer" / "length").write_text("0\n")
    (dev / "trigger").mkdir()
    (dev / "trigger" / "current_trigger").write_text("\n")
    dev_root = root / "devfs"
    dev_root.mkdir()
    frames = b""
    for v0, v1 in [(-1, 0), (1, 1), (100, 2), (-100, 3)]:
        frames += struct.pack("<H", (v0 << 4) & 0xFFFF) + struct.pack("B", v1)
    (dev_root / "iio:device0").write_bytes(frames)
    return sys_root, dev_root


def _iio_buffered(ns, tmp_path, props):
    sys_root, dev_root = buffered_tree(per_package(tmp_path, ns))
    rec = run_record(ns, (
        f"tensor_src_iio device=buf-accel base-dir={sys_root} "
        f"dev-dir={dev_root} mode=buffer {props} ! tensor_sink name=out"))
    dev = sys_root / "iio:device0"
    controls = [(dev / f).read_text().strip() for f in (
        "scan_elements/in_voltage0_en", "scan_elements/in_voltage1_en",
        "trigger/current_trigger", "buffer/length", "buffer/enable")]
    return rec, controls


@pytest.mark.parametrize("props", [
    "trigger=trig0 buffer-capacity=2 frequency=100",
    "trigger=trig0 buffer-capacity=4",
    "buffer-capacity=2 merge-channels=false",
    "buffer-capacity=1 frequency=50", "buffer-capacity=3"])
def test_iio_buffered_equal_jax(tmp_path, props):
    rec, controls = both(_iio_buffered, tmp_path, props)
    assert controls[4] == "0"


def test_iio_buffered_values():
    """The decoded values of the buffered tree, as the JAX test states
    them: ch0 (raw + 1) * 0.5, ch1 raw * 2."""
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        rec, _ = _iio_buffered(PORT, Path(tmp),
                               "buffer-capacity=2 frequency=100")
    a = np.frombuffer(rec["out"]["bufs"][1][3][0][3], np.float32)
    np.testing.assert_allclose(a.reshape(2, 2), [[50.5, 4.0], [-49.5, 6.0]])


def _iio_big_endian(ns, tmp_path):
    root = per_package(tmp_path, ns)
    sys_root = root / "sys"
    dev = sys_root / "iio:device0"
    se = dev / "scan_elements"
    se.mkdir(parents=True)
    (dev / "name").write_text("be-dev\n")
    (se / "in_temp0_type").write_text("be:s16/16\n")
    (se / "in_temp0_index").write_text("0\n")
    (se / "in_temp0_en").write_text("0\n")
    dev_root = root / "devfs"
    dev_root.mkdir()
    (dev_root / "iio:device0").write_bytes(struct.pack(">hh", -300, 500))
    return run_record(ns, (
        f"tensor_src_iio device=be-dev base-dir={sys_root} "
        f"dev-dir={dev_root} mode=buffer buffer-capacity=1 "
        "! tensor_sink name=out"))


def test_iio_big_endian_equal_jax(tmp_path):
    rec = both(_iio_big_endian, tmp_path)
    assert len(rec["out"]["bufs"]) == 2


def fake_iio_tree(root):
    dev = root / "iio:device0"
    dev.mkdir(parents=True)
    (dev / "name").write_text("test-accel\n")
    for i, val in enumerate([100, -50, 25]):
        (dev / f"in_accel{i}_raw").write_text(f"{val}\n")
        (dev / f"in_accel{i}_scale").write_text("0.5\n")
        (dev / f"in_accel{i}_offset").write_text("10\n")
    return root


def _iio_poll(ns, tmp_path, props):
    root = fake_iio_tree(per_package(tmp_path, ns))
    return run_record(ns, f"tensor_src_iio device=test-accel base-dir={root} "
                      f"frequency=1000 {props} ! tensor_sink name=out")


@pytest.mark.parametrize("props", ["num-buffers=3",
                                   "num-buffers=2 merge-channels=false",
                                   "num-buffers=1 device-number=0"])
def test_iio_poll_equal_jax(tmp_path, props):
    rec = both(_iio_poll, tmp_path, props)
    assert rec["out"]["bufs"]


def test_iio_malformed_scale_warns_equal_jax(tmp_path):
    def case(ns):
        root = fake_iio_tree(per_package(tmp_path, ns))
        (root / "iio:device0" / "in_accel0_scale").write_text("garbage\n")
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        log = logging.getLogger(ns.logger)
        log.addHandler(handler)
        try:
            rec = run_record(ns, f"tensor_src_iio device=test-accel "
                             f"base-dir={root} frequency=100 num-buffers=1 "
                             "! tensor_sink name=out")
        finally:
            log.removeHandler(handler)
        return rec, any("malformed sysfs float" in r.getMessage()
                        for r in records)

    rec, warned = both(case)
    assert warned


def test_iio_missing_device_equal_jax(tmp_path):
    def case(ns):
        root = fake_iio_tree(per_package(tmp_path, ns))
        p = ns.parse_launch(f"tensor_src_iio device=nope base-dir={root} "
                            "num-buffers=1 ! tensor_sink")
        with pytest.raises(ns.PipelineError) as e:
            p.run(timeout=5)
        return "not found" in str(e.value)

    assert both(case)
