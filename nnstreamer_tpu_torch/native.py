"""ctypes binding of the repository's native tensorwire library: the
CRC-32C of the query wire (``query/protocol.py``), the shared-memory
ring (``query/shm.py``, which binds the ``tw_shm_*`` entry points), the
sparse codec's gather/scatter (``elements/sparse.py``) and the dataset
reader (:class:`RepoReader`, ``datareposrc``).

The port's own counterpart of ``nnstreamer_tpu/native.py``: it compiles
``native/tensorwire/tensorwire.cc``, ``reader.cc`` and ``shmring.cc``
(the repository-level sources) with ``g++`` into
``nnstreamer_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the sources and flags, and loads it with ``ctypes``.
The sparse codec and the reader keep the JAX module's numpy fallbacks,
which give the same bytes.  It links
``-lpthread -lrt`` as ``native/Makefile`` does: ``shm_open`` and
``shm_unlink`` live in librt on glibc < 2.34, where a library linked
without it fails to load and every ring would take the Python fallback.
The JAX package's ``native/libnnstw.so`` stays that package's.

The contract is the JAX module's: the first request starts the build on a
background thread and :func:`crc32c_fn` answers None until the library
loads (the wire then carries CRC 0, "unchecked", and receivers verify
only nonzero values; a ring opened meanwhile takes the Python fallback);
:func:`available` waits for the build.  Nothing is built when the module
is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(os.path.dirname(_HERE), "native", "tensorwire")
SOURCES = tuple(os.path.join(_SRC_DIR, name)
                for name in ("tensorwire.cc", "reader.cc", "shmring.cc"))
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")
#: after the sources: librt holds shm_open on glibc < 2.34
LINK_FLAGS = ("-lpthread", "-lrt")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: True once loading was decided (loaded, or the build failed)
_tried = False
_building: Optional[threading.Thread] = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    for source in SOURCES:
        with open(source, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libnnstw-{digest.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    """Compile to a process-unique name, then rename into place: a
    concurrent builder never sees a half-written library."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *SOURCES,
                        *LINK_FLAGS], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, path)
    except (subprocess.SubprocessError, OSError):
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None while its background build runs (or
    when it cannot be built)."""
    global _lib, _tried, _building
    with _lock:
        if _lib is not None or _tried:
            return _lib
        try:
            path = library_path()
        except OSError:             # the sources are not beside the package
            _tried = True
            return None
        if not os.path.exists(path):
            if _building is None:
                _building = threading.Thread(target=_build, args=(path,),
                                             daemon=True,
                                             name="nnstw-build")
                _building.start()
            if _building.is_alive():
                return None
        _tried = True
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        lib.tw_crc32c.restype = ctypes.c_uint32
        lib.tw_crc32c.argtypes = [u8p, ctypes.c_size_t, ctypes.c_uint32]
        lib.tw_sparse_count.restype = ctypes.c_size_t
        lib.tw_sparse_count.argtypes = [u8p, ctypes.c_size_t,
                                        ctypes.c_size_t, ctypes.c_int]
        lib.tw_sparse_gather.restype = ctypes.c_size_t
        lib.tw_sparse_gather.argtypes = [u8p, ctypes.c_size_t,
                                         ctypes.c_size_t, ctypes.c_int,
                                         u8p, u32p]
        lib.tw_sparse_scatter.argtypes = [u8p, u32p, ctypes.c_size_t,
                                          ctypes.c_size_t, u8p,
                                          ctypes.c_size_t]
        lib.tw_reader_open.restype = ctypes.c_void_p
        lib.tw_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                                       ctypes.c_int, ctypes.c_int]
        lib.tw_reader_frames.restype = ctypes.c_long
        lib.tw_reader_frames.argtypes = [ctypes.c_void_p]
        lib.tw_reader_next.restype = ctypes.c_long
        lib.tw_reader_next.argtypes = [ctypes.c_void_p, u8p]
        lib.tw_reader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Load the library, waiting for an in-flight build (hot-path callers
    never come through here)."""
    lib = _load()
    if lib is None and _building is not None and _building.is_alive():
        _building.join(timeout=120)
        lib = _load()
    return lib is not None


def crc32c_fn():
    """A CRC-32C callable ``fn(data, seed=0)`` bound to the loaded
    library, or None while it is unavailable.  The per-call path takes no
    lock: resolve once, use per frame."""
    lib = _load()
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)

    def _fn(data, seed: int = 0) -> int:
        arr = np.frombuffer(data, np.uint8)
        return int(lib.tw_crc32c(arr.ctypes.data_as(u8p), arr.size, seed))

    return _fn


# dtype kind codes shared with tensorwire.cc
_KIND = {"float32": 8, "float64": 9}


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def sparse_gather(arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(values, uint32 flat indices)`` of the nonzero elements."""
    flat = np.ascontiguousarray(arr).reshape(-1)
    lib = _load()
    if lib is None:
        idx = np.flatnonzero(flat).astype(np.uint32)
        return flat[idx], idx
    kind = _KIND.get(flat.dtype.name, 0)
    esz = flat.dtype.itemsize
    nnz = lib.tw_sparse_count(_u8(flat.view(np.uint8)), flat.size, esz, kind)
    values = np.empty(nnz, dtype=flat.dtype)
    indices = np.empty(nnz, dtype=np.uint32)
    lib.tw_sparse_gather(_u8(flat.view(np.uint8)), flat.size, esz, kind,
                         _u8(values.view(np.uint8)),
                         indices.ctypes.data_as(
                             ctypes.POINTER(ctypes.c_uint32)))
    return values, indices


def sparse_scatter(values: np.ndarray, indices: np.ndarray,
                   n_elems: int) -> np.ndarray:
    """The dense flat array of ``(values, indices)``."""
    lib = _load()
    dense = np.zeros(n_elems, dtype=values.dtype)
    if lib is None:
        dense[indices] = values
        return dense
    lib.tw_sparse_scatter(_u8(np.ascontiguousarray(values).view(np.uint8)),
                          np.ascontiguousarray(indices).ctypes.data_as(
                              ctypes.POINTER(ctypes.c_uint32)),
                          len(values), values.dtype.itemsize,
                          _u8(dense.view(np.uint8)), n_elems)
    return dense


class RepoReader:
    """Sequential frame reader over a binary dataset file (the JAX
    module's: a native background ``pread`` prefetch ring with bounded
    memory, else an ``mmap``).

    ``next_frame()`` returns ``(global_frame_index, uint8 ndarray)`` (the
    index keeps counting across epochs when ``wrap``) or None at the end
    of a non-wrapping stream.
    """

    def __init__(self, path: str, frame_bytes: int, capacity: int = 8,
                 wrap: bool = False) -> None:
        self.frame_bytes = frame_bytes
        self._native = None
        self._mm = None
        self._served = 0
        self._wrap = wrap
        lib = _load()
        if lib is not None:
            h = lib.tw_reader_open(path.encode(), frame_bytes,
                                   int(capacity), int(wrap))
            if h:
                self._native = (lib, h)
                self.num_frames = int(lib.tw_reader_frames(h))
                return
        import mmap

        f = open(path, "rb")
        try:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:          # a zero-byte file cannot be mapped
            f.close()
            raise ValueError(f"{path}: smaller than one frame") from None
        self._mm = (f, mm)
        self.num_frames = len(mm) // frame_bytes
        if self.num_frames == 0:
            self.close()
            raise ValueError(f"{path}: smaller than one frame")

    @property
    def is_native(self) -> bool:
        return self._native is not None

    def next_frame(self):
        """``(global_frame_index, uint8 ndarray)``: one copy out of the
        ring or the page cache a frame on either path."""
        if self._native is not None:
            lib, h = self._native
            dst = np.empty(self.frame_bytes, np.uint8)
            idx = lib.tw_reader_next(h, _u8(dst))
            if idx == -2:
                raise IOError(f"native reader: IO error at frame "
                              f"{self._served}")
            if idx < 0:
                return None
            self._served += 1
            return int(idx), dst
        if not self._wrap and self._served >= self.num_frames:
            return None
        idx = self._served
        pos = (idx % self.num_frames) * self.frame_bytes
        self._served += 1
        # mm[a:b] copies out of the page cache (a view of the mmap itself
        # would block mm.close())
        return idx, np.frombuffer(self._mm[1][pos:pos + self.frame_bytes],
                                  np.uint8)

    def close(self) -> None:
        if self._native is not None:
            lib, h = self._native
            lib.tw_reader_close(h)
            self._native = None
        if self._mm is not None:
            self._mm[1].close()
            self._mm[0].close()
            self._mm = None
