"""ctypes binding of the repository's native tensorwire library: the
CRC-32C of the query wire (``query/protocol.py``) and the shared-memory
ring (``query/shm.py``, which binds the ``tw_shm_*`` entry points).

The port's own counterpart of ``nnstreamer_tpu/native.py``: it compiles
``native/tensorwire/tensorwire.cc`` and ``native/tensorwire/shmring.cc``
(the repository-level sources) with ``g++`` into
``nnstreamer_tpu_torch/_build/`` (listed in ``.gitignore``), named by a
hash of the sources and flags, and loads it with ``ctypes``.  It links
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
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(os.path.dirname(_HERE), "native", "tensorwire")
SOURCES = tuple(os.path.join(_SRC_DIR, name)
                for name in ("tensorwire.cc", "shmring.cc"))
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
        lib.tw_crc32c.restype = ctypes.c_uint32
        lib.tw_crc32c.argtypes = [ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_size_t, ctypes.c_uint32]
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
