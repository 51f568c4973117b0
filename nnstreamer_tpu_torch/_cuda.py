"""Build, load and count the port's hand-written CUDA kernels.

Each kernel is a ``csrc/*.cu`` file with a plain C interface.  At first use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``_build/`` (listed in ``.gitignore``), named by a hash of its source and
flags, and loaded with ``ctypes``: pointers and the stream pass as
``c_void_p``.  Nothing is built when a module is imported, so the CPU tests
import every module on hosts without ``nvcc``.

``launches`` counts kernel launches by kernel name: each wrapper adds one
where it launches its kernel and nowhere else.  A CUDA graph
(:class:`CapturedGraph`) calls no wrapper when it replays, so its capture
records the launches the wrappers counted while it was captured (they
launched nothing: capture only records) and each replay adds them again;
``graphs`` counts the captures and replays.

``nvcc`` runs with ``-Xptxas -v``: its report (registers, shared memory and
spill bytes of every kernel function) is kept beside each library as
``<library>.log`` and parsed by :func:`ptxas_report`.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Any, Callable, Dict, Iterable, List, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> its source file under csrc/
SOURCES = {"normalize_frame": "normalize_frame.cu",
           "flash_attention": "flash_attention.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu"}

#: kernel name -> launches since the last reset
launches: "collections.Counter[str]" = collections.Counter()
#: "captures" and "replays" of CUDA graphs since the last reset
graphs: "collections.Counter[str]" = collections.Counter()

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launches() -> None:
    launches.clear()
    graphs.clear()


def graph_memory(device) -> tuple:
    """A (memory pool, side stream) pair for one owner's graphs: they
    capture on the stream, into the pool, and share its memory."""
    import torch

    return torch.cuda.graph_pool_handle(), torch.cuda.Stream(device)


class CapturedGraph:
    """``fn(*inputs)`` captured as one ``torch.cuda.CUDAGraph``.

    ``inputs`` are static device tensors that already hold the first
    call's values.  ``memory`` is the owner's :func:`graph_memory`.  The
    constructor runs ``fn`` once eagerly on its side stream (the warm-up
    loads every lazily loaded kernel module, the ctypes kernels included,
    and sets up the libraries' per-stream state), keeps that run's
    outputs as :attr:`first`, then captures ``fn`` on the same stream
    into its memory pool.  :meth:`replay` re-runs the captured kernels on
    the current stream and returns :attr:`outputs`, the graph's static
    outputs, which the next replay overwrites.

    The caller runs it under ``torch.inference_mode()``.  A capture that
    fails (a host sync inside ``fn``, an operation CUDA cannot capture)
    raises; nothing falls back to eager execution."""

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[Any],
                 memory) -> None:
        import torch

        pool, stream = memory
        current = torch.cuda.current_stream(inputs[0].device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.first = fn(*inputs)
        current.wait_stream(stream)
        before = launches.copy()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream):
                self.outputs = fn(*inputs)
        except BaseException:
            # a capture that fails to end leaves the capture stream current
            torch.cuda.set_stream(current)
            raise
        finally:
            # the wrappers counted the kernels they recorded; none ran
            self.launched = launches - before
            launches.clear()
            launches.update(before)
        self.inputs = list(inputs)
        graphs["captures"] += 1

    def replay(self) -> Any:
        self.graph.replay()
        launches.update(self.launched)
        graphs["replays"] += 1
        return self.outputs


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a host with the CUDA toolkit")
    return found


def _library_path(name: str) -> str:
    """The source, every shared header under csrc/ and the flags name the
    library, so an edit to any of them builds it anew."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [SOURCES[name], *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together; returns name -> library path."""
    paths = {n: _library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = f"{p}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[n])]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT), tmp)
    errors = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{SOURCES[n]}:\n{out.decode(errors='replace')}")
            continue
        with open(f"{tmp}.log", "wb") as f:
            f.write(out)
        os.replace(f"{tmp}.log", f"{todo[n]}.log")
        os.replace(tmp, todo[n])   # atomic: a concurrent loader never
        # sees a half-written library
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return paths


_FUNCTION = re.compile(r"Compiling entry function '([^']+)'")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")


def parse_ptxas(text: str) -> List[dict]:
    """One entry per kernel function of an ``nvcc -Xptxas -v`` report:
    its (mangled) name, registers a thread, static shared memory, stack
    frame and spill bytes, and ptxas's performance notes on it (such as
    wgmma products it had to serialise)."""
    funcs: List[dict] = []
    notes: Dict[str, List[str]] = collections.defaultdict(list)
    for line in text.splitlines():
        m = _FUNCTION.search(line)
        if m:
            funcs.append({"function": m.group(1)})
            continue
        if "Performance" in line or "serialized" in line:
            named = re.search(r"'(_Z\w+)'", line)
            key = named.group(1) if named else (
                funcs[-1]["function"] if funcs else "")
            notes[key].append(line.split(":", 1)[-1].strip())
            continue
        if not funcs:
            continue
        m = _SPILL.search(line)
        if m:
            funcs[-1].update(stack_bytes=int(m.group(1)),
                             spill_store_bytes=int(m.group(2)),
                             spill_load_bytes=int(m.group(3)))
            continue
        m = _USED.search(line)
        if m:
            smem = _SMEM.search(line)
            funcs[-1].update(registers=int(m.group(1)),
                             static_smem_bytes=int(smem.group(1)) if smem
                             else 0)
    for f in funcs:
        f["notes"] = notes.get(f["function"], [])
    return funcs


def ptxas_report() -> Dict[str, list]:
    """name -> :func:`parse_ptxas` of the kept build log of each kernel
    library (built first where missing)."""
    report = {}
    for n, p in build().items():
        with open(f"{p}.log", encoding="utf-8", errors="replace") as f:
            report[n] = parse_ptxas(f.read())
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (built on first call)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build([name])[name])
            lib.nns_cuda_error_string.argtypes = [ctypes.c_int]
            lib.nns_cuda_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry point returned a nonzero cudaError_t."""
    if code:
        msg = lib.nns_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
