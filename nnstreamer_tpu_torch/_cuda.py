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
``graphs`` counts the captures and replays.  :class:`GraphedStep` runs a
training step as one such graph per batch signature.

``nvcc`` runs with ``-Xptxas -v``: its report (registers, shared memory and
spill bytes of every kernel function) is kept beside each library as
``<library>.log`` and parsed by :func:`ptxas_report`.
"""

from __future__ import annotations

import collections
import ctypes
import gc
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


_SHAPE_ONLY = threading.local()


class shape_only:
    """Context in which a kernel wrapper given a ``meta`` tensor returns
    a shape-only stand-in (an aten op of the same input and output
    shapes and types) instead of refusing it: the cost counter's pass
    (obs/attrib.py).  Per thread; outside it a meta tensor is refused
    as before."""

    def __enter__(self) -> "shape_only":
        _SHAPE_ONLY.depth = getattr(_SHAPE_ONLY, "depth", 0) + 1
        return self

    def __exit__(self, *exc) -> None:
        _SHAPE_ONLY.depth -= 1


def shape_only_active() -> bool:
    return getattr(_SHAPE_ONLY, "depth", 0) > 0


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
    outputs, which the next replay overwrites.  ``error_mode`` is
    ``torch.cuda.graph``'s ``capture_error_mode``: ``"thread_local"``
    lets other threads call CUDA while this one captures.

    A serving caller runs it under ``torch.inference_mode()``.  A training
    step (:class:`GraphedStep`) runs it with autograd: there the warm-up
    is the step's first run (it updates the parameters and optimizer
    state once, and :attr:`first` is that step's loss), and the capture
    records the same step without running it.  The backward's kernels are
    launched from autograd's device thread while ``fn`` waits for it, so
    their counts land inside the capture window too.  A capture that
    fails (a host sync inside ``fn``, an operation CUDA cannot capture)
    raises; nothing falls back to eager execution.

    The garbage collector is held off while the graph captures: a dead
    reference cycle that owns another graph (an engine or a pipeline
    dropped earlier), collected inside the capture window, would destroy
    that graph there, which CUDA forbids while a stream captures (the
    capture fails with ``cudaErrorStreamCaptureInvalidated``)."""

    def __init__(self, fn: Callable[..., Any], inputs: Sequence[Any],
                 memory, error_mode: str = "global") -> None:
        import torch

        pool, stream = memory
        current = torch.cuda.current_stream(inputs[0].device)
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            self.first = fn(*inputs)
        current.wait_stream(stream)
        before = launches.copy()
        self.graph = torch.cuda.CUDAGraph()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode=error_mode):
                self.outputs = fn(*inputs)
        except BaseException:
            # a capture that fails to end leaves the capture stream current
            torch.cuda.set_stream(current)
            raise
        finally:
            if collecting:
                gc.enable()
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


def host_tensor(x, pin: bool = False):
    """``x`` as a tensor: a tensor as it is, anything else through numpy.
    A read-only array (a frame decoded over a received wire payload),
    which ``torch.from_numpy`` refuses to wrap, is copied once: into
    pinned memory with ``pin`` (the caller's device is the card), so its
    copy there needs no second, pageable staging copy."""
    import numpy as np
    import torch

    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if not arr.flags.writeable:
        return stack_host([arr], None, pin)
    return torch.from_numpy(arr)


def stack_host(arrs, rows=0, pin: bool = False):
    """Host arrays of one shape and dtype stacked into ONE host tensor of
    ``rows`` rows (``len(arrs)`` when 0; rows past them repeat the last
    array; ``None``: the one array itself, unstacked): one copy of each
    array, into pinned memory with ``pin`` (the caller's device is the
    card), after which the tensor's copy there is asynchronous."""
    import numpy as np
    import torch

    arrs = [np.asarray(a) for a in arrs]
    lead = () if rows is None else (max(int(rows), len(arrs)),)
    host = torch.empty(lead + arrs[0].shape,
                       dtype=torch.from_numpy(np.empty(0, arrs[0].dtype)
                                              ).dtype,
                       pin_memory=pin)
    if rows is None:
        np.copyto(host.numpy(), arrs[0])
    else:
        np.stack(arrs + [arrs[-1]] * (lead[0] - len(arrs)),
                 out=host.numpy())
    return host


class GraphedStep:
    """A training step ``fn(*batch) -> loss`` that updates its parameters
    and optimizer state in place, run as one CUDA graph per batch
    signature: the counterpart of the JAX package's jitted step with
    donated parameters and optimizer state.

    Each signature (the shape and dtype of each batch tensor) gets static
    batch buffers on the step's device; a call copies its batch into them
    (from host memory through pinned staging, without blocking) and runs
    ``fn`` on them.  On the card the first call of a signature is a
    :class:`CapturedGraph`: its eager warm-up is that call's step, and
    every later call of the signature replays the graph.  The loss it
    returns is then the graph's static output, which the next call
    overwrites: read it (``float(loss)``, the step's one sync) before the
    next call.  All of a step's graphs share one memory pool and side
    stream.  On the CPU, and on the card while :attr:`_eager` is set, the
    step runs eagerly on the same static buffers.

    A capture that fails raises ``RuntimeError`` (after the warm-up's step
    has run); nothing falls back to eager execution."""

    #: private: run the step eagerly on the card as well, for a reference
    #: run to hold the graphs to (set on the class or an instance by tests
    #: and chip_smoke.py; not a launch property)
    _eager = False

    def __init__(self, fn: Callable[..., Any], device) -> None:
        import torch

        self.fn = fn
        self.device = torch.device(device)
        #: signature -> the static batch buffers on the step's device
        self.statics: Dict[tuple, list] = {}
        #: signature -> its CapturedGraph
        self.graphs: Dict[tuple, CapturedGraph] = {}
        self._staging: Dict[tuple, list] = {}
        self._copied: Dict[tuple, Any] = {}
        self._memory = None

    def _graphed(self) -> bool:
        return self.device.type == "cuda" and not self._eager

    def _copy_in(self, key: tuple, batch: list) -> list:
        import torch

        statics = self.statics.get(key)
        if statics is None:
            statics = self.statics[key] = [
                torch.empty(x.shape, dtype=x.dtype, device=self.device)
                for x in batch]
        staging = self._staging.setdefault(key, [None] * len(batch))
        copied = self._copied.pop(key, None)
        if copied is not None:
            # the last copy out of the staging buffers must end before
            # they are written again
            copied.synchronize()
        staged = False
        for i, (x, static) in enumerate(zip(batch, statics)):
            if self.device.type == "cuda" and x.device.type == "cpu":
                if staging[i] is None:
                    staging[i] = torch.empty(x.shape, dtype=x.dtype,
                                             pin_memory=True)
                staging[i].copy_(x)
                x, staged = staging[i], True
            if x is not static:
                static.copy_(x, non_blocking=True)
        if staged:
            self._copied[key] = torch.cuda.Event()
            self._copied[key].record()
        return statics

    def __call__(self, *batch) -> Any:
        import torch

        if torch.is_inference_mode_enabled():
            raise RuntimeError("a training step needs autograd: it cannot "
                               "run under torch.inference_mode()")
        batch = [host_tensor(x) for x in batch]
        key = tuple((tuple(x.shape), x.dtype) for x in batch)
        statics = self._copy_in(key, batch)
        if not self._graphed():
            return self.fn(*statics)
        graph = self.graphs.get(key)
        if graph is not None:
            return graph.replay()
        if self._memory is None:
            self._memory = graph_memory(self.device)
        try:
            graph = CapturedGraph(self.fn, statics, self._memory)
        except RuntimeError as exc:
            raise RuntimeError(f"CUDA graph capture of the training step "
                               f"for {key} failed: {exc}") from exc
        self.graphs[key] = graph
        return graph.first


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
