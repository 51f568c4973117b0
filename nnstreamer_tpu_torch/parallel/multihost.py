"""Multi-process initialization: one process a rank over torch.distributed.

The PyTorch counterpart of ``nnstreamer_tpu/parallel/multihost.py``.  The
JAX package joins its hosts into one runtime with
``jax.distributed.initialize``: every host runs the same program and
``jax.devices()`` becomes the global device list.  The port joins its
processes into one ``torch.distributed`` process group: every process
runs the same program (one a card, or several sharing a card over
``gloo``), and :func:`~.mesh.make_mesh` then lays the group's ranks out
as the mesh's grid.

Typical launch (one command per process)::

    from nnstreamer_tpu_torch.parallel import make_mesh, multihost
    multihost.initialize(coordinator="10.0.0.1:8476", num_processes=4,
                         process_id=RANK)
    mesh = make_mesh(axis_sizes={"dp": 2, "sp": 2},
                     devices=[torch.device("cuda", LOCAL_RANK)])

Without arguments the group reads ``MASTER_ADDR``/``MASTER_PORT``/
``WORLD_SIZE``/``RANK`` from the environment (``torchrun``'s launch), the
role of the JAX package's auto-detection on Cloud TPU.

:class:`LocalWorld` starts ``n`` ranks on this host as spawned processes
and runs functions on all of them: the tests' and ``chip_smoke.py``'s
multi-rank runs.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue
import socket
import threading
import traceback
from typing import Any, Callable, List, Optional

import torch

_initialized = False


def default_backend() -> str:
    """``nccl`` where the process computes on a card, ``gloo`` otherwise."""
    return "nccl" if torch.cuda.is_available() else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               _backend=None, backend: Optional[str] = None,
               timeout_s: Optional[float] = None) -> None:
    """Join the process group: ``coordinator`` (``host:port``) holds its
    TCP store, ``num_processes`` is the world size and ``process_id`` this
    process's rank; ``backend`` defaults to :func:`default_backend`.  A
    second call is a no-op.

    ``_backend`` is a test seam: a callable standing in for
    ``torch.distributed.init_process_group``, which gets the keyword
    arguments it would have got."""
    global _initialized
    if _initialized:
        return
    if _backend is None:
        import torch.distributed as dist

        _backend = dist.init_process_group
    kwargs: dict = {"backend": backend or default_backend()}
    if coordinator is not None:
        kwargs["init_method"] = f"tcp://{coordinator}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))
    _backend(**kwargs)
    _initialized = True


def is_initialized() -> bool:
    return _initialized


def shutdown() -> None:
    """Leave the process group (the counterpart of ``initialize``)."""
    global _initialized
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def process_info() -> dict:
    """This process's place in the group, in the JAX package's keys: a
    process computes on one device, so the global device count is the
    world size."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    return {"process_index": dist.get_rank() if up else 0,
            "process_count": world, "local_devices": 1,
            "global_devices": world}


def free_port() -> int:
    """A free TCP port on this host's loopback."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, coordinator: str, backend: str,
               threads: int, timeout_s: float, conn) -> None:
    """A :class:`LocalWorld` rank: join the group, then run each function
    the parent sends until it sends ``None``."""
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize(coordinator, world, rank, backend=backend,
                   timeout_s=timeout_s)
        conn.send(("ok", rank))
    except Exception:  # noqa: BLE001 - reported to the parent
        conn.send(("error", traceback.format_exc()))
        return
    try:
        while True:
            task = conn.recv()
            if task is None:
                break
            fn, args, kwargs = task
            try:
                conn.send(("ok", fn(*args, **kwargs)))
            except Exception:  # noqa: BLE001 - reported to the parent
                conn.send(("error", traceback.format_exc()))
    finally:
        shutdown()


class LocalWorld:
    """``n`` ranks of one process group on this host, each a spawned
    process: :meth:`run` calls a function on every rank and returns each
    rank's result (the function must be importable by name, its arguments
    and results picklable); :meth:`submit` starts such a call and
    returns at once, so the caller can work while the ranks do.  A rank
    that raises fails the call with its traceback; ``timeout_s`` bounds
    each collective (a rank left waiting on a peer that raised gives up
    then) and each call."""

    def __init__(self, n: int, backend: str = "gloo", threads: int = 1,
                 timeout_s: float = 300.0) -> None:
        ctx = multiprocessing.get_context("spawn")
        self.n = n
        self.timeout_s = timeout_s
        coordinator = f"127.0.0.1:{free_port()}"
        self._conns, self._procs = [], []
        #: each rank's answers, read off its pipe as they come (a rank
        #: never blocks sending a result while the parent sends a task)
        self._answers: List[queue.Queue] = []
        #: submitted calls whose results have not been read, oldest first
        self._pending: List["_Call"] = []
        for rank in range(n):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_rank_main, daemon=True,
                               args=(rank, n, coordinator, backend, threads,
                                     timeout_s, child))
            proc.start()
            child.close()
            answers: queue.Queue = queue.Queue()
            threading.Thread(target=self._read, args=(parent, answers),
                             daemon=True, name=f"world-rank{rank}").start()
            self._conns.append(parent)
            self._answers.append(answers)
            self._procs.append(proc)
        try:
            self._gather()
        except BaseException:
            self.close()
            raise

    @staticmethod
    def _read(conn, answers: queue.Queue) -> None:
        try:
            while True:
                answers.put(conn.recv())
        except (EOFError, OSError):
            answers.put(("error", "the rank's process ended"))

    def _gather(self) -> List[Any]:
        out, errors = [], []
        for rank, answers in enumerate(self._answers):
            try:
                status, value = answers.get(timeout=self.timeout_s)
            except queue.Empty:
                errors.append(f"rank {rank}: no answer in "
                              f"{self.timeout_s} s")
                out.append(None)
                continue
            if status != "ok":
                errors.append(f"rank {rank}:\n{value}")
            out.append(value)
        if errors:
            raise RuntimeError("LocalWorld: " + "\n".join(errors))
        return out

    def submit(self, fn: Callable[..., Any], *args, **kwargs) -> "_Call":
        """Start ``fn(*args, **kwargs)`` on every rank; the returned call's
        ``result()`` waits for the ranks' results."""
        for conn in self._conns:
            conn.send((fn, args, kwargs))
        call = _Call(self)
        self._pending.append(call)
        return call

    def _settle(self, call: "_Call") -> None:
        """Read results in submission order up to ``call``'s."""
        while not call.done:
            head = self._pending.pop(0)
            try:
                head.value = self._gather()
            except RuntimeError as exc:
                head.error = exc
            head.done = True

    def run(self, fn: Callable[..., Any], *args, **kwargs) -> List[Any]:
        """``fn(*args, **kwargs)`` on every rank; the ranks' results."""
        return self.submit(fn, *args, **kwargs).result()

    def close(self) -> None:
        """Stop every rank (those that do not leave in time are killed)."""
        for conn in self._conns:
            try:
                conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        for proc in self._procs:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join(5)
        for conn in self._conns:
            conn.close()
        self._conns, self._procs = [], []

    def __enter__(self) -> "LocalWorld":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class _Call:
    """A :meth:`LocalWorld.submit` call in flight."""

    def __init__(self, world: LocalWorld) -> None:
        self._world = world
        self.done = False
        self.value: Optional[List[Any]] = None
        self.error: Optional[BaseException] = None

    def result(self) -> List[Any]:
        """Each rank's result; raises if a rank raised."""
        self._world._settle(self)
        if self.error is not None:
            raise self.error
        return self.value
