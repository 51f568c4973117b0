"""The device trace of a run's traced window, read from ``torch.profiler``.

One :class:`DeviceTrace` profiles the host and the card over a window
and reduces the profiler's raw events (Kineto's, without the profiler's
own per-event post-processing, which takes minutes on a window of a few
hundred thousand kernels) to what the per-layer metrics read:

- ``kernels``: ``(name, start_ns, duration_ns)`` of every operation that
  ran on the card inside the window (kernels, copies and sets; a range a
  user annotation draws on the card is not an operation);
- ``busy_s``: the union of those intervals; ``window_s``: the window's
  length on the host's clock;
- ``host_calls``: the host's calls that put work on the card (kernel and
  graph launches, asynchronous copies), by name;
- ``breakdown``: the operations that took most time, and the longest idle
  gaps on the card named by the host operation that covered most of each.

CUPTI set up after the process has replayed CUDA graphs has crashed the
process or lost the graphs' kernels, and torn down and set up again
crashes it: :func:`prepare` sets it up once, before any graph exists, and
the environment keeps it up.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Dict, List, Tuple

#: host calls that put work on the card: kernel launches, graph launches
#: (a replay) and asynchronous copies
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                     "cudaLaunchKernelExC", "cudaGraphLaunch",
                     "cudaMemcpyAsync")
#: entries of each list of the result's ``breakdown``
BREAKDOWN_ENTRIES = 10


def configure_environment() -> None:
    """Keep CUPTI up between traces; set before torch is imported."""
    os.environ.setdefault("TEARDOWN_CUPTI", "0")
    os.environ.setdefault("DISABLE_CUPTI_LAZY_REINIT", "1")


def prepare() -> None:
    """Set CUPTI up before the program captures its first graph."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class DeviceTrace:
    """``start()`` and ``close()`` around the traced window, ``stop()``
    once nothing runs on the card any more, then :meth:`read`.

    The profiler is stopped only where no other thread launches work: a
    stop racing a pipeline thread's graph launches has hung a process
    (once in nine traced label runs)."""

    def __init__(self) -> None:
        self._prof = None
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0_ns = time.time_ns()

    def close(self) -> None:
        """The traced window ends here."""
        self.t1_ns = time.time_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)

    def read(self) -> dict:
        return reduce_events(self._prof.profiler.kineto_results.events(),
                             self.t0_ns, self.t1_ns)


def _union_ns(intervals: List[Tuple[int, int]]) -> Tuple[int, list]:
    """Total length of the union of ``(start, end)`` intervals, and the
    gaps between its pieces as ``(start, end)``."""
    total, gaps = 0, []
    end = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total, gaps


def reduce_events(events, t0_ns: int, t1_ns: int) -> dict:
    """The traced window ``[t0_ns, t1_ns]`` (the profiler's clock, which
    is the host's wall clock) of Kineto's events, as the module doc
    says."""
    kernels, host_ops = [], []
    host_calls: Dict[str, int] = collections.Counter()
    for e in events:
        start = e.start_ns()
        if start < t0_ns or start > t1_ns:
            continue
        if str(e.device_type()).endswith("CUDA"):
            if e.is_user_annotation():
                continue
            kernels.append((e.name(), start, e.duration_ns()))
            continue
        name = e.name()
        if name in HOST_LAUNCH_CALLS:
            host_calls[name] += 1
        elif not e.is_user_annotation() and e.duration_ns() > 0:
            host_ops.append((name, start, start + e.duration_ns()))
    busy_ns, gaps = _union_ns([(s, min(s + d, t1_ns)) for _, s, d in kernels])
    by_name: Dict[str, int] = collections.Counter()
    for name, _, dur in kernels:
        by_name[name] += dur
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:BREAKDOWN_ENTRIES]
    return {"kernels": kernels, "busy_s": busy_ns / 1e9,
            "window_s": (t1_ns - t0_ns) / 1e9, "host_calls": dict(host_calls),
            "breakdown": {
                "device_ops": [[n[:120], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[_covering(host_ops, s, e), (e - s) / 1e9]
                              for s, e in longest]}}


def _covering(host_ops, s: int, e: int) -> str:
    """The host operation that overlaps most of ``[s, e]``."""
    best, best_ns = "host idle", 0
    for name, hs, he in host_ops:
        ov = min(e, he) - max(s, hs)
        if ov > best_ns:
            best, best_ns = name, ov
    return best[:120]


def kernel_calls(trace: dict, patterns) -> Tuple[int, float]:
    """(count, seconds) of the traced kernels whose name holds any of
    ``patterns``."""
    hits = [d for n, _, d in trace["kernels"]
            if any(p in n for p in patterns)]
    return len(hits), sum(hits) / 1e9
