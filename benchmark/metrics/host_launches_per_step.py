"""Host calls that put work on the card (``cudaLaunchKernel`` and its
driver forms, ``cudaGraphLaunch``, ``cudaMemcpyAsync``), counted by the
profiler on the host side of the traced window, a training step."""

from benchmark.readers import host_calls_per


def read(window):
    return host_calls_per(window, "units")
