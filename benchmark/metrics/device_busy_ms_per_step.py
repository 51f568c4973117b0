"""Device time of every operation on the card in the traced window
(kernels, copies and sets, from the profiler's trace), milliseconds a
training step that ended in it."""

from benchmark.readers import device_seconds_per


def read(window):
    s = device_seconds_per(window, "units")
    return None if s is None else s * 1e3
