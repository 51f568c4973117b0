"""Device time of every operation on the card in the traced window
(kernels, copies and sets, from the profiler's trace), microseconds a
frame that reached the sink in it."""

from benchmark.readers import device_seconds_per


def read(window):
    s = device_seconds_per(window, "frames")
    return None if s is None else s * 1e6
