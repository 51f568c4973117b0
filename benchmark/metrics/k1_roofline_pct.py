"""K1 (``csrc/normalize_frame.cu``) against its roofline: the least time
of one bucket's call over the device time a call of the kernels named
below took in the traced window, in percent.

The call normalises a whole bucket of uint8 frames into the served type:
it must read every frame byte once and write every output element once,
with one multiply-add an element (far below the byte bound)."""

from benchmark import roofline
from benchmark.readers import ITEMSIZE
from benchmark.trace import kernel_calls

#: a part of every K1 kernel's name
KERNELS = ("normalize_frame",)


def least_s(batch: int, size: int, out_dtype: str) -> float:
    elements = batch * size * size * 3
    nbytes = elements * (1 + ITEMSIZE[out_dtype])
    return roofline.bound_s(nbytes, 2.0 * elements,
                            ITEMSIZE[out_dtype])[0]


def read(window):
    calls, took = kernel_calls(window, KERNELS)
    if not calls:
        return None
    cfg = window["config"]
    one = least_s(int(window["traffic"]["batch"]), int(cfg["image_size"]),
                  cfg["serve_dtype"])
    return roofline.percent(calls * one, took)
