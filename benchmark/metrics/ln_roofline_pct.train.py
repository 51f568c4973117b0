"""ViT's LayerNorm kernels (``csrc/layer_norm.cu``: the forward, the
backward and the backward's partial sum) in the training step against
their roofline: the least time of the traced forward and backward calls
at the cell's shape, ``(batch x tokens, hidden size)`` in the compute
type with float32 weight and bias, over the device time of every kernel
of the three in the traced window, in percent.

A forward must read x, the weight and the bias once and write y once; a
backward must read x, dy and the weight once and write dx, dweight and
dbias once.  Row statistics are not counted: a design may recompute
them.  Bytes bind: a few operations a value.  Forward and backward calls
are counted apart, by name; a window that ran none of these kernels (a
program without them) reads nothing."""

from benchmark import roofline
from benchmark.readers import ITEMSIZE, attention_shape
from benchmark.trace import kernel_calls

#: a part of the name of every kernel of the mechanism, of the forward's
#: and of the backward's (the partial sum is neither)
KERNELS = ("layer_norm_",)
FORWARD = ("layer_norm_fwd",)
BACKWARD = ("layer_norm_bwd",)


def least_bytes(which: str, rows: int, width: int, dtype: str) -> int:
    act = rows * width * ITEMSIZE[dtype]
    if which == "fwd":
        return 2 * act + 2 * width * 4
    return 3 * act + 3 * width * 4


def least_s(which: str, rows: int, width: int, dtype: str) -> float:
    return roofline.bound_s(least_bytes(which, rows, width, dtype), 0.0,
                            ITEMSIZE[dtype])[0]


def read(window):
    _, took = kernel_calls(window, KERNELS)
    fwd, _ = kernel_calls(window, FORWARD)
    bwd, _ = kernel_calls(window, BACKWARD)
    if not fwd and not bwd:
        return None
    cfg = window["config"]
    tokens = attention_shape(cfg)[0]
    shape = (int(window["traffic"]["batch"]) * tokens,
             int(cfg["hidden_size"]), cfg["train"]["compute_dtype"])
    least = fwd * least_s("fwd", *shape) + bwd * least_s("bwd", *shape)
    return roofline.percent(least, took)
