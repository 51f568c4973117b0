"""K3 and K4 (``csrc/flash_attention_bwd.cu``, the flash-attention
backward: dq, and dk with dv) in the training step against their
roofline: the least time of one K3 and one K4 call at the batch's shape,
``(batch, tokens, heads, head dim)`` in the compute type with no causal
mask, over the device time of the kernels named below in the traced
window, in percent.

K3 must read q, k, v, dO and the float32 log-sum-exp and delta once and
write dq once, with 6 x head dim operations a (query, key) pair (s, dO.v,
ds.k); K4 reads the same and writes dk and dv, with 8 x head dim (s,
dO.v, p.dO, ds.q)."""

from benchmark import roofline
from benchmark.readers import ITEMSIZE, attention_shape
from benchmark.trace import kernel_calls

#: a part of the name of every K3 kernel, and of every K4 kernel
K3_KERNELS = ("flash_bwd_dq",)
K4_KERNELS = ("flash_bwd_dkv",)


def least_s(which: str, batch: int, tokens: int, heads: int, head_dim: int,
            dtype: str) -> float:
    item = ITEMSIZE[dtype]
    rows = 4 * tokens * heads * head_dim * item + 2 * heads * tokens * 4
    out = (1 if which == "dq" else 2) * tokens * heads * head_dim * item
    per_pair = 6.0 if which == "dq" else 8.0
    ops = per_pair * head_dim * batch * heads * tokens * tokens
    return roofline.bound_s(batch * (rows + out), ops, item)[0]


def read(window):
    k3, t3 = kernel_calls(window, K3_KERNELS)
    k4, t4 = kernel_calls(window, K4_KERNELS)
    if not k3 or not k4:
        return None
    cfg = window["config"]
    shape = (int(window["traffic"]["batch"]), *attention_shape(cfg),
             cfg["train"]["compute_dtype"])
    least = k3 * least_s("dq", *shape) + k4 * least_s("dkv", *shape)
    return roofline.percent(least, t3 + t4)
