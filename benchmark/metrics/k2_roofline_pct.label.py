"""K2 (``csrc/flash_attention.cu``, the flash-attention forward) in the
serving path against its roofline: the least time of one call at the
bucket's shape, ``(batch, tokens, heads, head dim)`` in the served type
with no causal mask, over the device time a traced K2 call took, in
percent.  Serving needs no log-sum-exp, so none is counted
(``readers.k2_least_s``)."""

from benchmark import readers

#: a part of every K2 kernel's name
KERNELS = ("flash_forward",)


def least_s(batch, tokens, heads, head_dim, dtype):
    return readers.k2_least_s(batch, tokens, heads, head_dim, dtype,
                              lse=False)


def read(window):
    return readers.k2_roofline_pct(
        window, KERNELS, window["config"]["serve_dtype"], lse=False)
