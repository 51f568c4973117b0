"""K2 (``csrc/flash_attention.cu``, the flash-attention forward) in the
training step against its roofline: the least time of one call at the
batch's shape, ``(batch, tokens, heads, head dim)`` in the compute type
with no causal mask, over the device time a traced K2 call took, in
percent.  The call also writes the per-row float32 log-sum-exp that the
backward reads (``readers.k2_least_s``)."""

from benchmark import readers

#: a part of every K2 kernel's name
KERNELS = ("flash_forward",)


def least_s(batch, tokens, heads, head_dim, dtype):
    return readers.k2_least_s(batch, tokens, heads, head_dim, dtype,
                              lse=True)


def read(window):
    return readers.k2_roofline_pct(
        window, KERNELS, window["config"]["train"]["compute_dtype"], lse=True)
