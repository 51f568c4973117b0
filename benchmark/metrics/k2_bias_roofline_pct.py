"""The biased flash-attention forward (``csrc/flash_attention_bias.cu``,
SwinV2's window attention with its position bias and region mask) in the
training step against its roofline: the least time of a whole forward
pass's calls, each at its layer's shape, over the device time the pass
took, in percent (``benchmark/swin.py``: q, k, v, out and the log-sum-exp
once, the bias and the labels once; 4 x head dim operations a pair).  A
window that ran no such kernel (a program without them) reads nothing."""

from benchmark import swin


def read(window):
    return swin.forward_roofline_pct(window)
