"""The biased flash-attention backward (``csrc/flash_attention_bias.cu``:
K3 with the bias's gradient, the sum of its partials, K4) in the training
step against its roofline: the least time of a whole backward pass's K3
and K4 calls, each at its layer's shape, over the device time of every
biased backward kernel of the pass, in percent (``benchmark/swin.py``:
dbias written once among K3's bytes).  A window that ran no such kernel
reads nothing."""

from benchmark import swin


def read(window):
    return swin.backward_roofline_pct(window)
