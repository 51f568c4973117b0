"""SwinV2's LayerNorm kernels (``csrc/layer_norm.cu``: the forward, the
backward and the backward's partial sum) in the training step against
their roofline: the least time of a whole forward pass and a whole
backward pass of the step's norms, each call at its own rows and width
(``benchmark/swin.py``: the patch embedding's, two a block, each patch
merging's at twice its stage's width, the final one; bytes counted as
``ln_roofline_pct.train`` counts them), over the device time of those
passes, in percent.  A window that ran none of these kernels (a program
without them) reads nothing."""

from benchmark import swin


def read(window):
    return swin.norm_roofline_pct(window)
