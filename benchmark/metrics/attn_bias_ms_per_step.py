"""Device time of the biased flash-attention kernels (forward, K3, the
partials' sum and K4 of ``csrc/flash_attention_bias.cu``), milliseconds a
training step: the traced window's mean whole forward pass plus its mean
whole backward pass (``benchmark/swin.py``).  A window that ran no such
kernel reads nothing."""

from benchmark import swin


def read(window):
    return swin.ms_per_step(window)
