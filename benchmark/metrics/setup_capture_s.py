"""Seconds of set-up the trainer's step spends on its eager warm-up step
and its CUDA graph capture (its ``trainer.capture`` span), less any
kernel libraries compiled inside it (``kernels.build``), so that a
checkout's first run and a warm run read alike."""

from benchmark import spans


def read(window):
    return spans.setup_s("trainer.capture", less="kernels.build")
