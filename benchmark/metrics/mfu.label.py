"""The whole step's share of the card's peak: frames labelled in the
traced window times the model's FLOPs a frame (forward), over the
window's seconds and the H100's dense bf16 peak, in percent.  The FLOPs
are counted by ``torch.utils.flop_counter`` over the benchmark's own
reference model at the cell's batch (``benchmark/flops.py``), not by the
program."""

from benchmark.readers import mfu


def read(window):
    return mfu(window, "frames", train=False)
