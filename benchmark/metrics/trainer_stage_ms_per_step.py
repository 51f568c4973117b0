"""Host milliseconds a step of the trainer's ``trainer.stage`` span: the
host batch made a tensor, the wait for the previous staging copy, the
copy into pinned staging and the copy to the card enqueued
(``_cuda.GraphedStep``), averaged over the traced window's steps."""

from benchmark import spans


def read(window):
    return spans.phase_ms_per_step(window, "trainer.stage")
