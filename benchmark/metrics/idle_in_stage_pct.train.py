"""Share of the traced window of a training stream in which no operation
ran on the card while the trainer's ``trainer.stage`` span was the
innermost open program span, in percent: the idle the staging of the
next batch leaves (a part of ``device_idle_pct.train``)."""

from benchmark import spans


def read(window):
    return spans.idle_pct(window, "trainer.stage")
