"""Share of the traced window of a training stream in which no operation
ran on the card and no program span was open, in percent: the idle the
program cannot place yet (the epoch loop, the benchmark's wrapper of the
step, the garbage collector); a part of ``device_idle_pct.train``."""

from benchmark import spans


def read(window):
    return spans.idle_pct(window, None)
