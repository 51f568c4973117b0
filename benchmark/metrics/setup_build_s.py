"""Seconds of set-up the trainer spends building its model and step at
the first ``finish()`` (its ``trainer.build`` span; a run builds one
trainer)."""

from benchmark import spans


def read(window):
    return spans.setup_s("trainer.build")
