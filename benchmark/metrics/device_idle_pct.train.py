"""Share of the traced window of a training stream in which no operation
ran on the card, in percent (``readers.idle_pct``)."""

from benchmark.readers import idle_pct as read  # noqa: F401
