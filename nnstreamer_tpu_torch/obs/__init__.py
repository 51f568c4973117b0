"""Observability helpers.  Only the clock is ported so far."""
