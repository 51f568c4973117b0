"""Observability: the clock, trace spans and the metrics registry
(``obs/httpd``, ``attrib``, ``profile``, ``timeseries``, ``federation`` and
``dashboard`` are not ported yet)."""
