"""Observability: the clock, trace spans and the metrics registry, the
``/metrics`` + ``/healthz`` endpoint (``httpd``), wait-state attribution
with the H100 cost and peak tables (``attrib``), the profiler
(``profile``), the time-series ring (``timeseries``), cross-process
metric federation (``federation``) and the ``nns-top`` view
(``dashboard``)."""
