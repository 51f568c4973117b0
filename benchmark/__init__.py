"""The benchmark of ``nnstreamer_tpu_torch`` on an NVIDIA H100: one cell
a run (``python3 -m benchmark.run``), cells, configurations, traffic
mixes and per-layer metrics found by name (``benchmark/spec.py``)."""
