"""SLO harness: open-loop load generation, burn-rate gating, flight
recording.

The obs package gives the framework eyes (spans, histograms, a metrics endpoint);
this package is what *consumes* them at fleet scale — the verification
substrate the ROADMAP's serving-plane items are judged against.
StreamTensor (arXiv:2509.13694) is the motivating posture: tail
behavior under sustained concurrent streams, not mean fps, is the
honest health metric for an always-on multi-user pipeline service
(NNStreamer, arXiv:2101.06371).

- :mod:`~nnstreamer_tpu_torch.slo.spec` — SLO objectives (latency /
  error-rate / availability targets) + multi-window burn-rate
  parameters, as plain JSON.
- :mod:`~nnstreamer_tpu_torch.slo.loadgen` — open-loop (coordinated-omission-
  free) Poisson / constant-rate load generator over concurrent
  ``tensor_query_client`` connections, with per-class request tagging.
- :mod:`~nnstreamer_tpu_torch.slo.evaluator` — windowed burn-rate evaluation
  over the metrics registry's snapshot/diff API; machine-readable
  PASS/FAIL verdicts; breach-onset callbacks.
- :mod:`~nnstreamer_tpu_torch.slo.flightrec` — always-on bounded triage ring
  dumped as a Chrome-trace + metrics bundle at the moment of breach.

The port of ``nnstreamer_tpu/slo``.  ``launch.py --soak/--slo`` gates
any launch-string pipeline with all four.  ``time.sleep`` polling is
banned in this package: every wait is an
``Event.wait`` against an absolute deadline, because a load generator
that drifts under load measures its own jitter, not the server's.
"""

from .evaluator import Evaluator, SLOMonitor  # noqa: F401
from .flightrec import FlightRecorder  # noqa: F401
from .loadgen import (LoadGenerator, constant_schedule,  # noqa: F401
                      poisson_schedule)
from .spec import Objective, SLOSpec, demo_spec, load_spec  # noqa: F401
