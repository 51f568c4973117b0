"""The micro-batching filter's lock order: ``filter.coalesce`` (rank 30)
must never be held while the planner's lock (rank 10) is taken.

A ``tensor_filter batch=N batch-timeout-ms=T`` pushes its batches while
holding its coalesce lock (stream order is the lock order), and the
first push into a fused run compiles the run under the planner lock.
The port builds that run before it takes the coalesce lock
(``SegmentPlanner.prepare``); the JAX package compiles at the push.

- ``tests/test_torch_batch.py`` under ``NNS_DEBUG=1`` in a fresh process
  (so every lock is instrumented from import on): every case passes and
  the port's sanitizer reports nothing;
- one deadline-flushed string through both packages under ``NNS_DEBUG=1``:
  the port is clean, the JAX package's sanitizer reports the inversion (a
  reference fault; the JAX code is not edited).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = dict(os.environ, NNS_DEBUG="1", JAX_PLATFORMS="cpu", PYTHONPATH=REPO)

BATCH_CHILD = """
import json, sys
import pytest
rc = pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                  "-p", "no:xdist", %r])
from nnstreamer_tpu_torch.analysis import sanitizer
print(json.dumps({"rc": int(rc),
                  "findings": [f.message for f in sanitizer.findings()]}))
"""

DEADLINE_CHILD = """
import json, time
import numpy as np
import nnstreamer_tpu, nnstreamer_tpu_torch
from nnstreamer_tpu.analysis import sanitizer as jax_sanitizer
from nnstreamer_tpu_torch.analysis import sanitizer

CAPS = ("other/tensors,format=static,num_tensors=1,dimensions=8,"
        "types=float32,framerate=0/1")


def run(pkg, accel):
    p = pkg.parse_launch(
        f"appsrc name=in caps={CAPS} ! tensor_filter framework=xla "
        "model=mlp custom=in_dim:8,width:16,depth:1,out_dim:4,dtype:float32 "
        f"{accel} batch=4 batch-timeout-ms=30 name=f ! tensor_sink name=out")
    got = []
    p.get("out").connect("new-data", lambda b: got.append(b))
    p.play()
    src = p.get("in")
    for i in range(2):         # fewer than a bucket: the deadline flushes
        src.push_buffer(pkg.TensorBuffer(
            tensors=[np.full(8, i, np.float32)], pts=i))
    t0 = time.monotonic()
    while len(got) < 2 and time.monotonic() - t0 < 60:
        time.sleep(0.01)
    src.end_of_stream()
    p.wait(timeout=60)
    p.stop()
    return len(got)


n_port = run(nnstreamer_tpu_torch, "accelerator=true:cpu")
n_jax = run(nnstreamer_tpu, "")
print(json.dumps({"frames": [n_port, n_jax],
                  "torch": [f.message for f in sanitizer.findings()],
                  "jax": [f.message for f in jax_sanitizer.findings()]}))
"""


def _child(code):
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=REPO, env=ENV)
    assert r.returncode == 0, (r.stdout[-2000:], r.stderr[-2000:])
    return json.loads(r.stdout.splitlines()[-1])


def test_batching_cases_run_clean_under_the_sanitizer():
    got = _child(BATCH_CHILD % os.path.join(REPO, "tests",
                                            "test_torch_batch.py"))
    assert got["rc"] == 0
    assert got["findings"] == [], got["findings"]


def test_deadline_flush_inversion_is_a_reference_fault():
    got = _child(DEADLINE_CHILD)
    assert got["frames"] == [2, 2]
    assert got["torch"] == [], got["torch"]
    assert any("'planner' (rank 10) while holding 'filter.coalesce'" in m
               for m in got["jax"]), got["jax"]
