"""The import guard: a run fails when its process holds JAX or the JAX
package, compared by each module's whole top-level name."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import run
from benchmark import spec as bench_spec


@pytest.mark.parametrize("modules, held", [
    (["nnstreamer_tpu_torch", "nnstreamer_tpu_torch.ops.preprocess",
      "torch", "flaxen", "jaxtyping"], []),
    (["nnstreamer_tpu.ops.preprocess"], ["nnstreamer_tpu"]),
    (["jax.numpy", "jaxlib"], ["jax", "jaxlib"]),
    (["flax.linen", "orbax.checkpoint"], ["flax", "orbax"]),
])
def test_top_level_names_are_compared_whole(modules, held):
    assert run.forbidden_modules(modules) == held


def test_a_run_imports_nothing_forbidden():
    """Everything a run of each kind of cell imports, in a fresh process."""
    code = ("import json, sys\n"
            "import benchmark.run, benchmark.label, benchmark.train\n"
            "import benchmark.controls, benchmark.flops\n"
            "from nnstreamer_tpu_torch import parse_launch\n"
            "from nnstreamer_tpu_torch.parallel.vision_train import "
            "make_vision_train_step\n"
            "import nnstreamer_tpu_torch.elements, "
            "nnstreamer_tpu_torch.filter.backends.xla\n"
            "from nnstreamer_tpu_torch.models.registry import get_model\n"
            "get_model('mobilenet_v2', {'input_size': '32'}, 'cpu')\n"
            "print(json.dumps(benchmark.run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=bench_spec.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_a_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "vit-train-b32", "--seed", str(2 ** 31 + 7), "--seconds", "1"],
        cwd=bench_spec.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": "/tmp"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
