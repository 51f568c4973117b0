"""Fixtures of the benchmark's tests: a copy of the benchmark with tiny
cells that the CPU runs in seconds, and the card for the tests that need
one (decided here, never at import)."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from benchmark import spec as bench_spec

#: tiny cells: (cell, config, traffic, base config, overrides, custom)
TINY = {
    "mnv2-tiny": ("mnv2-tiny", "label-b32", "mobilenet_v2-1.0-224",
                  {"image_size": 32},
                  "num_classes:1001,input_size:32,use_pallas:1"),
    "vit-tiny": ("vit-tiny", "label-b32", "vit-s16-224",
                 {"hidden_size": 32, "num_hidden_layers": 2,
                  "num_attention_heads": 2, "intermediate_size": 128,
                  "patch_size": 8, "image_size": 32, "num_classes": 10},
                 "dim:32,depth:2,heads:2,patch:8,input_size:32,"
                 "num_classes:10"),
}
TINY["vit-tiny-train"] = ("vit-tiny", "train-b32") + TINY["vit-tiny"][2:]


def copy_benchmark(dest: str, held: bool = False) -> str:
    """A copy of BENCHMARK.json and benchmark/ under ``dest``; with
    ``held``, the held cells' entries moved into its BENCHMARK.json."""
    shutil.copy(os.path.join(bench_spec.ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(bench_spec.HERE, os.path.join(dest, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    if held:
        doc = bench_spec.Benchmark(held=True).doc
        with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
            json.dump(doc, f)
    return dest


def add_cell(root: str, cell: str, config: str, traffic: str, base: str,
             overrides: dict, custom: str) -> None:
    """Add a cell to the copy at ``root`` by adding files and entries only:
    its configuration (``base`` with ``overrides``), its limits (those of
    the first cell of the same traffic) and its BENCHMARK.json entries."""
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", f"{base}.json")) as f:
        cfg = json.load(f)
    cfg.update(overrides)
    cfg["program"] = dict(cfg["program"], custom=custom)
    with open(os.path.join(b, "configs", f"{config}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        doc = json.load(f)
    like = next(w for w in doc["workloads"] if w["traffic"] == traffic)
    shutil.copy(os.path.join(b, "workloads", f"{like['name']}.json"),
                os.path.join(b, "workloads", f"{cell}.json"))
    if not any(c["name"] == config for c in doc["configs"]):
        doc["configs"].append({"name": config, "source": "test",
                               "file": f"benchmark/configs/{config}.json",
                               "reduced": [], "why": "test"})
    doc["workloads"].append({"name": cell, "config": config,
                             "traffic": traffic, "chips": 1, "why": "test"})
    for m in doc["end_to_end"] + doc["per_layer"]:
        if like["name"] in m.get("workloads", []):
            m["workloads"].append(cell)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(doc, f)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory) -> bench_spec.Benchmark:
    root = copy_benchmark(str(tmp_path_factory.mktemp("bench")), held=True)
    for cell, args in TINY.items():
        add_cell(root, cell, *args)
    return bench_spec.Benchmark(root=root)


@pytest.fixture
def card():
    """The card, or a skip where the host has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark measures on the "
                    "card only)")
    return "cuda"
