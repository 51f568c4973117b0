"""BENCHMARK.json keeps to its contract, and every cell, configuration,
traffic mix and per-layer metric it names resolves to files of its own
by name; a cell is added by adding files and entries alone."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import spec as bench_spec
from benchmark.tests.conftest import TINY, add_cell, copy_benchmark

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = bench_spec.Benchmark()
DOC = BENCH.doc
CELLS = [w["name"] for w in DOC["workloads"]]


def test_top_level_keys_and_sizes():
    assert set(DOC) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= DOC["run_seconds"] <= 51
    assert DOC["paths"] == ["benchmark"]
    assert len(json.dumps(DOC)) < 64 * 1024
    assert all(not w.startswith("/") and ".." not in w
               for w in DOC["command"])


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in DOC[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_keep_to_the_contract():
    for m in DOC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and "workloads" not in m
               for m in DOC["end_to_end"])
    for m in DOC["end_to_end"] + DOC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in DOC["end_to_end"]}
    for m in DOC["per_layer"]:
        assert m["moves"] in e2e and 1 <= len(m["layer"]) <= 200
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in BENCH.end_to_end(cell)}


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_name(cell, bench=BENCH):
    c = bench.cell(cell)
    assert c["chips"] == 1
    assert c["traffic"]["kind"] in ("label_stream", "train_stream")
    ref = bench_spec.reference(c["config"])
    assert ref.spec(c["config"])
    names = {m["name"] for m in bench.end_to_end(cell)}
    assert "setup_s" in names and len(names) >= 2
    assert bench.per_layer(cell)
    for m in bench.per_layer(cell):
        assert callable(bench.reader(m["name"]))
    assert set(c["limits"]) >= {"label_gap_mean", "unanswered"} or set(
        c["limits"]) >= {"loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("entry", DOC["configs"], ids=lambda e: e["name"])
def test_every_config_file_is_used_and_lies_under_paths(entry, doc=DOC):
    assert entry["file"] == f"benchmark/configs/{entry['name']}.json"
    assert os.path.exists(os.path.join(bench_spec.ROOT, entry["file"]))
    assert any(w["config"] == entry["name"] for w in doc["workloads"])
    with open(os.path.join(bench_spec.ROOT, entry["file"])) as f:
        assert json.load(f)["reduced"] == entry["reduced"] == []


def test_a_cell_is_added_by_files_alone(tmp_path):
    root = copy_benchmark(str(tmp_path))
    before = {p: open(p, "rb").read()
              for p in _files(os.path.join(root, "benchmark"))}
    add_cell(root, "vit-tiny-train", *TINY["vit-tiny-train"])
    metric = os.path.join(root, "benchmark", "metrics", "steps_seen.py")
    with open(metric, "w") as f:
        f.write("def read(window):\n    return window.get('units')\n")
    for p, data in before.items():
        assert open(p, "rb").read() == data, f"{p} was edited"
    bench = bench_spec.Benchmark(root=root)
    cell = bench.cell("vit-tiny-train")
    assert cell["config"]["image_size"] == 32
    assert "train_samples_per_s" in {m["name"] for m in bench.end_to_end(
        "vit-tiny-train")}
    assert bench.reader("steps_seen")({"units": 7}) == 7


def test_a_held_cell_comes_back_by_its_entries_alone():
    """The held labeling cells resolve once their entries are moved into
    BENCHMARK.json, with every file they name already there."""
    held = bench_spec.Benchmark(held=True)
    names = {w["name"] for w in held.doc["workloads"]} - set(CELLS)
    assert names == {"mnv2-label-b32", "vit-label-b32"}
    for cell in names:
        test_every_cell_resolves_by_name(cell, held)
    for entry in held.doc["configs"]:
        test_every_config_file_is_used_and_lies_under_paths(entry, held.doc)


def _files(top):
    for d, _, fs in os.walk(top):
        for f in fs:
            if "__pycache__" not in d:
                yield os.path.join(d, f)


@pytest.mark.parametrize("config, params", [("mobilenet_v2-1.0-224",
                                             3_506_153),
                                            ("vit-s16-224", 22_050_664)])
def test_references_have_the_published_parameter_counts(config, params):
    """MobileNetV2 1.0-224: torchvision's 3,504,872 at 1000 classes and
    1,281 more for the TF-slim checkpoint's 1001; ViT-S/16 as DeiT-S and
    timm's ``vit_small_patch16_224``: 22,050,664."""
    held = bench_spec.Benchmark(held=True)
    cfg = dict(held.cell(next(w["name"] for w in held.doc["workloads"]
                              if w["config"] == config))["config"])
    total = sum(_numel(shape) for name, shape, _ in
                bench_spec.reference(cfg).spec(cfg)
                if bench_spec.trainable(name))
    assert total == params


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n
