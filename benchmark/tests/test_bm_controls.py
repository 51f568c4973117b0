"""The controls of ``correct`` fail the cells' limits: the reference put
in the program's place one precision below (float8 for the bf16 the
configurations state), and the half-batch fault of the training cell.
At each cell's own size on the card; the mechanics on the CPU at a tiny
size."""

from __future__ import annotations

import pytest

from benchmark import controls
from benchmark import spec as bench_spec

#: the cells and the held labeling cells
BENCH = bench_spec.Benchmark(held=True)
SEEDS = (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13)


def _fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in numbers.items() if k in limits)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH.doc["workloads"]])
def test_control_fails_the_cell_on_the_card(card, cell):
    c = BENCH.cell(cell)
    train = c["traffic"]["kind"] == "train_stream"
    for seed in SEEDS:
        got = (controls.train_readings if train else
               controls.label_readings)(c, seed, card)
        assert _fails(got["fp8"], c["limits"]) or (
            train and _fails(got["half_batch"], c["limits"])), (seed, got)


@pytest.mark.parametrize("cell", ["vit-tiny", "vit-tiny-train"])
def test_controls_read_every_compared_number(tiny, cell):
    c = tiny.cell(cell)
    train = c["traffic"]["kind"] == "train_stream"
    got = (controls.train_readings if train else
           controls.label_readings)(c, 5, "cpu")
    for control in ("fp8", "bf16") + (("half_batch",) if train else ()):
        compared = {k for k in c["limits"] if "gap" in k}
        assert compared <= set(got[control])
        assert all(v >= 0 for v in got[control].values())
