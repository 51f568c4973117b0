"""Everything a run reads, found by name.

``BENCHMARK.json`` at the checkout's root names the cells, their
configurations and traffic mixes, and the metrics.  Each of those has
files of its own under ``benchmark/``, found by its name alone, so a
later change adds a cell, a configuration, a traffic mix or a per-layer
metric by adding files and entries:

- ``configs/<config>.json``: the model's sizes as run, its source and the
  program's model (``reference`` names the plain model under
  ``reference/``);
- ``traffic/<traffic>.json``: the mix's parameters, read by the driver its
  ``kind`` names (``label_stream``, ``train_stream``);
- ``workloads/<cell>.json``: the cell's correctness limits;
- ``metrics/<metric>.py``: a per-layer metric's reader, ``read(window)``;
- ``held/<name>.json``: entries of ``BENCHMARK.json``'s lists (configs,
  cells, metrics) that the benchmark has built but holds out of it, with
  the files they name; a later change adds a held cell back by moving its
  entries into ``BENCHMARK.json``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

#: state of a model that no optimizer trains (BatchNorm's statistics)
_FROZEN = ("running_mean", "running_var", "num_batches_tracked")


def trainable(name: str) -> bool:
    return not name.endswith(_FROZEN)


class Benchmark:
    """``BENCHMARK.json`` and the benchmark's files under ``base`` (the
    checkout's ``benchmark/``, or a copy of it in the tests); with
    ``held``, the held entries too (``held/``: the tests run those cells
    at a tiny size)."""

    def __init__(self, root: str = ROOT, base: Optional[str] = None,
                 held: bool = False) -> None:
        self.root = root
        self.base = base or os.path.join(root, "benchmark")
        with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
            self.doc = json.load(f)
        if held:
            self.doc = with_held(self.doc, self.base)

    def _json(self, kind: str, name: str) -> dict:
        with open(os.path.join(self.base, kind, f"{name}.json"),
                  encoding="utf-8") as f:
            return json.load(f)

    def cell(self, name: str) -> dict:
        """The cell's ``workloads`` entry with its files loaded:
        ``config``, ``traffic`` and ``limits``."""
        entry = next((w for w in self.doc["workloads"] if w["name"] == name),
                     None)
        if entry is None:
            known = sorted(w["name"] for w in self.doc["workloads"])
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; known: "
                           f"{known}")
        config = self._json("configs", entry["config"])
        config["name"] = entry["config"]
        config["base"] = self.base
        return {"name": name, "chips": int(entry["chips"]), "config": config,
                "traffic": self._json("traffic", entry["traffic"]),
                "limits": self._json("workloads", name)["limits"]}

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.doc["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics this cell reports: those that list it,
        and those without a list whose end-to-end metric it reports."""
        moved = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.doc["per_layer"]
                if cell in m.get("workloads", [])
                or ("workloads" not in m and m["moves"] in moved)]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        return load_module(os.path.join(self.base, "metrics",
                                        f"{metric}.py")).read


def with_held(doc: dict, base: str) -> dict:
    """``doc`` with the entries of every file under ``base``'s ``held/``
    appended to its lists."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in doc.items()}
    folder = os.path.join(base, "held")
    for name in sorted(os.listdir(folder)) if os.path.isdir(folder) else ():
        with open(os.path.join(folder, name), encoding="utf-8") as f:
            for kind, entries in json.load(f).items():
                out[kind] = out[kind] + entries
    return out


def load_module(path: str):
    """The Python file at ``path`` as a module (metric and reference file
    names need not be identifiers)."""
    name = "benchmark_file_" + "".join(
        c if c.isalnum() else "_" for c in os.path.relpath(path, ROOT))
    mod = sys.modules.get(name)
    if mod is not None and getattr(mod, "__file__", None) == path:
        return mod
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def reference(config: dict):
    """The configuration's plain reference model (``reference/<name>.py``)."""
    base = config.get("base", HERE)
    return load_module(os.path.join(base, "reference",
                                    f"{config['reference']}.py"))


def parse_custom(custom: str) -> Dict[str, str]:
    """A filter's ``custom=`` string, ``key:value,...``, as a mapping."""
    pairs = (part.partition(":") for part in custom.split(",") if part)
    return {k.strip(): v.strip() for k, _, v in pairs}
