"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``benchmark/``
and the program, ``nnstreamer_tpu_torch``, on a host with the cards the
cell asks for.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a traced part of the window.  The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device`` (with ``--trace 1``
also ``breakdown``) and, last, ``checks``: every number compared with its
limit, which also close standard error.

Exit codes: 0 with a result; 2 without the cards the cell needs; 3 when
the process holds JAX or the JAX package once the window has closed; 1
on any other failure.  No result is printed unless the code is 0.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import spec as bench_spec  # noqa: E402
from . import trace as bench_trace  # noqa: E402

#: top-level modules no process of the benchmark may hold: JAX and the
#: JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "nnstreamer_tpu")
#: kernel caches of the program, at fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton",
              "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}
DRIVERS = {"label_stream": "label", "train_stream": "train"}


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    each module's name compared whole up to its first dot."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def run_cell(bench: bench_spec.Benchmark, name: str, seed: int,
             seconds: float, traced: bool, device: str = "cuda",
             started: float = None) -> dict:
    """One run of cell ``name``: the driver's outcome with the cell's
    metrics read (``metrics``)."""
    import importlib

    cell = bench.cell(name)
    driver = importlib.import_module(
        f"benchmark.{DRIVERS[cell['traffic']['kind']]}")
    out = driver.run(cell, seed, seconds, traced, device,
                     STARTED if started is None else started)
    if not traced:
        out["metrics"] = {m["name"]: {"value": out["end_to_end"][m["name"]],
                                      "unit": m["unit"]}
                          for m in bench.end_to_end(name)}
        return out
    window = dict(out["window"], cell=cell["name"], config=cell["config"],
                  traffic=cell["traffic"])
    out["metrics"] = {}
    for m in bench.per_layer(name):
        value = bench.reader(m["name"])(window)
        if value is not None:
            out["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = bench_spec.Benchmark()
    chips = bench.cell(args.workload)["chips"]
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(bench.base, "_cache", sub)
    if args.trace:
        bench_trace.configure_environment()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {args.workload} needs {chips} CUDA "
              f"device(s); this host has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.zeros(1, device="cuda")
    cuda_s = time.perf_counter() - STARTED
    if args.trace:
        bench_trace.prepare()
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace))
    held = forbidden_modules()
    if held:
        print(f"benchmark: the process holds {', '.join(held)}",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"],
              "device": device}
    if args.trace:
        device.update(busy_s=out["window"]["busy_s"],
                      window_s=out["window"]["window_s"])
        result["breakdown"] = out["window"]["breakdown"]
    result["setup_phases"] = dict(cuda=cuda_s, **out["setup_phases"])
    for extra in ("worst_leaves", "uncompared"):
        if extra in out:
            result[extra] = out[extra]
    result["checks"] = out["checks"]
    for n, row in out["checks"].items():
        print(f"check {n} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
