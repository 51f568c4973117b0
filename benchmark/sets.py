"""Run cells several times, one process a run, and summarise the runs:
the tool behind the measurements that set the benchmark's bounds and
limits.

    python3 -m benchmark.sets --cell vit-label-b32 --seeds 11 12 13 \\
        --seconds 10 [--trace 0 1] [--sets 2] [--out DIR]

runs every seed of the list in each set (the sets share their seeds), in
order, for each trace flag; keeps each run's standard output and error
under ``--out``; and prints one JSON line a run and, for every metric,
the spread of each set: the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) over the median.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def spread(values):
    """(median, interquartile distance over the median)."""
    if len(values) < 2:
        return (values[0] if values else float("nan")), float("nan")
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / abs(med)


def one(cell: str, seed: int, seconds: float, traced: int, out: str,
        timeout: float) -> dict:
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", cell,
           "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(traced)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as exc:
        rc, stdout, stderr = 124, exc.stdout or "", exc.stderr or ""
        stdout = stdout if isinstance(stdout, str) else stdout.decode()
        stderr = stderr if isinstance(stderr, str) else stderr.decode()
    wall = time.perf_counter() - t0
    tag = f"{cell}-s{seed}-t{traced}-{int(time.time() * 1000)}"
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, tag + ".out"), "w") as f:
        f.write(stdout)
    with open(os.path.join(out, tag + ".err"), "w") as f:
        f.write(stderr)
    row = {"cell": cell, "seed": seed, "trace": traced, "rc": rc,
           "wall_s": wall}
    lines = stdout.strip().splitlines()
    try:
        row.update(json.loads(lines[-1]))
    except (IndexError, ValueError):
        row["stderr_tail"] = stderr[-1500:]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.sets")
    ap.add_argument("--cell", action="append", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--trace", type=int, nargs="+", default=[0])
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--timeout", type=float, default=1300)
    ap.add_argument("--out", default="chiprun_out/runs")
    args = ap.parse_args(argv)
    for cell in args.cell:
        for traced in args.trace:
            sets = []
            for _ in range(args.sets):
                rows = []
                for seed in args.seeds:
                    row = one(cell, seed, args.seconds, traced, args.out,
                              args.timeout)
                    print(json.dumps(row), flush=True)
                    rows.append(row)
                sets.append(rows)
            names = sorted({m for rows in sets for r in rows
                            for m in r.get("metrics", {})})
            for m in names:
                summary = []
                for rows in sets:
                    vals = [r["metrics"][m]["value"] for r in rows
                            if m in r.get("metrics", {})]
                    med, sp = spread(vals)
                    summary.append({"median": med, "spread": sp,
                                    "values": vals})
                print(json.dumps({"cell": cell, "trace": traced,
                                  "metric": m, "sets": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
