#!/usr/bin/env python3
"""K2, K3 and K4 (the port's flash-attention kernels) of several checkouts
of the port, timed against each other in turns on one CUDA card.

    python3 tools/torch_flash_turns.py --rows lm,lm_train,lm_wide \\
        PARENT CHANGE CHANGE PARENT

Each positional argument is the root of a checkout that holds
``nnstreamer_tpu_torch``.  Each runs in a child process of its own, in the
order given, so two versions are compared on one card within one call
(give them as parent, change, change, parent).  A child builds that
checkout's kernels, then, at each named row of ``chip_smoke.FLASH_ROWS``
of the checkout this script is in, calls its ``flash_attention`` (K2) and,
where ``chip_smoke.BWD_ROWS`` has the row too, its backward kernels (K3
and K4, on that K2's out and lse), on inputs made from a seed, and times
each with ``chip_smoke.time_ms`` (CUDA events, calls queued behind a spin
on the card).  It prints one JSON line a row: the root, the row, the
card's name and power limit, and the median ms of each kernel, or the
error that checkout raised at that row.  With ``--sass`` a child first
prints one JSON line of the SASS instruction count of each tensor-core
K2/K3/K4 function of its build (``cuobjdump -sass``), so two checkouts'
code can be compared kernel by kernel.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_rows", os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def sass_counts(paths) -> dict:
    """Instructions of each tensor-core flash kernel function in the
    libraries at ``paths``, from ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    counts, func = {}, None
    for path in paths:
        text = subprocess.run([tool, "-sass", path], capture_output=True,
                              text=True, check=True).stdout
        for line in text.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                # the kernel's name and arguments, without the anonymous
                # namespace's tag (it differs between checkouts)
                k = re.search(r"\d(flash_(?:forward|bwd)_\w+)", m.group(1))
                func = k.group(1) if k and "_tc" in k.group(1) else None
                counts.setdefault(func, 0)
            elif func and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
                counts[func] += 1
    counts.pop(None, None)
    return counts


def child(root: str, names, reps: int, sass: bool) -> int:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from nnstreamer_tpu_torch import _cuda
    from nnstreamer_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv, flash_attention_bwd_dq)

    smoke = _smoke()
    card = smoke.card_line()
    libs = _cuda.build(["flash_attention", "flash_attention_bwd"])
    if sass:
        print(json.dumps({"root": root, "card": card,
                          "sass": sass_counts(libs.values())}), flush=True)
    rows = {r[0]: r for r in smoke.FLASH_ROWS}
    bwd = {r[0] for r in smoke.BWD_ROWS}
    gen = torch.Generator().manual_seed(1)
    for name in names:
        _, b, tq, tkv, h, d, causal, dt, qo, ko = rows[name]
        lead = () if b is None else (b,)
        q, k, v, g = (torch.randn(*lead, t, h, d, generator=gen)
                      .to("cuda", getattr(torch, dt))
                      for t in (tq, tkv, tkv, tq))
        kw = dict(causal=causal, q_offset=qo, k_offset=ko)
        out = {"root": root, "row": name, "card": card}
        try:
            out["k2_ms"] = smoke.time_ms(
                lambda: flash_attention(q, k, v, **kw), reps)
            if name in bwd:
                o, lse = flash_attention(q, k, v, return_lse=True, **kw)
                delta = (g.float() * o.float()).sum(-1).transpose(-1, -2)
                args = (q, k, v, g, lse, delta)
                out["k3_ms"] = smoke.time_ms(
                    lambda: flash_attention_bwd_dq(*args, **kw), reps)
                out["k4_ms"] = smoke.time_ms(
                    lambda: flash_attention_bwd_dkv(*args, **kw), reps)
        except (ValueError, RuntimeError) as exc:
            out["error"] = str(exc)
        print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", required=True,
                    help="comma-separated names of chip_smoke.FLASH_ROWS")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--sass", action="store_true",
                    help="print each tensor-core kernel's SASS count")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="*")
    args = ap.parse_args(argv)
    names = args.rows.split(",")
    if args.child:
        return child(args.child, names, args.reps, args.sass)
    rc = 0
    for root in args.roots:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--rows", args.rows, "--reps", str(args.reps),
                              *(["--sass"] if args.sass else []),
                              "--child", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
