"""Command-line pipeline launcher (gst-launch-1.0 role) and element
inspector (gst-inspect-1.0 role) of the port.

Usage::

    python -m nnstreamer_tpu_torch.launch "videotestsrc num-buffers=10 ! \
        video/x-raw,format=RGB,width=224,height=224 ! tensor_converter ! \
        tensor_filter framework=xla model=mobilenet_v2 ! \
        tensor_decoder mode=image_labeling ! tensor_sink name=out" \
        [--timeout SECONDS] [--print-sink NAME]

    python -m nnstreamer_tpu_torch.launch --inspect          # all factories
    python -m nnstreamer_tpu_torch.launch --inspect tensor_filter

The port of ``nnstreamer_tpu/launch.py``.  The options that need a module
the port does not have yet exit with code 2 and name that module
(:data:`UNPORTED`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

#: option -> the module of the JAX package it waits for
UNPORTED = {
    "--check": "analysis/verify.py",
    "--jit": "analysis/jitaudit.py",
    "--profile": "obs/profile.py",
    "--metrics-port": "obs/httpd.py",
    "--push-metrics": "obs/federation.py",
    "--top": "obs/dashboard.py",
    "--soak": "slo/",
    "--slo": "slo/",
}
#: unported options that take a value
_WITH_VALUE = ("--metrics-port", "--push-metrics", "--soak", "--slo")


def inspect(name=None, out=None) -> int:
    """List element factories, or one factory's properties."""
    import inspect as _inspect

    out = out or sys.stdout
    from .pipeline.registry import element_factory, list_factories

    if name:
        try:
            cls = element_factory(name)
        except KeyError as e:
            print(f"ERROR: {e}", file=sys.stderr)
            return 1
        doc = _inspect.cleandoc(cls.__doc__) if cls.__doc__ else ""
        print(f"Factory: {name}\n", file=out)
        if doc:
            print(doc + "\n", file=out)
        # element props first, then the universal ones every element
        # inherits (gst-inspect lists inherited GObject props too)
        props = dict(getattr(cls, "PROPERTIES", {}))
        props.update({k: v for k, v in
                      getattr(cls, "UNIVERSAL_PROPERTIES", {}).items()
                      if k not in props})
        if props:
            print("Properties:", file=out)
            for key, spec in sorted(props.items()):
                default, desc = (spec if isinstance(spec, tuple)
                                 else (spec, ""))
                print(f"  {key:<24} default={default!r}  {desc}", file=out)
        return 0
    for fac in sorted(list_factories()):
        cls = element_factory(fac)
        first = (cls.__doc__ or "").strip().partition("\n")[0]
        print(f"{fac:<24} {first}", file=out)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nns-torch-launch",
                                 description="Run a pipeline description")
    ap.add_argument("pipeline", nargs="?", help="pipeline launch string")
    ap.add_argument("--inspect", nargs="?", const="", default=None,
                    metavar="FACTORY",
                    help="list element factories (or one factory's "
                         "properties) instead of running a pipeline")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--print-sink", default=None,
                    help="tensor_sink name whose outputs to print")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--stats", action="store_true",
                    help="print the pipeline LATENCY query result at EOS "
                         "(per-element invoke latency contributions)")
    ap.add_argument("--trace", action="store_true",
                    help="record per-element proctime/framerate (GstShark "
                         "tracer role) and print the report at EOS "
                         "(p50/p95/p99 latency percentiles, source-to-"
                         "element interlatency, the query layer's "
                         "resilience counters and the metrics snapshot)")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="write the --trace report as JSON to FILE "
                         "(implies tracing)")
    ap.add_argument("--timeline", default=None, metavar="FILE",
                    help="record per-buffer timeline spans and write a "
                         "Chrome trace_event JSON to FILE at EOS (spans "
                         "a tensor_query server sends back merge in under "
                         "their own process row)")
    ap.add_argument("--drain-grace", type=float, default=5.0,
                    metavar="SECONDS",
                    help="graceful-drain budget for SIGTERM: serving "
                         "elements shed new requests with retry-after "
                         "and finish in-flight replies, then the process "
                         "exits 0 (Pipeline.drain)")
    ap.add_argument("--fuse", default=None,
                    choices=["interpret", "python", "xla"],
                    help="segment-compiler lowering tier "
                         "(pipeline/schedule.py): 'interpret' = per-pad "
                         "dispatch, 'python' = fused plan_step loops "
                         "(default), 'xla' = one CUDA graph a lowerable "
                         "segment, double-buffered (segments with a "
                         "non-lowerable step run python).  Same as "
                         "NNS_FUSE=0|1|xla")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable the segment compiler: interpreted "
                         "per-pad dispatch; same as --fuse interpret")
    for opt, module in UNPORTED.items():
        kw = ({"nargs": "?", "const": True} if opt in _WITH_VALUE
              else {"action": "store_true"})
        ap.add_argument(opt, dest="unported_" + opt[2:].replace("-", "_"),
                        help=f"not ported yet (waits for {module})", **kw)
    args = ap.parse_args(argv)

    for opt, module in UNPORTED.items():
        if getattr(args, "unported_" + opt[2:].replace("-", "_")) not in (
                None, False):
            print(f"ERROR: {opt} needs {module} of the JAX package, which "
                  "nnstreamer_tpu_torch does not have yet", file=sys.stderr)
            return 2
    if args.inspect is not None:
        return inspect(args.inspect or args.pipeline)
    if not args.pipeline:
        ap.error("pipeline launch string required (or use --inspect)")
    if args.no_fuse:
        args.fuse = "interpret"
    if args.fuse is not None:
        # through the env, so every pipeline this process builds inherits
        # the requested tier
        import os

        os.environ["NNS_FUSE"] = {"interpret": "0", "python": "1",
                                  "xla": "xla"}[args.fuse]

    from . import parse_launch

    t0 = time.time()
    try:
        p = parse_launch(args.pipeline)
        if args.print_sink:
            p.get(args.print_sink).connect("new-data", _print_buffer)
        if args.stats:
            for el in p.elements:
                if hasattr(el, "latency_report"):
                    el.latency_report = True
        tracer = (p.enable_tracing(spans=bool(args.timeline))
                  if args.trace or args.trace_out or args.timeline
                  else None)
        metrics = None
        _install_sigterm_drain(p, args.drain_grace)
        try:
            p.play()
            p.wait(args.timeout)
            if tracer is not None:
                # the LIVE registry before stop(): teardown unregisters
                # the elements' gauges
                from .obs.metrics import REGISTRY

                metrics = REGISTRY.report()
            if args.stats:
                total, per = p.query_latency()
                for name, ns in sorted(per.items()):
                    print(f"latency {name}: {ns / 1e6:.3f} ms",
                          file=sys.stderr)
                print(f"latency total: {total / 1e6:.3f} ms",
                      file=sys.stderr)
        finally:
            p.stop()
            if tracer is not None:
                # print even on timeout or error: bounded tracing of a
                # live pipeline is the --trace --timeout use
                _write_trace(tracer, metrics, args)
    except Exception as exc:  # noqa: BLE001 - the CLI's exit path
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"pipeline finished in {time.time() - t0:.2f}s",
              file=sys.stderr)
    return 0


def _write_trace(tracer, metrics, args) -> None:
    report = {"trace": tracer.report()}
    resilience = tracer.resilience_report()
    if resilience:
        # retry/failure/breaker/heartbeat counters of this run
        report["resilience"] = resilience
    if metrics is None:   # error or timeout: the post-stop view
        from .obs.metrics import REGISTRY

        metrics = REGISTRY.report()
    if metrics:
        report["metrics"] = metrics
    if args.timeline:
        tracer.export_chrome(args.timeline)
        print(f"timeline written to {args.timeline}", file=sys.stderr)
    if args.trace_out:
        with open(args.trace_out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    if args.trace:
        print(json.dumps(report, indent=2), file=sys.stderr)


def _install_sigterm_drain(pipeline, grace_s: float) -> None:
    """SIGTERM -> graceful drain: serving elements answer new requests
    with explicit sheds while in-flight replies finish, then the process
    exits 0 (clients see retry-after hints, never mid-reply resets)."""
    import signal

    fired = []

    def _on_term(signum, frame):
        if fired:           # re-delivery while the first drain unwinds
            raise SystemExit(0)
        fired.append(signum)
        print(f"SIGTERM: draining pipeline (grace {grace_s:.1f}s)...",
              file=sys.stderr)
        try:
            pipeline.drain(grace_s)
        finally:
            raise SystemExit(0)

    try:
        signal.signal(signal.SIGTERM, _on_term)
    except ValueError:
        pass    # not the main thread (embedded use): caller owns signals


def _print_buffer(buf) -> None:
    desc = buf.extra.get("label")
    if desc is None:
        desc = ", ".join(str(getattr(t, "shape", "?")) for t in buf.tensors)
    print(f"pts={buf.pts} {desc}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
