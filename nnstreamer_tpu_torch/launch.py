"""Command-line pipeline launcher (gst-launch-1.0 role) and element
inspector (gst-inspect-1.0 role) of the port.

Usage::

    python -m nnstreamer_tpu_torch.launch "videotestsrc num-buffers=10 ! \
        video/x-raw,format=RGB,width=224,height=224 ! tensor_converter ! \
        tensor_filter framework=xla model=mobilenet_v2 ! \
        tensor_decoder mode=image_labeling ! tensor_sink name=out" \
        [--timeout SECONDS] [--print-sink NAME] [--check] [--profile] \
        [--metrics-port PORT] [--push-metrics HOST:PORT] [--top] \
        [--soak SECONDS] [--slo FILE|demo]
    python -m nnstreamer_tpu_torch.launch --check --jit   # capture audit

    python -m nnstreamer_tpu_torch.launch --inspect          # all factories
    python -m nnstreamer_tpu_torch.launch --inspect tensor_filter

The port of ``nnstreamer_tpu/launch.py``, with its options and exit
codes: 1 for errors (``--check`` and ``--check --jit`` findings
included), 3 for an SLO FAIL.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

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
    ap.add_argument("--check", action="store_true",
                    help="statically verify the pipeline graph (or a "
                         "fleet config .json) and exit without playing: "
                         "caps dead-ends, deadlock cycles, dead branches "
                         "and scheduler misconfigurations are reported "
                         "with element paths (analysis/verify.py); exit "
                         "1 on errors")
    ap.add_argument("--jit", action="store_true",
                    help="with --check: also run the static graph-capture "
                         "boundary audit (analysis/jitaudit.py) over the "
                         "package — unquantized shapes at capture "
                         "signatures, out-of-place pool updates, host "
                         "syncs and tensor-value branches in the capture "
                         "call graph, unbounded cache keys — and print "
                         "the declared compile budgets; a pipeline string "
                         "is optional (audit-only mode); exit 1 on "
                         "findings")
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
    ap.add_argument("--profile", action="store_true",
                    help="utilization attribution profile: record "
                         "per-buffer spans, decompose every frame's "
                         "end-to-end wall time into wait states "
                         "(obs/attrib.py), print the blame table at EOS "
                         "and write profile.json, trace.json and "
                         "flame.folded under --profile-out; live nns_mfu "
                         "and occupancy gauges ride the metrics registry")
    ap.add_argument("--profile-out", default="profile", metavar="DIR",
                    help="artifact dir for --profile (default: ./profile)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve live Prometheus metrics on "
                         "127.0.0.1:PORT while the pipeline runs (GET "
                         "/metrics and /healthz; same effect as "
                         "NNS_METRICS_PORT; PORT 0 binds an ephemeral "
                         "port, exported as NNS_METRICS_BOUND_PORT)")
    ap.add_argument("--push-metrics", default=None, metavar="HOST:PORT",
                    help="telemetry federation (obs/federation.py): push "
                         "this process's metrics registry to a collector "
                         "as T_METRICS deltas every --push-interval "
                         "seconds")
    ap.add_argument("--push-interval", type=float, default=1.0,
                    metavar="SECONDS",
                    help="metrics push period for --push-metrics "
                         "(default 1.0)")
    ap.add_argument("--top", nargs="?", const=1.0, type=float,
                    default=None, metavar="INTERVAL",
                    help="live nns-top dashboard on stderr while the "
                         "pipeline runs (obs/dashboard.py), refreshed "
                         "every INTERVAL seconds (default 1.0) from an "
                         "in-process time-series ring")
    ap.add_argument("--soak", type=float, default=None, metavar="SECONDS",
                    help="soak mode: run the pipeline for SECONDS and "
                         "treat not-reaching-EOS as success; combine "
                         "with --slo to gate the run on burn-rate "
                         "objectives")
    ap.add_argument("--slo", default=None, metavar="FILE",
                    help="evaluate the run against an SLO spec JSON "
                         "(slo/spec.py; 'demo' uses the built-in demo "
                         "spec): verdict JSON on stderr at exit, exit "
                         "code 3 on FAIL; breaches dump flight-recorder "
                         "bundles")
    ap.add_argument("--slo-out", default="flightrec", metavar="DIR",
                    help="flight-recorder bundle dir for --slo breaches "
                         "(default: ./flightrec)")
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
                         "non-lowerable step run python; --check reports "
                         "them as xla-fallback warnings).  Same as "
                         "NNS_FUSE=0|1|xla")
    ap.add_argument("--no-fuse", action="store_true",
                    help="disable the segment compiler: interpreted "
                         "per-pad dispatch; same as --fuse interpret")
    args = ap.parse_args(argv)

    if args.inspect is not None:
        return inspect(args.inspect or args.pipeline)
    if not args.pipeline and not (args.check and args.jit):
        ap.error("pipeline launch string required (or use --inspect)")
    if args.no_fuse:
        args.fuse = "interpret"
    if args.fuse is not None:
        # through the env, so every pipeline this process builds (the
        # --check graph included) inherits the requested tier
        import os

        os.environ["NNS_FUSE"] = {"interpret": "0", "python": "1",
                                  "xla": "xla"}[args.fuse]
    if args.check:
        rc = check(args.pipeline) if args.pipeline else 0
        if args.jit:
            rc = max(rc, check_jit())
        return rc

    import os

    fleet_role = os.environ.get("NNS_FLEET_ROLE")
    if fleet_role:
        # fleet membership tag: rides the federated scrape so the
        # nns-top fleet view labels each origin
        from .obs.metrics import REGISTRY

        REGISTRY.gauge("nns_fleet_role", fn=lambda: 1.0,
                       role=str(fleet_role))

    from . import parse_launch

    t0 = time.time()
    slo_failed = False
    try:
        p = parse_launch(args.pipeline)
        if args.print_sink:
            p.get(args.print_sink).connect("new-data", _print_buffer)
        if args.stats:
            for el in p.elements:
                if hasattr(el, "latency_report"):
                    el.latency_report = True
        if args.metrics_port is not None:
            from .obs.httpd import start_metrics_server

            server = start_metrics_server(args.metrics_port)
            if not args.quiet:
                # where port 0 landed, for whoever scrapes this run
                print("metrics endpoint on http://127.0.0.1:"
                      f"{server.server_address[1]}/metrics",
                      file=sys.stderr, flush=True)
        want_trace = (args.trace or args.trace_out or args.timeline
                      or args.profile)
        tracer = (p.enable_tracing(spans=bool(args.timeline or args.profile))
                  if want_trace else None)
        profiler = None
        if args.profile:
            from .obs.profile import Profiler

            profiler = Profiler(p, tracer=tracer)
        plans = metrics = prof_report = None
        slo_monitor = slo_evaluator = recorder = None
        if args.slo:
            from .slo import Evaluator, FlightRecorder, SLOMonitor
            from .slo.spec import load_spec

            spec = load_spec(None if args.slo == "demo" else args.slo,
                             duration_s=args.soak or 60.0)
            recorder = FlightRecorder(args.slo_out, tracer=tracer)
            slo_evaluator = Evaluator(spec, on_breach=recorder.on_breach)
            slo_evaluator.on_tick = recorder.record
            slo_monitor = SLOMonitor(slo_evaluator)
        publisher = None
        if args.push_metrics:
            from .obs.federation import MetricsPublisher
            from .obs.httpd import health_report

            host, _, port = str(args.push_metrics).rpartition(":")
            if not port.isdigit():
                ap.error(f"--push-metrics {args.push_metrics!r}: "
                         "want HOST:PORT")
            publisher = MetricsPublisher(
                host or "127.0.0.1", int(port),
                interval_s=args.push_interval,
                health_fn=lambda: health_report()["state"])
        top_loop = top_sampler = top_ring = None
        if args.top is not None:
            from .obs.dashboard import RingSource, TopLoop
            from .obs.timeseries import RingSampler, TimeSeriesRing

            top_ring = TimeSeriesRing(interval_s=max(0.1, args.top))
            top_sampler = RingSampler(top_ring)
            # in-place redraw only on a real terminal: piped stderr gets
            # plain appended frames
            top_loop = TopLoop(RingSource(top_ring, label="launch"),
                               interval_s=max(0.1, args.top),
                               out=sys.stderr, ansi=sys.stderr.isatty())
        _install_sigterm_drain(p, args.drain_grace)
        try:
            p.play()
            if slo_monitor is not None:
                # breach bundles grow per-session token timelines when a
                # tensor_llm element records them (token-obs=1; its plane
                # exists only after start())
                recorder.session_obs = next(
                    (el._tok_obs for el in p.elements
                     if getattr(el, "_tok_obs", None) is not None), None)
                slo_monitor.start()
            if publisher is not None:
                publisher.start()
            if top_loop is not None:
                top_sampler.start()
                top_loop.start()
            if args.soak is not None:
                try:
                    _wait(p, args.soak)
                except TimeoutError:
                    pass    # soak: surviving until the deadline IS the
                    #         success condition; the SLO verdict judges
            else:
                _wait(p, args.timeout)
            if tracer is not None and p.planner is not None:
                plans = p.planner.plans()   # before stop() drops it
            if tracer is not None:
                # the LIVE registry before stop(): teardown unregisters
                # the elements' gauges
                from .obs.metrics import REGISTRY

                metrics = REGISTRY.report()
            if profiler is not None:
                # before stop(): nns_mfu and the device gauges unregister
                # at element teardown
                prof_report = profiler.report(metrics_report=metrics)
            if args.stats:
                total, per = p.query_latency()
                for name, ns in sorted(per.items()):
                    print(f"latency {name}: {ns / 1e6:.3f} ms",
                          file=sys.stderr)
                print(f"latency total: {total / 1e6:.3f} ms",
                      file=sys.stderr)
        finally:
            if top_loop is not None:
                top_loop.stop()
                top_sampler.stop(final_capture=False)
                top_ring.close()
            if publisher is not None:
                # final push BEFORE element teardown: the collector's
                # last view of this worker carries its closing counters
                publisher.stop(final_push=True)
            if slo_monitor is not None:
                # final tick BEFORE element teardown: the verdict sees
                # the run's last requests while gauges are live
                slo_monitor.stop(final_tick=True)
            p.stop()
            if slo_evaluator is not None:
                verdict = slo_evaluator.verdict()
                slo_failed = not verdict["pass"]
                print(json.dumps(verdict, indent=2), file=sys.stderr)
            if tracer is not None:
                # print even on timeout or error: bounded tracing of a
                # live pipeline is the --trace --timeout use
                _write_trace(tracer, metrics, plans, profiler, prof_report,
                             args)
    except Exception as exc:  # noqa: BLE001 - the CLI's exit path
        print(f"ERROR: {exc}", file=sys.stderr)
        return 1
    if not args.quiet:
        print(f"pipeline finished in {time.time() - t0:.2f}s",
              file=sys.stderr)
    return 3 if slo_failed else 0


def _write_trace(tracer, metrics, plans, profiler, prof_report,
                 args) -> None:
    report = {"trace": tracer.report()}
    if plans is not None:
        # which elements run fused, and where each segment pushes
        report["plan"] = plans
    resilience = tracer.resilience_report()
    if resilience:
        # retry/failure/breaker/heartbeat counters of this run
        report["resilience"] = resilience
    if metrics is None:   # error or timeout: the post-stop view
        from .obs.metrics import REGISTRY

        metrics = REGISTRY.report()
    if metrics:
        report["metrics"] = metrics
    if profiler is not None:
        import os

        os.makedirs(args.profile_out, exist_ok=True)
        if prof_report is None:   # error or timeout
            prof_report = profiler.report(metrics_report=metrics)
        report["attribution"] = prof_report["blame"]
        print(profiler.blame_table(prof_report), file=sys.stderr)
        with open(os.path.join(args.profile_out, "profile.json"), "w",
                  encoding="utf-8") as fh:
            json.dump({"pipeline": args.pipeline, "profile": prof_report,
                       "trace": report["trace"]}, fh, indent=2)
        profiler.export_chrome(os.path.join(args.profile_out, "trace.json"))
        profiler.export_folded(os.path.join(args.profile_out,
                                            "flame.folded"))
        profiler.close()
        print(f"profile written to {args.profile_out}/"
              "{profile.json, trace.json, flame.folded}", file=sys.stderr)
    if args.timeline:
        tracer.export_chrome(args.timeline)
        print(f"timeline written to {args.timeline}", file=sys.stderr)
    if args.trace_out:
        with open(args.trace_out, "w", encoding="utf-8") as fh:
            json.dump(report, fh, indent=2)
    if args.trace or not (args.trace_out or args.timeline or args.profile):
        print(json.dumps(report, indent=2), file=sys.stderr)


def _wait(pipeline, timeout: float) -> None:
    """``pipeline.wait(timeout)`` in half-second slices.  Python runs a
    signal's handler in the main thread only, once that thread is back
    in the interpreter; where the kernel hands the signal to another
    thread (one of the CUDA runtime's, as seen on a GPU host), a main
    thread blocked in one long wait would leave the SIGTERM drain
    pending until the wait ended."""
    deadline = time.monotonic() + timeout
    while True:
        left = deadline - time.monotonic()
        try:
            return pipeline.wait(max(0.0, min(0.5, left)))
        except TimeoutError:
            if left <= 0.5:
                raise


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


def check(description: str, out=None) -> int:
    """``--check``: build the pipeline graph and run the static verifier
    WITHOUT playing — no element starts, no thread spawns, no buffer
    flows.  Prints every finding (errors first, element-path
    diagnostics) plus the streaming-thread structure; returns 1 when
    the graph has error-severity findings, else 0.  A path to an
    existing ``.json`` file is a fleet config (:func:`check_fleet`)."""
    import os

    out = out or sys.stderr
    from . import parse_launch
    from .analysis.verify import thread_segments, verify_pipeline
    from .pipeline.parse import ParseError

    if str(description).endswith(".json") and os.path.exists(description):
        return check_fleet(description, out=out)
    try:
        p = parse_launch(description)
    except ParseError as exc:
        print(f"check: FAIL (parse): {exc}", file=out)
        return 1
    findings = verify_pipeline(p)
    for f in findings:
        print(f"check: {f}", file=out)
    for seg in thread_segments(p):
        members = " -> ".join(seg["elements"]) or "(boundary only)"
        print(f"check: thread {seg['thread']}: {members}", file=out)
    return _verdict(findings, out)


def check_jit(out=None) -> int:
    """``--check --jit``: the static graph-capture boundary audit
    (analysis/jitaudit.py) over the installed package, plus the declared
    compile budgets — the same pass ``python -m
    nnstreamer_tpu_torch.analysis.jitaudit`` runs, surfaced through the
    launcher's front door."""
    import os

    out = out or sys.stderr
    from .analysis import compileledger
    from .analysis.jitaudit import audit_paths

    pkg = os.path.dirname(os.path.abspath(__file__))
    findings = audit_paths([pkg], root=os.path.dirname(pkg))
    for f in findings:
        print(f"check: jit: {f}", file=out)
    # importing the engine registers its @compile_budget sites
    from .llm import engine as _engine  # noqa: F401

    for site, n in sorted(compileledger.budgets().items()):
        print(f"check: jit: budget {site} = {n} executables", file=out)
    if findings:
        print(f"check: jit: FAIL ({len(findings)} finding(s))", file=out)
        return 1
    print("check: jit: OK", file=out)
    return 0


def check_fleet(path: str, out=None) -> int:
    """``--check`` on a fleet config JSON: static validation without
    spawning anything (analysis/verify.py ``verify_fleet_config``)."""
    out = out or sys.stderr
    from .analysis.verify import verify_fleet_config

    findings = verify_fleet_config(path)
    for f in findings:
        print(f"check: {f}", file=out)
    return _verdict(findings, out)


def _verdict(findings, out) -> int:
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        print(f"check: FAIL ({len(errors)} error(s))", file=out)
        return 1
    print("check: OK", file=out)
    return 0


def _print_buffer(buf) -> None:
    desc = buf.extra.get("label")
    if desc is None:
        desc = ", ".join(str(getattr(t, "shape", "?")) for t in buf.tensors)
    print(f"pts={buf.pts} {desc}", flush=True)


if __name__ == "__main__":
    raise SystemExit(main())
