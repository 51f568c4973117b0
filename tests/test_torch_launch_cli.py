"""The port's CLI (``python -m nnstreamer_tpu_torch.launch``, the
gst-launch / gst-inspect roles) driven as real child processes: the
inspector lists the query factories, a launch line prints its sink,
``--check --jit`` (the last option that waited for a module of the JAX
package) runs the graph-capture audit in the JAX layout, and a client
pipeline started through the CLI offloads to a port server running in
this process, with no module of JAX loaded in the child."""

import json
import os
import subprocess
import sys

import pytest

from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch import launch
from nnstreamer_tpu_torch.launch import main
from nnstreamer_tpu_torch.query.server import shutdown_server

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "nnstreamer_tpu")
FRAMES = ("videotestsrc num-buffers={n} pattern=random ! "
          "video/x-raw,format=RGB,width=8,height=6,framerate=30/1 ! "
          "tensor_converter ! ")


def _run_cli(*args, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", "nnstreamer_tpu_torch.launch", *args],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def test_inspect_lists_the_query_factories():
    r = _run_cli("--inspect")
    assert r.returncode == 0, r.stderr[-1500:]
    for factory in ("tensor_filter", "tensor_query_serversrc",
                    "tensor_query_serversink", "tensor_query_client"):
        assert factory in r.stdout


def test_inspect_one_factory_shows_its_properties():
    r = _run_cli("--inspect", "tensor_query_serversrc")
    assert r.returncode == 0, r.stderr[-1500:]
    for prop in ("batch-timeout-ms", "queue-depth", "capacity-rps",
                 "send-timeout"):
        assert prop in r.stdout


def test_launch_line_runs_and_prints_sink(tmp_path):
    out = tmp_path / "trace.json"
    r = _run_cli(FRAMES.format(n=3) + "tensor_sink name=out",
                 "--print-sink", "out", "--trace-out", str(out),
                 "--timeout", "60")
    assert r.returncode == 0, r.stderr[-1500:]
    assert r.stdout.count("pts=") == 3
    assert json.loads(out.read_text())["trace"]["out"]["buffers"] == 3


def test_unported_option_exits_2_naming_its_module():
    """No option waits for a module any more: ``--jit`` (the last one,
    formerly exit 2) now runs the graph-capture audit, with no pipeline
    string needed, and exits 0 on the port's tree with the JAX
    package's output layout."""
    assert not hasattr(launch, "UNPORTED")
    r = _run_cli("--check", "--jit")
    assert r.returncode == 0, r.stderr[-1500:]
    assert "check: jit: OK" in r.stderr
    assert "check: jit: budget llm.engine.step = 16 executables" \
        in r.stderr


@pytest.mark.parametrize("option", ["--jit"])
def test_every_unported_option_exits_2(option, capsys):
    """The same, in-process, for each formerly unported option: with a
    pipeline string ``--check`` verifies the graph and the option's
    audit runs beside it."""
    assert main(["--check", option, FRAMES.format(n=1) + "tensor_sink"]) \
        == 0
    err = capsys.readouterr().err
    assert "check: OK" in err and "check: jit: OK" in err


def test_cli_client_offloads_to_port_server_without_jax():
    """The child runs the CLI's ``__main__`` exactly as ``-m`` does and
    then names every JAX module it loaded (none)."""
    sid = 1950
    server = parse_launch(
        f"tensor_query_serversrc name=qsrc id={sid} port=0 "
        "caps=other/tensors,format=static,num_tensors=1,dimensions=3:8:6,"
        f"types=uint8,framerate=0/1 ! tensor_query_serversink id={sid}")
    server.play()
    try:
        port = server.get("qsrc").bound_port
        argv = [FRAMES.format(n=4) + f"tensor_query_client port={port} "
                "timeout=20 ! tensor_sink name=out", "--print-sink", "out",
                "--timeout", "60"]
        code = (
            "import runpy, sys\n"
            f"sys.argv = ['nnstreamer_tpu_torch.launch', *{argv!r}]\n"
            "try:\n"
            "    runpy.run_module('nnstreamer_tpu_torch.launch',\n"
            "                     run_name='__main__', alter_sys=True)\n"
            "    rc = 0\n"
            "except SystemExit as exc:\n"
            "    rc = exc.code\n"
            f"bad = {FORBIDDEN!r}\n"
            "print('LOADED', sorted(m for m in sys.modules\n"
            "                       if m.split('.')[0] in bad))\n"
            "sys.exit(rc)\n")
        r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=120, cwd=REPO,
                           env=dict(os.environ, PYTHONPATH=REPO))
        assert r.returncode == 0, r.stderr[-1500:]
        assert r.stdout.count("pts=") == 4
        assert "(6, 8, 3)" in r.stdout
        assert r.stdout.strip().splitlines()[-1] == "LOADED []"
        counters = server.get("qsrc").server.counters()
        assert sum(counters["admitted"].values()) == 4
        assert sum(counters["shed"].values()) == 0
    finally:
        server.stop()
        shutdown_server(sid)
