"""The port's analysis tier against the JAX package's: the declared lock
hierarchy, the runtime sanitizer (lock order + buffer aliasing), the
lint and the graph-capture boundary audit.

- the lock hierarchy declares every ``make_lock`` site of the port, and
  orders every pair of lock classes both packages name the same way;
- the sanitizer finds the seeded inversion with both stacks, raises in
  strict mode, catches a seeded aliasing write and a slab re-issue with
  a live view, lets the pool recycle, stays silent on real port
  pipelines (a queue boundary, the query transport), and gives the same
  findings as the JAX sanitizer on the same scenario;
- the lint and the audit come out clean on the port's own tree, every
  rule fires on a seeded violation written in the port's idiom, a
  pragma suppresses, a syntax error is a finding and the CLIs exit
  non-zero on findings; ``launch.py --check --jit`` prints the budgets
  in the JAX layout.

Every comparison is exact.
"""

import ast
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from nnstreamer_tpu.analysis import lockorder as jax_lockorder
from nnstreamer_tpu.analysis import sanitizer as jax_sanitizer
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.analysis import (jitaudit, lint, lockorder,
                                           sanitizer)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nnstreamer_tpu_torch")
CAPS4 = ("other/tensors,format=static,num_tensors=1,dimensions=4,"
         "types=float32,framerate=0/1")


@pytest.fixture
def clean_sanitizer():
    for mod in (sanitizer, jax_sanitizer):
        mod.reset()
    yield
    for mod in (sanitizer, jax_sanitizer):
        mod.disable()
        mod.reset()


def _lock_sites(root):
    """(path, line, factory, class name) of every lock factory call."""
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                name = f.id if isinstance(f, ast.Name) else getattr(
                    f, "attr", "")
                if name in ("make_lock", "make_rlock", "make_condition") \
                        and node.args \
                        and isinstance(node.args[0], ast.Constant):
                    out.append((os.path.relpath(path, REPO), node.lineno,
                                name, node.args[0].value))
    return out


# ==========================================================================
# lock hierarchy
# ==========================================================================

def test_every_port_lock_site_is_declared():
    sites = _lock_sites(PORT)
    assert len(sites) >= 44, len(sites)
    undeclared = [s for s in sites if lockorder.rank_of(s[3]) is None]
    assert not undeclared, undeclared


def test_shared_lock_classes_order_as_jax():
    """Wherever both packages name a lock class, every ordered pair of
    classes gets the same verdict (same-class nesting included)."""
    shared = sorted(set(lockorder.HIERARCHY) & set(jax_lockorder.HIERARCHY))
    port_names = {s[3] for s in _lock_sites(PORT)}
    assert port_names <= set(shared)
    for a in shared:
        for b in shared:
            assert (lockorder.check_order(a, b) is None) == \
                (jax_lockorder.check_order(a, b) is None), (a, b)
    assert lockorder.SAME_NAME_OK == jax_lockorder.SAME_NAME_OK


def test_check_order_direction():
    assert lockorder.check_order("planner", "pool") is None
    assert lockorder.check_order("pool", "planner") is not None
    assert lockorder.check_order("queue.space", "queue.space") is None
    assert lockorder.check_order("pool", "pool") is not None
    assert lockorder.check_order("nobody", "pool") is None


# ==========================================================================
# runtime sanitizer: lock order
# ==========================================================================

def _inversion(mod):
    """query.registry -> query.send on one thread, the reverse on
    another (named threads: the findings' text is comparable)."""
    mod.enable(strict=False)
    a = mod.make_lock("query.registry")
    b = mod.make_lock("query.send")

    def forward():
        with a:
            with b:
                pass

    def backward():
        with b:
            with a:
                pass

    for fn in (forward, backward):
        t = threading.Thread(target=fn, name=fn.__name__)
        t.start()
        t.join()
    return mod.findings()


def test_seeded_inversion_reports_cycle_with_both_stacks(clean_sanitizer):
    finds = _inversion(sanitizer)
    kinds = {f.kind for f in finds}
    assert {"lock-hierarchy", "lock-cycle"} <= kinds
    cycle = [f for f in finds if f.kind == "lock-cycle"][0]
    assert len(cycle.stacks) == 2         # both directions' stacks
    assert "query.send" in cycle.message \
        and "query.registry" in cycle.message
    assert "forward" in cycle.stacks[1] and "backward" in cycle.stacks[0]
    assert "lock-cycle" in sanitizer.report()


def test_inversion_findings_equal_jax(clean_sanitizer):
    got = [(f.kind, f.message, len(f.stacks))
           for f in _inversion(sanitizer)]
    want = [(f.kind, f.message, len(f.stacks))
            for f in _inversion(jax_sanitizer)]
    assert got == want and got


def test_strict_mode_raises_at_the_inversion_site(clean_sanitizer):
    sanitizer.enable(strict=True)
    outer = sanitizer.make_lock("pool")      # rank 80
    inner = sanitizer.make_lock("planner")   # rank 10: must come first
    with outer:
        with pytest.raises(sanitizer.LockOrderError, match="hierarchy"):
            inner.acquire()


def test_same_class_nesting_is_instance_safe(clean_sanitizer):
    sanitizer.enable(strict=True)
    up = sanitizer.make_lock("queue.space")
    down = sanitizer.make_lock("queue.space")
    with up:
        with down:
            pass
    same = sanitizer.make_lock("pool")
    other = sanitizer.make_lock("pool")
    with same:
        with pytest.raises(sanitizer.LockOrderError, match="same-class"):
            other.acquire()
    assert [f.kind for f in sanitizer.findings()] == ["lock-hierarchy"]


def test_off_returns_plain_primitives(clean_sanitizer):
    sanitizer.disable()
    assert type(sanitizer.make_lock("pool")) is type(threading.Lock())
    assert type(sanitizer.make_rlock("element")) is \
        type(threading.RLock())
    assert isinstance(sanitizer.make_condition("queue.space"),
                      threading.Condition)
    view = np.zeros(3)
    assert sanitizer.guard_readonly(view) is view


def test_pipeline_run_under_sanitizer_is_finding_free(clean_sanitizer):
    """The declared hierarchy matches the port's real acquisition order
    across a queue boundary and through the filter (instrumented
    conditions keep Condition.wait semantics)."""
    sanitizer.enable(strict=False)
    p = parse_launch(
        "videotestsrc num-buffers=8 pattern=random ! "
        "video/x-raw,format=RGB,width=32,height=32,framerate=30/1 ! "
        "tensor_converter ! queue max-size-buffers=2 ! "
        "tensor_filter framework=xla model=mobilenet_v2 "
        "accelerator=true:cpu custom=input_size:32,use_pallas:1 ! "
        "tensor_decoder mode=image_labeling ! tensor_sink name=out")
    got = []
    p.get("out").connect("new-data", lambda b: got.append(b.pts))
    p.run(timeout=120)
    assert len(got) == 8
    assert sanitizer.findings() == [], sanitizer.report()


QUERY_CHILD = """
import json
import numpy as np
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.analysis import sanitizer
from nnstreamer_tpu_torch.query import QueryConnection, shutdown_server
from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer
sanitizer.enable(strict=True)
sid = 1460
p = parse_launch(
    "tensor_query_serversrc name=qsrc id=1460 port=0 caps=%s "
    "batch=4 batch-timeout-ms=5 ! "
    "tensor_transform mode=arithmetic option=mul:2 ! "
    "tensor_query_serversink id=1460")
p.play()
ok = 0
try:
    conn = QueryConnection("127.0.0.1", p.get("qsrc").bound_port,
                           timeout=10.0)
    conn.connect()
    for i in range(6):
        out = conn.query(TensorBuffer(
            tensors=[np.full(4, float(i), np.float32)]))
        ok += bool((out.np(0) == 2.0 * i).all())
    conn.close()
finally:
    p.stop()
    shutdown_server(sid)
print(json.dumps({"ok": ok, "findings": [str(f)
                                         for f in sanitizer.findings()]}))
"""


def test_query_transport_under_sanitizer_is_finding_free():
    """A served query pair with cross-stream batching (pooled slabs,
    decoded read-only views, send locks, the server's registry) under
    the strict sanitizer, in a fresh process under ``NNS_DEBUG=1`` so
    the module-level locks are instrumented too."""
    r = subprocess.run(
        [sys.executable, "-c", QUERY_CHILD % CAPS4], capture_output=True,
        text=True, timeout=180, cwd=REPO,
        env=dict(os.environ, NNS_DEBUG="1", PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.splitlines()[-1])
    assert got == {"ok": 6, "findings": []}, got


SERVER_TABLE_CHILD = """
import json
from nnstreamer_tpu import parse_launch as jax_parse_launch
from nnstreamer_tpu.analysis import sanitizer as jax_sanitizer
from nnstreamer_tpu.query import shutdown_server as jax_shutdown
from nnstreamer_tpu_torch import parse_launch
from nnstreamer_tpu_torch.analysis import sanitizer
from nnstreamer_tpu_torch.query import shutdown_server
line = ("tensor_query_serversrc name=qsrc id={sid} port=0 caps=%s ! "
        "tensor_query_serversink id={sid}")
for parse, down, sid in ((parse_launch, shutdown_server, 1461),
                         (jax_parse_launch, jax_shutdown, 1462)):
    p = parse(line.format(sid=sid))
    p.play()
    p.stop()
    down(sid)
print(json.dumps({"torch": [f.message for f in sanitizer.findings()],
                  "jax": [f.message for f in jax_sanitizer.findings()]}))
"""


def test_server_table_inversion_is_a_reference_fault():
    """The JAX package builds a new QueryServer (which registers its
    gauges under ``obs.metrics``, rank 74) while holding the server
    table's ``leaf`` lock (rank 95): its own sanitizer reports the
    inversion.  The port builds it under a ``query.registry`` creation
    lock instead and stays clean on the same string.  A fresh process
    under ``NNS_DEBUG=1``, so the module-level locks are instrumented
    too."""
    r = subprocess.run(
        [sys.executable, "-c", SERVER_TABLE_CHILD % CAPS4],
        capture_output=True, text=True, timeout=180, cwd=REPO,
        env=dict(os.environ, NNS_DEBUG="1", JAX_PLATFORMS="cpu",
                 PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.splitlines()[-1])
    assert got["torch"] == [], got["torch"]
    assert any("'obs.metrics' (rank 74) while holding 'leaf'" in m
               for m in got["jax"]), got["jax"]


# ==========================================================================
# runtime sanitizer: buffer aliasing
# ==========================================================================

def _leased_views(pool):
    from nnstreamer_tpu_torch.query.protocol import (decode_tensors,
                                                     encode_tensors)
    from nnstreamer_tpu_torch.tensor.buffer import TensorBuffer

    src = TensorBuffer(
        tensors=[np.arange(12, dtype=np.float32).reshape(3, 4)])
    blob = encode_tensors(src)
    lease = pool.acquire(len(blob))
    lease.memory()[:] = blob
    views = decode_tensors(lease.memory())
    buf = TensorBuffer(tensors=views, pts=0, lease=lease)
    return lease, views, buf


def test_seeded_aliasing_write_detected(clean_sanitizer):
    from nnstreamer_tpu_torch.tensor.buffer import TensorBufferPool

    sanitizer.enable(strict=False)
    lease, views, buf = _leased_views(TensorBufferPool())
    lease.memory()            # writable grant with live views
    finds = [f for f in sanitizer.findings() if f.kind == "aliasing"]
    assert finds, "aliasing write grant not detected"
    assert "live zero-copy view" in finds[0].message
    assert len(finds[0].stacks) == 2   # view creation + grant site
    assert "BufferLease.memory" in finds[0].message


def test_aliasing_findings_equal_jax(clean_sanitizer):
    """The same leased-view scenario through each package's pool, codec
    and TensorBuffer: the same findings."""
    from nnstreamer_tpu.query.protocol import (
        decode_tensors as jax_decode, encode_tensors as jax_encode)
    from nnstreamer_tpu.tensor.buffer import (
        TensorBuffer as JaxTensorBuffer, TensorBufferPool as JaxPool)
    from nnstreamer_tpu_torch.tensor.buffer import TensorBufferPool

    sanitizer.enable(strict=False)
    lease, views, buf = _leased_views(TensorBufferPool())
    lease.memory()
    jax_sanitizer.enable(strict=False)
    src = JaxTensorBuffer(
        tensors=[np.arange(12, dtype=np.float32).reshape(3, 4)])
    blob = jax_encode(src)
    jlease = JaxPool().acquire(len(blob))
    jlease.memory()[:] = blob
    jviews = jax_decode(jlease.memory())
    jbuf = JaxTensorBuffer(tensors=jviews, pts=0, lease=jlease)
    jlease.memory()
    got = [(f.kind, f.message) for f in sanitizer.findings()]
    want = [(f.kind, f.message) for f in jax_sanitizer.findings()]
    assert got == want and got
    del buf, jbuf


def test_strict_mode_raises_aliasing_error(clean_sanitizer):
    from nnstreamer_tpu_torch.tensor.buffer import TensorBufferPool

    sanitizer.enable(strict=True)
    lease, views, buf = _leased_views(TensorBufferPool())
    with pytest.raises(sanitizer.AliasingError, match="live"):
        lease.memory()


def test_write_attempt_raises_clear_error(clean_sanitizer):
    from nnstreamer_tpu_torch.tensor.buffer import TensorBufferPool

    sanitizer.enable(strict=True)
    lease, views, buf = _leased_views(TensorBufferPool())
    with pytest.raises(sanitizer.AliasingError, match="zero-copy"):
        views[0][0, 0] = 5.0
    with pytest.raises(sanitizer.AliasingError, match="zero-copy"):
        views[0].fill(1.0)


def test_slab_reissue_with_live_view_detected(clean_sanitizer):
    sanitizer.enable(strict=False)
    slab = bytearray(16)
    view = np.frombuffer(slab, np.uint8)
    sanitizer.note_views(slab, [view])
    sanitizer.check_slab_reissue(slab)
    finds = [f for f in sanitizer.findings() if f.kind == "aliasing"]
    assert finds and "re-issue" in finds[0].stacks[1]
    del view


def test_pool_reissue_hook_fires_through_the_pool(clean_sanitizer):
    """The pool's own re-issue path calls the check: a slab whose
    registered view is still alive is caught when the pool hands the
    slab out again."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBufferPool

    sanitizer.enable(strict=False)
    pool = TensorBufferPool()
    lease = pool.acquire(64)
    slab = lease._slab
    keep = np.frombuffer(slab, np.uint8)
    lease.release()
    sanitizer.note_views(slab, [keep])
    again = pool.acquire(64)
    if again._slab is slab:
        assert any("re-issued" in f.message
                   for f in sanitizer.findings()), sanitizer.report()
    del keep


def test_pool_recycles_under_sanitizer(clean_sanitizer):
    """The instrumented lock honors acquire(blocking=False) — the pool's
    __del__-safe reclaim depends on it."""
    from nnstreamer_tpu_torch.tensor.buffer import TensorBufferPool

    sanitizer.enable(strict=True)
    lock = sanitizer.make_lock("pool")
    assert lock.acquire(blocking=False) is True
    assert lock.acquire(False) is False   # contended, no deadlock
    lock.release()
    pool = TensorBufferPool()
    for _ in range(3):
        lease = pool.acquire(64)
        lease.memory()[:] = b"x" * 64
        lease.release()
    assert pool.stats["hits"] >= 1, pool.stats
    assert sanitizer.findings() == [], sanitizer.report()


def test_normal_transport_flow_is_clean(clean_sanitizer):
    from nnstreamer_tpu_torch.tensor.buffer import TensorBufferPool

    sanitizer.enable(strict=True)
    pool = TensorBufferPool()
    for _ in range(4):
        lease, views, buf = _leased_views(pool)
        assert float(np.asarray(views[0]).sum()) == 66.0
        del lease, views, buf
    assert sanitizer.findings() == [], sanitizer.report()


def test_nns_debug_arms_the_sanitizer_in_a_fresh_process():
    code = ("from nnstreamer_tpu_torch.analysis import sanitizer as s\n"
            "import threading\n"
            "assert s.enabled()\n"
            "assert type(s.make_lock('pool')) is not "
            "type(threading.Lock())\n"
            "print('armed')\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=REPO,
                       env=dict(os.environ, NNS_DEBUG="1",
                                PYTHONPATH=REPO))
    assert r.returncode == 0 and "armed" in r.stdout, r.stderr[-1500:]


# ==========================================================================
# lint
# ==========================================================================

def test_lint_self_run_is_clean():
    """The standing gate: the port passes its own lint."""
    violations = lint.lint_paths([PORT])
    assert violations == [], "\n".join(str(v) for v in violations)


SEEDED_LINT = (
    "import collections\n"
    "import queue as _queue\n"
    "import time\n"
    "from nnstreamer_tpu_torch.analysis.sanitizer import make_lock\n"
    "from nnstreamer_tpu_torch.query.protocol import decode_tensors\n"
    "class Bad:\n"
    "    def __init__(self):\n"
    "        self._lock = make_lock('query.registry')\n"
    "        self._send_lock = make_lock('query.send')\n"
    "        self._odd = make_lock('no-such-class')\n"
    "        self.backlog = collections.deque()\n"
    "        self.incoming = _queue.Queue()\n"
    "    def poll(self):\n"
    "        while True:\n"
    "            time.sleep(0.01)\n"
    "    def send_under_registry(self, sock, data):\n"
    "        with self._lock:\n"
    "            sock.sendall(data)\n"
    "    def inverted(self):\n"
    "        with self._send_lock:\n"
    "            with self._lock:\n"
    "                pass\n"
    "    def scribble(self, payload):\n"
    "        views = decode_tensors(payload)\n"
    "        views[0].flags.writeable = True\n"
    "        views[0][0] = 1\n"
    "    def chain(self, pad, buf):\n"
    "        buf.extra['t'] = time.time()\n"
    "    def start(self):\n"
    "        self.n = int(self.batch or 8)\n"
    "    def lower_step(self):\n"
    "        def fn(x):\n"
    "            return x.float().cpu().item()\n"
    "        return fn\n")


def test_lint_seeded_violations_all_fire(tmp_path):
    qdir = tmp_path / "nnstreamer_tpu_torch" / "query"
    qdir.mkdir(parents=True)
    bad = qdir / "seeded.py"
    bad.write_text(SEEDED_LINT)
    sched = tmp_path / "nnstreamer_tpu_torch" / "pipeline"
    sched.mkdir()
    (sched / "schedule.py").write_text(
        "class P:\n"
        "    def _make_executor(self, head, steps, tail_pad):\n"
        "        tracer = self.pipeline.tracer\n"
        "        def run(buf, _tracer=tracer):\n"
        "            return _tracer\n"
        "        return run\n")
    got = {v.rule for v in lint.lint_paths([str(tmp_path)])}
    assert got == set(lint.RULES), sorted(set(lint.RULES) - got)


def test_lint_host_sync_in_lower_targets_torch_syncs(tmp_path):
    bad = tmp_path / "lower.py"
    bad.write_text(
        "import numpy as np\n"
        "import torch\n"
        "class E:\n"
        "    def lower_step(self):\n"
        "        def fn(x):\n"
        "            a = x.item()\n"
        "            b = x.cpu()\n"
        "            c = x.numpy()\n"
        "            d = np.asarray(x)\n"
        "            torch.cuda.synchronize()\n"
        "            return buf.np(0), a, b, c, d\n"
        "        return fn\n"
        "    def lower_decode(self, config):\n"
        "        return lambda t: t.argmax(-1).to(torch.int32)\n")
    lines = sorted(v.line for v in lint.lint_paths([str(bad)])
                   if v.rule == "host-sync-in-lower")
    assert lines == [6, 7, 8, 9, 10, 11], lines


def test_lint_pragma_suppresses(tmp_path):
    bad = tmp_path / "pragma.py"
    bad.write_text(
        "import time\n"
        "def poll():\n"
        "    while True:\n"
        "        # cross-process wait  # nnslint: allow(sleep-poll)\n"
        "        time.sleep(0.01)\n")
    assert lint.lint_paths([str(bad)]) == []


def test_lint_syntax_error_is_a_finding(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def oops(:\n")
    [v] = lint.lint_paths([str(bad)])
    assert v.rule == "syntax"


def test_lint_cli_exits_nonzero_on_findings(tmp_path):
    bad = tmp_path / "seeded.py"
    bad.write_text("import time\n"
                   "while True:\n"
                   "    time.sleep(1)\n")
    run = [sys.executable, "-m", "nnstreamer_tpu_torch.analysis.lint"]
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(run + [str(bad)], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env=env)
    assert r.returncode == 1 and "sleep-poll" in r.stdout, r.stderr
    r = subprocess.run(run, capture_output=True, text=True, timeout=120,
                       cwd=REPO, env=env)
    assert r.returncode == 0 and "clean" in r.stderr, r.stdout[-1500:]
    r = subprocess.run(run + ["--list-rules"], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0 and set(r.stdout.split()) == set(lint.RULES)


def test_lint_rules_equal_the_jax_lint():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import nnslint
    finally:
        sys.path.pop(0)
    assert lint.RULES == nnslint.RULES


# ==========================================================================
# graph-capture boundary audit
# ==========================================================================

def test_jitaudit_self_run_is_clean():
    findings = jitaudit.audit_paths([PORT], root=REPO)
    assert findings == [], "\n".join(str(f) for f in findings)


SEEDED_JIT = (
    "import torch\n"
    "from nnstreamer_tpu_torch import _cuda\n"
    "def _step_fn(padded):\n"
    "    return padded\n"
    "def model(params, x):\n"
    "    n = float(x)\n"                 # host-sync-in-jit
    "    if x.sum() > 0:\n"              # tracer-branch
    "        n += 1\n"
    "    return n\n"
    "_g = _cuda.CapturedGraph(model, [], None)\n"
    "def mutator(params, pool, x):\n"
    "    pool = pool.index_put((x,), x)\n"
    "    return pool\n"
    "_m = _cuda.GraphedStep(mutator, None)\n"   # missing-donation
    "def host_driver(tokens):\n"
    "    t = tokens.size(0)\n"
    "    return _step_fn(t)\n"           # unquantized-shape-at-jit
    "def _sig(arrays):\n"
    "    return tuple(a.dtype for a in arrays)\n")   # unbounded


def test_jitaudit_seeded_violations_all_fire(tmp_path):
    bad = tmp_path / "seeded.py"
    bad.write_text(SEEDED_JIT)
    got = {f.rule for f in jitaudit.audit_paths([str(bad)],
                                                root=str(tmp_path))}
    assert got == set(jitaudit.RULES), got


@pytest.mark.parametrize("line", [
    "    y = x.item()\n", "    y = x.tolist()\n", "    y = x.cpu()\n",
    "    y = x.numpy()\n", "    y = int(x)\n", "    y = bool(x)\n",
    "    torch.cuda.synchronize()\n", "    y = np.asarray(x)\n"])
def test_jitaudit_each_torch_host_sync_fires(tmp_path, line):
    bad = tmp_path / "sync.py"
    bad.write_text("import numpy as np\nimport torch\n"
                   "from nnstreamer_tpu_torch import _cuda\n"
                   "def body(x):\n" + line + "    return x\n"
                   "_g = _cuda.CapturedGraph(body, [], None)\n")
    got = jitaudit.audit_paths([str(bad)], root=str(tmp_path))
    assert [(f.rule, f.line) for f in got] == [("host-sync-in-jit", 5)]


def test_jitaudit_disciplined_code_is_clean(tmp_path):
    """The same shapes of code written WITH the discipline: quantized
    lengths, pools updated in place, shape-only branches, host work on
    static arguments."""
    ok = tmp_path / "ok.py"
    ok.write_text(
        "import torch\n"
        "from nnstreamer_tpu_torch import _cuda\n"
        "def pad_rows(n, cap):\n"
        "    return min(cap, n)\n"
        "def _step_fn(padded):\n"
        "    return padded\n"
        "def model(params, x):\n"
        "    if x.shape[0] > 8 and x.is_cuda:\n"
        "        return torch.sum(x)\n"
        "    return torch.amax(x)\n"
        "_g = _cuda.CapturedGraph(model, [], None)\n"
        "def mutator(params, pool, x):\n"
        "    pool.index_copy_(0, x, x)\n"
        "    return pool\n"
        "_m = _cuda.GraphedStep(mutator, None)\n"
        "def host_driver(tokens):\n"
        "    t = len(tokens)\n"
        "    return _step_fn(pad_rows(t, 64))\n"
        "def host_report(cfg: object, n: int):\n"
        "    return float(n) if n > 0 else 0.0\n")
    findings = jitaudit.audit_paths([str(ok)], root=str(tmp_path))
    assert findings == [], "\n".join(str(f) for f in findings)


def test_jitaudit_pragma_suppresses(tmp_path):
    bad = tmp_path / "pragma.py"
    bad.write_text(
        "from nnstreamer_tpu_torch import _cuda\n"
        "def model(params, x):\n"
        "    # a host scalar the caller pins per graph\n"
        "    # nnsjit: allow(host-sync-in-jit)\n"
        "    return float(x)\n"
        "_g = _cuda.CapturedGraph(model, [], None)\n")
    assert jitaudit.audit_paths([str(bad)], root=str(tmp_path)) == []


def test_jitaudit_syntax_error_is_a_finding_not_a_crash(tmp_path):
    bad = tmp_path / "broken.py"
    bad.write_text("def oops(:\n")
    findings = jitaudit.audit_paths([str(bad)], root=str(tmp_path))
    assert [f.rule for f in findings] == ["syntax"]


def test_jitaudit_cli_exits_nonzero_on_findings(tmp_path):
    bad = tmp_path / "seeded.py"
    bad.write_text("from nnstreamer_tpu_torch import _cuda\n"
                   "def model(params, x):\n"
                   "    return float(x)\n"
                   "_g = _cuda.CapturedGraph(model, [], None)\n")
    run = [sys.executable, "-m", "nnstreamer_tpu_torch.analysis.jitaudit"]
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(run + [str(bad)], capture_output=True, text=True,
                       timeout=120, cwd=REPO, env=env)
    assert r.returncode == 1 and "host-sync-in-jit" in r.stdout
    r = subprocess.run(run + ["--list-rules"], capture_output=True,
                       text=True, timeout=120, cwd=REPO, env=env)
    assert r.returncode == 0 and set(r.stdout.split()) == \
        set(jitaudit.RULES)
    r = subprocess.run(run, capture_output=True, text=True, timeout=120,
                       cwd=REPO, env=env)
    assert r.returncode == 0 and "nnsjit: clean" in r.stderr, r.stdout


def test_jitaudit_rules_and_layout_equal_jax(tmp_path):
    """The same rule names and finding layout as the JAX audit."""
    from nnstreamer_tpu.analysis import jitaudit as jax_jitaudit

    assert jitaudit.RULES == jax_jitaudit.RULES
    f = jitaudit.Finding("a.py", 3, "tracer-branch", "m", "msg")
    j = jax_jitaudit.Finding("a.py", 3, "tracer-branch", "m", "msg")
    assert str(f) == str(j) and vars(f) == vars(j)


def test_check_jit_prints_budgets_in_the_jax_layout(capsys):
    from nnstreamer_tpu import launch as jax_launch
    from nnstreamer_tpu_torch import launch

    assert launch.main(["--check", "--jit"]) == 0
    err = capsys.readouterr().err.splitlines()
    assert jax_launch.main(["--check", "--jit"]) == 0
    jerr = capsys.readouterr().err.splitlines()
    assert err[-1] == jerr[-1] == "check: jit: OK"
    budgets = [ln for ln in err if ln.startswith("check: jit: budget ")]
    jbudgets = [ln for ln in jerr if ln.startswith("check: jit: budget ")]
    assert budgets and [ln.split(" = ")[0] for ln in budgets] == \
        [ln.split(" = ")[0] for ln in jbudgets if " = " in ln
         and ln.split(" = ")[0] in {b.split(" = ")[0] for b in budgets}]
    assert all(ln.endswith(" executables") for ln in budgets)
