"""The port's lint: repo-specific AST checks of nnstreamer_tpu_torch's
concurrency and zero-copy contracts (the port of ``tools/nnslint.py``,
the same ten rules).

Generic linters cannot know that this codebase has a declared lock
hierarchy, that ``decode_tensors`` views are shared read-only payloads,
or that the untraced fused executor must carry zero tracer references.
This tool checks exactly those repo rules:

``sleep-poll``
    ``time.sleep`` inside a loop is a polling wait — this codebase is
    event-driven (conditions, blocking gets, wake sentinels).  Allowed:
    ``query/resilience.py`` (THE backoff module), sleeps whose duration
    comes from a retry policy (``*.delay(...)``), and pragma'd lines
    (cross-process mmap waits that genuinely cannot block on a local
    primitive).  In ``slo/`` the rule tightens to ANY ``time.sleep``
    (loop or not): the SLO harness is deadline-driven by contract —
    open-loop arrival schedules and evaluator ticks pace on
    ``Event.wait`` against absolute monotonic deadlines, because a
    load generator that drifts under load measures its own jitter.

``io-under-lock``
    Blocking socket send/recv while holding a lock that is not the
    connection's dedicated send lock (``query.send``) serializes
    unrelated work behind a stalled peer — the bug class the
    per-connection send locks exist to prevent.  Lock identities come
    from the ``make_lock("name")`` creation sites, so the rule only
    fires on locks it can resolve.

``lock-order``
    Lexically nested acquisitions (``with`` blocks and ``.acquire()``
    calls) of resolvable locks must respect the hierarchy declared in
    ``nnstreamer_tpu_torch/analysis/lockorder.py`` — the static half of
    the runtime sanitizer's check.

``unknown-lock``
    ``make_lock``/``make_rlock``/``make_condition`` with a name the
    hierarchy does not declare: add the class to lockorder.HIERARCHY.

``tracer-in-untraced-plan``
    The segment compiler's untraced executor (``run`` inside
    ``_make_executor``, pipeline/schedule.py) must reference no tracer
    state — "tracing costs zero when off" is load-bearing for the
    dispatch benchmarks.

``readonly-view-mutation``
    Zero-copy views are shared: flipping ``flags.writeable`` back to
    True, or store/augmented-assign into a ``decode_tensors`` result,
    corrupts frames other consumers already hold.

``wallclock-in-chain``
    Direct ``time.time()``/``time.time_ns()`` in a chain-path method
    (``chain``/``create``/``plan_step``/``_chain_entry``).  Latency and
    pacing math on the wall clock silently breaks under NTP slew; the
    obs clock helpers (``obs/clock.py``) keep the monotonic/wall split
    explicit — ``mono_ns()`` for durations and deadlines, ``wall_us()``
    for cross-host stamps.

``host-sync-in-lower``
    ``lower_step`` / ``lower_decode`` implementations (the fuse=xla
    whole-segment lowering hooks, captured as one CUDA graph a segment)
    must return PURE tensor code: a ``buf.np()`` / ``.item()`` /
    ``.cpu()`` / ``.numpy()`` / ``.tolist()`` / ``np.asarray`` /
    ``torch.cuda.synchronize()`` inside one silently re-introduces the
    per-element host sync the tier exists to remove (and breaks the
    capture anyway).  Host finishers belong in ``LoweredStep.post``.

``unbounded-queue``
    ``queue.Queue()`` without ``maxsize`` or ``deque()`` without
    ``maxlen`` in the dataflow layers (``query/``, ``pipeline/``).  An
    unbounded buffer on a data path absorbs overload as unbounded
    memory growth and unbounded latency instead of explicit
    backpressure or shedding — the failure mode the admission layer
    (query/overload.py) exists to prevent.  Queues that are
    bounded by construction elsewhere (a slot condition, a ≤1-in-flight
    protocol) take the pragma WITH the reason in the comment.

``falsy-zero-default``
    ``int(get_property(k) or default)``-style reads with a NONZERO
    constant default.  ``or`` cannot distinguish "property unset" from
    "property explicitly 0/0.0/empty", so a user who configures zero
    silently gets the default back — the LeakyReLU ``alpha or 0.2``
    class of bug (alpha=0.0 is a valid, meaningful setting).  Compare
    against None instead (``v = read(...); x = int(v) if v is not None
    else default``).  ``or 0`` / ``or 0.0`` stay exempt: when the
    default equals the falsy trap there is nothing to lose.  Sites
    where zero is genuinely invalid (a port number, a positive queue
    bound) take the pragma WITH the reason.

Pragma: append ``# nnslint: allow(<rule>)`` to the offending line or
the comment line directly above it (give a reason in the comment).

Usage::

    python -m nnstreamer_tpu_torch.analysis.lint [path ...]   # default:
    #                                      the nnstreamer_tpu_torch package
    python -m nnstreamer_tpu_torch.analysis.lint --list-rules

Exit status 1 when violations are found (the tier-1 suite runs this
over the port: a violation fails CI).  Pure ``ast``: no import of
torch or of the port is needed to lint it.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import importlib.util
import os
import sys
from typing import Dict, List, Optional, Set, Tuple

#: the port's package directory and the repository root above it
PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE)

RULES = ("sleep-poll", "io-under-lock", "lock-order", "unknown-lock",
         "tracer-in-untraced-plan", "readonly-view-mutation",
         "wallclock-in-chain", "unbounded-queue", "host-sync-in-lower",
         "falsy-zero-default")

#: function names whose bodies must stay pure tensor code (the fuse=xla
#: lowering hooks — pipeline/element.py LoweredStep contract)
_LOWER_FUNCS = frozenset({"lower_step", "lower_decode"})
#: attribute calls that force a device→host sync or materialization
_HOST_SYNC_ATTRS = frozenset({"np", "item", "cpu", "numpy", "tolist",
                              "synchronize"})

#: directories where unbounded queue/deque construction is a finding
#: (the dataflow layers the overload story bounds; the fleet tier is a
#: dataflow layer — an unbounded buffer in the router would absorb a
#: worker outage as unbounded memory exactly like an unprotected server)
_BOUNDED_QUEUE_DIRS = (
    os.path.join("nnstreamer_tpu_torch", "query") + os.sep,
    os.path.join("nnstreamer_tpu_torch", "pipeline") + os.sep,
    os.path.join("nnstreamer_tpu_torch", "fleet") + os.sep,
    os.path.join("nnstreamer_tpu_torch", "llm") + os.sep,
)

#: method names that are per-buffer dataflow paths for wallclock-in-chain
_CHAIN_PATH_FUNCS = frozenset({"chain", "create", "plan_step",
                               "_chain_entry"})

#: call names treated as blocking socket I/O for io-under-lock
_IO_CALLS = frozenset({
    "sendall", "sendmsg", "sendmsg_all", "send_msg", "send_msg_zc",
    "send_tensors", "recv", "recv_into", "recv_msg", "_recv_exact",
    "_recv_exact_into",
})

#: lock factory names whose first argument is the lock-class name
_LOCK_FACTORIES = frozenset({"make_lock", "make_rlock", "make_condition"})

#: lock classes under which blocking sends are the DESIGN (per-stream
#: send serialization)
_SEND_OK = frozenset({"query.send"})


def _load_lockorder():
    """Load analysis/lockorder.py straight from its file: no package
    import, so linting works without torch/numpy in the environment."""
    path = os.path.join(PACKAGE, "analysis", "lockorder.py")
    spec = importlib.util.spec_from_file_location("_nns_lockorder", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Violation:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule}: {self.message}"


def _pragma_lines(source: str) -> Dict[int, Set[str]]:
    """line number -> set of rules allowed on that line.  A pragma on a
    pure comment line also covers the next non-comment line."""
    allowed: Dict[int, Set[str]] = {}
    pending: Set[str] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        rules: Set[str] = set()
        marker = "# nnslint: allow("
        pos = text.find(marker)
        if pos >= 0:
            inner = text[pos + len(marker):]
            rules = {r.strip() for r in
                     inner.partition(")")[0].split(",") if r.strip()}
        stripped = text.strip()
        if stripped.startswith("#"):
            pending |= rules
            continue
        here = rules | pending
        if stripped:
            pending = set()
        if here:
            allowed[i] = allowed.get(i, set()) | here
    return allowed


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, rel: str, tree: ast.Module,
                 source: str, lockorder) -> None:
        self.path = path
        self.rel = rel
        self.tree = tree
        self.lockorder = lockorder
        self.allowed = _pragma_lines(source)
        self.violations: List[Violation] = []
        #: module-level name -> lock class, from make_lock sites
        self.lock_names: Dict[str, str] = {}
        #: class name -> {attr -> lock class} (attr names like "_lock"
        #: recur across classes with DIFFERENT ranks: scope them)
        self.class_lock_names: Dict[str, Dict[str, str]] = {}
        self._class_stack: List[str] = []
        #: enclosing function-name stack (wallclock-in-chain scoping)
        self._func_stack: List[str] = []
        #: per-function local name -> lock class (reset per FunctionDef)
        self._locals: Dict[str, str] = {}
        #: stack of (lock class, line) currently held lexically
        self._with_stack: List[Tuple[str, int]] = []
        #: names bound to decode_tensors(...) results in this function
        self._view_names: Set[str] = set()

    # -- plumbing ----------------------------------------------------------
    def _add(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        if rule in self.allowed.get(line, ()):
            return
        self.violations.append(Violation(self.rel, line, rule, message))

    @staticmethod
    def _call_name(call: ast.Call) -> str:
        fn = call.func
        if isinstance(fn, ast.Name):
            return fn.id
        if isinstance(fn, ast.Attribute):
            return fn.attr
        return ""

    def _factory_name(self, value: ast.AST) -> Optional[str]:
        """'query.send' from a make_lock("query.send") call, else None."""
        if isinstance(value, ast.Call) \
                and self._call_name(value) in _LOCK_FACTORIES \
                and value.args \
                and isinstance(value.args[0], ast.Constant) \
                and isinstance(value.args[0].value, str):
            return value.args[0].value
        return None

    def _resolve_lock(self, expr: ast.AST) -> Optional[str]:
        """Lock class of a with-item / acquire target, when known."""
        if isinstance(expr, ast.Attribute):
            for cls in reversed(self._class_stack):
                got = self.class_lock_names.get(cls, {}).get(expr.attr)
                if got is not None:
                    return got
            return self.lock_names.get(expr.attr)
        if isinstance(expr, ast.Subscript):
            return self._resolve_lock(expr.value)
        if isinstance(expr, ast.Name):
            got = self._locals.get(expr.id)
            if got is not None:
                return got
            return self.lock_names.get(expr.id)
        if isinstance(expr, ast.Call):
            # self._send_locks.get(cid) / dict access helpers
            fn = expr.func
            if isinstance(fn, ast.Attribute):
                inner = self._resolve_lock(fn.value)
                if inner is not None:
                    return inner
            return self._factory_name(expr)
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                got = self._resolve_lock(v)
                if got is not None:
                    return got
        return None

    # -- collection pass ---------------------------------------------------
    def collect_lock_names(self) -> None:
        self._collect_into(self.tree, self.lock_names)
        for node in ast.walk(self.tree):
            if isinstance(node, ast.ClassDef):
                scoped = self.class_lock_names.setdefault(node.name, {})
                self._collect_into(node, scoped)

    def _collect_into(self, root: ast.AST, table: Dict[str, str]) -> None:
        for node in ast.walk(root):
            if not isinstance(node, ast.Assign):
                continue
            name = self._factory_name(node.value)
            if name is None:
                continue
            if self.lockorder.rank_of(name) is None:
                self._add(node, "unknown-lock",
                          f"lock class {name!r} is not declared in "
                          "analysis/lockorder.py HIERARCHY")
            for target in node.targets:
                if isinstance(target, ast.Attribute):
                    table[target.attr] = name
                elif isinstance(target, ast.Name):
                    table[target.id] = name
                elif isinstance(target, ast.Subscript) \
                        and isinstance(target.value, ast.Attribute):
                    table[target.value.attr] = name

    # -- visitors ----------------------------------------------------------
    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self.generic_visit(node)
        self._class_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        saved_locals, saved_views = self._locals, self._view_names
        self._locals, self._view_names = dict(self._locals), set()
        self._func_stack.append(node.name)
        self.generic_visit(node)
        self._func_stack.pop()
        self._locals, self._view_names = saved_locals, saved_views

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Assign(self, node: ast.Assign) -> None:
        resolved = self._resolve_lock(node.value)
        if resolved is not None:
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self._locals[target.id] = resolved
        if isinstance(node.value, ast.Call) \
                and self._call_name(node.value) == "decode_tensors":
            for target in node.targets:
                if isinstance(target, ast.Name):
                    self._view_names.add(target.id)
        # <arr>.flags.writeable = True
        for target in node.targets:
            if isinstance(target, ast.Attribute) \
                    and target.attr == "writeable" \
                    and isinstance(target.value, ast.Attribute) \
                    and target.value.attr == "flags" \
                    and isinstance(node.value, ast.Constant) \
                    and node.value.value is True:
                self._add(node, "readonly-view-mutation",
                          "re-enabling writeable on a tensor view breaks "
                          "the shared read-only payload contract "
                          "(tee fan-out / pooled slabs); copy instead")
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        entered = []
        for item in node.items:
            name = self._resolve_lock(item.context_expr)
            if name is not None:
                self._note_acquire(name, node)
                entered.append(name)
        self.generic_visit(node)
        for _ in entered:
            self._with_stack.pop()

    def _note_acquire(self, name: str, node: ast.AST,
                      push: bool = True) -> None:
        for held, held_line in self._with_stack:
            problem = self.lockorder.check_order(held, name)
            if problem is not None:
                self._add(node, "lock-order",
                          f"{problem} (outer acquired at line "
                          f"{held_line})")
        if push:
            self._with_stack.append((name, getattr(node, "lineno", 0)))

    def visit_Call(self, node: ast.Call) -> None:
        name = self._call_name(node)
        # explicit .acquire() of a resolvable lock while inside a with
        if name == "acquire" and isinstance(node.func, ast.Attribute):
            lock = self._resolve_lock(node.func.value)
            if lock is not None and self._with_stack:
                self._note_acquire(lock, node, push=False)
        # sleep-poll: time.sleep inside a lexical loop — and ANY
        # time.sleep in slo/ (loop or not): the SLO harness is
        # deadline-driven by contract; a generator that sleeps measures
        # its own scheduling jitter, not the server's latency
        in_slo = (os.sep + "slo" + os.sep) in self.rel
        if name == "sleep" and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in ("time", "_time") \
                and (self._in_loop(node) or in_slo) \
                and not self._is_backoff_sleep(node) \
                and not self.rel.endswith(os.path.join("query",
                                                       "resilience.py")):
            self._add(node, "sleep-poll",
                      "time.sleep in slo/ is banned: pace on "
                      "Event.wait against absolute deadlines "
                      "(slo/loadgen.py pattern)" if in_slo else
                      "time.sleep in a loop is a polling wait: use a "
                      "condition / blocking get with a wake sentinel "
                      "(pipeline/graph.py AppSrc/Queue pattern), or a "
                      "RetryPolicy.delay for backoff")
        # wallclock-in-chain: time.time()/time.time_ns() on a per-buffer
        # dataflow path (obs/clock.py is exempt: it IS the helper)
        if name in ("time", "time_ns") \
                and isinstance(node.func, ast.Attribute) \
                and isinstance(node.func.value, ast.Name) \
                and node.func.value.id in ("time", "_time") \
                and any(f in _CHAIN_PATH_FUNCS for f in self._func_stack) \
                and not self.rel.endswith(os.path.join("obs", "clock.py")):
            self._add(node, "wallclock-in-chain",
                      f"time.{name}() in a chain-path method: the wall "
                      "clock slews under NTP — use obs.clock.mono_ns() "
                      "for durations/deadlines or obs.clock.wall_us() "
                      "for cross-host stamps")
        # unbounded-queue: queue.Queue() without maxsize / deque()
        # without maxlen in the dataflow layers — unbounded buffers
        # absorb overload as memory growth instead of backpressure or
        # explicit shedding (query/overload.py)
        if any(d in self.rel for d in _BOUNDED_QUEUE_DIRS):
            if name == "Queue" and self._queue_unbounded(node):
                self._add(node, "unbounded-queue",
                          "queue.Queue() without a positive maxsize in "
                          "a dataflow layer: overload becomes unbounded "
                          "memory growth — bound it (the hard watermark "
                          "admission control sheds under) or pragma "
                          "WITH the reason it is bounded elsewhere")
            elif name == "deque" and len(node.args) < 2 \
                    and not any(kw.arg == "maxlen"
                                for kw in node.keywords):
                # deque() AND deque(iterable) are both unbounded; only
                # a maxlen (kw or second positional) bounds one
                self._add(node, "unbounded-queue",
                          "deque() without maxlen in a dataflow layer: "
                          "bound it or pragma WITH the reason it is "
                          "bounded elsewhere")
        # falsy-zero-default: int/float over an `or`-defaulted read
        # with a NONZERO constant fallback — an explicit 0/0.0/"" from
        # the property read is falsy and silently becomes the default
        if name in ("int", "float") and isinstance(node.func, ast.Name) \
                and len(node.args) == 1 \
                and isinstance(node.args[0], ast.BoolOp) \
                and isinstance(node.args[0].op, ast.Or):
            vals = node.args[0].values
            default = vals[-1]
            reads = any(isinstance(v, (ast.Call, ast.Attribute,
                                       ast.Subscript))
                        for v in vals[:-1])
            if reads and isinstance(default, ast.Constant) \
                    and isinstance(default.value, (int, float)) \
                    and not isinstance(default.value, bool) \
                    and default.value != 0:
                self._add(node, "falsy-zero-default",
                          f"{name}(<read> or {default.value!r}) folds an "
                          "explicit zero/empty property value into the "
                          "default — compare against None (v = read(); "
                          f"{name}(v) if v is not None else "
                          f"{default.value!r}), or pragma WITH the "
                          "reason zero is invalid here")
        # io-under-lock
        if name in _IO_CALLS and self._with_stack:
            for held, held_line in self._with_stack:
                if held not in _SEND_OK:
                    self._add(node, "io-under-lock",
                              f"blocking socket {name}() while holding "
                              f"{held!r} (acquired line {held_line}): "
                              "only the per-connection send lock "
                              "('query.send') may be held across "
                              "socket I/O — a stalled peer would wedge "
                              "every thread needing that lock")
        self.generic_visit(node)

    @staticmethod
    def _queue_unbounded(node: ast.Call) -> bool:
        """True when a Queue(...) construction is unbounded: no maxsize
        at all, or an explicit 0 / non-positive constant (queue.Queue
        treats maxsize<=0 as infinite)."""
        size = None
        if node.args:
            size = node.args[0]
        for kw in node.keywords:
            if kw.arg == "maxsize":
                size = kw.value
        if size is None:
            return True
        if isinstance(size, ast.Constant) \
                and isinstance(size.value, (int, float)):
            return size.value <= 0
        return False       # computed bound: assume intentional

    def _in_loop(self, node: ast.AST) -> bool:
        # lexical ancestry via a parent walk (ast has no parent links:
        # search the tree for loops whose span contains the node)
        target = node.lineno
        for outer in ast.walk(self.tree):
            if isinstance(outer, (ast.While, ast.For)):
                end = getattr(outer, "end_lineno", outer.lineno)
                if outer.lineno < target <= end:
                    # exclude the loop's else block? good enough lexical
                    return True
        return False

    @staticmethod
    def _is_backoff_sleep(node: ast.Call) -> bool:
        """sleep(<retry-policy>.delay(...)) is sanctioned backoff."""
        return bool(node.args) and isinstance(node.args[0], ast.Call) \
            and isinstance(node.args[0].func, ast.Attribute) \
            and node.args[0].func.attr == "delay"

    def visit_Subscript(self, node: ast.Subscript) -> None:
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._check_view_store(node.target, node)
        self.generic_visit(node)

    def _check_view_store(self, target: ast.AST, node: ast.AST) -> None:
        root = target
        while isinstance(root, (ast.Subscript, ast.Attribute)):
            root = root.value
        if isinstance(root, ast.Name) and root.id in self._view_names \
                and isinstance(target, ast.Subscript):
            self._add(node, "readonly-view-mutation",
                      f"in-place store into {root.id!r}, a "
                      "decode_tensors() zero-copy view: the payload is "
                      "shared read-only; np.array() it first")

    def run(self) -> List[Violation]:
        self.collect_lock_names()
        self.visit(self.tree)
        # store-assignments into view names (X[...] = v) are Assign
        # nodes; re-walk for them with function-local view tracking
        self._lint_view_stores()
        self._lint_untraced_executor()
        self._lint_lower_purity()
        # the collection passes overlap (module walk + per-class walk):
        # dedupe by site+rule
        seen, unique = set(), []
        for v in self.violations:
            key = (v.path, v.line, v.rule)
            if key not in seen:
                seen.add(key)
                unique.append(v)
        return unique

    def _lint_view_stores(self) -> None:
        for fn in ast.walk(self.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            views: Set[str] = set()
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign) \
                        and isinstance(node.value, ast.Call) \
                        and self._call_name(node.value) == "decode_tensors":
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            views.add(t.id)
            if not views:
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        if isinstance(t, ast.Subscript):
                            root = t.value
                            while isinstance(root,
                                             (ast.Subscript, ast.Attribute)):
                                root = root.value
                            if isinstance(root, ast.Name) \
                                    and root.id in views:
                                self._add(
                                    node, "readonly-view-mutation",
                                    f"store into {root.id!r}, a "
                                    "decode_tensors() zero-copy view: "
                                    "shared read-only payload; "
                                    "np.array() it first")

    def _lint_untraced_executor(self) -> None:
        if not self.rel.endswith(os.path.join("pipeline", "schedule.py")):
            return
        makers = [node for node in ast.walk(self.tree)
                  if isinstance(node, ast.FunctionDef)
                  and node.name in ("_make_executor",
                                    "_make_xla_executor")]
        for maker in makers:
            for node in ast.walk(maker):
                if isinstance(node, ast.FunctionDef) and node.name == "run":
                    for sub in ast.walk(node):
                        ident = None
                        if isinstance(sub, ast.Name):
                            ident = sub.id
                        elif isinstance(sub, ast.arg):
                            ident = sub.arg
                        if ident is not None and "tracer" in ident:
                            self._add(
                                sub if hasattr(sub, "lineno") else node,
                                "tracer-in-untraced-plan",
                                "the untraced fused executor references "
                                f"{ident!r}: the zero-cost-when-off "
                                "tracing guarantee requires the untraced "
                                "plan to hold no tracer state")

    def _lint_lower_purity(self) -> None:
        """host-sync-in-lower: ``lower_step``/``lower_decode`` bodies
        (and their nested captured functions) must not materialize on
        host — ``X.np()``, ``.item()``, ``.cpu()``, ``.numpy()``,
        ``np.asarray``, ``torch.cuda.synchronize()`` all force the
        device sync the fuse=xla tier exists to collapse."""
        for fn in ast.walk(self.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in _LOWER_FUNCS:
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) \
                        or not isinstance(node.func, ast.Attribute):
                    continue
                attr = node.func.attr
                bad = attr in _HOST_SYNC_ATTRS
                if attr == "asarray" \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id in ("np", "numpy"):
                    bad = True
                if bad:
                    self._add(
                        node, "host-sync-in-lower",
                        f".{attr}() inside {fn.name}: lowered steps "
                        "must be pure tensor code — host "
                        "materialization belongs in LoweredStep.post "
                        "(and would break the segment's capture)")


def lint_file(path: str, lockorder, rel: Optional[str] = None
              ) -> List[Violation]:
    rel = rel or os.path.relpath(path, REPO_ROOT)
    with open(path, "r", encoding="utf-8") as fh:
        source = fh.read()
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Violation(rel, exc.lineno or 0, "syntax",
                          f"cannot parse: {exc.msg}")]
    return _FileLinter(path, rel, tree, source, lockorder).run()


def lint_paths(paths: List[str]) -> List[Violation]:
    lockorder = _load_lockorder()
    out: List[Violation] = []
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames
                               if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))  # type: ignore
        else:
            out.append(path)  # type: ignore
    files, out = out, []
    for f in files:
        out.extend(lint_file(f, lockorder))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="nnslint-torch",
        description="repo-specific concurrency/zero-copy lint for "
                    "nnstreamer_tpu_torch")
    ap.add_argument("paths", nargs="*", default=[PACKAGE])
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule in RULES:
            print(rule)
        return 0
    violations = lint_paths(list(args.paths))
    for v in violations:
        print(v)
    if violations:
        print(f"nnslint: {len(violations)} violation(s)", file=sys.stderr)
        return 1
    print("nnslint: clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
