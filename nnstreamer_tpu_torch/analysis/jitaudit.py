"""Static graph-capture boundary auditor: the bounded-executable
discipline as a machine-checked property.

The port's executable boundary is CUDA graph capture, not ``jax.jit``:
a function handed to :class:`~nnstreamer_tpu_torch._cuda.CapturedGraph`
or :class:`~nnstreamer_tpu_torch._cuda.GraphedStep` is recorded once per
signature and replayed after, and every hot path rests on the same
contract as the JAX package's: shapes reaching a captured executable are
QUANTIZED (``pad_rows`` / pow2) so the set of graphs stays bounded,
pools are updated IN PLACE (a captured function that rebinds a pool to
a new tensor copies the whole arena on every replay), and captured code
never syncs with the host (a sync inside a capture breaks it).  This
module is the port of ``nnstreamer_tpu/analysis/jitaudit.py``: the same
five rules, the same pragma and the same output, over the port's
boundary — an AST dataflow pass over the capture call graph
(``CapturedGraph(...)`` / ``GraphedStep(...)`` call sites, the model
forwards in :data:`KNOWN_JIT_ROOTS`, the closures the shape-keyed
getters build and the ``lower_step``/``lower_decode`` closures):

``unquantized-shape-at-jit``
    A shape-derived value (``len(x)``, ``x.shape[i]``, ``x.size(i)``,
    arithmetic on them) reaches an executable-cache key — a shape-keyed
    getter (``_step_fn``/``_pstep_fn``/``_chunk_fn``/``_prefill_fn``)
    — without flowing through a registered quantizer (``pad_rows``,
    ``quantize_prompt``, ``quantize_pages``, ``_next_pow2``).  Raw
    lengths at a capture signature mean one graph PER FILL LEVEL: a
    capture storm.

``missing-donation``
    A captured function rebinds a whole tensor parameter to a new
    tensor (``p = p.index_put(...)``, ``p = torch.cat([p, ...])``,
    ``p = p.clone()``), directly or one call level down, instead of
    updating it in place (``p.copy_``, ``p.index_copy_``,
    ``p.index_put_``).  The graph then allocates and copies the WHOLE
    buffer on every replay — the port's form of an undonated jit
    argument.

``host-sync-in-jit``
    ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``np.asarray``/
    ``np.array``, ``float()``/``int()``/``bool()`` or ``TensorBuffer.np``
    applied to a traced value, or ``torch.cuda.synchronize()``,
    anywhere in the capture call graph: each one syncs with the host,
    which a capture refuses.  Tracedness is propagated
    interprocedurally: a helper called with only static arguments (a
    shape, a config) stays host code even when a captured function
    calls it.

``tracer-branch``
    A Python ``if``/``while`` on a tensor's VALUE inside the capture
    graph: the capture records one branch and every replay takes it,
    whatever the data says.  Branching on shapes, ``len()``, dtypes and
    devices is static and fine; ``is None`` structure checks are fine.

``unbounded-signature``
    An executable-cache key builder (``_sig``/``_cfg_key``-style
    functions) iterates a parameter collection with no declared bound
    — a dict/list signature component whose cardinality nothing caps
    is an unbounded graph set by construction.  Declare the bound
    (slice, cap) or pragma WITH the reason the arity is fixed
    elsewhere.

Pragma: append ``# nnsjit: allow(<rule>)`` to the offending line or the
comment line directly above it (give the reason in the comment).

The pass is import-free (pure ``ast``): it audits files that import
torch without needing torch in the environment.  CLI::

    python -m nnstreamer_tpu_torch.analysis.jitaudit [path ...] \
        [--list-rules] [--json]

(default path: the port's package; exit 1 on findings).  The RUNTIME
half of the contract — every capture that actually happens, attributed
to a site — lives in :mod:`nnstreamer_tpu_torch.analysis.compileledger`.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
import sys
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

RULES = ("unquantized-shape-at-jit", "missing-donation",
         "host-sync-in-jit", "tracer-branch", "unbounded-signature")

#: registered shape quantizers: a value that flowed through one of
#: these is bounded by construction (idempotent, monotone, >= input,
#: capped — what licenses this whitelist)
QUANTIZERS = frozenset({"pad_rows", "quantize_prompt", "quantize_pages",
                        "_next_pow2"})

#: shape-keyed executable getters: their int arguments ARE the
#: executable-cache key (llm/engine.py warm-set dicts), so a raw
#: length here is a capture per fill level; the closures they build
#: are captured (audited as roots)
SHAPE_KEYED_GETTERS = frozenset({"_step_fn", "_pstep_fn", "_chunk_fn",
                                 "_prefill_fn"})

#: executable-cache key builders: unbounded-signature applies to their
#: bodies
SIG_BUILDERS = frozenset({"_sig", "_cfg_key"})

#: capture-graph roots that are wired through runtime indirection the
#: AST cannot see (the model forwards the filter backend and the decode
#: engine capture through closures): audited as if captured directly
KNOWN_JIT_ROOTS = frozenset({
    "forward_logits", "prefill_kv", "decode_step", "decode_step_pooled",
    "decode_step_paged", "prefill_chunk_paged",
    # nn.Module forwards: the models the filter backend captures
    "forward", "batched", "segment_forward",
})

#: lowering hooks whose nested defs are traced closures
#: (LoweredStep.fn joins the segment's captured computation)
LOWER_HOOKS = frozenset({"lower_step", "lower_decode"})

#: callees whose first argument is the function a capture records
CAPTURE_CALLEES = frozenset({"CapturedGraph", "GraphedStep"})

#: attribute calls that force a device->host sync on a traced value
#: (``np``: TensorBuffer.np materializes on the host)
HOST_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy", "np"})

#: attribute calls that sync with the device whatever they are called
#: on (``torch.cuda.synchronize()``, ``stream.synchronize()``)
DEVICE_SYNC_METHODS = frozenset({"synchronize"})

#: out-of-place updates: ``p = p.<one of these>(...)`` rebinds a pool
#: parameter to a new tensor (the in-place forms end in ``_``)
OUT_OF_PLACE_METHODS = frozenset({
    "index_put", "index_copy", "index_add", "index_fill", "scatter",
    "scatter_add", "masked_fill", "masked_scatter", "clone"})

#: torch functions that build a new tensor from a list holding ``p``
OUT_OF_PLACE_FUNCS = frozenset({"cat", "stack", "concat", "where"})

#: builtins that force concretization when applied to a tracer
HOST_CAST_BUILTINS = frozenset({"float", "int", "bool"})

#: annotation substrings marking a parameter as STATIC (python-level)
#: rather than traced: branches and casts on these are fine
_STATIC_ANN_TOKENS = ("int", "float", "bool", "str", "Config", "None",
                      "Callable")
_TRACED_ANN_TOKENS = ("Tensor", "ndarray", "Array", "Dict", "dict",
                      "List", "list", "Any", "Tuple", "tuple")

#: attribute roots that are module namespaces, not instances — a call
#: through them never resolves to a repo-local def by bare name
_MODULE_ROOTS = ("torch", "F", "np", "_np", "numpy", "nn", "os",
                 "time", "math", "json", "re", "sys", "ast", "_cuda")

#: higher-order callees whose Name arguments are function references
#: entering the traced graph (torch.func transforms, activation
#: checkpointing); a bare Name argument to anything else is just a value
_HOF_CALLEES = frozenset({"vmap", "grad", "grad_and_value", "jacrev",
                          "jacfwd", "vjp", "jvp", "functional_call",
                          "checkpoint"})


@dataclasses.dataclass
class Finding:
    path: str
    line: int
    rule: str
    func: str
    message: str

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}: {self.rule} "
                f"[{self.func}]: {self.message}")


def _pragma_lines(source: str) -> Dict[int, Set[str]]:
    """line number -> rules allowed there; a pragma on a pure comment
    line also covers the next non-comment line (nnslint convention)."""
    allowed: Dict[int, Set[str]] = {}
    pending: Set[str] = set()
    for i, text in enumerate(source.splitlines(), start=1):
        rules: Set[str] = set()
        marker = "# nnsjit: allow("
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


def _call_name(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return ""


def _is_jit_callee(func: ast.AST) -> bool:
    """``_cuda.CapturedGraph`` / ``GraphedStep`` (any spelling) as a
    call target: the capture boundary."""
    if isinstance(func, ast.Attribute):
        return func.attr in CAPTURE_CALLEES
    if isinstance(func, ast.Name):
        return func.id in CAPTURE_CALLEES
    return False


#: tensor metadata: static under capture even on a traced tensor
_SHAPE_ATTRS = ("shape", "ndim", "dtype", "device", "is_cuda", "layout",
                "requires_grad")
#: return annotations of host-scalar helpers
_STATIC_RETURNS = ("bool", "int", "float", "str")
#: tensor methods returning metadata, not data
_SHAPE_METHODS = ("size", "dim", "numel", "ndimension", "element_size",
                  "get_device", "is_contiguous", "stride", "data_ptr",
                  "storage_offset")


def _is_shape_access(node: ast.AST) -> bool:
    """Expressions that are STATIC under capture even when rooted at a
    traced value: ``x.shape``/``x.shape[i]``, ``x.size(i)``,
    ``x.ndim``, ``x.dtype``, ``x.device``, ``len(x)`` — metadata, not
    data."""
    if isinstance(node, ast.Subscript):
        return _is_shape_access(node.value)
    if isinstance(node, ast.Attribute):
        return node.attr in _SHAPE_ATTRS
    if isinstance(node, ast.Call):
        fn = node.func
        if isinstance(fn, ast.Attribute):
            return fn.attr in _SHAPE_METHODS
        return isinstance(fn, ast.Name) and fn.id == "len"
    if isinstance(node, (ast.Tuple, ast.List)):
        return all(_is_shape_access(e) or isinstance(e, ast.Constant)
                   for e in node.elts)
    return False


def _returns_static(node: ast.AST) -> bool:
    """``-> bool`` / ``-> int`` / ``-> float`` / ``-> str``."""
    ann = getattr(node, "returns", None)
    return isinstance(ann, ast.Name) and ann.id in _STATIC_RETURNS


def _params(node: ast.AST) -> List[ast.arg]:
    a = node.args
    return list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)


def _param_is_traced(arg: ast.arg) -> bool:
    """A parameter counts as traced unless its annotation names a
    static python scalar/config type.  Unannotated parameters (capture
    closures) are traced — that is what being captured means."""
    ann = arg.annotation
    if ann is None:
        return True
    try:
        text = ast.unparse(ann)
    except Exception:
        text = ""
    if any(tok in text for tok in _TRACED_ANN_TOKENS):
        return True
    return not any(tok in text for tok in _STATIC_ANN_TOKENS)


def _expr_traced(expr: ast.AST, tainted: Set[str],
                 static: FrozenSet[str] = frozenset()) -> bool:
    """True when a traced value's DATA (not its static metadata) feeds
    the expression: prune shape accesses at every level, and calls of
    ``static`` functions (annotated to return a python scalar: a
    placement or size decision, not data)."""
    if _is_shape_access(expr):
        return False
    if isinstance(expr, ast.Call) and _call_name(expr) in static:
        return False
    if isinstance(expr, ast.Name):
        return expr.id in tainted
    return any(_expr_traced(child, tainted, static)
               for child in ast.iter_child_nodes(expr))


def _own_nodes(node: ast.AST) -> List[ast.AST]:
    """All descendants of ``node`` EXCLUDING nested function bodies
    (nested defs are audited as their own functions)."""
    out: List[ast.AST] = []

    def walk(cur: ast.AST) -> None:
        for child in ast.iter_child_nodes(cur):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.Lambda)):
                continue
            out.append(child)
            walk(child)

    walk(node)
    return out


def _compute_taint(node: ast.AST, initial: Set[str],
                   static: FrozenSet[str] = frozenset()) -> Set[str]:
    """Forward taint over the function's OWN statements (two passes:
    the hot-path code shape is straight-line math, but a second pass
    picks up simple use-before-redef orderings)."""
    tainted = set(initial)
    own = _own_nodes(node)
    for _ in range(2):
        for sub in own:
            if isinstance(sub, ast.Assign):
                rhs = _expr_traced(sub.value, tainted, static)
                for t in sub.targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            if rhs:
                                tainted.add(n.id)
                            else:
                                tainted.discard(n.id)
            elif isinstance(sub, ast.AugAssign):
                if isinstance(sub.target, ast.Name) \
                        and _expr_traced(sub.value, tainted, static):
                    tainted.add(sub.target.id)
            elif isinstance(sub, ast.For):
                if _expr_traced(sub.iter, tainted, static):
                    for n in ast.walk(sub.target):
                        if isinstance(n, ast.Name):
                            tainted.add(n.id)
    # params are axioms: a reassignment cannot untaint the NAME when
    # the update derives from itself (p = p.index_put(...))
    tainted |= initial & _compute_selfupdates(node)
    return tainted


def _compute_selfupdates(node: ast.AST) -> Set[str]:
    out: Set[str] = set()
    for sub in _own_nodes(node):
        if isinstance(sub, ast.Assign):
            rhs_names = {n.id for n in ast.walk(sub.value)
                         if isinstance(n, ast.Name)}
            for t in sub.targets:
                if isinstance(t, ast.Name) and t.id in rhs_names:
                    out.add(t.id)
    return out


@dataclasses.dataclass
class _FuncInfo:
    name: str
    qual: str
    node: ast.AST                       # FunctionDef | AsyncFunctionDef
    file: "_FileInfo"
    parent_names: Tuple[str, ...]       # enclosing def/class names


@dataclasses.dataclass
class _FileInfo:
    path: str
    rel: str
    tree: ast.Module
    source: str
    allowed: Dict[int, Set[str]]


class _JitGraph:
    """Cross-file function table + interprocedural traced-parameter
    masks, propagated from the capture roots: a callee's parameter is
    traced iff SOME in-graph call site feeds it a traced argument (or
    the callee is itself a root, where annotations decide)."""

    def __init__(self, files: List[_FileInfo]) -> None:
        self.files = files
        self.funcs: List[_FuncInfo] = []
        self.by_name: Dict[str, List[_FuncInfo]] = {}
        self.by_id: Dict[int, _FuncInfo] = {}
        self.jit_sites: List[Tuple[_FileInfo, ast.Call]] = []
        for fi in files:
            self._collect_file(fi)
        #: functions annotated to return a python scalar (every def of
        #: the name): their results are host values, not traced data
        self.static_calls: FrozenSet[str] = frozenset(
            name for name, infos in self.by_name.items()
            if all(_returns_static(i.node) for i in infos))
        #: id(node) -> set of traced parameter names (membership in
        #: this dict IS "in the capture graph")
        self.masks: Dict[int, Set[str]] = {}
        self._propagate()

    # -- collection ----------------------------------------------------
    def _collect_file(self, fi: _FileInfo) -> None:
        stack: List[str] = []

        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    info = _FuncInfo(child.name,
                                     ".".join(stack + [child.name]),
                                     child, fi, tuple(stack))
                    self.funcs.append(info)
                    self.by_name.setdefault(child.name, []).append(info)
                    self.by_id[id(child)] = info
                    stack.append(child.name)
                    walk(child)
                    stack.pop()
                elif isinstance(child, ast.ClassDef):
                    stack.append(child.name)
                    walk(child)
                    stack.pop()
                else:
                    walk(child)

        walk(fi.tree)
        for node in ast.walk(fi.tree):
            if isinstance(node, ast.Call) and _is_jit_callee(node.func):
                self.jit_sites.append((fi, node))

    def resolve(self, name: str, fi: _FileInfo) -> Optional[_FuncInfo]:
        """Callee resolution: same file first, else a UNIQUE global
        match (ambiguous bare names are skipped, not guessed)."""
        cands = self.by_name.get(name, [])
        local = [c for c in cands if c.file is fi]
        if len(local) == 1:
            return local[0]
        if len(cands) == 1:
            return cands[0]
        return None

    # -- roots + mask propagation --------------------------------------
    def _root_mask(self, info: _FuncInfo) -> Set[str]:
        # a method's receiver is the module / element: structure the
        # capture closes over, not traced data
        return {a.arg for a in _params(info.node)
                if _param_is_traced(a) and a.arg not in ("self", "cls")}

    def _roots(self) -> List[_FuncInfo]:
        out: List[_FuncInfo] = []
        seen: Set[int] = set()

        def add(info: Optional[_FuncInfo]) -> None:
            if info is not None and id(info.node) not in seen:
                seen.add(id(info.node))
                out.append(info)

        for fi, call in self.jit_sites:
            if not call.args:
                continue
            fn = call.args[0]
            if isinstance(fn, ast.Name):
                add(self.resolve(fn.id, fi))
            elif isinstance(fn, ast.Call):
                # CapturedGraph(make_step(...)): the factory's closures
                # are what the capture records
                factory = self.resolve(_call_name(fn), fi)
                if factory is not None:
                    for child in ast.iter_child_nodes(factory.node):
                        if id(child) in self.by_id:
                            add(self.by_id[id(child)])
        for info in self.funcs:
            if info.name in KNOWN_JIT_ROOTS:
                add(info)
            elif info.parent_names and \
                    info.parent_names[-1] in (LOWER_HOOKS
                                              | SHAPE_KEYED_GETTERS):
                add(info)
        return out

    def _propagate(self) -> None:
        work: List[_FuncInfo] = []
        for info in self._roots():
            self.masks[id(info.node)] = self._root_mask(info)
            work.append(info)
        while work:
            info = work.pop()
            mask = self.masks[id(info.node)]
            taint = _compute_taint(info.node, mask, self.static_calls)
            for sub in _own_nodes(info.node):
                if not isinstance(sub, ast.Call):
                    continue
                self._flow_call(info, sub, taint, work)
                # functions passed BY NAME into a torch.func transform
                # (vmap, grad, functional_call) are traced with all
                # their (unannotated) params
                if _call_name(sub) in _HOF_CALLEES:
                    for a in list(sub.args) + [kw.value
                                               for kw in sub.keywords]:
                        if isinstance(a, ast.Name):
                            target = self.resolve(a.id, info.file)
                            if target is not None:
                                self._grow(target,
                                           self._root_mask(target),
                                           work)

    def _flow_call(self, info: _FuncInfo, call: ast.Call,
                   taint: Set[str], work: List[_FuncInfo]) -> None:
        callee_name: Optional[str] = None
        fn = call.func
        same_file_only = False
        if isinstance(fn, ast.Name):
            callee_name = fn.id
        elif isinstance(fn, ast.Attribute):
            root = fn.value
            if not (isinstance(root, ast.Name)
                    and root.id in _MODULE_ROOTS):
                # a bare method name is only trustworthy within its
                # own file — `x.find(...)` must not resolve to an
                # unrelated global `find` elsewhere in the package
                callee_name = fn.attr
                same_file_only = True
        if callee_name is None:
            return
        target = self.resolve(callee_name, info.file)
        if same_file_only and target is not None \
                and target.file is not info.file:
            return
        if target is None or target.node is info.node:
            return
        params = _params(target.node)
        names = [a.arg for a in params]
        # a parameter annotated as a python scalar / config stays static
        # whatever the call site passes (the declaration is the contract)
        static_params = {a.arg for a in params
                         if a.annotation is not None
                         and not _param_is_traced(a)}
        # methods called through an instance: drop the self slot
        offset = 1 if names[:1] == ["self"] and not (
            isinstance(fn, ast.Name)) else 0
        grow: Set[str] = set()
        for pos, a in enumerate(call.args):
            idx = pos + offset
            if idx < len(names) and _expr_traced(a, taint,
                                                 self.static_calls):
                grow.add(names[idx])
        for kw in call.keywords:
            if kw.arg in names and _expr_traced(kw.value, taint,
                                                self.static_calls):
                grow.add(kw.arg)
        grow -= static_params
        if grow:
            self._grow(target, grow, work)

    def _grow(self, info: _FuncInfo, add: Set[str],
              work: List[_FuncInfo]) -> None:
        cur = self.masks.get(id(info.node))
        if cur is None:
            self.masks[id(info.node)] = set(add)
            work.append(info)
        elif not add <= cur:
            cur |= add
            work.append(info)


class _Auditor:
    def __init__(self, graph: _JitGraph) -> None:
        self.graph = graph
        self.findings: List[Finding] = []

    def _add(self, fi: _FileInfo, node: ast.AST, rule: str, func: str,
             message: str) -> None:
        line = getattr(node, "lineno", 0)
        if rule in fi.allowed.get(line, ()):
            return
        self.findings.append(Finding(fi.rel, line, rule, func, message))

    def run(self) -> List[Finding]:
        for info in self.graph.funcs:
            mask = self.graph.masks.get(id(info.node))
            if mask is not None:
                self._audit_traced(info, mask)
            if info.name in SIG_BUILDERS:
                self._audit_signature(info)
            self._audit_host_quantization(info)
        self._audit_donation()
        # one finding per site+rule (nested walks overlap)
        seen, unique = set(), []
        for f in sorted(self.findings,
                        key=lambda f: (f.path, f.line, f.rule)):
            key = (f.path, f.line, f.rule)
            if key not in seen:
                seen.add(key)
                unique.append(f)
        return unique

    # -- traced-body rules: host-sync-in-jit + tracer-branch -----------
    def _audit_traced(self, info: _FuncInfo, mask: Set[str]) -> None:
        tainted = _compute_taint(info.node, mask,
                                 self.graph.static_calls)
        for sub in _own_nodes(info.node):
            if isinstance(sub, ast.Call):
                self._check_host_sync(info, sub, tainted)
            elif isinstance(sub, (ast.If, ast.While)):
                self._check_branch(info, sub, tainted)

    def _check_host_sync(self, info: _FuncInfo, call: ast.Call,
                         tainted: Set[str]) -> None:
        fn = call.func
        name = _call_name(call)
        static = self.graph.static_calls
        arg_traced = any(_expr_traced(a, tainted, static)
                         for a in call.args)
        if isinstance(fn, ast.Attribute):
            if name in HOST_SYNC_METHODS \
                    and _expr_traced(fn.value, tainted, static):
                self._add(info.file, call, "host-sync-in-jit",
                          info.qual,
                          f".{name}() on a traced value forces a "
                          "device->host sync inside the capture graph "
                          "— return the tensor and materialize outside")
                return
            if name in DEVICE_SYNC_METHODS:
                self._add(info.file, call, "host-sync-in-jit",
                          info.qual,
                          f".{name}() inside the capture graph waits "
                          "on the device, which a capture refuses — "
                          "synchronize in the caller")
                return
            if name in ("asarray", "array") \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id in ("np", "numpy", "_np") \
                    and arg_traced:
                self._add(info.file, call, "host-sync-in-jit",
                          info.qual,
                          f"np.{name}() on a traced value "
                          "materializes on host mid-capture — use "
                          "torch, or hoist the conversion out of the "
                          "capture graph")
                return
        if isinstance(fn, ast.Name) and name in HOST_CAST_BUILTINS \
                and arg_traced:
            self._add(info.file, call, "host-sync-in-jit", info.qual,
                      f"{name}() on a traced value reads the tensor "
                      "on the host (device sync; the capture records "
                      "one value for every replay) — keep it a tensor "
                      "or make the input static")

    def _check_branch(self, info: _FuncInfo, node: ast.AST,
                      tainted: Set[str]) -> None:
        test = node.test
        # `x is None` / `x is not None` is STRUCTURE, not data
        if isinstance(test, ast.Compare) \
                and all(isinstance(op, (ast.Is, ast.IsNot))
                        for op in test.ops):
            return
        if _expr_traced(test, tainted, self.graph.static_calls):
            kw = "while" if isinstance(node, ast.While) else "if"
            self._add(info.file, node, "tracer-branch", info.qual,
                      f"python `{kw}` on a tensor's value: the "
                      "capture records one branch and every replay "
                      "takes it (and reading the value syncs) — use "
                      "torch.where, or branch on shapes (static)")

    # -- unbounded-signature -------------------------------------------
    def _audit_signature(self, info: _FuncInfo) -> None:
        params = {a.arg for a in _params(info.node)}
        for sub in ast.walk(info.node):
            iters: List[ast.AST] = []
            if isinstance(sub, (ast.GeneratorExp, ast.ListComp,
                                ast.SetComp, ast.DictComp)):
                iters = [c.iter for c in sub.generators]
            elif isinstance(sub, ast.For):
                iters = [sub.iter]
            for it in iters:
                root = it
                # unwrap sorted(x) / vars(x).items() / enumerate(x)
                while True:
                    if isinstance(root, ast.Call):
                        if isinstance(root.func, ast.Attribute):
                            root = root.func.value
                            continue
                        if root.args:
                            root = root.args[0]
                            continue
                    break
                if isinstance(root, ast.Subscript):
                    continue   # x[:n] — an explicit bound
                if isinstance(root, ast.Name) and root.id in params:
                    self._add(
                        info.file, sub, "unbounded-signature",
                        info.qual,
                        f"signature builder iterates parameter "
                        f"{root.id!r} with no declared bound: a "
                        "dict/list key component nothing caps is an "
                        "unbounded executable set — slice/cap it, or "
                        "pragma WITH the reason the arity is fixed")

    # -- unquantized-shape-at-jit --------------------------------------
    def _audit_host_quantization(self, info: _FuncInfo) -> None:
        """Host-side pass over EVERY function: shape-derived ints must
        be quantized before keying an executable getter."""
        shape_vars: Set[str] = set()
        clean_vars: Set[str] = set()

        def tainted_expr(expr: ast.AST) -> bool:
            if isinstance(expr, ast.Call):
                if _call_name(expr) in QUANTIZERS:
                    return False
                if _is_shape_access(expr):
                    return True         # len(x) / x.size(i) / x.numel()
                return any(tainted_expr(a) for a in expr.args)
            if _is_shape_access(expr):
                return True
            if isinstance(expr, ast.Name):
                return expr.id in shape_vars and \
                    expr.id not in clean_vars
            if isinstance(expr, (ast.BinOp, ast.IfExp, ast.Tuple,
                                 ast.List, ast.Compare, ast.BoolOp,
                                 ast.UnaryOp)):
                return any(tainted_expr(c)
                           for c in ast.iter_child_nodes(expr))
            return False

        own = _own_nodes(info.node)
        for sub in own:
            if isinstance(sub, ast.Assign):
                is_taint = tainted_expr(sub.value)
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        if is_taint:
                            shape_vars.add(t.id)
                            clean_vars.discard(t.id)
                        else:
                            clean_vars.add(t.id)
                            shape_vars.discard(t.id)
        for sub in own:
            if not isinstance(sub, ast.Call):
                continue
            if _call_name(sub) in SHAPE_KEYED_GETTERS:
                for a in sub.args:
                    if tainted_expr(a):
                        self._add(
                            info.file, sub, "unquantized-shape-at-jit",
                            info.qual,
                            f"shape-derived value reaches "
                            f"{_call_name(sub)}() — an executable-"
                            "cache key — without a registered "
                            "quantizer (pad_rows / quantize_prompt / "
                            "quantize_pages / _next_pow2): one "
                            "captured graph per fill level")

    # -- missing-donation ----------------------------------------------
    def _captured(self, fi: _FileInfo, call: ast.Call
                  ) -> List[_FuncInfo]:
        """The functions a capture call site records: a resolvable Name,
        or the closures a factory call builds."""
        if not call.args:
            return []
        fn = call.args[0]
        if isinstance(fn, ast.Name):
            target = self.graph.resolve(fn.id, fi)
            return [target] if target is not None else []
        if isinstance(fn, ast.Call):
            factory = self.graph.resolve(_call_name(fn), fi)
            if factory is not None:
                return [self.graph.by_id[id(c)]
                        for c in ast.iter_child_nodes(factory.node)
                        if id(c) in self.graph.by_id]
        return []

    def _audit_donation(self) -> None:
        for fi, call in self.graph.jit_sites:
            for target in self._captured(fi, call):
                mutated = self._mutated_param_indices(target, depth=1)
                if not mutated:
                    continue
                names = [a.arg for a in _params(target.node)]
                self._add(
                    fi, call, "missing-donation", target.name,
                    f"captured function rebinds tensor parameter(s) "
                    f"{[names[i] for i in sorted(mutated)]} to a new "
                    "tensor (an out-of-place update): every replay "
                    "allocates and copies the whole buffer — update "
                    "it in place (copy_ / index_copy_ / index_put_)")

    def _mutated_param_indices(self, info: _FuncInfo,
                               depth: int) -> Set[int]:
        """Positional param indices rebound out of place: ``p =
        p.index_put(...)`` / ``p = p.clone()`` / ``p = torch.cat([p,
        ...])`` — plus one level of positional flow into callees that do
        the same."""
        node = info.node
        index = {a.arg: i for i, a in enumerate(_params(node))}
        mutated: Set[int] = set()
        for sub in _own_nodes(node):
            if not isinstance(sub, ast.Assign):
                continue
            for t in sub.targets:
                if isinstance(t, ast.Name) and t.id in index \
                        and self._out_of_place_update_of(sub.value,
                                                         t.id):
                    mutated.add(index[t.id])
        if depth > 0:
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                callee = self.graph.resolve(_call_name(sub), info.file)
                if callee is None or callee.node is node:
                    continue
                inner = self._mutated_param_indices(callee,
                                                    depth=depth - 1)
                if not inner:
                    continue
                for pos, a in enumerate(sub.args):
                    if isinstance(a, ast.Name) and a.id in index \
                            and pos in inner:
                        mutated.add(index[a.id])
        return mutated

    @staticmethod
    def _out_of_place_update_of(expr: ast.AST, name: str) -> bool:
        for n in ast.walk(expr):
            if not isinstance(n, ast.Call):
                continue
            fn = n.func
            # name.index_put(...) / name.scatter(...) / name.clone()
            if isinstance(fn, ast.Attribute) \
                    and fn.attr in OUT_OF_PLACE_METHODS \
                    and isinstance(fn.value, ast.Name) \
                    and fn.value.id == name:
                return True
            # torch.cat([name, ...]) / torch.where(mask, v, name)
            if _call_name(n) in OUT_OF_PLACE_FUNCS:
                for a in n.args:
                    elts = (a.elts if isinstance(a, (ast.List, ast.Tuple))
                            else [a])
                    if any(isinstance(e, ast.Name) and e.id == name
                           for e in elts):
                        return True
        return False


def _iter_py(paths: List[str]) -> List[str]:
    out: List[str] = []
    for path in paths:
        if os.path.isdir(path):
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(os.path.join(dirpath, fn))
        else:
            out.append(path)
    return out


def audit_paths(paths: List[str],
                root: Optional[str] = None) -> List[Finding]:
    """The entry point the CLI and ``launch.py --check --jit`` share:
    parse every file, build ONE cross-file capture graph (the decode
    twins are defined in models/ and captured from llm/), and run the
    five rules."""
    root = root or os.getcwd()
    files: List[_FileInfo] = []
    findings: List[Finding] = []
    for path in _iter_py(paths):
        rel = os.path.relpath(path, root)
        try:
            with open(path, "r", encoding="utf-8") as fh:
                source = fh.read()
            tree = ast.parse(source, filename=path)
        except SyntaxError as exc:
            findings.append(Finding(rel, exc.lineno or 0, "syntax", "-",
                                    f"cannot parse: {exc.msg}"))
            continue
        except OSError as exc:
            findings.append(Finding(rel, 0, "io", "-", str(exc)))
            continue
        files.append(_FileInfo(path, rel, tree, source,
                               _pragma_lines(source)))
    graph = _JitGraph(files)
    findings.extend(_Auditor(graph).run())
    return findings


#: the audited package when no path is given
PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    """CLI (the port of ``tools/nnsjit.py``): findings one a line, exit
    1 when any remain."""
    ap = argparse.ArgumentParser(
        prog="nnsjit-torch", description="static graph-capture boundary "
                                         "audit (bounded-executable "
                                         "discipline)")
    ap.add_argument("paths", nargs="*", default=[PACKAGE])
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule in RULES:
            print(rule)
        return 0
    findings = audit_paths(list(args.paths),
                           root=os.path.dirname(PACKAGE))
    if args.json:
        print(json.dumps([vars(f) for f in findings], indent=2))
    else:
        for f in findings:
            print(f)
    if findings:
        print(f"nnsjit: {len(findings)} finding(s)", file=sys.stderr)
        return 1
    if not args.json:
        print("nnsjit: clean", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
