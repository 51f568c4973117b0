"""minilua: a small Lua interpreter for script filters.

The reference's lua subplugin embeds liblua to run user scripts as stream
filters (ext/nnstreamer/tensor_filter/tensor_filter_lua.cc, 591 LoC; the
fixture scripts are tests/test_models/models/passthrough.lua and
scaler.lua).  This image has no Lua runtime, so the framework ships
its own interpreter for the Lua subset those filters use — written from
the Lua 5.x reference manual, not from any Lua implementation:

statements   assignment (incl. table fields), local, function defs,
             numeric for, generic for over pairs/ipairs, while,
             repeat/until, if/elseif/else, return, break, calls
expressions  precedence-climbing: or/and, comparisons, .., + -, * / %,
             unary - not #, ^, calls, colon method calls (strings
             dispatch via the string library), table constructors,
             field/index
values       numbers (int/float), strings, booleans, nil, 1-based
             tables; multiple return values with Lua's expression-list
             adjustment (non-final results truncate to one value, the
             final one expands; conditions take the first value)
stdlib       math.floor/ceil/abs/min/max/sqrt/huge · string.format/sub/
             len/upper/lower/rep/reverse/byte/char/find/match/gmatch/
             gsub with REAL Lua patterns (§6.4.1: classes %a %d %s %w
             %l %u %p %c %x + complements, [sets] with ranges and ^,
             * + - ? quantifiers, ^ $ anchors, captures incl. position
             captures and %1-%9 back-references, %b balanced, %f
             frontier; gsub takes string/function/table replacements
             with %0-%9 escapes and returns (result, count)) ·
             table.insert/remove/concat · tostring · tonumber · # ·
             print · setmetatable/getmetatable/rawget/rawset/type with
             __index (table or function, chained), __newindex, __call,
             AND the operator metamethods __add/__sub/__mul/__div/
             __mod/__pow/__unm/__eq/__lt/__le/__concat (first operand's
             metatable, then the second's, manual §2.8); closures
             capture lexical scope and MUTATE upvalues (the counter
             idiom works).  Not implemented: per-iteration
             loop-variable scoping, coroutines, goto — scripts touching
             those fail with a named LuaError (or behave as documented
             in Env for loop captures).

Execution compiles the AST to Python closures once (scripts run a
nested-loop body per frame — ~1M interpreted ops for the reference's
640×480 scaler — so a tree-walk per eval would be too slow).  Host
integration: callers inject globals (e.g. ``input_tensor``) and read
globals back (``inputTensorsInfo``); numpy-backed objects implementing
``__getitem__``/``__setitem__`` work as 1-based tensor proxies.

The port of ``nnstreamer_tpu/utils/minilua.py``, unchanged: the port keeps
its own copy (the interpreter imports nothing of either package).
"""

from __future__ import annotations

import math
import re
from typing import Any, Callable, Dict, List, Optional, Tuple


class LuaError(RuntimeError):
    pass


# ---------------------------------------------------------------------------
# lexer
# ---------------------------------------------------------------------------

_KEYWORDS = {"and", "break", "do", "else", "elseif", "end", "false", "for",
             "function", "if", "in", "local", "nil", "not", "or", "repeat",
             "return", "then", "true", "until", "while"}

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<num>0[xX][0-9a-fA-F]+
          |(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_]\w*)
  | (?P<str>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<op>\.\.|==|~=|<=|>=|[-+*/%^#<>=(){}\[\],;.:])
""", re.VERBOSE)


def _lex(src: str) -> List[Tuple[str, Any]]:
    toks: List[Tuple[str, Any]] = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise LuaError(f"lua: bad character {src[pos]!r} at {pos}")
        pos = m.end()
        kind = m.lastgroup
        text = m.group()
        if kind in ("ws", "comment"):
            continue
        if kind == "num":
            if text[:2] in ("0x", "0X"):
                toks.append(("num", int(text, 16)))
            elif "." in text or "e" in text or "E" in text:
                toks.append(("num", float(text)))
            else:
                toks.append(("num", int(text)))
        elif kind == "name":
            toks.append((text, text) if text in _KEYWORDS
                        else ("name", text))
        elif kind == "str":
            body = text[1:-1]
            toks.append(("str", re.sub(
                r"\\(.)",
                lambda m: {"n": "\n", "t": "\t", "r": "\r",
                           "a": "\a", "0": "\0"}.get(m.group(1),
                                                       m.group(1)),
                body)))
        else:
            toks.append((text, text))
    toks.append(("<eof>", None))
    return toks


# ---------------------------------------------------------------------------
# runtime values
# ---------------------------------------------------------------------------

class LuaTable:
    """1-based table: array part + hash part in one dict; optional
    metatable (``__index``/``__newindex``/``__call`` plus the operator
    metamethods ``__add``/``__sub``/``__mul``/``__div``/``__mod``/
    ``__pow``/``__unm``/``__eq``/``__lt``/``__le``/``__concat`` are
    honored — see _BINFN and the unary/power parsers)."""

    __slots__ = ("data", "metatable")

    def __init__(self, data: Optional[Dict[Any, Any]] = None):
        self.data = data or {}
        self.metatable: Optional["LuaTable"] = None

    def get(self, key):
        if isinstance(key, float) and key.is_integer():
            key = int(key)
        return self.data.get(key)

    def set(self, key, value):
        if isinstance(key, float) and key.is_integer():
            key = int(key)
        if value is None:
            # Lua: assigning nil DELETES the entry (pairs/# never see it)
            self.data.pop(key, None)
        else:
            self.data[key] = value

    def length(self) -> int:
        n = 0
        while (n + 1) in self.data:
            n += 1
        return n


class Env:
    """Variable scope: per-call locals chained to the DEFINING scope
    (lexical upvalues), over the shared globals table.

    Lua semantics: reads fall through locals → enclosing function
    locals → globals; PLAIN assignment writes the nearest existing
    binding in that chain (closures MUTATE captured upvalues — the
    counter idiom works), else the GLOBAL; ``local`` and loop control
    variables write the current frame explicitly.  The top-level chunk
    uses the globals table as its locals.  Subset note: a closure
    created inside a loop captures the frame, not a per-iteration
    binding (real Lua scopes loop variables per iteration)."""

    __slots__ = ("locals", "globals", "parent")

    def __init__(self, locals_: Dict[str, Any], globals_: Dict[str, Any],
                 parent: Optional["Env"] = None):
        self.locals = locals_
        self.globals = globals_
        self.parent = parent

    def get(self, name: str):
        e = self
        while e is not None:
            if name in e.locals:
                return e.locals[name]
            e = e.parent
        return self.globals.get(name)

    def set(self, name: str, value) -> None:
        e = self
        while e is not None:
            if name in e.locals:
                e.locals[name] = value
                return
            e = e.parent
        self.globals[name] = value

    def set_local(self, name: str, value) -> None:
        self.locals[name] = value


class _Break(Exception):
    pass


class _Return(Exception):
    def __init__(self, value):
        self.value = value


def _truthy(v) -> bool:
    if isinstance(v, tuple):              # a condition takes the FIRST
        v = v[0] if v else None           # of a multi-value result
    return v is not None and v is not False


def _index(obj, key, _depth=0):
    if _depth > 100:
        raise LuaError("lua: __index chain too deep")
    if isinstance(obj, LuaTable):
        v = obj.get(key)
        if v is None and obj.metatable is not None:
            handler = obj.metatable.get("__index")
            if isinstance(handler, LuaTable):
                return _index(handler, key, _depth + 1)
            if callable(handler):
                return _first(handler(obj, key))
        return v
    if isinstance(obj, str):
        # Lua strings carry a metatable with __index = the string
        # library (lstrlib.c createmetatable): ("x").rep and s:rep(2)
        # BOTH resolve here (mcall routes through _index); any other
        # key — numeric indexing included — is nil, never a Python
        # str.__getitem__ (which leaked a TypeError on string keys,
        # fuzz-found).  Divergence note: the method table is a shared
        # singleton, so a script REPLACING string.fn in its own
        # globals changes neither path (liblua points its string
        # metatable at the state's own string table, so there a
        # replacement affects both).
        if isinstance(key, str):
            return _string_lib().get(key)
        return None
    if hasattr(obj, "__getitem__"):
        if isinstance(key, float) and key.is_integer():
            key = int(key)
        return obj[key]
    raise LuaError(f"lua: cannot index {type(obj).__name__}")


def _first(v):
    """Single-value adjustment: a multi-value result (Python tuple) in a
    scalar position — operator operand, index key/object, parenthesized
    expression, keyed constructor value — takes its FIRST value
    (manual §3.4)."""
    if isinstance(v, tuple):
        return v[0] if v else None
    return v


def _adjust_values(vals: List[Any], n: int) -> List[Any]:
    """Lua multiple-value adjustment for an evaluated expression list:
    a non-final multi-value result (Python tuple) truncates to its first
    value, the FINAL one expands; the list is then padded with nil / cut
    to ``n`` (manual §3.4: expression-list adjustment)."""
    out = _expand_args(vals)
    return [out[i] if i < len(out) else None for i in range(n)]


def _expand_args(vals: List[Any]) -> List[Any]:
    """Call-argument adjustment: final multi-value expands, earlier ones
    truncate to their first value."""
    out: List[Any] = []
    for i, v in enumerate(vals):
        if isinstance(v, tuple):
            if i == len(vals) - 1:
                out.extend(v)
            else:
                out.append(v[0] if v else None)
        else:
            out.append(v)
    return out


def _setindex(obj, key, value, _depth=0):
    if _depth > 100:
        raise LuaError("lua: __newindex chain too deep")
    if isinstance(obj, LuaTable):
        # __newindex fires only for keys ABSENT from the table (manual
        # §2.4); existing keys raw-assign
        if obj.get(key) is None and obj.metatable is not None:
            handler = obj.metatable.get("__newindex")
            if isinstance(handler, LuaTable):
                return _setindex(handler, key, value, _depth + 1)
            if callable(handler):
                handler(obj, key, value)
                return
        obj.set(key, value)
        return
    if hasattr(obj, "__setitem__"):
        if isinstance(key, float) and key.is_integer():
            key = int(key)
        obj[key] = value
        return
    raise LuaError(f"lua: cannot index-assign {type(obj).__name__}")


def _call_value(f, args):
    """Invoke a Lua value: function, or table with a ``__call``
    metamethod (the callable-object pattern)."""
    if callable(f):
        return f(*args)
    if isinstance(f, LuaTable) and f.metatable is not None:
        handler = f.metatable.get("__call")
        if callable(handler):
            return handler(f, *args)
    if f is None:
        raise LuaError("lua: call of nil")
    raise LuaError(f"lua: cannot call a {type(f).__name__} value")


# ---------------------------------------------------------------------------
# parser + closure compiler
# ---------------------------------------------------------------------------

class _Parser:
    """Recursive-descent parser emitting Python closures.

    Compiled expressions are ``fn(env) -> value``; statements are
    ``fn(env) -> None``; ``env`` is the variable scope (function calls
    get a fresh child scope falling back to globals — sufficient for the
    script-filter subset, which uses globals + loop locals)."""

    def __init__(self, toks: List[Tuple[str, Any]]):
        self.toks = toks
        self.i = 0

    # -- token helpers -------------------------------------------------------
    def peek(self) -> str:
        return self.toks[self.i][0]

    def next(self) -> Tuple[str, Any]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, kind: str) -> Any:
        k, v = self.next()
        if k != kind:
            raise LuaError(f"lua: expected {kind!r}, got {k!r}")
        return v

    def accept(self, kind: str) -> bool:
        if self.peek() == kind:
            self.i += 1
            return True
        return False

    # -- chunk / block -------------------------------------------------------
    def parse_chunk(self) -> Callable[[Dict], None]:
        body = self.block(("<eof>",))
        self.expect("<eof>")
        return body

    def block(self, stops: Tuple[str, ...]) -> Callable[[Dict], None]:
        stmts: List[Callable] = []
        while self.peek() not in stops:
            st = self.statement()
            if st is not None:
                stmts.append(st)

        def run(env):
            for st in stmts:
                st(env)
        return run

    # -- statements ----------------------------------------------------------
    def statement(self) -> Optional[Callable]:
        k = self.peek()
        if k == ";":
            self.next()
            return None
        if k == "local":
            self.next()
            names = [self.expect("name")]
            while self.accept(","):
                names.append(self.expect("name"))
            exprs = []
            if self.accept("="):
                exprs = self.exprlist()

            def local_stmt(env, names=names, exprs=exprs):
                vals = _adjust_values([e(env) for e in exprs], len(names))
                for n, v in zip(names, vals):
                    env.set_local(n, v)
            return local_stmt
        if k == "function":
            self.next()
            name = self.expect("name")
            if self.peek() in (".", ":"):
                # function t.m(...) / function t:m(self-style) — define
                # into a table field; colon form prepends the implicit
                # `self` parameter (Lua manual §3.4.11)
                sep = self.next()[0]
                field = self.expect("name")
                fn = self.function_body(implicit_self=(sep == ":"))

                def mdef(env, name=name, field=field, fn=fn):
                    obj = env.get(name)
                    if obj is None:
                        raise LuaError(
                            f"lua: function {name}.{field}: {name!r} "
                            "is nil")
                    # same assignment rule as `obj.field = fn` (tables
                    # AND host __setitem__ proxies)
                    _setindex(obj, field, fn(env))
                return mdef
            fn = self.function_body()

            def fndef(env, name=name, fn=fn):
                env.set(name, fn(env))
            return fndef
        if k == "for":
            return self.for_stmt()
        if k == "while":
            self.next()
            cond = self.expr()
            self.expect("do")
            body = self.block(("end",))
            self.expect("end")

            def while_stmt(env, cond=cond, body=body):
                while _truthy(cond(env)):
                    try:
                        body(env)
                    except _Break:
                        break
            return while_stmt
        if k == "repeat":
            self.next()
            body = self.block(("until",))
            self.expect("until")
            cond = self.expr()

            def repeat_stmt(env, body=body, cond=cond):
                # body locals stay visible to the until-condition (same
                # env object runs both, per the Lua scoping rule)
                while True:
                    try:
                        body(env)
                    except _Break:
                        break
                    if _truthy(cond(env)):
                        break
            return repeat_stmt
        if k == "if":
            return self.if_stmt()
        if k == "return":
            self.next()
            exprs: List[Callable] = []
            if self.peek() not in ("end", "else", "elseif", "until",
                                   "<eof>", ";"):
                exprs = self.exprlist()

            def ret(env, exprs=tuple(exprs)):
                if not exprs:
                    raise _Return(None)
                if len(exprs) == 1:
                    # single expr: pass through (incl. a callee's own
                    # multi-value tuple — chained returns)
                    raise _Return(exprs[0](env))
                vals = _expand_args([e(env) for e in exprs])
                raise _Return(tuple(vals))
            return ret
        if k == "break":
            self.next()

            def brk(env):
                raise _Break()
            return brk
        return self.expr_or_assign()

    def for_stmt(self) -> Callable:
        self.next()
        var = self.expect("name")
        if self.peek() in (",", "in"):
            return self.generic_for(var)
        self.expect("=")
        start = self.expr()
        self.expect(",")
        stop = self.expr()
        step = None
        if self.accept(","):
            step = self.expr()
        self.expect("do")
        body = self.block(("end",))
        self.expect("end")

        _MISSING = object()

        def run(env, var=var, start=start, stop=stop, step=step,
                body=body, _MISSING=_MISSING):
            i = _first(start(env))
            limit = _first(stop(env))
            inc = _first(step(env)) if step else 1
            if inc == 0:
                raise LuaError("lua: for step is zero")
            saved = env.locals.get(var, _MISSING)
            try:
                while (i <= limit) if inc > 0 else (i >= limit):
                    env.set_local(var, i)
                    try:
                        body(env)
                    except _Break:
                        break
                    i += inc
            finally:
                # the control variable is a fresh local scoped to the
                # loop (Lua manual §3.3.5) — restore the outer binding
                if saved is _MISSING:
                    env.locals.pop(var, None)
                else:
                    env.locals[var] = saved
        return run

    def generic_for(self, first_var: str) -> Callable:
        """``for k, v in pairs(t) do … end`` — the Lua generic-for
        protocol: the in-list evaluates to (iterator, state, control);
        each round calls ``iterator(state, control)`` and stops when the
        first result is nil (manual §3.3.5)."""
        names = [first_var]
        while self.accept(","):
            names.append(self.expect("name"))
        self.expect("in")
        exprs = self.exprlist()
        self.expect("do")
        body = self.block(("end",))
        self.expect("end")

        _MISSING = object()

        def run(env, names=tuple(names), exprs=tuple(exprs), body=body,
                _MISSING=_MISSING):
            # standard expression-list adjustment to the (iterator,
            # state, control) triple — pairs/ipairs expand from one expr
            it, state, ctrl = _adjust_values([e(env) for e in exprs], 3)
            if not callable(it):
                raise LuaError("lua: generic for needs an iterator "
                               "function (pairs/ipairs)")
            saved = {n: env.locals.get(n, _MISSING) for n in names}
            try:
                while True:
                    res = it(state, ctrl)
                    if isinstance(res, tuple):
                        first = res[0] if res else None
                    else:
                        res = (res,)
                        first = res[0]
                    if first is None:
                        break
                    ctrl = first
                    for i, n in enumerate(names):
                        env.set_local(n, res[i] if i < len(res) else None)
                    try:
                        body(env)
                    except _Break:
                        break
            finally:
                for n, s in saved.items():
                    if s is _MISSING:
                        env.locals.pop(n, None)
                    else:
                        env.locals[n] = s
        return run

    def if_stmt(self) -> Callable:
        self.next()
        arms: List[Tuple[Optional[Callable], Callable]] = []
        cond = self.expr()
        self.expect("then")
        arms.append((cond, self.block(("elseif", "else", "end"))))
        while self.peek() == "elseif":
            self.next()
            c = self.expr()
            self.expect("then")
            arms.append((c, self.block(("elseif", "else", "end"))))
        if self.accept("else"):
            arms.append((None, self.block(("end",))))
        self.expect("end")

        def run(env, arms=arms):
            for cond, body in arms:
                if cond is None or _truthy(cond(env)):
                    body(env)
                    return
        return run

    def expr_or_assign(self) -> Callable:
        target = self.suffixed()
        if self.peek() in ("=", ","):
            targets = [target]
            while self.accept(","):
                targets.append(self.suffixed())
            self.expect("=")
            exprs = self.exprlist()
            setters = []
            for t in targets:
                if t[0] == "name":
                    setters.append(("name", t[1]))
                elif t[0] == "index":
                    setters.append(("index", t[1], t[2]))
                else:
                    raise LuaError("lua: cannot assign to expression")

            def assign(env, setters=setters, exprs=exprs):
                vals = _adjust_values([e(env) for e in exprs],
                                      len(setters))
                for s, v in zip(setters, vals):
                    if s[0] == "name":
                        env.set(s[1], v)
                    else:
                        _setindex(_first(s[1](env)), _first(s[2](env)), v)
            return assign
        # bare expression statement (function call)
        fn = self.finish_expr_from_suffixed(target)

        def run(env, fn=fn):
            fn(env)
        return run

    # -- functions -----------------------------------------------------------
    def function_body(self, implicit_self: bool = False) -> Callable:
        self.expect("(")
        params: List[str] = ["self"] if implicit_self else []
        if self.peek() != ")":
            params.append(self.expect("name"))
            while self.accept(","):
                params.append(self.expect("name"))
        self.expect(")")
        body = self.block(("end",))
        self.expect("end")

        def make(defenv, params=params, body=body):
            g = defenv.globals
            # the chunk-level env aliases globals as its locals; chaining
            # to it would only duplicate the globals fallback
            parent = defenv if defenv.locals is not g else None

            def call(*args):
                env = Env({}, g, parent)
                for i, p in enumerate(params):
                    env.set_local(p, args[i] if i < len(args) else None)
                try:
                    body(env)
                except _Return as r:
                    return r.value
                return None
            return call
        return make

    # -- expressions (precedence climbing) -----------------------------------
    #: precedence levels, loosest first; or/and get short-circuit
    #: handling inline in expr(), everything else dispatches via _BINFN
    _BINOPS = [
        {"or"}, {"and"},
        {"<", ">", "<=", ">=", "==", "~="},
        {".."}, {"+", "-"}, {"*", "/", "%"},
    ]

    def exprlist(self) -> List[Callable]:
        out = [self.expr()]
        while self.accept(","):
            out.append(self.expr())
        return out

    def expr(self, level: int = 0) -> Callable:
        if level >= len(self._BINOPS):
            return self.unary()
        ops = self._BINOPS[level]
        left = self.expr(level + 1)
        while self.peek() in ops:
            op = self.next()[0]
            right = self.expr(level + 1)
            if op == "or":
                left = (lambda a, b: lambda env:
                        (lambda v: v if _truthy(v) else _first(b(env)))
                        (_first(a(env))))(left, right)
            elif op == "and":
                left = (lambda a, b: lambda env:
                        (lambda v: _first(b(env)) if _truthy(v) else v)
                        (_first(a(env))))(left, right)
            else:
                fn = _BINFN[op]
                left = (lambda a, b, fn=fn: lambda env:
                        fn(_first(a(env)), _first(b(env))))(left, right)
        return left

    def unary(self) -> Callable:
        if self.accept("-"):
            operand = self.unary()

            def neg(env):
                v = _first(operand(env))
                if isinstance(v, (int, float)):
                    return -v
                h = _metamethod(v, "__unm")
                if h is not None:
                    return _first(_call_value(h, (v, v)))
                raise LuaError("lua: arithmetic (unary -) on non-number "
                               "(no __unm metamethod)")
            return neg
        if self.accept("not"):
            operand = self.unary()
            return lambda env: not _truthy(operand(env))
        if self.accept("#"):
            operand = self.unary()

            def length(env):
                v = _first(operand(env))
                if isinstance(v, LuaTable):
                    return v.length()
                if isinstance(v, str):
                    return len(v)
                try:
                    return len(v)
                except TypeError:
                    raise LuaError("lua: # of non-table")
            return length
        return self.power()

    def power(self) -> Callable:
        base = self.finish_expr_from_suffixed(self.suffixed())
        if self.accept("^"):
            exp = self.unary()       # right associative, binds over unary

            def powr(env):
                a, b = _first(base(env)), _first(exp(env))
                if isinstance(a, (int, float)) and isinstance(b,
                                                              (int, float)):
                    return _lua_rawpow(a, b)
                h = _meta_bin(a, b, "__pow")
                if h is not None:
                    return h()
                raise LuaError("lua: arithmetic (^) on non-number "
                               "(no __pow metamethod)")
            return powr
        return base

    # -- primary/suffixed expressions ---------------------------------------
    def suffixed(self):
        """Parse primary + suffixes, returning a tagged node so assignment
        targets can be distinguished: ('name', n) | ('index', objfn,
        keyfn) | ('expr', fn)."""
        k, v = self.next()
        if k == "num" or k == "str":
            node = ("expr", lambda env, v=v: v)
        elif k == "true":
            node = ("expr", lambda env: True)
        elif k == "false":
            node = ("expr", lambda env: False)
        elif k == "nil":
            node = ("expr", lambda env: None)
        elif k == "name":
            node = ("name", v)
        elif k == "(":
            inner = self.expr()
            self.expect(")")
            node = ("expr", lambda env, inner=inner: _first(inner(env)))
        elif k == "{":
            node = ("expr", self.table_constructor())
        elif k == "function":
            fn = self.function_body()
            node = ("expr", lambda env, fn=fn: fn(env))
        else:
            raise LuaError(f"lua: unexpected token {k!r}")

        while True:
            p = self.peek()
            if p == ".":
                self.next()
                field = self.expect("name")
                objfn = self.node_value(node)
                node = ("index", objfn, lambda env, f=field: f)
            elif p == "[":
                self.next()
                key = self.expr()
                self.expect("]")
                node = ("index", self.node_value(node), key)
            elif p == "(":
                self.next()
                args: List[Callable] = []
                if self.peek() != ")":
                    args = self.exprlist()
                self.expect(")")
                fnv = self.node_value(node)

                def call(env, fnv=fnv, args=tuple(args)):
                    f = _first(fnv(env))
                    return _call_value(
                        f, _expand_args([a(env) for a in args]))
                node = ("expr", call)
            elif p == ":":
                # method-call sugar: obj:m(a) == obj.m(obj, a); strings
                # dispatch through the `string` library table (the role
                # of Lua's string metatable)
                self.next()
                method = self.expect("name")
                self.expect("(")
                margs: List[Callable] = []
                if self.peek() != ")":
                    margs = self.exprlist()
                self.expect(")")
                objfn = self.node_value(node)

                def mcall(env, objfn=objfn, method=method,
                          margs=tuple(margs)):
                    obj = _first(objfn(env))
                    # strings resolve via _index's shared string-lib
                    # singleton — the SAME table dot access uses, so
                    # s:rep(2) and ('x').rep can never diverge
                    f = _index(obj, method)
                    if f is None:
                        raise LuaError(
                            f"lua: no method {method!r} on "
                            f"{_lua_str(obj)[:40]!r}")
                    return _call_value(
                        f, [obj] + _expand_args([a(env) for a in margs]))
                node = ("expr", mcall)
            else:
                return node

    def node_value(self, node) -> Callable:
        if node[0] == "name":
            name = node[1]

            def load(env, name=name):
                return env.get(name)
            return load
        if node[0] == "index":
            objfn, keyfn = node[1], node[2]
            return lambda env: _index(_first(objfn(env)),
                                      _first(keyfn(env)))
        return node[1]

    def finish_expr_from_suffixed(self, node) -> Callable:
        return self.node_value(node)

    def table_constructor(self) -> Callable:
        items: List[Tuple[Optional[Any], Callable]] = []
        while not self.accept("}"):
            if self.peek() == "name" and self.toks[self.i + 1][0] == "=":
                key = self.expect("name")
                self.expect("=")
                items.append((key, self.expr()))
            elif self.accept("["):
                key_expr = self.expr()
                self.expect("]")
                self.expect("=")
                items.append((key_expr, self.expr()))
            else:
                items.append((None, self.expr()))
            if not (self.accept(",") or self.accept(";")):
                self.expect("}")
                break

        def build(env, items=items):
            t = LuaTable()
            n = 0
            for i, (key, vexpr) in enumerate(items):
                v = vexpr(env)
                if key is None:
                    if isinstance(v, tuple):
                        # multi-value adjustment in constructors: the
                        # FINAL positional item expands, earlier ones
                        # truncate to their first value
                        if i == len(items) - 1:
                            for vv in v:
                                n += 1
                                t.set(n, vv)
                            continue
                        v = v[0] if v else None
                    n += 1
                    t.set(n, v)
                elif callable(key):
                    t.set(_first(key(env)), _first(v))
                else:
                    t.set(key, _first(v))
            return t
        return build


def _lua_str(v) -> str:
    if isinstance(v, float) and v.is_integer():
        return str(int(v))
    if v is True:
        return "true"
    if v is False:
        return "false"
    if v is None:
        return "nil"
    return str(v)


def _lua_setmetatable(t, mt):
    if not isinstance(t, LuaTable):
        raise LuaError("lua: setmetatable on non-table")
    if mt is not None and not isinstance(mt, LuaTable):
        raise LuaError("lua: metatable must be a table or nil")
    t.metatable = mt
    return t


def _lua_getmetatable(t):
    return t.metatable if isinstance(t, LuaTable) else None


def _lua_rawget(t, k):
    if not isinstance(t, LuaTable):
        raise LuaError("lua: rawget on non-table")
    return t.get(k)


def _lua_rawset(t, k, v):
    if not isinstance(t, LuaTable):
        raise LuaError("lua: rawset on non-table")
    t.set(k, v)
    return t


def _lua_type(v):
    if v is None:
        return "nil"
    if isinstance(v, bool):
        return "boolean"
    if isinstance(v, (int, float)):
        return "number"
    if isinstance(v, str):
        return "string"
    if isinstance(v, LuaTable):
        return "table"
    if callable(v):
        return "function"
    return "userdata"


def _lua_pairs(t):
    """Iterator triple over ALL entries (snapshot of keys at call time)."""
    if not isinstance(t, LuaTable):
        raise LuaError("lua: pairs expects a table")
    keys = list(t.data.keys())
    succ: Dict[Any, Any] = {}
    prev: Any = None
    for key in keys:
        succ[prev] = key
        prev = key

    def nxt(state, ctrl):
        k = succ.get(ctrl)
        # skip keys deleted mid-traversal (Lua allows removing fields
        # during pairs; next never yields a removed key)
        while k is not None and k not in t.data:
            k = succ.get(k)
        if k is None:
            return None
        return (k, t.get(k))

    return (nxt, t, None)


def _lua_ipairs(t):
    """Iterator triple over the 1..n array part, stopping at the first
    nil (the Lua ipairs contract)."""
    if not isinstance(t, LuaTable):
        raise LuaError("lua: ipairs expects a table")

    def nxt(state, ctrl):
        i = 1 if ctrl is None else int(ctrl) + 1
        v = state.get(i)
        if v is None:
            return None
        return (i, v)

    return (nxt, t, None)


def _lua_tonumber(v, base=None):
    if isinstance(v, bool):
        return None                 # Lua: booleans are not numbers
    if base is not None:
        try:
            return float(int(str(v).strip(), int(base)))
        except ValueError:
            return None
    if isinstance(v, (int, float)):
        return v
    try:
        s = str(v).strip()
        return int(s, 16) if s[:2].lower() == "0x" else (
            int(s) if s.lstrip("+-").isdigit() else float(s))
    except (ValueError, IndexError):
        return None


def _metamethod(v, event):
    if isinstance(v, LuaTable) and v.metatable is not None:
        return v.metatable.get(event)
    return None


def _meta_bin(a, b, event):
    """First operand's metamethod, then the second's (manual §2.8 order);
    None when neither has one."""
    h = _metamethod(a, event) or _metamethod(b, event)
    if h is None:
        return None
    return lambda: _first(_call_value(h, (a, b)))


def _arith(name, fn, event):
    def op(a, b):
        if isinstance(a, (int, float)) and isinstance(b, (int, float)):
            return fn(a, b)
        h = _meta_bin(a, b, event)
        if h is not None:
            return h()
        raise LuaError(f"lua: arithmetic ({name}) on non-number "
                       f"(no {event} metamethod)")
    return op


def _lua_lt(a, b):
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a < b
    if isinstance(a, str) and isinstance(b, str):
        return a < b
    h = _meta_bin(a, b, "__lt")
    if h is not None:
        return _truthy(h())
    raise LuaError("lua: attempt to compare incompatible values "
                   "(no __lt metamethod)")


def _lua_le(a, b):
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a <= b
    if isinstance(a, str) and isinstance(b, str):
        return a <= b
    h = _meta_bin(a, b, "__le")
    if h is not None:
        return _truthy(h())
    raise LuaError("lua: attempt to compare incompatible values "
                   "(no __le metamethod)")


def _lua_eq(a, b):
    if a is b:
        return True
    if isinstance(a, bool) != isinstance(b, bool):
        return False       # Lua: different types are never equal
                           # (Python would unify True == 1)
    if isinstance(a, LuaTable) and isinstance(b, LuaTable):
        # __eq fires only when neither raw-equal nor identical (§2.8)
        h = _meta_bin(a, b, "__eq")
        if h is not None:
            return _truthy(h())
        return False
    if isinstance(a, LuaTable) or isinstance(b, LuaTable):
        return False
    return a == b


def _lua_concat(a, b):
    if isinstance(a, (str, int, float)) and isinstance(b, (str, int, float)):
        return _lua_str(a) + _lua_str(b)
    h = _meta_bin(a, b, "__concat")
    if h is not None:
        return h()
    bad = a if not isinstance(a, (str, int, float)) else b
    raise LuaError(f"lua: attempt to concatenate a {_lua_type(bad)} "
                   "value (no __concat metamethod)")


def _lua_rawdiv(a, b):
    """Lua numbers are C doubles: 1/0 is inf, -1/0 is -inf, 0/0 is nan
    (Python raises ZeroDivisionError instead, which leaked)."""
    a, b = float(a), float(b)
    if b == 0.0:
        if a == 0.0 or math.isnan(a):
            return math.nan
        same_sign = (a > 0) == (math.copysign(1.0, b) > 0)
        return math.inf if same_sign else -math.inf
    return a / b


def _lua_rawmod(a, b):
    """a % b == a - floor(a/b)*b (manual §2.5.1); x%0 and inf%x are
    nan per C fmod, and floor() of an infinite quotient must not raise
    OverflowError."""
    a, b = float(a), float(b)
    if b == 0.0 or not math.isfinite(a):
        return math.nan
    if math.isinf(b):
        # C-Lua luai_nummod: m = fmod(a, b) (= a for finite a), then
        # m += b when m*b < 0 — so an opposite-sign infinite divisor
        # yields b itself: -5 % inf = inf, 5 % -inf = -inf.  Same-sign
        # (and ±0 numerators: 0*inf is nan, not < 0) keep a.
        return b if a != 0.0 and (a < 0.0) != (b < 0.0) else a
    q = a / b
    if not math.isfinite(q):
        return math.nan
    fl = math.floor(q)
    if fl == 0:
        return a                  # 5 % inf = 5 (0*inf would be nan)
    return a - fl * b


def _lua_rawpow(a, b):
    """C pow semantics: 0^-1 is inf, overflow saturates to inf, and a
    negative base with a non-integer exponent is nan (Python would
    raise or go complex)."""
    a, b = float(a), float(b)
    if a < 0 and not b.is_integer():
        return math.nan
    try:
        r = a ** b
    except (ZeroDivisionError, OverflowError):
        neg = a < 0 and b.is_integer() and int(b) % 2 == 1
        return -math.inf if neg else math.inf
    return r


_BINFN: Dict[str, Callable] = {
    "+": _arith("+", lambda a, b: a + b, "__add"),
    "-": _arith("-", lambda a, b: a - b, "__sub"),
    "*": _arith("*", lambda a, b: a * b, "__mul"),
    "/": _arith("/", _lua_rawdiv, "__div"),
    "%": _arith("%", _lua_rawmod, "__mod"),
    "<": _lua_lt, ">": lambda a, b: _lua_lt(b, a),
    "<=": _lua_le, ">=": lambda a, b: _lua_le(b, a),
    "==": _lua_eq, "~=": lambda a, b: not _lua_eq(a, b),
    "..": _lua_concat,
}


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

def _protect(name: str, fn):
    """Stdlib/builtin boundary guard: a bad argument to a library
    function — string.gsub(nil, ...), string.sub(s, 'o'), bare
    ipairs() — must surface as the named LuaError liblua raises ("bad
    argument #n to 'gsub'"), never as a leaked Python
    TypeError/ValueError (fuzz-found).  LuaError raised inside a
    function (its own argument checks) passes through untouched."""
    def wrapped(*args):
        try:
            return fn(*args)
        except LuaError:
            raise
        except (TypeError, ValueError, AttributeError, IndexError,
                KeyError, OverflowError) as exc:
            raise LuaError(
                f"lua: bad argument to '{name}' ({exc})") from exc
    return wrapped


def _protected_lib(entries: Dict[str, Any]) -> LuaTable:
    return LuaTable({k: (_protect(k, v) if callable(v) else v)
                     for k, v in entries.items()})


_STRING_LIB: Optional[LuaTable] = None


def _string_lib() -> LuaTable:
    """Shared string library for Lua's string-metatable __index (what
    makes ``s:rep(2)`` / ``("x").sub`` resolve)."""
    global _STRING_LIB
    if _STRING_LIB is None:
        _STRING_LIB = _make_string()
    return _STRING_LIB


def _make_math() -> LuaTable:
    return _protected_lib({
        "floor": lambda x: float(math.floor(x)),
        "ceil": lambda x: float(math.ceil(x)),
        "abs": abs, "sqrt": math.sqrt,
        "min": min, "max": max, "huge": math.inf,
    })


_FMT_RE = re.compile(r"%[-+ #0]*\d*(?:\.\d+)?[diouxXeEfgGqsc%]")


def _lua_format(fmt: str, *args) -> str:
    """string.format per the Lua manual's C-printf subset (%q quotes).
    Every '%' must start a valid directive — an invalid one raises
    wherever it sits (Lua: "invalid conversion")."""
    out: List[str] = []
    pos = 0
    ai = 0
    while True:
        i = fmt.find("%", pos)
        if i < 0:
            out.append(fmt[pos:])
            break
        out.append(fmt[pos:i])
        m = _FMT_RE.match(fmt, i)
        if m is None:
            raise LuaError("lua: string.format: invalid conversion "
                           f"{fmt[i:i + 2]!r}")
        pos = m.end()
        spec = m.group()
        conv = spec[-1]
        if conv == "%":
            out.append("%")
            continue
        if ai >= len(args):
            raise LuaError(f"lua: string.format: no argument #{ai + 1} "
                           f"for {spec!r}")
        a = args[ai]
        ai += 1
        if conv == "q":
            s = _lua_str(a).replace("\\", "\\\\").replace('"', '\\"')
            out.append('"' + s.replace("\n", "\\n") + '"')
        elif conv in "diouxX":
            out.append(spec % int(a))
        elif conv in "eEfgG":
            out.append(spec % float(a))
        elif conv == "c":
            out.append(chr(int(a)))
        else:                                   # s
            out.append(spec % _lua_str(a))
    return "".join(out)


def _str_range(s: str, i, j=None):
    """Lua 1-based, negative-from-end [i, j] → Python slice bounds."""
    n = len(s)
    i = int(i)
    j = n if j is None else int(j)
    if i < 0:
        i = max(n + i + 1, 1)
    elif i == 0:
        i = 1
    if j < 0:
        j = n + j + 1
    elif j > n:
        j = n
    return i - 1, j


# ---------------------------------------------------------------------------
# Lua pattern matching (manual §6.4.1), written from the manual's
# specification: character classes, sets, quantifiers (* + - ?),
# anchors, captures (incl. position captures and %1-%9 back-references),
# %b balanced match, %f frontier.  Recursive matcher with explicit
# backtracking — the same observable semantics as liblua's lstrlib, from
# a fresh implementation.
# ---------------------------------------------------------------------------

_HEXDIGITS = "0123456789abcdefABCDEF"


def _cls_match(ch: str, cl: str) -> bool:
    """Single class character (the letter after %%) against one char."""
    low = cl.lower()
    if low == "a":
        res = ch.isalpha()
    elif low == "c":
        res = ord(ch) < 32 or ord(ch) == 127
    elif low == "d":
        res = ch.isdigit()
    elif low == "l":
        res = ch.islower()
    elif low == "p":
        res = ch.isprintable() and not ch.isalnum() and not ch.isspace()
    elif low == "s":
        res = ch in " \t\n\r\f\v"
    elif low == "u":
        res = ch.isupper()
    elif low == "w":
        res = ch.isalnum()
    elif low == "x":
        res = ch in _HEXDIGITS
    else:
        return ch == cl                    # %. %% %( … : literal escape
    return (not res) if cl.isupper() else res


class _MatchState:
    __slots__ = ("src", "pat", "caps")

    def __init__(self, src: str, pat: str):
        self.src = src
        self.pat = pat
        self.caps: List[List[Any]] = []    # [start, len] ; len -1 = open,
        #                                    "pos" = position capture


def _class_end(ms: _MatchState, pi: int) -> int:
    """Index just past the single-item class starting at pat[pi]."""
    p = ms.pat
    c = p[pi]
    pi += 1
    if c == "%":
        if pi >= len(p):
            raise LuaError("lua pattern: malformed (ends with '%')")
        return pi + 1
    if c == "[":
        if pi < len(p) and p[pi] == "^":
            pi += 1
        first = True                        # ']' as first char is literal
        while True:
            if pi >= len(p):
                raise LuaError("lua pattern: malformed (missing ']')")
            if p[pi] == "]" and not first:
                return pi + 1
            if p[pi] == "%":
                pi += 1
                if pi >= len(p):
                    raise LuaError("lua pattern: malformed (ends with '%')")
            pi += 1
            first = False
    return pi


def _set_match(ms: _MatchState, ch: str, pi: int, ep: int) -> bool:
    """Char vs a [set] spanning pat[pi:ep] (pi at '[', ep past ']')."""
    p = ms.pat
    i = pi + 1
    neg = False
    if i < ep - 1 and p[i] == "^":
        neg = True
        i += 1
    res = False
    while i < ep - 1:
        if p[i] == "%" and i + 1 < ep - 1:
            if _cls_match(ch, p[i + 1]):
                res = True
            i += 2
        elif i + 2 < ep - 1 and p[i + 1] == "-":
            if p[i] <= ch <= p[i + 2]:
                res = True
            i += 3
        else:
            if p[i] == ch:
                res = True
            i += 1
    return res != neg


def _single_match(ms: _MatchState, si: int, pi: int, ep: int) -> bool:
    if si >= len(ms.src):
        return False
    ch = ms.src[si]
    c = ms.pat[pi]
    if c == ".":
        return True
    if c == "%":
        return _cls_match(ch, ms.pat[pi + 1])
    if c == "[":
        return _set_match(ms, ch, pi, ep)
    return ch == c


def _max_expand(ms: _MatchState, si: int, pi: int, ep: int):
    i = 0
    while _single_match(ms, si + i, pi, ep):
        i += 1
    while i >= 0:
        r = _pm(ms, si + i, ep + 1)
        if r is not None:
            return r
        i -= 1
    return None


def _min_expand(ms: _MatchState, si: int, pi: int, ep: int):
    while True:
        r = _pm(ms, si, ep + 1)
        if r is not None:
            return r
        if _single_match(ms, si, pi, ep):
            si += 1
        else:
            return None


def _pm(ms: _MatchState, si: int, pi: int):
    """Match pat[pi:] at src[si:]; returns the end index or None."""
    p, s = ms.pat, ms.src
    while True:
        if pi >= len(p):
            return si
        c = p[pi]
        if c == "(":
            if pi + 1 < len(p) and p[pi + 1] == ")":   # position capture
                ms.caps.append([si, "pos"])
                r = _pm(ms, si, pi + 2)
                if r is None:
                    ms.caps.pop()
                return r
            ms.caps.append([si, -1])
            r = _pm(ms, si, pi + 1)
            if r is None:
                ms.caps.pop()
            return r
        if c == ")":
            for cap in reversed(ms.caps):
                if cap[1] == -1:
                    cap[1] = si - cap[0]
                    r = _pm(ms, si, pi + 1)
                    if r is None:
                        cap[1] = -1
                    return r
            raise LuaError("lua pattern: unmatched ')'")
        if c == "$" and pi + 1 == len(p):
            return si if si == len(s) else None
        if c == "%" and pi + 1 < len(p):
            nx = p[pi + 1]
            if nx == "b":
                if pi + 3 >= len(p):
                    raise LuaError("lua pattern: malformed %b "
                                   "(needs two chars)")
                x, y = p[pi + 2], p[pi + 3]
                if si >= len(s) or s[si] != x:
                    return None
                bal, j = 1, si + 1
                while j < len(s):
                    if s[j] == y:
                        bal -= 1
                        if bal == 0:
                            r = _pm(ms, j + 1, pi + 4)
                            if r is not None:
                                return r
                            break
                    elif s[j] == x:
                        bal += 1
                    j += 1
                return None
            if nx == "f":
                if pi + 2 >= len(p) or p[pi + 2] != "[":
                    raise LuaError("lua pattern: missing '[' after %f")
                ep = _class_end(ms, pi + 2)
                prev = s[si - 1] if si > 0 else "\0"
                cur = s[si] if si < len(s) else "\0"
                if (not _set_match(ms, prev, pi + 2, ep)
                        and _set_match(ms, cur, pi + 2, ep)):
                    pi = ep
                    continue
                return None
            if nx.isdigit():                      # back-reference
                idx = int(nx) - 1
                if (nx == "0" or idx >= len(ms.caps)
                        or ms.caps[idx][1] in (-1, "pos")):
                    raise LuaError(f"lua pattern: invalid capture %{nx}")
                st, ln = ms.caps[idx]
                cap = s[st:st + ln]
                if s.startswith(cap, si):
                    si += len(cap)
                    pi += 2
                    continue
                return None
        ep = _class_end(ms, pi)
        q = p[ep] if ep < len(p) else ""
        if q == "?":
            if _single_match(ms, si, pi, ep):
                r = _pm(ms, si + 1, ep + 1)
                if r is not None:
                    return r
            pi = ep + 1
            continue
        if q == "+":
            if not _single_match(ms, si, pi, ep):
                return None
            return _max_expand(ms, si + 1, pi, ep)
        if q == "*":
            return _max_expand(ms, si, pi, ep)
        if q == "-":
            return _min_expand(ms, si, pi, ep)
        if not _single_match(ms, si, pi, ep):
            return None
        si += 1
        pi = ep


def _captures(ms: _MatchState, si: int, ei: int) -> List[Any]:
    """Captured values (whole match when no captures)."""
    if not ms.caps:
        return [ms.src[si:ei]]
    out = []
    for start, ln in ms.caps:
        if ln == "pos":
            out.append(float(start + 1))          # 1-based position
        elif ln == -1:
            raise LuaError("lua pattern: unfinished capture")
        else:
            out.append(ms.src[start:start + ln])
    return out


def _has_captures(pat: str) -> bool:
    i = 0
    while i < len(pat):
        c = pat[i]
        if c == "%":
            i += 2
        elif c == "[":
            # skip the whole [set] — '(' inside it is literal
            i += 1
            if i < len(pat) and pat[i] == "^":
                i += 1
            first = True
            while i < len(pat) and (pat[i] != "]" or first):
                if pat[i] == "%":
                    i += 1
                i += 1
                first = False
            i += 1
        elif c == "(":
            return True
        else:
            i += 1
    return False


def _pat_search(s: str, pat: str, init: int = 0):
    """Find the first match of `pat` in `s` at/after byte `init`.
    Returns (start, end, captures) with 0-based [start, end), or None."""
    anchor = pat.startswith("^")
    p0 = 1 if anchor else 0
    si = init
    while True:
        ms = _MatchState(s, pat)
        e = _pm(ms, si, p0)
        if e is not None:
            return si, e, _captures(ms, si, e)
        si += 1
        if anchor or si > len(s):
            return None


def _make_string() -> LuaTable:
    def sub(s, i, j=None):
        a, b = _str_range(s, i, j)
        return s[a:b] if a < b else ""

    def find(s, pat, init=1, plain=None):
        a, _ = _str_range(s, init)
        a = min(a, len(s))          # Lua 5.1 clamps init to #s+1
        if _truthy(plain):
            idx = s.find(pat, a)
            if idx < 0:
                return None
            return (float(idx + 1), float(idx + len(pat)))
        hit = _pat_search(s, pat, a)
        if hit is None:
            return None
        st, en, ms_caps = hit
        caps = () if not _has_captures(pat) else tuple(ms_caps)
        return (float(st + 1), float(en)) + caps

    def match(s, pat, init=1):
        a, _ = _str_range(s, init)
        a = min(a, len(s))          # Lua 5.1 clamps init to #s+1
        hit = _pat_search(s, pat, a)
        if hit is None:
            return None
        caps = hit[2]
        return caps[0] if len(caps) == 1 else tuple(caps)

    def gmatch(s, pat):
        state = {"pos": 0}

        def it(*_ignored):
            while state["pos"] <= len(s):
                hit = _pat_search(s, pat, state["pos"])
                if hit is None:
                    return None
                st, en, caps = hit
                state["pos"] = en + 1 if en == st else en  # empty-match step
                return caps[0] if len(caps) == 1 else tuple(caps)
            return None
        return it

    def _expand_repl(repl: str, caps: List[Any], whole: str) -> str:
        out: List[str] = []
        i = 0
        while i < len(repl):
            ch = repl[i]
            if ch == "%" and i + 1 < len(repl):
                nx = repl[i + 1]
                if nx == "%":
                    out.append("%")
                elif nx == "0":
                    out.append(whole)
                elif nx.isdigit():
                    idx = int(nx) - 1
                    if idx >= len(caps):
                        raise LuaError(
                            f"lua: string.gsub: invalid capture %{nx} "
                            "in replacement")
                    out.append(_lua_str(caps[idx]))
                else:
                    raise LuaError(
                        f"lua: string.gsub: invalid use of '%' in "
                        f"replacement ('%{nx}')")
                i += 2
            else:
                out.append(ch)
                i += 1
        return "".join(out)

    def gsub(s, pat, repl, n=None):
        limit = math.inf if n is None else int(n)
        out: List[str] = []
        pos = 0
        count = 0
        anchor = pat.startswith("^")
        while count < limit and pos <= len(s):
            hit = _pat_search(s, pat, pos)
            if hit is None:
                break
            st, en, caps = hit
            out.append(s[pos:st])
            whole = s[st:en]
            if isinstance(repl, str):
                rep = _expand_repl(repl, caps, whole)
            elif isinstance(repl, LuaTable):
                rep = repl.get(caps[0])
            elif callable(repl):
                rep = _first(repl(*caps))
            else:
                raise LuaError("lua: string.gsub: replacement must be a "
                               "string, table, or function")
            if rep is None or rep is False:     # nil/false: keep the match
                rep = whole
            elif not isinstance(rep, str):
                if isinstance(rep, (int, float)):
                    rep = _lua_str(rep)
                else:
                    raise LuaError("lua: string.gsub: replacement value "
                                   f"must be a string (got {_lua_type(rep)})")
            out.append(rep)
            count += 1
            if en == st:                         # empty match: emit + step
                if st < len(s):
                    out.append(s[st])
                pos = st + 1
            else:
                pos = en
            if anchor:
                break
        out.append(s[pos:])
        return ("".join(out), float(count))

    def byte(s, i=1):
        a, _ = _str_range(s, i)
        return float(ord(s[a])) if a < len(s) else None

    return _protected_lib({
        "format": _lua_format,
        "sub": sub, "len": lambda s: len(s),
        "upper": lambda s: s.upper(), "lower": lambda s: s.lower(),
        "rep": lambda s, n, sep=None: (
            (_lua_str(sep or "")).join([s] * int(n)) if int(n) > 0 else ""),
        "reverse": lambda s: s[::-1],
        "byte": byte,
        "char": lambda *cs: "".join(chr(int(c)) for c in cs),
        "find": find, "match": match, "gmatch": gmatch, "gsub": gsub,
    })


def _make_table() -> LuaTable:
    def insert(t: LuaTable, a, b=None):
        if b is None:
            t.set(t.length() + 1, a)
            return
        pos = int(a)
        n = t.length()
        if pos < 1 or pos > n + 1:
            raise LuaError(
                f"lua: table.insert: position {pos} out of bounds "
                f"(table length {n})")
        for k in range(n, pos - 1, -1):
            t.set(k + 1, t.get(k))
        t.set(pos, b)

    def remove(t: LuaTable, pos=None):
        n = t.length()
        if n == 0:
            return None
        p = n if pos is None else int(pos)
        v = t.get(p)
        for k in range(p, n):
            t.set(k, t.get(k + 1))
        t.data.pop(n, None)
        return v

    def concat(t: LuaTable, sep=""):
        return _lua_str(sep).join(
            _lua_str(t.get(k)) for k in range(1, t.length() + 1))

    return _protected_lib({"insert": insert, "remove": remove,
                           "concat": concat})


class LuaState:
    """A loaded script: globals table + compiled chunk."""

    def __init__(self, source: str,
                 host_globals: Optional[Dict[str, Any]] = None):
        # builtins go through the same _protect boundary as the stdlib
        # tables: bare ipairs() is a LuaError, not a Python TypeError
        self.globals: Dict[str, Any] = {
            "math": _make_math(),
            "string": _make_string(),
            "table": _make_table(),
        }
        self.globals.update({
            name: _protect(name, fn) for name, fn in {
                "tostring": _lua_str,
                "tonumber": _lua_tonumber,
                "pairs": _lua_pairs,
                "ipairs": _lua_ipairs,
                "print": lambda *a: print(
                    "[lua]", *[_lua_str(x) for x in a]),
                "setmetatable": _lua_setmetatable,
                "getmetatable": _lua_getmetatable,
                "rawget": _lua_rawget,
                "rawset": _lua_rawset,
                "type": _lua_type,
            }.items()})
        if host_globals:
            self.globals.update(host_globals)
        chunk = _Parser(_lex(source)).parse_chunk()
        try:
            # the top-level chunk's locals ARE the globals table
            chunk(Env(self.globals, self.globals))
        except _Return:
            pass                      # chunks may end with `return`
        except _Break:
            raise LuaError("lua: break outside a loop")

    def get(self, name: str):
        return self.globals.get(name)

    def set(self, name: str, value) -> None:
        self.globals[name] = value

    def call(self, name: str, *args):
        fn = self.globals.get(name)
        if fn is None:
            raise LuaError(f"lua: no function {name!r}")
        return fn(*args)
