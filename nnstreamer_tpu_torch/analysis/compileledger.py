"""Runtime compile-ledger sentinel: every executable build, attributed.

The port's copy of ``nnstreamer_tpu/analysis/compileledger.py``: the same
API, the same exceptions and the same code (only the docstrings differ).
In the port a "compile" is the capture of a CUDA graph on the card and
the first build of a signature's callable on the CPU, so one run gives
the same ledger on either device, and the same ledger as the JAX
package.  With ``NNS_JIT_SENTINEL=1`` every executable-cache miss in the
wired sites (the ``TorchExecMixin`` dispatch path and the two
``DecodeEngine`` warm-set getters) calls :func:`record` with a *site* (a
stable dotted name, ``llm.engine.step``) and a *signature* (the hashable
tuple that keyed the executable).  The ledger keeps, per site:

- the ordered compile events, each carrying the **field diff against
  the nearest cached neighbor** (the one previously recorded signature
  differing in the fewest fields);
- a **budget**, declared at the site with :func:`compile_budget`: the
  number of distinct signatures the site may build.  Exceeding it raises
  :class:`CompileBudgetExceeded` carrying both the offending signature
  and its nearest neighbor, diffed.

The ledger exports ``nns_jit_compiles_total{site=...}`` through the obs
registry (``obs/metrics.py``).

Sentinel OFF (the default) costs one attribute load and one falsy test
per *compile*; dispatch paths guard their signature bookkeeping with
``if compileledger.ENABLED:`` so steady-state inference pays nothing.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .sanitizer import make_lock

__all__ = [
    "ENABLED", "enabled", "configure", "record", "compile_budget",
    "declare_budget", "snapshot", "events", "budgets", "reset",
    "CompileEvent", "CompileBudgetExceeded", "diff_signatures",
    "format_diff", "LEDGER",
]


def _env_on() -> bool:
    return os.environ.get("NNS_JIT_SENTINEL", "").strip().lower() \
        not in ("", "0", "false", "no", "off")


#: module-level flag so hot paths can guard with a single attribute
#: load; mutate only through :func:`configure`
ENABLED: bool = _env_on()


def enabled() -> bool:
    return ENABLED


def configure(on: bool) -> None:
    """Flip the sentinel at runtime (tests, bench stages).  Does not
    clear the ledger — call :func:`reset` for that."""
    global ENABLED
    ENABLED = bool(on)


def _normalize(signature: Any) -> Tuple[Tuple[str, Any], ...]:
    """Signatures become ``((field, value), ...)`` so diffs are
    field-addressed.  Mappings keep their keys; plain sequences get
    positional ``arg[i]`` names; scalars become a single field."""
    if isinstance(signature, dict):
        return tuple(sorted((str(k), v) for k, v in signature.items()))
    if isinstance(signature, (tuple, list)):
        out = []
        for i, v in enumerate(signature):
            if isinstance(v, (tuple, list)) and len(v) == 2 \
                    and isinstance(v[0], str):
                out.append((v[0], v[1]))
            else:
                out.append((f"arg[{i}]", v))
        return tuple(out)
    return ((("value"), signature),)


def diff_signatures(a: Tuple[Tuple[str, Any], ...],
                    b: Tuple[Tuple[str, Any], ...],
                    ) -> Tuple[Tuple[str, Any, Any], ...]:
    """``((field, a_value, b_value), ...)`` for every field present in
    either signature where the values differ."""
    da, db = dict(a), dict(b)
    out: List[Tuple[str, Any, Any]] = []
    for k in list(da) + [k for k in db if k not in da]:
        va, vb = da.get(k, "<absent>"), db.get(k, "<absent>")
        if va != vb:
            out.append((k, va, vb))
    return tuple(out)


def format_diff(diff: Tuple[Tuple[str, Any, Any], ...]) -> str:
    if not diff:
        return "(first compile at site)"
    return ", ".join(f"{k}: {va!r} -> {vb!r}" for k, va, vb in diff)


@dataclass
class CompileEvent:
    site: str
    seq: int                                   # per-site ordinal, 0-based
    signature: Tuple[Tuple[str, Any], ...]
    #: field diff vs the nearest previously-recorded signature at this
    #: site (empty for the site's first compile)
    diff: Tuple[Tuple[str, Any, Any], ...]

    def __str__(self) -> str:
        return (f"compile site={self.site} seq={self.seq} "
                f"diff=({format_diff(self.diff)})")


class CompileBudgetExceeded(RuntimeError):
    """A site compiled more distinct signatures than it declared.

    Carries the offending event so gates can assert on structure, and
    renders BOTH signatures diffed — the recompile's cause is the
    message, not an exercise for the reader."""

    def __init__(self, event: CompileEvent, budget: int,
                 neighbor: Optional[Tuple[Tuple[str, Any], ...]]):
        self.event = event
        self.budget = budget
        self.neighbor = neighbor
        msg = (f"compile budget exceeded at site {event.site!r}: "
               f"compile #{event.seq + 1} > budget {budget}\n"
               f"  new signature:     {event.signature!r}\n"
               f"  nearest neighbor:  {neighbor!r}\n"
               f"  differing fields:  {format_diff(event.diff)}")
        super().__init__(msg)


class CompileLedger:
    """Process-wide compile event log + per-site budgets."""

    def __init__(self) -> None:
        self._lock = make_lock("analysis.ledger")
        self._events: List[CompileEvent] = []
        self._site_sigs: Dict[str, List[Tuple[Tuple[str, Any], ...]]] \
            = {}
        self._site_seq: Dict[str, int] = {}
        self._budgets: Dict[str, int] = {}

    # -- write path ----------------------------------------------------
    def record(self, site: str, signature: Any) -> CompileEvent:
        """Record one compile.  Raises CompileBudgetExceeded AFTER
        recording (the ledger keeps the evidence either way)."""
        sig = _normalize(signature)
        with self._lock:
            sigs = self._site_sigs.setdefault(site, [])
            neighbor: Optional[Tuple[Tuple[str, Any], ...]] = None
            diff: Tuple[Tuple[str, Any, Any], ...] = ()
            if sigs:
                neighbor = min(
                    sigs, key=lambda s: len(diff_signatures(s, sig)))
                diff = diff_signatures(neighbor, sig)
            seq = self._site_seq.get(site, 0)
            self._site_seq[site] = seq + 1
            event = CompileEvent(site, seq, sig, diff)
            novel = sig not in sigs
            if novel:
                sigs.append(sig)
            self._events.append(event)
            budget = self._budgets.get(site)
            # only a NOVEL signature can overflow the budget: the
            # budget caps the executable SET, not the compile count
            over = budget is not None and novel and len(sigs) > budget
        # counter outside the ledger lock: analysis.ledger (73) ranks
        # below obs.metrics (74), and we never hold both
        try:
            from ..obs.metrics import REGISTRY
            REGISTRY.counter("nns_jit_compiles_total", site=site).inc()
        except Exception:
            pass                   # obs plane absent: ledger still works
        if over:
            raise CompileBudgetExceeded(event, budget, neighbor)
        return event

    def declare_budget(self, site: str, n: int) -> None:
        with self._lock:
            self._budgets[site] = int(n)

    # -- read path -----------------------------------------------------
    def snapshot(self) -> Dict[str, int]:
        """site -> total compiles recorded (the bench gates diff two
        of these around a steady-state window)."""
        with self._lock:
            out: Dict[str, int] = {}
            for ev in self._events:
                out[ev.site] = out.get(ev.site, 0) + 1
            return out

    def count(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is None:
                return len(self._events)
            return sum(1 for ev in self._events if ev.site == site)

    def events(self, site: Optional[str] = None) -> List[CompileEvent]:
        with self._lock:
            if site is None:
                return list(self._events)
            return [ev for ev in self._events if ev.site == site]

    def budgets(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._budgets)

    def reset(self) -> None:
        """Clear events and signature history; budgets persist (they
        are declarations, not state)."""
        with self._lock:
            self._events.clear()
            self._site_sigs.clear()
            self._site_seq.clear()


#: the process ledger; import the module and call the functions below
LEDGER = CompileLedger()


def record(site: str, signature: Any) -> Optional[CompileEvent]:
    """The sentinel write path: no-op (None) when the sentinel is off."""
    if not ENABLED:
        return None
    return LEDGER.record(site, signature)


def declare_budget(site: str, n: int) -> None:
    LEDGER.declare_budget(site, n)


def compile_budget(n: int, site: str):
    """Decorator form of :func:`declare_budget`: annotate the function
    that performs the compile with the number of distinct signatures
    its site may legitimately produce.  The function body is returned
    unchanged — the declaration is the point::

        @compile_budget(16, site="llm.engine.step")
        def _step_fn(self, padded): ...
    """
    def deco(fn):
        LEDGER.declare_budget(site, n)
        return fn
    return deco


def snapshot() -> Dict[str, int]:
    return LEDGER.snapshot()


def count(site: Optional[str] = None) -> int:
    return LEDGER.count(site)


def events(site: Optional[str] = None) -> List[CompileEvent]:
    return LEDGER.events(site)


def budgets() -> Dict[str, int]:
    return LEDGER.budgets()


def reset() -> None:
    LEDGER.reset()
