"""Stream capability (caps) system: typed, intersectable media descriptions.

The reference delegates caps to GStreamer (``GstCaps``/``GstStructure``) and
layers tensor semantics on top (gst_tensor_caps_from_config / …_config_from_
structure, nnstreamer_plugin_api_impl.c:1110-1393).  GStreamer is external to
the reference, so this module is a ground-up design: a small algebra of
structures whose field values are concrete values, option lists, or ranges,
with intersection / fixation / subset tests — just enough to drive the same
negotiation logic the reference elements rely on.

Caps strings look like GStreamer's for familiarity::

    other/tensors,format=static,num_tensors=1,dimensions=3:224:224,types=uint8,framerate=30/1
    video/x-raw,format=RGB,width=640,height=480,framerate=30/1
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Dict, Iterable, List, Optional, Tuple, Union


class IntRange:
    """Inclusive integer range field value (GStreamer GST_TYPE_INT_RANGE)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: int, hi: int):
        if lo > hi:
            raise ValueError(f"empty range [{lo},{hi}]")
        self.lo, self.hi = lo, hi

    def __eq__(self, other):
        return (isinstance(other, IntRange) and self.lo == other.lo
                and self.hi == other.hi)

    def __hash__(self):
        return hash(("IntRange", self.lo, self.hi))

    def __repr__(self):
        return f"[{self.lo},{self.hi}]"

    def contains(self, v: int) -> bool:
        return self.lo <= v <= self.hi


class FractionRange:
    """Inclusive fraction range (framerates)."""

    __slots__ = ("lo", "hi")

    def __init__(self, lo: Fraction, hi: Fraction):
        if lo > hi:
            raise ValueError(f"empty range [{lo},{hi}]")
        self.lo, self.hi = lo, hi

    def __eq__(self, other):
        return (isinstance(other, FractionRange) and self.lo == other.lo
                and self.hi == other.hi)

    def __hash__(self):
        return hash(("FractionRange", self.lo, self.hi))

    def __repr__(self):
        return f"[{self.lo},{self.hi}]"

    def contains(self, v: Fraction) -> bool:
        return self.lo <= v <= self.hi


#: Full-range framerate used as the lenient default (reference intersects
#: tensor caps with framerate leniency, nnstreamer_plugin_api_impl.c:1201-1260).
ANY_FRAMERATE = FractionRange(Fraction(0, 1), Fraction(1 << 31, 1))

FieldValue = Union[int, str, Fraction, Tuple[Any, ...], IntRange, FractionRange, list]


def _intersect_value(a: FieldValue, b: FieldValue) -> Optional[FieldValue]:
    """Intersect two field values; None means empty intersection."""
    if isinstance(a, list) or isinstance(b, list):
        la = a if isinstance(a, list) else [a]
        lb = b if isinstance(b, list) else [b]
        out = []
        for va in la:
            for vb in lb:
                r = _intersect_value(va, vb)
                if r is not None and r not in out:
                    out.append(r)
        if not out:
            return None
        return out[0] if len(out) == 1 else out
    if isinstance(a, IntRange) and isinstance(b, IntRange):
        lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
        if lo > hi:
            return None
        return lo if lo == hi else IntRange(lo, hi)
    if isinstance(a, IntRange):
        return b if (isinstance(b, int) and a.contains(b)) else None
    if isinstance(b, IntRange):
        return a if (isinstance(a, int) and b.contains(a)) else None
    if isinstance(a, FractionRange) and isinstance(b, FractionRange):
        lo, hi = max(a.lo, b.lo), min(a.hi, b.hi)
        if lo > hi:
            return None
        return lo if lo == hi else FractionRange(lo, hi)
    if isinstance(a, FractionRange):
        return b if (isinstance(b, Fraction) and a.contains(b)) else None
    if isinstance(b, FractionRange):
        return a if (isinstance(a, Fraction) and b.contains(a)) else None
    return a if a == b else None


def _is_fixed_value(v: FieldValue) -> bool:
    return not isinstance(v, (list, IntRange, FractionRange))


def _fixate_value(v: FieldValue) -> FieldValue:
    if isinstance(v, list):
        return _fixate_value(v[0])
    if isinstance(v, IntRange):
        return v.lo
    if isinstance(v, FractionRange):
        # Prefer a sane default inside the range (30/1 if allowed, else lo).
        default = Fraction(30, 1)
        return default if v.contains(default) else v.lo
    return v


@dataclasses.dataclass
class Structure:
    """One media description: name + constrained fields."""

    name: str
    fields: Dict[str, FieldValue] = dataclasses.field(default_factory=dict)

    def get(self, key: str, default=None):
        return self.fields.get(key, default)

    def intersect(self, other: "Structure") -> Optional["Structure"]:
        if self.name != other.name:
            return None
        out: Dict[str, FieldValue] = {}
        for key in set(self.fields) | set(other.fields):
            if key in self.fields and key in other.fields:
                r = _intersect_value(self.fields[key], other.fields[key])
                if r is None:
                    return None
                out[key] = r
            else:
                out[key] = self.fields.get(key, other.fields.get(key))
        return Structure(self.name, out)

    def is_fixed(self) -> bool:
        return all(_is_fixed_value(v) for v in self.fields.values())

    def fixate(self) -> "Structure":
        return Structure(self.name,
                         {k: _fixate_value(v) for k, v in self.fields.items()})

    def is_subset_of(self, other: "Structure") -> bool:
        """True if every stream matching self also matches other."""
        if self.name != other.name:
            return False
        for k, v in other.fields.items():
            if k not in self.fields:
                # other constrains a field self leaves open → not subset
                if not _is_fixed_value(v):
                    continue
                return False
            if _intersect_value(self.fields[k], v) != self.fields[k]:
                return False
        return True

    def __str__(self) -> str:
        parts = [self.name]
        for k, v in self.fields.items():
            parts.append(f"{k}={_value_to_str(v)}")
        return ",".join(parts)


def _value_to_str(v: FieldValue) -> str:
    if isinstance(v, Fraction):
        return f"{v.numerator}/{v.denominator}"
    if isinstance(v, list):
        return "{" + ";".join(_value_to_str(x) for x in v) + "}"
    return str(v)


class Caps:
    """An ordered set of alternative :class:`Structure` s.

    Empty caps = "cannot link"; ``Caps.any()`` = unconstrained.
    """

    def __init__(self, structures: Optional[Iterable[Structure]] = None,
                 any_caps: bool = False):
        self.structures: List[Structure] = list(structures or [])
        self._any = any_caps

    # -- constructors --------------------------------------------------------
    @classmethod
    def any(cls) -> "Caps":
        return cls(any_caps=True)

    @classmethod
    def empty(cls) -> "Caps":
        return cls()

    @classmethod
    def from_string(cls, s: str) -> "Caps":
        """Parse a caps string: ``name,k=v,...;name2,k=v`` — alternatives
        separated by ``;``."""
        s = s.strip()
        if s in ("ANY", "any"):
            return cls.any()
        if not s:
            return cls.empty()
        structures = []
        for alt in _split_top(s, ";"):
            if alt.strip():
                structures.append(_parse_structure(alt.strip()))
        return cls(structures)

    @classmethod
    def new(cls, name: str, **fields) -> "Caps":
        return cls([Structure(name, dict(fields))])

    # -- algebra -------------------------------------------------------------
    def is_any(self) -> bool:
        return self._any

    def is_empty(self) -> bool:
        return not self._any and not self.structures

    def is_fixed(self) -> bool:
        return (not self._any and len(self.structures) == 1
                and self.structures[0].is_fixed())

    def intersect(self, other: "Caps") -> "Caps":
        if self._any:
            return Caps(list(other.structures), any_caps=other._any)
        if other._any:
            return Caps(list(self.structures))
        out = []
        for a in self.structures:
            for b in other.structures:
                r = a.intersect(b)
                if r is not None:
                    out.append(r)
        return Caps(out)

    def can_intersect(self, other: "Caps") -> bool:
        return not self.intersect(other).is_empty()

    def fixate(self) -> "Caps":
        if self._any:
            raise ValueError("cannot fixate ANY caps")
        if not self.structures:
            raise ValueError("cannot fixate EMPTY caps")
        return Caps([self.structures[0].fixate()])

    def first(self) -> Structure:
        if not self.structures:
            raise ValueError("empty caps")
        return self.structures[0]

    def append(self, other: "Caps") -> "Caps":
        if self._any or other._any:
            return Caps.any()
        return Caps(self.structures + other.structures)

    def __eq__(self, other):
        if not isinstance(other, Caps):
            return NotImplemented
        return self._any == other._any and self.structures == other.structures

    def __str__(self) -> str:
        if self._any:
            return "ANY"
        if not self.structures:
            return "EMPTY"
        return ";".join(str(s) for s in self.structures)

    def __repr__(self) -> str:
        return f"Caps({self})"


def _fraction(raw: str) -> Fraction:
    """Fraction('16/0') raises ZeroDivisionError, which would leak a
    non-ValueError out of caps parsing (fuzz-found) — a zero
    denominator is a malformed caps VALUE, i.e. a ValueError."""
    try:
        return Fraction(raw)
    except ZeroDivisionError:
        raise ValueError(f"caps fraction with zero denominator: {raw!r}")


def _parse_value(raw: str, _depth: int = 0) -> FieldValue:
    raw = raw.strip()
    if raw.startswith("{") and raw.endswith("}"):
        # caps lists don't nest semantically; a deeply nested brace
        # string is malformed input, and unbounded recursion here would
        # leak a RecursionError out of the ValueError contract
        if _depth >= 8:
            raise ValueError(f"caps value nests too deeply: {raw[:40]!r}")
        return [_parse_value(p, _depth + 1)
                for p in raw[1:-1].split(";") if p.strip()]
    if raw.startswith("[") and raw.endswith("]"):
        lo, hi = raw[1:-1].split(",")
        lo, hi = lo.strip(), hi.strip()
        if "/" in lo or "/" in hi:
            return FractionRange(_fraction(lo), _fraction(hi))
        return IntRange(int(lo), int(hi))
    if "/" in raw and all(p.strip().lstrip("-").isdigit()
                          for p in raw.split("/", 1)):
        return _fraction(raw)
    try:
        return int(raw)
    except ValueError:
        return raw


def _parse_structure(s: str) -> Structure:
    parts = [p.strip() for p in _split_fields(s)]
    name = parts[0]
    fields: Dict[str, FieldValue] = {}
    for p in parts[1:]:
        if not p:
            continue
        k, _, v = p.partition("=")
        fields[k.strip()] = _parse_value(v)
    return Structure(name, fields)


def _split_top(s: str, sep: str) -> List[str]:
    """Split on a separator at brace/bracket depth 0 only."""
    out, depth, cur = [], 0, []
    for ch in s:
        if ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        if ch == sep and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    out.append("".join(cur))
    return out


def _split_fields(s: str) -> List[str]:
    """Split on top-level commas (not inside {} or [])."""
    return _split_top(s, ",")
