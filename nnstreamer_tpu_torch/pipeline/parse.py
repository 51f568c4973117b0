"""gst-launch-style pipeline string parser.

The reference's user API is gst-launch pipeline strings (every SSAT golden
test builds one, e.g. tests/nnstreamer_filter_tensorflow2_lite/runTest.sh).
This parser accepts the same shape of syntax::

    parse_launch("videotestsrc num-buffers=10 ! "
                 "video/x-raw,format=RGB,width=224,height=224 ! "
                 "tensor_converter ! "
                 "tensor_filter framework=xla model=mobilenet_v2 ! "
                 "tensor_sink name=out")

Supported: element factories with ``key=value`` properties, ``!`` links,
caps-filter segments (a bare caps string between ``!``), ``name=`` element
naming, and gst-launch's multi-chain grammar — whitespace without ``!``
starts a new chain, ``name. ! ...`` branches from an element (tee/demux
fan-out), ``... ! name.`` links into one (mux/merge fan-in), with forward
references allowed.  The grammar is the JAX package's; which factories
resolve is up to the port's element registry.
"""

from __future__ import annotations

import shlex
from typing import List, Optional

from .caps import Caps
from .element import CapsEvent, Element
from .graph import Pipeline
from .registry import make_element, register_element


class ParseError(ValueError):
    """Single error domain for malformed launch strings — the role of
    GStreamer's GST_PARSE_ERROR quark (no-such-element, link failures,
    bad syntax all surface as one catchable type;
    gst/parse/grammar.y).  Subclasses ValueError so existing callers
    catching ValueError keep working; parser internals must never leak
    a raw KeyError/NotImplementedError to the user."""


@register_element
class CapsFilter(Element):
    """Pass-through element that constrains negotiation (GStreamer
    ``capsfilter`` role — what a bare caps string in a launch line becomes).
    """

    FACTORY = "capsfilter"
    PROPERTIES = {"caps": (None, "constraint caps")}

    def _make_pads(self):
        self.add_sink_pad(Caps.any(), "sink")
        self.add_src_pad(Caps.any(), "src")

    def _constraint(self) -> Caps:
        constraint = self.caps
        if isinstance(constraint, str):
            constraint = Caps.from_string(constraint)
        return constraint if constraint is not None else Caps.any()

    def set_caps(self, pad, caps):
        inter = caps.intersect(self._constraint())
        if inter.is_empty():
            raise ValueError(
                f"capsfilter {self.name}: {caps} does not satisfy "
                f"{self._constraint()}")
        self.src_pad.push_event(CapsEvent(caps))

    def get_allowed_caps(self, sink_pad):
        downstream = self.src_pad.peer_allowed_caps()
        return self._constraint().intersect(downstream)

    def chain(self, pad, buf):
        return self.src_pad.push(buf)

    def _passthrough(self, buf):
        return buf

    def plan_step(self):
        # negotiation work all happens at caps time; per buffer this is a
        # pure passthrough, so fused dispatch elides it
        return self._passthrough

    def lower_reason(self):
        return None

    def lower_step(self):
        from .element import LoweredStep

        return LoweredStep(lambda ts: ts, batched=lambda ts: ts)


def _coerce(value: str):
    try:
        return int(value, 0)  # handles decimal and 0x… hex
    except ValueError:
        pass
    try:
        return float(value)
    except ValueError:
        pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value


def _is_prop(tok: str) -> bool:
    """``key=value`` tokens attach to the preceding element head."""
    k, eq, _ = tok.partition("=")
    return bool(eq) and "/" not in k and not k.endswith(".")


def iter_launch_ops(description: str):
    """Tokenize a launch string into grammar operations — the single
    tokenizer shared by :func:`parse_launch` and tools/pbtxt_pipeline.py.

    Yields tuples:
      ``("link",)``                  — a ``!``
      ``("ref", name)``              — a ``name.`` branch/sink reference
      ``("caps", caps_string)``      — a caps-filter segment
      ``("element", head, props, name)`` — an element with properties
    """
    tokens = shlex.split(description)
    i = 0
    while i < len(tokens):
        tok = tokens[i]
        if tok == "!":
            yield ("link",)
        elif tok.endswith(".") and "=" not in tok:
            yield ("ref", tok[:-1], None)
        elif ("." in tok and "=" not in tok and "/" not in tok
              and not tok.replace(".", "").isdigit()):
            # gst-launch named-pad reference: ``mux.sink_0``
            el_name, _, pad_name = tok.partition(".")
            yield ("ref", el_name, pad_name)
        elif "/" in tok and "=" not in tok.split(",")[0]:
            # caps filter — gst-launch allows spaces after commas
            # ("video/x-raw, format=RGB, width=224"): join follow-on
            # fragments until the next '!' into one caps string
            parts = [tok]
            while tok.endswith(",") and i + 1 < len(tokens) \
                    and tokens[i + 1] != "!":
                i += 1
                tok = tokens[i]
                parts.append(tok)
            yield ("caps", "".join(parts))
        else:
            head = tok
            props = []
            name = None
            while i + 1 < len(tokens) and _is_prop(tokens[i + 1]):
                k, _, v = tokens[i + 1].partition("=")
                if k == "name":
                    name = v
                else:
                    props.append((k, v))
                i += 1
            yield ("element", head, props, name)
        i += 1


class _ForwardRef:
    """A ``name.`` / ``name.pad`` branch-from reference to an element named
    later in the line (gst-launch allows both directions)."""

    __slots__ = ("name", "pad")

    def __init__(self, name: str, pad: Optional[str] = None):
        self.name = name
        self.pad = pad


def _parse_launch(description: str, pipeline: Optional[Pipeline]) -> Pipeline:
    """Build a :class:`Pipeline` from a launch string.

    Implements gst-launch's chain grammar: elements join with ``!``;
    whitespace without ``!`` ends a chain and starts a new one, so tee
    fan-out / mux fan-in read exactly like the reference pipelines::

        ... ! tee name=t ! tensor_sink name=a  t. ! tensor_sink name=b
        appsrc name=s1 ! mux.  appsrc name=s2 ! mux.  tensor_mux name=mux ! ...

    A trailing ``name.`` links the chain INTO that element (requesting a
    sink pad); a leading ``name.`` branches FROM it.  References may point
    forward — both directions resolve after all elements are created.
    """
    p = pipeline or Pipeline()
    prev = None                    # Element | _ForwardRef | None
    linked = False                 # saw '!' since the previous element
    into_refs: List[tuple] = []    # (src_el, sink_name, pad): '... ! name.'
    from_refs: List[tuple] = []    # (src_name, pad, sink_el): 'name. ! ...'
    ref_refs: List[tuple] = []     # 'a.src_0 ! b.sink_1' (both by name)
    for op in iter_launch_ops(description):
        kind = op[0]
        if kind == "link":
            if prev is None:
                raise ParseError("launch string: '!' with nothing upstream")
            linked = True
            continue
        if kind == "ref":
            name, pad = op[1], op[2]
            if linked:             # chain INTO named element (sink ref)
                if isinstance(prev, _ForwardRef):
                    # 'a.src_0 ! b.sink_1': both ends by reference
                    ref_refs.append((prev.name, prev.pad, name, pad))
                else:
                    into_refs.append((prev, name, pad))
                prev, linked = None, False
            else:                  # branch FROM named element
                if isinstance(prev, _ForwardRef):
                    raise ParseError(
                        f"launch string: reference '{prev.name}.' is never "
                        f"linked (followed by '{name}.' without '!')")
                prev = _ForwardRef(name, pad)
            continue
        if kind == "caps":
            el = p.add(CapsFilter(None, caps=Caps.from_string(op[1])))
        else:
            _, head, props, name = op
            el = p.add(make_element(
                head, name, **{k: _coerce(v) for k, v in props}))
        if linked:
            if isinstance(prev, _ForwardRef):
                from_refs.append((prev.name, prev.pad, el))
            else:
                p.link(prev, el)
        elif isinstance(prev, _ForwardRef):
            raise ParseError(
                f"launch string: reference '{prev.name}.' is never linked "
                f"(followed by an element without '!')")
        prev, linked = el, False
    if linked:
        raise ParseError("launch string ends with '!'")
    if isinstance(prev, _ForwardRef):
        raise ParseError(f"launch string: trailing reference '{prev.name}.'"
                         " is never linked")
    for src_name, src_pad, sink_el in from_refs:
        p.link_pads(p.get(src_name), src_pad, sink_el, None)
    for src_el, sink_name, sink_pad in into_refs:
        p.link_pads(src_el, None, p.get(sink_name), sink_pad)
    for src_name, src_pad, sink_name, sink_pad in ref_refs:
        p.link_pads(p.get(src_name), src_pad, p.get(sink_name), sink_pad)
    return p


def parse_launch(description: str, pipeline: Optional[Pipeline] = None) -> Pipeline:
    """Build a :class:`Pipeline` from a launch string (see
    :func:`_parse_launch` for the grammar).

    Error contract (the gst_parse_launch GError analogue): ANY
    malformed launch string raises :class:`ParseError` (a ValueError) —
    unknown element factories (a KeyError from the registry), unknown
    properties (an AttributeError from the element,
    GST_PARSE_ERROR_NO_SUCH_PROPERTY's case), branch/sink references to
    unknown or static-pad elements, link failures, unparsable caps
    values (down to Fraction's ZeroDivisionError on framerate=0/0),
    unbalanced quotes, and bad syntax alike."""
    try:
        return _parse_launch(description, pipeline)
    except ParseError:
        raise                      # already wrapped — no double prefix
    except (KeyError, NotImplementedError, AttributeError, ValueError,
            ZeroDivisionError) as exc:
        detail = exc.args[0] if exc.args else repr(exc)
        raise ParseError(f"launch string: {detail}") from exc
