"""Pipeline substrate: caps, elements, graph, parse, and the segment
compiler's tiers (schedule.py)."""

from .caps import ANY_FRAMERATE, Caps, FractionRange, IntRange, Structure
from .element import (CapsEvent, CustomEvent, Element, EOSEvent, Event,
                      FlowReturn, LoweredStep, Pad, PadDirection,
                      SegmentEvent)
from .graph import AppSrc, Pipeline, PipelineError, Queue, Source, Tee
from .registry import element_factory, list_factories, make_element, register_element
from .parse import CapsFilter, ParseError, parse_launch

__all__ = [
    "Caps", "Structure", "IntRange", "FractionRange", "ANY_FRAMERATE",
    "Element", "Pad", "PadDirection", "Event", "CapsEvent", "EOSEvent",
    "SegmentEvent", "CustomEvent", "FlowReturn", "LoweredStep", "Pipeline",
    "PipelineError", "Source", "AppSrc", "Queue", "Tee", "register_element", "make_element",
    "element_factory", "list_factories", "parse_launch", "ParseError",
    "CapsFilter",
]
