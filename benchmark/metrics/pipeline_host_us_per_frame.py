"""Host self time of the pipeline's elements other than the filter (the
source, converter, queue, decoder and sink), microseconds a frame: the
sum over those elements of the program's ``pipeline.tracing.Tracer``
self time (GstShark's proctime: time inside an element's ``chain()``,
less the downstream chains it called) in the traced window, over the
frames that reached the sink in it."""

#: the filter's name in the traffic's launch string
FILTER = "filter"


def read(window):
    elements, frames = window.get("elements"), window.get("frames", 0)
    if not elements or not frames:
        return None
    ms = sum(ms for name, (ms, _) in elements.items() if name != FILTER)
    return ms * 1e3 / frames
