"""Host self time of ``tensor_filter`` (bucket collection, dispatch and
graph replay, the wait for the bucket in flight), milliseconds a bucket:
the program's ``pipeline.tracing.Tracer`` self time of the filter in the
traced window over the buckets that reached the sink in it."""

#: the filter's name in the traffic's launch string
FILTER = "filter"


def read(window):
    elements, buckets = window.get("elements"), window.get("buckets", 0)
    if not elements or FILTER not in elements or not buckets:
        return None
    return elements[FILTER][0] / buckets
