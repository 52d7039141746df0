"""The tracer's glue a frame, in ms: the traced frames' union of the
tracer's span (``bhx_torch.trace``: straight phases, slot merges, state,
classification) less what the kernel entries' spans
(``bhx_torch.kernel.*``) cover, over the frames."""

from benchmark.metrics import _spans


def read(trace):
    if trace.info.get("kind") != "orbit" or not trace.units:
        return None
    traces = _spans.spans(trace, _spans.TRACE)
    if not traces:
        return None
    return _spans.ms_per_unit(trace, _spans.self_ns(trace, traces,
                                                    _spans.spans(trace, _spans.KERNEL)))
