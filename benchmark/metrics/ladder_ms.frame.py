"""The ladder's own host time a frame, in ms: the traced frames' union of
the ladder's level spans (``bhx_torch.ladder.L<k>``: each level's rays,
refine masks and merge) less what the tracer's span (``bhx_torch.trace``)
covers, over the frames."""

from benchmark.metrics import _spans


def read(trace):
    if trace.info.get("kind") != "orbit" or not trace.units:
        return None
    levels = _spans.spans(trace, _spans.LADDER)
    if not levels:
        return None
    return _spans.ms_per_unit(trace, _spans.self_ns(trace, levels,
                                                    _spans.spans(trace, _spans.TRACE)))
