"""The post chain's host time a frame, in ms: the traced frames' union of
the post spans (``bhx_torch.post.*``: bloom; mix + ACES; FXAA), over the
frames."""

from benchmark.metrics import _spans


def read(trace):
    if trace.info.get("kind") != "orbit" or not trace.units:
        return None
    post = _spans.spans(trace, _spans.POST)
    if not post:
        return None
    return _spans.ms_per_unit(trace, _spans.covered_ns(trace, post))
