"""The backward replays' device work a traced step, as launches: the host
runtime calls that put work on the device (``cudaLaunchKernel*``,
``cudaMemcpyAsync``, ``cudaMemsetAsync``) that start inside the replays'
spans (``bhx_torch.replay.*``), over the traced steps."""

from benchmark.metrics import _spans


def read(trace):
    if trace.info.get("kind") != "fit" or not trace.units:
        return None
    replays = _spans.spans(trace, _spans.REPLAY)
    if not replays:
        return None
    return _spans.starts_inside(trace, _spans.LAUNCHES, replays) / trace.units
