"""The share of the tracer's calls over the traced frames that replayed a
CUDA graph: the program's counters (``bhx_torch.profiling.counts()``:
``trace.graph_replays`` over ``trace.calls``), which count only while a
profiler records, so in a run with one profiled stretch they hold the
stretch's frames alone.  ``None`` outside the orbit, or where the program
has no such counters."""

CALLS = "trace.calls"
GRAPH_REPLAYS = "trace.graph_replays"


def read(trace):
    if trace.info.get("kind") != "orbit":
        return None
    try:
        from bhx_torch import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "counts", None)
    if counts is None:
        return None
    got = counts()
    if not got.get(CALLS) or GRAPH_REPLAYS not in got:
        return None
    return got[GRAPH_REPLAYS] / got[CALLS]
