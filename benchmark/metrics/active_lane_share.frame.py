"""The share of the tracer's lanes that are live over the traced frames:
the program's lane counters (``bhx_torch.profiling.counts()``:
``trace.active_lanes`` over ``trace.lanes``), which count only while a
profiler records, so in a run with one profiled stretch they hold the
stretch's frames alone.  The masked ladder levels carry every pixel of
their level and march those that the refine masks leave."""

LANES = "trace.lanes"
ACTIVE_LANES = "trace.active_lanes"


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
    if not got.get(LANES) or ACTIVE_LANES not in got:
        return None
    return got[ACTIVE_LANES] / got[LANES]
