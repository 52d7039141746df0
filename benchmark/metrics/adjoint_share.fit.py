"""The share of the march's backward passes over the traced step that ran
the Euler adjoint kernel: the program's counters
(``bhx_torch.profiling.counts()``: ``replay.march_adjoints`` over
``replay.march_calls``), which count only while a profiler records, so in
a run with one profiled stretch they hold the stretch's step alone.
``None`` outside the fit, or where the program has no such counters."""

CALLS = "replay.march_calls"
ADJOINTS = "replay.march_adjoints"


def read(trace):
    if trace.info.get("kind") != "fit":
        return None
    try:
        from bhx_torch import profiling
    except ImportError:
        return None
    counts = getattr(profiling, "counts", None)
    if counts is None:
        return None
    got = counts()
    if not got.get(CALLS) or ADJOINTS not in got:
        return None
    return got[ADJOINTS] / got[CALLS]
