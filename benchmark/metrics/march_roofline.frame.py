"""The march's share of its roofline over the traced frames, in %: the
least time the card could take for the lane-substeps that the reference
counts when it marches the same frames' rays (``_bound``), over the
device-busy time of the kernels whose name holds ``march``."""

from benchmark.metrics import _bound


def read(trace):
    work = trace.info.get("march_work")
    if trace.info.get("kind") != "orbit" or not work:
        return None
    busy_ns = trace.busy_ns("march")
    if not busy_ns:
        return None
    bound_ms = sum(_bound.march_bound_ms(trace.info["integrator"], live, steps)
                   for live, steps in work)
    return 100.0 * bound_ms / (busy_ns / 1e6)
