"""The mean wall time of a frame in the traced run, in ms: the window's
wall time outside the profiled stretch over the frames it completed there
(the closed loop's frame time, which the host's speed moves more than a
bound can hold, so it is read here beside ``frame_p95_ms``)."""


def read(trace):
    unit_s = trace.info.get("unit_s")
    if trace.info.get("kind") != "orbit" or not unit_s:
        return None
    return 1e3 * unit_s
