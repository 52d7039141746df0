"""Device operations (kernels, copies, fills) a frame over the traced
frames: the load that the host dispatches."""


def read(trace):
    if trace.info.get("kind") != "orbit" or not trace.units:
        return None
    n = sum(1 for _, a, b in trace.device if a >= trace.lo and b <= trace.hi)
    return n / trace.units
