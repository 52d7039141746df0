"""The device's idle share of a frame: 1 - the device-busy time of a traced
frame (the union of the device operations' intervals over the traced
frames, a frame's share) over a frame's wall time outside the trace (the
arithmetic of the program's frame profile)."""


def read(trace):
    if trace.info.get("kind") != "orbit":
        return None
    return trace.idle_share()
