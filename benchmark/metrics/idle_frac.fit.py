"""The device's idle share of a fit step: 1 - the device-busy time of the
traced step (the union of the device operations' intervals) over a step's
wall time outside the trace."""


def read(trace):
    if trace.info.get("kind") != "fit":
        return None
    return trace.idle_share()
