"""The share of the traced fit step's wall time that the host spends
inside the autograd engine's functions (the union of the profiler's
``autograd::engine::evaluate_function`` ranges): the backward pass,
whatever implements it."""

from benchmark.metrics import _busy

PREFIX = "autograd::engine::evaluate_function"


def read(trace):
    if trace.info.get("kind") != "fit":
        return None
    spans = [(a, b) for n, a, b in trace.host if n.startswith(PREFIX)]
    if not spans:
        return None
    return _busy.covered(spans, trace.lo, trace.hi) / (trace.hi - trace.lo)
