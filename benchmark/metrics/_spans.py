"""The program's spans in a trace: their names, frozen here as the
program's ``bhx_torch.profiling`` gives them (so that a rename there shows
as a missing span and a ``None``, never as another number), and the
arithmetic of their host time.

A span is a host range (name, start, end) of ``Trace.host``.  A name that
ends in "." stands for every span whose name starts with it.  A span's
self time is the union of its ranges less the part that its children's
union covers, clipped to the stretch: |A - B| = |A + B| - |B| of the
unions (``_busy.covered``).
"""

from __future__ import annotations

import bisect
from typing import List, Sequence, Tuple

from benchmark.metrics import _busy

LADDER = "bhx_torch.ladder."
TRACE = "bhx_torch.trace"
KERNEL = "bhx_torch.kernel."
POST = "bhx_torch.post."
REPLAY = "bhx_torch.replay."
# The host runtime calls that put work on the device: kernel launches,
# copies and fills.
LAUNCHES = ("cudaLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync")


def spans(trace, name: str) -> List[Tuple[int, int]]:
    """The (start, end) of the host ranges named ``name``."""
    if name.endswith("."):
        return [(a, b) for n, a, b in trace.host if n.startswith(name)]
    return [(a, b) for n, a, b in trace.host if n == name]


def covered_ns(trace, ranges: Sequence[Tuple[int, int]]) -> int:
    """Nanoseconds of the stretch that ``ranges`` cover."""
    return _busy.covered(ranges, trace.lo, trace.hi)


def self_ns(trace, ranges: Sequence[Tuple[int, int]],
            children: Sequence[Tuple[int, int]]) -> int:
    """Nanoseconds of the stretch that ``ranges`` cover and ``children``
    do not."""
    return covered_ns(trace, list(ranges) + list(children)) - covered_ns(trace, children)


def ms_per_unit(trace, ns: int) -> float:
    """``ns`` as ms a traced frame or step."""
    return ns / trace.units / 1e6


def starts_inside(trace, names: Sequence[str], ranges: Sequence[Tuple[int, int]]) -> int:
    """How many host operations whose name starts with one of ``names``
    start inside the union of ``ranges``."""
    union = _busy.union(ranges, trace.lo, trace.hi)
    starts = [a for a, _ in union]
    names = tuple(names)
    count = 0
    for n, a, _ in trace.host:
        if n.startswith(names):
            k = bisect.bisect_right(starts, a) - 1
            count += k >= 0 and a <= union[k][1]
    return count
