"""Device busy time from a profiler trace: the union of the intervals in
which a device operation (kernel, copy or fill) ran, clipped to a window;
its complement, the idle gaps, attributed to what the host was doing.

The union's arithmetic is that of the program's frame profile
(``bhx_torch.bench.frame_profile``: busy = the union of kernel intervals,
idle share = 1 - busy / wall), frozen here.  Times are nanoseconds of the
profiler's clock.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Iterable, List, Sequence, Tuple

Interval = Tuple[int, int]


def union(intervals: Iterable[Interval], lo: int, hi: int) -> List[Interval]:
    """The disjoint, sorted union of ``intervals`` clipped to [lo, hi]."""
    out: List[Interval] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def covered(intervals: Iterable[Interval], lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi] that ``intervals`` cover."""
    return sum(b - a for a, b in union(intervals, lo, hi))


def gaps(busy: Sequence[Interval], lo: int, hi: int) -> List[Interval]:
    """The parts of [lo, hi] that the disjoint sorted ``busy`` leaves."""
    out, reach = [], lo
    for a, b in busy:
        if a > reach:
            out.append((reach, a))
        reach = max(reach, b)
    if hi > reach:
        out.append((reach, hi))
    return out


def top(totals: dict, n: int = 10) -> List[list]:
    """The ``n`` largest (name, seconds) entries of ``totals`` (ns)."""
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in ranked]


def device_ops(device: Sequence[tuple], lo: int, hi: int, n: int = 10) -> List[list]:
    """The device operations that took most time in [lo, hi], by name:
    ``device`` holds (name, start, end)."""
    totals = defaultdict(int)
    for name, a, b in device:
        a, b = max(a, lo), min(b, hi)
        if b > a:
            totals[name] += b - a
    return top(totals, n)


def idle_gaps(busy: Sequence[Interval], host: Sequence[tuple], lo: int, hi: int,
              n: int = 10) -> List[list]:
    """The device's idle time in [lo, hi], summed by the innermost host
    operation running at each gap's midpoint (``host`` holds (name,
    start, end)); "host: no operation" where none runs."""
    host = sorted(host, key=lambda e: e[1])
    starts = [e[1] for e in host]
    totals = defaultdict(int)
    for a, b in gaps(busy, lo, hi):
        mid = (a + b) // 2
        k = bisect.bisect_right(starts, mid)
        name = "host: no operation"
        # The latest-starting host operation that still runs at ``mid``;
        # a few hundred back cover any nesting depth.
        for j in range(k - 1, max(k - 400, 0) - 1, -1):
            if host[j][2] >= mid:
                name = host[j][0]
                break
        totals[name] += b - a
    return top(totals, n)
