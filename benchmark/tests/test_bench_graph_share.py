"""The reader of ``graph_share.frame``: the program's call and replay
counters over a made-up orbit stretch, and ``None`` outside the orbit,
with no call counted, or where the program has no such counters (as
before it had them)."""

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import tracing


def _trace(kind="orbit"):
    return tracing.Trace(device=[("k", 0, 10)], host=[], lo=0, hi=1000, units=3,
                         info=dict(kind=kind, integrator="euler"))


def test_graph_share_reads_the_programs_counters(monkeypatch):
    from bhx_torch import profiling

    read = tracing.reader("graph_share.frame")
    profiling.reset_counts()
    assert read(_trace()) is None  # no call counted
    with profile(activities=[ProfilerActivity.CPU]):
        for replayed in (False, True, True, True):
            profiling.count_call(replayed)
    profiling.count_call(False)  # no profiler: not counted
    assert read(_trace()) == pytest.approx(3 / 4)
    assert read(_trace(kind="fit")) is None
    counts = profiling.counts
    monkeypatch.setattr(profiling, "counts", lambda: {
        k: v for k, v in counts().items() if k != "trace.graph_replays"})
    assert read(_trace()) is None
    monkeypatch.delattr(profiling, "counts")
    assert read(_trace()) is None
    monkeypatch.undo()
    profiling.reset_counts()
