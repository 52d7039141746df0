"""The reader of ``adjoint_share.fit``: the program's march backward
counters over a made-up fit stretch, and ``None`` outside the fit, with no
backward counted, or where the program has no such counters (as before it
had them)."""

import pytest
from torch.profiler import ProfilerActivity, profile

from benchmark import tracing


def _trace(kind="fit"):
    return tracing.Trace(device=[("k", 0, 10)], host=[], lo=0, hi=1000, units=1,
                         info=dict(kind=kind, integrator="euler"))


def test_adjoint_share_reads_the_programs_counters(monkeypatch):
    from bhx_torch import profiling

    read = tracing.reader("adjoint_share.fit")
    profiling.reset_counts()
    assert read(_trace()) is None  # no backward counted
    with profile(activities=[ProfilerActivity.CPU]):
        for adjoint in (True, True, True, False):
            profiling.count_march_backward(adjoint)
    profiling.count_march_backward(False)  # no profiler: not counted
    assert read(_trace()) == pytest.approx(3 / 4)
    assert read(_trace(kind="orbit")) is None
    counts = profiling.counts
    monkeypatch.setattr(profiling, "counts", lambda: {
        k: v for k, v in counts().items() if k != "replay.march_adjoints"})
    assert read(_trace()) is None
    monkeypatch.delattr(profiling, "counts")
    assert read(_trace()) is None
    monkeypatch.undo()
    profiling.reset_counts()
