"""The readers of the program's spans and lane counters on made-up traces:
self time under nesting, clipped to the stretch and divided by the
frames; the replays' launch count; the lane share from the program's
counters; and ``None`` wherever the spans or the counters are missing.
The frozen span names are the program's."""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import tracing
from benchmark.metrics import _spans

NAMES = ("ladder_ms.frame", "glue_ms.frame", "post_ms.frame", "active_lane_share.frame",
         "replay_launches.fit")

# One made-up frame twice over (units=2), ns of the profiler's clock; the
# stretch ends at 1000, inside the last FXAA span.
FRAME = [
    ("bhx_torch.render", 0, 1200),
    ("bhx_torch.ladder.L0", 10, 200),
    ("bhx_torch.trace", 20, 180),
    ("bhx_torch.kernel.march", 50, 80),
    ("aten::where", 82, 90),
    ("bhx_torch.kernel.composite", 100, 110),
    ("bhx_torch.ladder.L1", 210, 500),
    ("aten::cat", 215, 240),
    ("bhx_torch.trace", 250, 480),
    ("bhx_torch.kernel.march", 300, 400),
    ("bhx_torch.sky", 510, 520),
    ("bhx_torch.kernel.sky", 512, 518),
    ("bhx_torch.post.bloom", 600, 700),
    ("bhx_torch.post.tonemap", 700, 720),
    ("bhx_torch.post.fxaa", 730, 1100),
]


def _trace(host, kind="orbit", units=2, hi=1000):
    return tracing.Trace(device=[("k", 0, 10)], host=host, lo=0, hi=hi, units=units,
                         info=dict(kind=kind, integrator="euler"))


@pytest.fixture
def read():
    return {m: tracing.reader(m) for m in NAMES}


def test_names_are_the_programs():
    from bhx_torch import profiling

    assert profiling.ladder_level(3).startswith(_spans.LADDER)
    assert _spans.TRACE == profiling.TRACE
    for name in (profiling.KERNEL_MARCH, profiling.KERNEL_COMPOSITE, profiling.KERNEL_MESH,
                 profiling.KERNEL_SKY):
        assert name.startswith(_spans.KERNEL)
    for name in (profiling.POST_BLOOM, profiling.POST_TONEMAP, profiling.POST_FXAA):
        assert name.startswith(_spans.POST)
    for name in (profiling.REPLAY_MARCH, profiling.REPLAY_COMPOSITE,
                 profiling.REPLAY_INGREDIENTS, profiling.REPLAY_SKY,
                 profiling.REPLAY_SKY_FINALIZE):
        assert name.startswith(_spans.REPLAY)
    # No span of another layer falls under these prefixes.
    for name in (profiling.RENDER, profiling.SKY, profiling.STEP_FORWARD):
        assert not name.startswith((_spans.LADDER, _spans.KERNEL, _spans.POST, _spans.REPLAY))


def test_self_time_under_nesting(read):
    t = _trace(FRAME)
    # Levels 190 + 290 ns less their traces' 160 + 230: 90 ns over 2 frames.
    assert read["ladder_ms.frame"](t) == pytest.approx(90 / 2 / 1e6)
    # Traces 390 ns less their kernels' 30 + 10 + 100: 250 ns over 2 frames.
    assert read["glue_ms.frame"](t) == pytest.approx(250 / 2 / 1e6)
    # Post 100 + 20 + (1000 - 730), FXAA clipped at the stretch's end.
    assert read["post_ms.frame"](t) == pytest.approx(390 / 2 / 1e6)
    one = dataclasses.replace(t, units=1)
    assert read["glue_ms.frame"](one) == pytest.approx(250 / 1e6)
    # A child span outside any parent takes nothing off it.
    stray = _trace(FRAME + [("bhx_torch.kernel.march", 900, 950)])
    assert read["glue_ms.frame"](stray) == read["glue_ms.frame"](t)


def test_overlapping_spans_count_once():
    t = _trace([("bhx_torch.trace", 0, 100), ("bhx_torch.trace", 50, 150),
                ("bhx_torch.kernel.march", 40, 60), ("bhx_torch.kernel.march", 55, 70)])
    assert _spans.covered_ns(t, _spans.spans(t, _spans.TRACE)) == 150
    assert _spans.self_ns(t, _spans.spans(t, _spans.TRACE),
                          _spans.spans(t, _spans.KERNEL)) == 120


def test_missing_spans_read_none(read):
    bare = _trace([("aten::mul", 0, 10), ("bhx_torch.render", 0, 900)])
    for m in ("ladder_ms.frame", "glue_ms.frame", "post_ms.frame"):
        assert read[m](bare) is None
        assert read[m](_trace(FRAME, kind="fit", units=1)) is None
    assert read["replay_launches.fit"](_trace(FRAME, kind="fit", units=1)) is None
    assert read["replay_launches.fit"](_trace([("bhx_torch.replay.march", 0, 10)])) is None


def test_replay_launches(read):
    host = [
        ("bhx_torch.step.backward", 0, 1000),
        ("bhx_torch.replay.march", 100, 300),
        ("bhx_torch.replay.composite", 400, 450),
        ("cudaMemcpyAsync", 120, 125),
        ("cudaLaunchKernel", 150, 152),
        ("aten::mul", 160, 170),
        ("cudaStreamSynchronize", 200, 210),
        ("cudaLaunchKernel", 299, 303),
        ("cudaLaunchKernel", 301, 302),
        ("cudaLaunchKernelExC", 420, 421),
        ("cudaMemsetAsync", 430, 431),
        ("cudaLaunchKernel", 500, 501),
        ("cudaLaunchKernel", 1200, 1201),
    ]
    assert read["replay_launches.fit"](_trace(host, kind="fit", units=1)) == 5.0
    assert read["replay_launches.fit"](_trace(host, kind="fit", units=2)) == 2.5
    assert read["replay_launches.fit"](_trace(host, kind="orbit", units=1)) is None


def test_active_lane_share_reads_the_programs_counters(read, monkeypatch):
    from bhx_torch import profiling

    orbit = _trace(FRAME)
    profiling.reset_counts()
    assert read["active_lane_share.frame"](orbit) is None
    with profile(activities=[ProfilerActivity.CPU]):
        profiling.count_lanes(100, None)
        profiling.count_lanes(64, torch.arange(64) % 4 == 0)
    profiling.count_lanes(1000, None)  # no profiler: not counted
    assert read["active_lane_share.frame"](orbit) == pytest.approx(116 / 164)
    assert read["active_lane_share.frame"](_trace(FRAME, kind="fit", units=1)) is None
    monkeypatch.delattr(profiling, "counts")
    assert read["active_lane_share.frame"](orbit) is None
    monkeypatch.undo()
    profiling.reset_counts()
