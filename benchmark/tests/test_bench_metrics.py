"""The frozen metric arithmetic: the reference's count of a seeded frame's
march work and its bound repeat exactly; the busy/idle union; the readers
on a made-up trace; and every device metric path raises without a card
instead of falling back to the CPU."""

import dataclasses

import pytest
import torch

from benchmark import harness, spec, tracing
from benchmark.drivers import orbit
from benchmark.drivers.common import reference_side
from benchmark.metrics import _bound, _busy
from benchmark.reference import frame as ref_frame
from benchmark.reference.scene import posed


def _work(seed):
    cell = spec.load("rk45.orbit")
    render = dict(cell.config["render"], width=40, height=24, max_iterations=150)
    rcfg, rscene = reference_side(render, cell.config["scene"], "cpu")
    row = orbit.poses(cell.traffic, seed, 10)[6]
    work = []
    ref_frame.render(posed(rscene, *(torch.tensor(float(v)) for v in row)), rcfg,
                     dict(work=work))
    return [(int(a), float(b)) for a, b in work]


def test_march_work_and_bound_repeat():
    a, b = _work(2**31 + 77), _work(2**31 + 77)
    assert a == b
    assert len(a) == 8  # 4 ladder levels x 2 march rounds
    assert sum(s for _, s in a) > 0
    bounds = [_bound.march_bound_ms("rk45", live, steps) for live, steps in a]
    assert bounds == [_bound.march_bound_ms("rk45", live, steps) for live, steps in b]


def test_bound_arithmetic():
    # 1e9 lane-substeps of Euler: 106e9 float32 operations at 33.45 T/s.
    got = _bound.bound(106e9, 51 * 4 * 1e6, 4e9)
    assert got["bound_ceiling"] == "float32"
    assert got["bound_ms"] == pytest.approx(106e9 / (132 * 128 * 1.98e9) * 1e3)
    assert _bound.bound(1.0, 3.35e12)["bound_ms"] == pytest.approx(1e3)


def test_union_gaps_and_breakdown():
    busy = _busy.union([(0, 10), (5, 20), (30, 40), (35, 36), (90, 120)], 2, 100)
    assert busy == [(2, 20), (30, 40), (90, 100)]
    assert _busy.covered([(0, 10), (5, 20)], 0, 100) == 20
    assert _busy.gaps(busy, 0, 100) == [(0, 2), (20, 30), (40, 90)]
    host = [("outer", 0, 100), ("aten::nonzero", 41, 89)]
    assert _busy.idle_gaps(busy, host, 0, 100)[0] == ["aten::nonzero", 50e-9]
    ops = _busy.device_ops([("k", 0, 10), ("k", 30, 40), ("m", 5, 8)], 0, 100)
    assert ops == [["k", 20e-9], ["m", 3e-9]]


def test_readers_on_a_made_up_trace():
    device = [("march_kernel", 10, 30), ("elementwise", 40, 50), ("march_queue_kernel", 25, 35)]
    host = [("autograd::engine::evaluate_function: X", 20, 60)]
    orbit_trace = tracing.Trace(device=device, host=host, lo=0, hi=100, units=2,
                                info=dict(kind="orbit", integrator="euler",
                                          march_work=[(1000.0, 5e5)]))
    fit_trace = tracing.Trace(device=device, host=host, lo=0, hi=100, units=1,
                              info=dict(kind="fit", window_peak_bytes=17.5e9))
    read = {m: tracing.reader(m) for m in ("idle_frac.frame", "idle_frac.fit",
                                            "device_events.frame", "march_roofline.frame",
                                            "frame_mean_ms.frame",
                                            "peak_mem_gb.fit", "backward_frac.fit")}
    assert read["idle_frac.frame"](orbit_trace) == pytest.approx(0.65)
    assert read["frame_mean_ms.frame"](orbit_trace) is None
    timed = dataclasses.replace(orbit_trace, info=dict(orbit_trace.info, unit_s=0.05))
    assert read["frame_mean_ms.frame"](timed) == pytest.approx(50.0)
    assert read["frame_mean_ms.frame"](fit_trace) is None
    assert read["idle_frac.frame"](fit_trace) is None
    assert read["idle_frac.fit"](fit_trace) == pytest.approx(0.65)
    assert read["device_events.frame"](orbit_trace) == 1.5
    share = read["march_roofline.frame"](orbit_trace)
    assert share == pytest.approx(100 * _bound.march_bound_ms("euler", 1000.0, 5e5) / 25e-6)
    assert read["peak_mem_gb.fit"](fit_trace) == 17.5
    assert read["backward_frac.fit"](fit_trace) == pytest.approx(0.4)
    assert read["backward_frac.fit"](orbit_trace) is None


def test_device_paths_raise_without_a_card(card_absent):
    with pytest.raises(RuntimeError):
        tracing.Capture()
    with pytest.raises(RuntimeError):
        harness.run_cell("euler.orbit", 1, 0.1, True, device="cpu",
                         overrides=dict(width=16, height=9, max_iterations=20))

