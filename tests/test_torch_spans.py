"""The port's spans and lane counters (``bhx_torch.profiling``) on the CPU:
every span of a ladder frame with the post chain and a mesh, of a Kerr
frame's straight phases, and of a train step, nested as the layers are;
the lane counters against the ladder's own masks; and nothing recorded or
counted while no profiler records."""

from __future__ import annotations

import dataclasses

import torch
from torch.profiler import ProfilerActivity, profile

import bhx_torch
from bhx_torch import parallel, profiling
from bhx_torch.pipeline import _refine_level, _refine_masks, trace_image_record_rows
from bhx_torch.scene import with_spin

from tests.torch_mesh_data import cube_arrays

torch.set_num_threads(2)

W, H = 48, 27


def _cfg(**kw) -> bhx_torch.RenderConfig:
    return bhx_torch.RenderConfig(
        width=W, height=H, max_iterations=120,
        ladder=bhx_torch.LadderConfig.for_resolution(W, H, 3),
        bloom=bhx_torch.BloomConfig(), fxaa=bhx_torch.FxaaConfig(), **kw)


def _spans(fn):
    """``fn()`` under the profiler: its result, and the program's spans as
    (name, start, end) in ns, in order of start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(profiling.PREFIX)]
    return out, sorted(spans, key=lambda s: s[1])


def _counts(lanes, active, calls=0, replays=0):
    """``profiling.counts()`` as it should read."""
    return {profiling.LANES: lanes, profiling.ACTIVE_LANES: active, profiling.CALLS: calls,
            profiling.GRAPH_REPLAYS: replays}


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_ladder_frame_records_every_span():
    scene = bhx_torch.Scene.default("cpu")
    cube = bhx_torch.make_mesh(cube_arrays(), (6.0, 0.0, -30.0), scale=1.0,
                               flip_y=False, device="cpu")
    scene = dataclasses.replace(scene, meshes=(cube,))
    cfg = _cfg()
    _, spans = _spans(lambda: bhx_torch.render(scene, cfg))
    levels = [profiling.ladder_level(k) for k in range(3)]
    names = {s[0] for s in spans}
    assert names == {profiling.RENDER, profiling.TRACE, profiling.TRACE_STRAIGHT,
                     profiling.TRACE_MARCH, profiling.TRACE_MERGE, profiling.TRACE_SHADE,
                     profiling.LADDER_MASKS, profiling.SKY,
                     profiling.KERNEL_MARCH, profiling.KERNEL_COMPOSITE,
                     profiling.KERNEL_MESH, profiling.KERNEL_SKY, profiling.POST_BLOOM,
                     profiling.POST_TONEMAP, profiling.POST_FXAA, *levels}
    (render,) = _named(spans, profiling.RENDER)
    traces = _named(spans, profiling.TRACE)
    assert len(traces) == 3 and all(_inside(t, render) for t in traces)
    masks = _named(spans, profiling.LADDER_MASKS)
    for k, name in enumerate(levels):
        (level,) = _named(spans, name)
        assert sum(_inside(t, level) for t in traces) == 1
        assert sum(_inside(m, level) for m in masks) == 2 * (k > 0)
    # Three straight phases a trace, each with a mesh test; two march
    # phases, each with a launch; one shade with one composite.
    for phase, kernel, per_trace in (
            (profiling.TRACE_STRAIGHT, profiling.KERNEL_MESH, 3),
            (profiling.TRACE_MARCH, profiling.KERNEL_MARCH, 2),
            (profiling.TRACE_SHADE, profiling.KERNEL_COMPOSITE, 1)):
        phases, kernels = _named(spans, phase), _named(spans, kernel)
        assert len(phases) == len(kernels) == 3 * per_trace
        assert all(any(_inside(p, t) for t in traces) for p in phases)
        assert all(sum(_inside(k, p) for p in phases) == 1 for k in kernels)
    # The second march phase of a trace merges its slots into the first's,
    # a span a slot.
    merges, marches = _named(spans, profiling.TRACE_MERGE), _named(spans, profiling.TRACE_MARCH)
    assert len(merges) == 3 * 4 and all(any(_inside(m, p) for p in marches) for m in merges)
    (sky,) = _named(spans, profiling.SKY)
    (sky_kernel,) = _named(spans, profiling.KERNEL_SKY)
    assert _inside(sky_kernel, sky) and _inside(sky, render)
    post = [_named(spans, n)[0] for n in (profiling.POST_BLOOM, profiling.POST_TONEMAP,
                                          profiling.POST_FXAA)]
    assert all(_inside(p, render) and p[1] >= sky[2] for p in post)
    assert post[0][2] <= post[1][1] and post[1][2] <= post[2][1]


def test_kerr_straight_phases_record_the_momentum_span():
    scene = with_spin(bhx_torch.Scene.default("cpu"), 0.9)
    for geodesics, per_phase in (("kerr", 1), ("pseudo", 0)):
        _, spans = _spans(lambda: bhx_torch.render(scene, _cfg(geodesics=geodesics)))
        phases = _named(spans, profiling.TRACE_STRAIGHT)
        momenta = _named(spans, profiling.TRACE_KERR_MOMENTUM)
        # Three traces (a ladder level each), three straight phases a trace.
        assert len(phases) == 3 * 3
        assert len(momenta) == per_phase * len(phases)
        assert all(sum(_inside(m, p) for p in phases) == 1 for m in momenta)


def test_no_profiler_no_span_and_no_count():
    profiling.reset_counts()
    assert not profiling.recording()
    off = profiling.span(profiling.RENDER)
    assert off is profiling.span(profiling.TRACE)
    assert not isinstance(off, torch.profiler.record_function)
    bhx_torch.render(bhx_torch.Scene.default("cpu"), _cfg())
    assert profiling.counts() == _counts(0, 0)

    def inside():
        assert profiling.recording()
        return profiling.span(profiling.RENDER)

    on, _ = _spans(inside)
    assert isinstance(on, torch.profiler.record_function)
    assert not profiling.recording()


def test_lane_counters_match_the_ladder():
    scene = bhx_torch.Scene.default("cpu")
    cfg = _cfg()
    lad = cfg.ladder_for_output()
    # The ladder apart: level 0 dense, each later level its re-trace mask.
    rows = trace_image_record_rows(scene, cfg, *lad.resolution(0))
    lanes = active = lad.resolution(0)[0] * lad.resolution(0)[1]
    for lvl in range(1, lad.levels):
        w, h = lad.resolution(lvl)
        needs, _ = _refine_masks(rows, cfg, w, h)
        lanes += w * h
        active += int(needs.sum())
        rows = _refine_level(rows, scene, cfg, w, h)
    assert 0 < active < lanes

    profiling.reset_counts()
    _spans(lambda: bhx_torch.render(scene, cfg))
    # One tracer call a level, none a graph's replay on the host.
    assert profiling.counts() == _counts(lanes, active, calls=lad.levels)
    profiling.reset_counts()
    assert profiling.counts() == _counts(0, 0)


def test_masked_sums_fold_when_the_ring_is_full(monkeypatch):
    monkeypatch.setattr(profiling, "RING_SLOTS", 3)
    monkeypatch.setattr(profiling, "_active_device", {})
    profiling.reset_counts()
    masks = [torch.arange(10) < k for k in range(1, 8)]
    _spans(lambda: [profiling.count_lanes(10, m) for m in masks])
    assert profiling.counts() == _counts(70, 28)
    ring, slot = profiling._active_device[torch.device("cpu")]
    assert ring.shape == (3,) and slot == 3
    profiling.reset_counts()


def test_train_step_records_its_parts_and_the_replays():
    scene = bhx_torch.Scene.default("cpu")
    cfg = bhx_torch.RenderConfig(width=16, height=9, max_iterations=60, use_ladder=False,
                                 show_sky=False)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in parallel.scene_params(scene).items()}
    optimizer = parallel.make_optimizer(params)
    target = torch.zeros((9, 16, 3))
    loss, spans = _spans(lambda: parallel.train_step(params, optimizer, scene, target, cfg))
    assert torch.isfinite(loss)
    names = {s[0] for s in spans}
    assert {profiling.STEP_FORWARD, profiling.STEP_BACKWARD, profiling.STEP_OPTIMIZER,
            profiling.REPLAY_MARCH, profiling.REPLAY_COMPOSITE} <= names
    assert profiling.STEP_ALL_REDUCE not in names
    (forward,) = _named(spans, profiling.STEP_FORWARD)
    (backward,) = _named(spans, profiling.STEP_BACKWARD)
    (optimizer_span,) = _named(spans, profiling.STEP_OPTIMIZER)
    assert forward[2] <= backward[1] and backward[2] <= optimizer_span[1]
    assert _named(spans, profiling.RENDER) and all(
        _inside(s, forward) for s in _named(spans, profiling.RENDER))
    replays = _named(spans, profiling.REPLAY_MARCH)
    assert len(replays) == 2 and all(_inside(r, backward) for r in replays)
