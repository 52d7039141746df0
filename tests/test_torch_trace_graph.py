"""The rule by which a trace runs as a CUDA graph (``bhx_torch.graphs``), on
the CPU: the reasons a call stays eager, the key, capture at a key's second
sighting and never while a profiler records, the bound on graphs a
device, a failed capture leaving its key eager, and the tracer's call and
replay counters.  Where a path needs a graph, a stand-in replays the eager
body; the card's graphs against the eager trace are
``tests/test_torch_gpu.py::test_trace_graph_replays_bit_identical``."""

from __future__ import annotations

import dataclasses
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bhx_torch
from bhx_torch import graphs, kernels, profiling, tracer
from bhx_torch.kernels import mesh as mesh_kernel

# tests/ is on sys.path under pytest (it has no __init__.py); a package
# named ``tests`` elsewhere on the path would shadow ``tests.torch_mesh_data``.
from torch_mesh_data import cube_arrays, torus_arrays

torch.set_num_threads(2)

W, H = 16, 9
CPU = torch.device("cpu")


def _inputs(**cfg):
    scene = bhx_torch.Scene.default("cpu")
    cfg = bhx_torch.RenderConfig(width=W, height=H, use_ladder=False, max_iterations=100,
                                 **cfg)
    o, d = (t.reshape(-1, 3) for t in tracer.camera_rays(scene.camera, W, H))
    return o, d, scene, cfg


def _with_mass(scene, mass):
    return dataclasses.replace(scene, black_hole=dataclasses.replace(scene.black_hole,
                                                                     mass=mass))


def _case(name):
    o, d, scene, cfg = _inputs(texture_mode="array" if name.startswith("array") else
                               "procedural", show_disk=name != "array_no_disk")
    if name == "mass_requires_grad" or name == "no_grad":
        scene = _with_mass(scene, scene.black_hole.mass.clone().requires_grad_())
    if name == "origins_require_grad":
        o = o.clone().requires_grad_()
    return o, d, scene, cfg


@pytest.mark.parametrize("name,reason", [
    ("host", graphs.ON_HOST),
    ("array_disk", graphs.HOST_SYNC),
    ("array_no_disk", graphs.ON_HOST),
    ("mass_requires_grad", graphs.AUTOGRAD),
    ("origins_require_grad", graphs.AUTOGRAD),
    ("no_grad", graphs.ON_HOST),
])
def test_eager_reasons(name, reason):
    o, d, scene, cfg = _case(name)
    with torch.set_grad_enabled(name != "no_grad"):
        assert graphs.eager_reason(o, d, scene, cfg) == reason


def test_capture_at_the_second_sighting_never_while_recording():
    g = graphs.Graphs()
    assert g.action("a", CPU, False) == graphs.EAGER
    assert g.action("a", CPU, True) == graphs.EAGER  # seen, but a profiler records
    assert g.action("a", CPU, False) == graphs.CAPTURE
    g.add("a", CPU, object())
    assert [g.action("a", CPU, r) for r in (False, True)] == [graphs.REPLAY] * 2
    # A first sighting while recording is a sighting all the same.
    assert g.action("b", CPU, True) == graphs.EAGER
    assert g.action("b", CPU, False) == graphs.CAPTURE
    assert g.action("c", CPU, False) == graphs.EAGER
    g.clear()
    assert len(g) == 0 and g.action("a", CPU, False) == graphs.EAGER


def test_graphs_past_the_limit_evict_the_least_recently_used():
    g = graphs.Graphs()
    other = torch.device("meta")
    g.add("other", other, object())
    for k in range(graphs.LIMIT):
        g.add(k, CPU, object())
    assert g.action(0, CPU, False) == graphs.REPLAY  # now the most recent
    g.add(graphs.LIMIT, CPU, object())
    assert len(g) == graphs.LIMIT + 1
    assert g.action(1, CPU, False) == graphs.EAGER  # evicted: seen anew
    assert g.action(1, CPU, False) == graphs.CAPTURE
    for k in (0, *range(2, graphs.LIMIT + 1)):
        assert g.action(k, CPU, False) == graphs.REPLAY
    assert g.action("other", other, False) == graphs.REPLAY


class _StandIn:
    """A graph that replays the eager body on the call's inputs."""

    made = 0

    def __init__(self, body, origins, directions, scene, cfg, rounds, active, keep, stream):
        _StandIn.made += 1
        self.body, self.cfg, self.rounds = body, cfg, rounds

    def replay(self, origins, directions, scene, active):
        return self.body(origins, directions, scene, self.cfg, self.rounds, active)


class _Fails(_StandIn):
    def __init__(self, *args):
        super().__init__(*args)
        raise RuntimeError("operation not permitted when stream is capturing")


@pytest.fixture
def stand_in(monkeypatch):
    """The process's graphs emptied, every call graphable, no card streams."""
    monkeypatch.setattr(graphs, "GRAPHS", graphs.Graphs())
    monkeypatch.setattr(graphs, "eager_reason", lambda *args: None)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    _StandIn.made = 0
    return monkeypatch


def test_a_failed_capture_leaves_its_key_eager(stand_in):
    stand_in.setattr(graphs, "_Graph", _Fails)
    o, d, scene, cfg = _inputs()
    want = tracer._trace_record_rows(o, d, scene, cfg, tracer.DEFAULT_ROUNDS)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = [graphs.GRAPHS.trace(tracer._trace_record_rows, o, d, scene, cfg,
                                   tracer.DEFAULT_ROUNDS, None) for _ in range(4)]
    assert _StandIn.made == 1 and len(graphs.GRAPHS) == 0
    assert [replayed for _, replayed in got] == [False] * 4
    assert all(torch.equal(rows, want) for rows, _ in got)
    assert len(caught) == 1 and "capture failed" in str(caught[0].message)


def test_calls_and_replays_counted_while_recording(stand_in):
    stand_in.setattr(graphs, "_Graph", _StandIn)
    o, d, scene, cfg = _inputs()
    want = tracer._trace_record_rows(o, d, scene, cfg, tracer.DEFAULT_ROUNDS)
    profiling.reset_counts()
    tracer.trace_rays_record_rows(o, d, scene, cfg)  # first sighting, not counted
    with profile(activities=[ProfilerActivity.CPU]):
        got = [tracer.trace_rays_record_rows(o, d, scene, cfg) for _ in range(3)]
    assert _StandIn.made == 0  # no capture while the profiler recorded
    tracer.trace_rays_record_rows(o, d, scene, cfg)  # captures, not counted
    counts = profiling.counts()
    profiling.reset_counts()
    assert _StandIn.made == 1
    assert counts[profiling.CALLS] == 3 and counts[profiling.GRAPH_REPLAYS] == 0
    assert all(torch.equal(rows, want) for rows in got)

    graphs.GRAPHS.clear()
    tracer.trace_rays_record_rows(o, d, scene, cfg)
    tracer.trace_rays_record_rows(o, d, scene, cfg)  # captures
    with profile(activities=[ProfilerActivity.CPU]):
        tracer.trace_rays_record_rows(o, d, scene, cfg)
        tracer.trace_rays_record_rows(o[:W], d[:W], scene, cfg)  # another key: eager
    counts = profiling.counts()
    profiling.reset_counts()
    assert counts[profiling.CALLS] == 2 and counts[profiling.GRAPH_REPLAYS] == 1


def test_a_host_trace_keeps_no_graph(monkeypatch):
    monkeypatch.setattr(graphs, "GRAPHS", graphs.Graphs())
    o, d, scene, cfg = _inputs()
    active = torch.arange(W * H) % 3 == 0
    want = tracer._trace_record_rows(o, d, scene, cfg, tracer.DEFAULT_ROUNDS, active)
    for _ in range(3):
        assert torch.equal(tracer.trace_rays_record_rows(o, d, scene, cfg, active=active), want)
    assert len(graphs.GRAPHS) == 0 and graphs.GRAPHS.action("x", CPU, False) == graphs.EAGER


def test_the_key_holds_what_the_body_bakes_in():
    o, d, scene, cfg = _inputs()
    key = lambda **kw: graphs.graph_key(**{  # noqa: E731
        **dict(origins=o, directions=d, scene=scene, cfg=cfg, rounds=2, active=None), **kw})[0]
    base = key()
    # Values read from the static inputs do not change it.
    moved = dataclasses.replace(_with_mass(scene, scene.black_hole.mass + 1.0),
                                time=scene.time + 3.0, disk_gain=scene.disk_gain * 2.0,
                                camera=scene.camera.rotated(0.2, 0.1))
    assert key(scene=moved, origins=o + 1.0, directions=-d) == base
    assert key(cfg=cfg.replace()) == base
    others = [key(origins=o[:W], directions=d[:W]), key(active=torch.ones(W * H, dtype=bool)),
              key(rounds=1), key(cfg=cfg.replace(max_iterations=99)),
              key(scene=dataclasses.replace(scene, disk_gain=torch.ones(8, 8, 4))),
              key(origins=o.double())]
    assert len({base, *others}) == len(others) + 1


def test_the_key_holds_the_meshes_read_in_place():
    o, d, scene, cfg = _inputs()
    cube = bhx_torch.make_mesh(cube_arrays(), (6.0, 0.0, -30.0), scale=1.0, flip_y=False,
                               device="cpu")
    p, n, t = torus_arrays(16, 20)
    torus = bhx_torch.make_mesh((p, n, t, t), (-6.0, 0.0, -27.0), scale=1.0, flip_y=False,
                                device="cpu")
    assert torus.num_triangles > mesh_kernel.BRUTE_FORCE_THRESHOLD >= cube.num_triangles
    with_meshes = dataclasses.replace(scene, meshes=(cube, torus))
    key, keep = graphs.graph_key(o, d, with_meshes, cfg, 2, None)
    # The torus's BVH is packed once, here, and its packing is read in place.
    assert all(any(t is k for k in keep) for t in mesh_kernel.packed(torus))
    assert graphs.graph_key(o, d, with_meshes, cfg, 2, None)[0] == key
    assert graphs.graph_key(o, d, with_meshes, cfg.replace(render_meshes=False), 2,
                            None)[0][-1] == ()
    moved = dataclasses.replace(cube, position=cube.position + 1.0)
    assert graphs.graph_key(o, d, dataclasses.replace(scene, meshes=(moved, torus)), cfg, 2,
                            None)[0] != key


def test_add_launch_counts():
    kernels.reset_launch_counts()
    kernels.add_launch_counts({"march": 2, "composite": 1, "not_a_kernel": 5})
    kernels.add_launch_counts({"march": -1})
    counts = kernels.launch_counts()
    kernels.reset_launch_counts()
    assert counts == {**dict.fromkeys(counts, 0), "march": 1, "composite": 1}
