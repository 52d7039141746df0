"""The mesh kernel M1's host side on the CPU: its packed layout
(``kernels.mesh.pack``) entry for entry against the mesh's BVH arrays, the
cache that keeps it, the cut of a scene's meshes into launches, and the
tracer-facing ``intersect_meshes`` taking the state's rows, against the
plain merge.  The kernel itself runs only on the card
(``tests/test_torch_gpu.py``)."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from bhx_torch.geometry import obj as tobj
from bhx_torch.geometry import traverse as ttrav
from bhx_torch.kernels import mesh as kmesh

from tests.torch_mesh_data import cube_arrays, torus_arrays

torch.set_num_threads(2)


def _mesh(which: str):
    if which == "cube":
        return tobj.make_mesh(cube_arrays(), position=(6.0, 0.0, -30.0), scale=1.0,
                              flip_y=False, device="cpu")
    p, n, tri = torus_arrays(32, 32)
    return tobj.make_mesh((p, n, tri, tri), position=(-6.0, 0.0, -27.0),
                          leaf_size=16 if which == "leaf16" else 2, device="cpu")


@pytest.mark.parametrize("which", ["cube", "torus", "leaf16"])
def test_pack_matches_the_bvh_arrays(which):
    """Record i + 1 is node i (min, left, max, count; record 0 is zero),
    and triangle row k holds the vertices points[tri_points[lookup[k]]]
    and the index lookup[k], bit for bit."""
    mesh = _mesh(which)
    if which == "leaf16":
        assert int(mesh.node_count.max()) > 4
    nodes, tris = kmesh.pack(mesh)
    b, t = mesh.node_left.shape[0], mesh.num_triangles
    assert nodes.dtype == tris.dtype == torch.int32
    assert tuple(nodes.shape) == (b + 1, 8) and tuple(tris.shape) == (t, 12)
    assert nodes.is_contiguous() and tris.is_contiguous()
    assert not bool(nodes[0].any())
    f = nodes[1:].view(torch.float32)
    assert torch.equal(f[:, 0:3], mesh.node_min) and torch.equal(f[:, 4:7], mesh.node_max)
    assert torch.equal(nodes[1:, 3], mesh.node_left)
    assert torch.equal(nodes[1:, 7], mesh.node_count)
    lookup = mesh.lookup.numpy()
    want = mesh.points.numpy()[mesh.tri_points.numpy()[lookup]].reshape(t, 9)
    np.testing.assert_array_equal(tris[:, :9].view(torch.float32).numpy(), want)
    np.testing.assert_array_equal(tris[:, 9].numpy(), lookup)
    assert not bool(tris[:, 10:].any())
    # An inner node's children are records left + 1 and left + 2, an even
    # first record: one aligned 64-byte read (records of 32 bytes).
    inner = mesh.node_count == 0
    assert bool(inner.any()) and bool(((mesh.node_left[inner] + 1) % 2 == 0).all())


def test_packing_is_cached_beside_the_mesh():
    """One packing per BVH: the same tensors again for the same mesh, and
    for a copy that changes only fields the packing does not read; a new
    one after an in-place change of a source, or for a moved mesh."""
    mesh = _mesh("torus")
    first = kmesh.packed(mesh)
    assert kmesh.packed(mesh) is first
    moved = dataclasses.replace(mesh, position=mesh.position + 1.0,
                                visible=torch.tensor(False))
    assert kmesh.packed(moved) is first
    mesh.node_min.add_(0.0)  # bumps the version counter
    again = kmesh.packed(mesh)
    assert again is not first and torch.equal(again[0], first[0])
    other = dataclasses.replace(mesh, points=mesh.points.clone())
    assert kmesh.packed(other) is not again


def _fake(triangles: int):
    return SimpleNamespace(num_triangles=triangles)


@pytest.mark.parametrize("case,sizes,want", [
    ("one", [12], [1]),
    ("ten cubes", [12] * 10, [8, 2]),
    ("eight", [12, 600000] * 4, [8]),
    ("staged", [512, 512, 12, 700], [2, 2]),
    ("bvh only", [513] * 17, [8, 8, 1]),
    ("none", [], []),
])
def test_launch_groups(case, sizes, want):
    """Meshes in order, at most MAX_MESHES and STAGE_MAX brute-force
    triangles a launch; BVH meshes stage nothing."""
    meshes = [_fake(s) for s in sizes]
    groups = kmesh.launch_groups(meshes)
    assert [len(g) for g in groups] == want, case
    assert [m for g in groups for m in g] == meshes
    for g in groups:
        assert len(g) <= kmesh.MAX_MESHES
        assert sum(m.num_triangles for m in g
                   if m.num_triangles <= kmesh.BRUTE_FORCE_THRESHOLD) <= kmesh.STAGE_MAX


@pytest.fixture(scope="module")
def scene_meshes():
    return _mesh("cube"), _mesh("torus")


def _rays(n=2000, seed=7):
    """Rays from around (0, 0, -40) toward the cube and the torus."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, -40.0]) + rng.normal(0.0, 1.0, (n, 3))
    aim = np.where(rng.random((n, 1)) < 0.5, [-6.0, 0.0, -27.0], [6.0, 0.0, -30.0])
    d = aim + rng.uniform(-4.5, 4.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (torch.tensor(o, dtype=torch.float32), torch.tensor(d, dtype=torch.float32),
            torch.from_numpy(rng.random(n) < 0.7))


@pytest.mark.parametrize("form", ["rows", "strided rows", "state rows"])
def test_intersect_meshes_takes_rows(scene_meshes, form):
    """The tracer hands ``intersect_meshes`` its state rows; on the CPU the
    result is the plain merge of the (N, 3) rays, whatever the rows'
    strides."""
    o, d, active = _rays()
    want = ttrav.intersect_meshes_torch(o, d, scene_meshes, active)
    if form == "rows":
        origin = tuple(o.t().contiguous())
        direction = tuple(d.t().contiguous())
    elif form == "strided rows":
        origin, direction = o.unbind(1), d.unbind(1)
    else:
        # Rows 1-6 of one (8, N) tensor: views at offsets into one storage.
        state = torch.cat([torch.zeros(1, len(o)), o.t(), d.t(), torch.ones(1, len(o))])
        origin, direction = tuple(state[1:4]), tuple(state[4:7])
    got = ttrav.intersect_meshes(origin, direction, scene_meshes, active=active)
    assert bool(want["hit"].any()) and not bool(want["hit"][~active].any())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_plain_merge_of_no_mesh_misses(scene_meshes):
    o, d, active = _rays(50)
    got = ttrav.intersect_meshes_torch(o, d, (), active)
    assert not bool(got["hit"].any()) and bool((got["t"] == ttrav.MISS_T).all())
    assert not bool(got["color"].any()) and not bool(got["normal"].any())


def test_wrapper_refuses_cpu_rows(scene_meshes):
    """The kernel's wrapper takes only card tensors; on the CPU the
    dispatch never reaches it."""
    o, d, active = _rays(50)
    with pytest.raises(ValueError, match="px"):
        kmesh.intersect_meshes_cuda(o.unbind(1), d.unbind(1), scene_meshes, active)
