"""bhx_torch.geometry against bhx.geometry on the CPU: the ray-shape tests,
the BVH arrays (numpy and C++ builders), OBJ parsing (C++ and numpy
parsers), the plain mesh traversal in both branches, and the leaf cap of
4 triangles that both packages share.

Inputs are made with numpy from seeds and handed to both packages.  The
bhx meshes are built from the port's arrays with bhx's numpy BVH builder,
so that no test here compiles bhx's native library into ``bhx/``."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhx.geometry.intersect as jint
import bhx.geometry.native as jnative
import bhx.geometry.obj as jobj
import bhx.geometry.traverse as jtrav
from bhx.geometry.bvh import _build_bvh_numpy as jax_build_bvh

from bhx_torch.geometry import bvh as tbvh
from bhx_torch.geometry import intersect as tint
from bhx_torch.geometry import obj as tobj
from bhx_torch.geometry import traverse as ttrav

from tests.torch_mesh_data import cube_arrays, jax_mesh, torus_arrays, write_obj

torch.set_num_threads(2)

def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)) for a in arrays]


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _intersection_case(name: str, rng):
    """(function name, numpy args): random rays and random shapes, one per
    ray, so that hits and misses of every kind occur."""
    n = 4096
    o = rng.uniform(-8.0, 8.0, (n, 3)).astype(np.float32)
    target = rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32)
    d = _unit(target - o + rng.normal(0.0, 1.0, (n, 3)))
    center = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    if name in ("hit_sphere", "hit_sphere_both"):
        return [o, d, center, rng.uniform(0.5, 4.0, (n,)).astype(np.float32)]
    if name == "hit_annulus":
        normal = _unit(rng.normal(0.0, 1.0, (n, 3)))
        return [o, d, center, normal, np.float32(1.0), np.float32(4.0)]
    if name == "hit_aabb":
        lo = center - rng.uniform(0.2, 3.0, (n, 3)).astype(np.float32)
        hi = center + rng.uniform(0.2, 3.0, (n, 3)).astype(np.float32)
        d = np.where(rng.random((n, 3)) < 0.05, 0.0, d).astype(np.float32)  # the 1e-12 guard
        inv = (1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)).astype(np.float32)
        return [o, inv, lo, hi]
    p = [center + rng.uniform(-3.0, 3.0, (n, 3)).astype(np.float32) for _ in range(3)]
    nrm = [_unit(rng.normal(0.0, 1.0, (n, 3))) for _ in range(3)]
    return [o, d, *p, *nrm]


@pytest.mark.parametrize("name", ["hit_sphere", "hit_sphere_both", "hit_annulus",
                                  "hit_aabb", "hit_triangles"])
def test_intersection_matches_bhx(name):
    """Each ray-shape test on the same random rays and shapes: hit masks
    equal, every float output within 1e-6 relative (1e-6 absolute near 0);
    the outputs after a hit mask (hit point, color, normal) on hits only,
    where a miss's are not defined."""
    args = _intersection_case(name, np.random.default_rng(11))
    scalars = [a if np.ndim(a) == 0 else None for a in args]
    want = getattr(jint, name)(*[s if s is not None else jnp.asarray(a)
                                 for s, a in zip(scalars, args)])
    got = getattr(tint, name)(*[float(s) if s is not None else torch.from_numpy(a)
                                for s, a in zip(scalars, args)])
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    hit = None
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w)
            hit = w
            assert 0.05 < hit.mean() < 0.95
        elif hit is not None and name != "hit_sphere_both":
            np.testing.assert_allclose(g[hit], w[hit], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def _random_tris(n, seed=0):
    """tests/test_bvh.py's random triangle soup."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    offsets = rng.uniform(-0.5, 0.5, (n, 2, 3)).astype(np.float32)
    points = np.concatenate(
        [centers, centers + offsets[:, 0], centers + offsets[:, 1]], axis=0).astype(np.float32)
    tris = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n],
                    axis=1).astype(np.int32)
    return points, tris


def _bvh_case(name):
    if name == "torus":
        p, _, tri = torus_arrays(32, 32)
        return p, tri
    if name == "single":
        return (np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32),
                np.array([[0, 1, 2]], np.int32))
    n, seed = {"random50": (50, 0), "random2000": (2000, 3), "random777": (777, 11)}[name]
    return _random_tris(n, seed)


@pytest.mark.parametrize("native", [False, True], ids=["numpy", "native"])
@pytest.mark.parametrize("case", ["torus", "random50", "random2000", "single", "random777"])
def test_bvh_arrays_match_bhx(case, native):
    """The port's builder gives bhx's arrays, bit for bit, and they are a
    valid BVH shallow enough for the traversal stack."""
    points, tris = _bvh_case(case)
    want = jax_build_bvh(points, tris)
    got = tbvh.build_bvh(points, tris, use_native=native)
    for f in want._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    tbvh.validate_bvh(got, points, tris)
    assert got.max_depth() < ttrav.STACK_DEPTH


_OBJ_FORMS = "\n".join([
    "# comment line",
    "v 0 0 0", "v 1 0 0", "v 1 1 0", "v 0 1 0", "v 0.5 0.5 1",
    "vn 0 0 1", "vn 0 0 -1", "vn 1 0 0",
    "f 1 2 3",                      # plain, normal synthesized
    "f 1/1/1 2/2/1 3/3/2 4/4/2",    # p/t/n quad -> fan
    "f -5//-3 -4//-1 -3//-2",       # p//n, negative indices
    "f 1/2 2/3 5/1",                # p/t (no normal)
    "",
])


@pytest.mark.parametrize("case", ["forms", "torus_vn", "torus_no_vn"])
def test_obj_parse_matches_bhx(case, tmp_path, monkeypatch):
    """The C++ and numpy parsers give identical arrays, equal to bhx's
    numpy parser's, with and without ``vn``."""
    path = tmp_path / "mesh.obj"
    if case == "forms":
        path.write_text(_OBJ_FORMS)
    else:
        p, n, tri = torus_arrays(16, 12)
        if case == "torus_vn":
            write_obj(path, p, n, tri)
        else:
            with open(path, "w") as f:
                np.savetxt(f, p, fmt="v %.6f %.6f %.6f")
                np.savetxt(f, tri + 1, fmt="f %d %d %d")
    # bhx's numpy parser, with its native library out of reach.
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_tried", True)
    want = jobj.load_obj(str(path))
    native = tobj.load_obj(str(path))
    plain = tobj.load_obj(str(path), use_native=False)
    for name, w, a, b in zip(("points", "normals", "tri_p", "tri_n"), want, native, plain):
        assert a.shape == w.shape and a.dtype == w.dtype, name
        np.testing.assert_array_equal(a, w, err_msg=name)
        np.testing.assert_array_equal(b, w, err_msg=name)
    if case == "torus_no_vn":
        assert want[1].shape[0] == want[2].shape[0]  # one flat normal a face


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The viewer's cube (brute force) and a 2,048-triangle torus loaded
    from an OBJ file (BVH), on the CPU, where the mesh scene puts them."""
    path = tmp_path_factory.mktemp("obj") / "torus.obj"
    write_obj(path, *torus_arrays(32, 32))
    cube = tobj.make_mesh(cube_arrays(), position=(6.0, 0.0, -30.0), name="cube",
                          scale=1.0, flip_y=False, device="cpu")
    torus = tobj.make_mesh(str(path), position=(-6.0, 0.0, -27.0), name="torus",
                           device="cpu")
    return cube, torus


def _rays(n=3000, seed=5):
    """Rays from around (0, 0, -40): 40% toward the torus, 30% toward the
    cube, 30% through the torus hole (within 0.6 of its center)."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, -40.0]) + rng.normal(0.0, 1.0, (n, 3))
    pick = rng.random(n)[:, None]
    torus, cube = np.array([-6.0, 0.0, -27.0]), np.array([6.0, 0.0, -30.0])
    aim = np.where(pick < 0.4, torus, np.where(pick < 0.7, cube, torus))
    scale = np.where(pick < 0.4, 4.5, np.where(pick < 0.7, 2.5, 0.6))
    d = _unit(aim + scale * rng.uniform(-1.0, 1.0, (n, 3)) - o)
    return o.astype(np.float32), d


def _assert_hits_match(got, want, tol=1e-5):
    hit = np.asarray(want["hit"])
    np.testing.assert_array_equal(got["hit"].numpy(), hit)
    np.testing.assert_allclose(got["t"].numpy()[hit], np.asarray(want["t"])[hit], rtol=tol)
    for k in ("color", "normal"):
        np.testing.assert_allclose(got[k].numpy()[hit], np.asarray(want[k])[hit], atol=tol)
    assert np.all(got["t"].numpy()[~hit] == tint.MISS_T)


@pytest.mark.parametrize("which", ["cube", "torus"])
def test_traversal_matches_bhx(meshes, which):
    """The plain traversal against bhx's (brute force for the cube, the
    BVH for the torus), and with an active mask: inactive lanes miss,
    active ones are unchanged."""
    mesh = meshes[0] if which == "cube" else meshes[1]
    assert (mesh.num_triangles <= ttrav.BRUTE_FORCE_THRESHOLD) == (which == "cube")
    o, d = _rays()
    want = jtrav.intersect_mesh(*_j(o, d), jax_mesh(mesh))
    got = ttrav.intersect_mesh(*_t(o, d), mesh)
    assert 0.1 < np.asarray(want["hit"]).mean() < 0.9
    _assert_hits_match(got, want)
    active = torch.from_numpy(np.random.default_rng(1).random(len(o)) < 0.7)
    masked = ttrav.intersect_mesh(*_t(o, d), mesh, active=active)
    assert not bool(masked["hit"][~active].any())
    for k in got:
        assert torch.equal(masked[k][active], got[k][active]), k


@pytest.mark.parametrize("hidden", [None, 0, 1, "tie"])
def test_intersect_meshes_matches_bhx(meshes, hidden):
    """Both meshes at once, one of them ``visible=False`` or neither: the
    nearest hit and its diffuse-lit color.  ``tie``: three meshes, the
    cube, the torus hidden, and the cube again with its vertex normals
    negated (same geometry, another color): the earlier cube wins every
    tie, so the result is the cube's alone."""
    ms = [m if i != hidden else dataclasses.replace(m, visible=torch.tensor(False))
          for i, m in enumerate(meshes)]
    if hidden == "tie":
        cube, torus = meshes
        ms = [cube, dataclasses.replace(torus, visible=torch.tensor(False)),
              dataclasses.replace(cube, normals=-cube.normals)]
    o, d = _rays()
    want = jtrav.intersect_meshes(*_j(o, d), tuple(jax_mesh(m) for m in ms))
    got = ttrav.intersect_meshes_torch(*_t(o, d), ms)
    _assert_hits_match(got, want)
    rows = [x.unbind(1) for x in _t(o, d)]
    for k, v in ttrav.intersect_meshes(*rows, ms).items():
        assert torch.equal(v, got[k]), k
    if hidden == "tie":
        alone = ttrav.intersect_meshes_torch(*_t(o, d), ms[:1])
        assert bool(alone["hit"].any())
        for k in got:
            assert torch.equal(got[k], alone[k]), k
    elif hidden is not None:
        alone = ttrav.intersect_mesh(*_t(o, d), meshes[1 - hidden])
        np.testing.assert_array_equal(got["hit"].numpy(), alone["hit"].numpy())


def _nbytes(*arrays):
    return sum(a.numel() * a.element_size() for a in arrays)


@pytest.mark.parametrize("which", ["cube", "torus"])
def test_mesh_work_counts_what_the_run_reads(meshes, which):
    """M1's bound counts the mesh bytes the run reads and the ray bytes of
    live lanes alone: one ray's walk reads each node and lookup entry it
    visits once; the cube's run reads all of its triangles, the torus's a
    part; brute force charges no inverse direction or root box."""
    from bhx_torch import checks

    mesh = meshes[0] if which == "cube" else meshes[1]
    o, d = _t(*_rays(400))
    if which == "torus":
        for i in range(40):
            work = {}
            ttrav.intersect_mesh_torch(o[i:i + 1], d[i:i + 1], mesh, work=work)
            assert int(work["nodes_read"].sum()) == int(
                work["inner_visits"].sum() + work["leaf_visits"].sum())
            assert int(work["lookup_read"].sum()) == int(work["tri_tests"].sum())
    active = torch.from_numpy(np.random.default_rng(3).random(len(o)) < 0.6)
    work = checks.meshes_work(o, d, [mesh], active)
    assert work["live"] == int(active.sum()) and work["masked"]
    assert len(work["meshes"]) == 1 and work["meshes"][0]["live"] == work["live"]
    whole = _nbytes(mesh.tri_points, mesh.tri_normals, mesh.points, mesh.normals,
                    mesh.position)
    if which == "cube":
        assert work["mesh_bytes"] == whole
        assert work["tris_read"] == mesh.num_triangles
        assert work["tri_tests"] == work["live"] * mesh.num_triangles
    else:
        assert 0 < work["mesh_bytes"] < whole + _nbytes(
            mesh.node_min, mesh.node_max, mesh.node_left, mesh.node_count, mesh.lookup)
        assert 0 < work["tris_read"] <= min(work["tri_tests"], mesh.num_triangles)
    passed = [work[k] for k in ttrav.EXIT_KEYS]
    assert work["tri_tests"] >= passed[0] >= passed[1] >= passed[2] >= passed[3] > 0
    assert passed[3] < work["tri_tests"]
    b = checks.mesh_bound(work)
    # Each triangle read pays its setup once, each test its ray-dependent
    # part as far as it gets; brute force pays no inverse direction or root
    # box.
    ops = (work["inner_visits"] * checks.MESH_INNER_OPS
           + work["tris_read"] * checks.MESH_TRI_SETUP_OPS
           + work["tri_tests"] * 15 + passed[0] * 17 + passed[1] * 14 + passed[2] * 14
           + passed[3] * 10
           + (0 if which == "cube"
              else work["live"] * (checks.MESH_INV_OPS + checks.MESH_ROOT_OPS)))
    assert checks.MESH_TRI_TEST_OPS == 70
    assert b["ops_ms"] == pytest.approx(ops / checks.PEAK_F32_OPS * 1e3, rel=1e-12)
    nbytes = 24 * work["live"] + len(o) * (1 + 32) + work["mesh_bytes"]
    assert b["bytes_ms"] == pytest.approx(nbytes / checks.PEAK_BYTES_PER_S * 1e3, rel=1e-12)
    idle = checks.meshes_work(o, d, [mesh], torch.zeros(len(o), dtype=torch.bool))
    assert idle["live"] == 0 and idle["mesh_bytes"] == 0 and idle["tris_read"] == 0


@pytest.mark.parametrize("x, y, z, direction, want", [
    (0.2, 0.2, -1.0, (0.0, 0.0, 1.0), 4),   # a hit
    (0.7, 0.7, -1.0, (0.0, 0.0, 1.0), 4),   # u + v > 1: found only past the divisions
    (-0.5, 0.2, -1.0, (0.0, 0.0, 1.0), 1),  # u < 0
    (0.2, -0.5, -1.0, (0.0, 0.0, 1.0), 2),  # v < 0
    (0.2, 0.2, 1.0, (0.0, 0.0, 1.0), 3),    # t < 0: the triangle is behind
    (0.2, 0.2, -1.0, (1.0, 0.0, 0.0), 0),   # parallel: |det| < 1e-5
])
def test_exits_passed_follow_the_kernel_order(x, y, z, direction, want):
    """How far M1's triangle test gets, on the triangle (0,0,0), (1,0,0),
    (0,1,0), where u runs along x and v along y."""
    p1, p2, p3 = (torch.tensor(v) for v in ((0.0, 0.0, 0.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0)))
    o, d = torch.tensor([x, y, z]), torch.tensor(direction)
    assert int(ttrav._exits_passed(o, d, p1, p2, p3)) == want
    hit = bool(tint.hit_triangles(o, d, p1, p2, p3, p1, p1, p1)[1])
    assert hit == (want == 4 and x + y <= 1.0)


def test_exits_passed_never_stop_a_hit():
    """A test that leaves early is a miss: every hit of the plain test
    passes all four exits, on random rays against random triangles."""
    rng = np.random.default_rng(11)
    o, d = (torch.from_numpy(rng.normal(size=(4000, 1, 3)).astype(np.float32))
            for _ in range(2))
    p1, p2, p3 = (torch.from_numpy(rng.normal(size=(1, 64, 3)).astype(np.float32) + 3.0)
                  for _ in range(3))
    passed = ttrav._exits_passed(o, d, p1, p2, p3)
    hit = tint.hit_triangles(o, d, p1, p2, p3, p1, p2, p3)[1]
    assert int(hit.sum()) > 100 and bool((passed[hit] == 4).all())
    assert bool((passed < 4).any()) and bool((passed == 4).any())


def _leaf_cap_mesh(facing: int):
    """Six triangles about one centroid, the origin: all but triangle
    ``facing`` lie in planes that hold the z axis, so a ray along +z meets
    only that one.  Their coincident centroids make the split degenerate:
    one leaf of 6.  600 small triangles far off push the mesh past the
    brute-force threshold, onto the BVH."""
    planes = {"x": [[0, -1, -1], [0, 1, -1], [0, 0, 2]],
              "y": [[-1, 0, -1], [1, 0, -1], [0, 0, 2]],
              "z": [[-1, -1, 0], [1, -1, 0], [0, 2, 0]]}
    order = ["x", "y", "x", "y", "x", "y"]
    order[facing] = "z"
    tris = [np.array(planes[k], np.float32) for k in order]
    far, _ = _random_tris(600, seed=2)
    pts = np.concatenate([np.concatenate(tris), far.reshape(3, 600, 3).transpose(1, 0, 2)
                          .reshape(-1, 3) + np.float32(100.0)]).astype(np.float32)
    tri = np.arange(len(pts), dtype=np.int32).reshape(-1, 3)
    normals = np.tile(np.array([[0.0, 0.0, -1.0]], np.float32), (len(pts), 1))
    return tobj.make_mesh((pts, normals, tri, tri), device="cpu")


@pytest.mark.parametrize("facing", [4, 5], ids=["5th", "6th"])
def test_leaf_cap_misses_in_both_packages(facing):
    """A fault of the reference that the port copies (ROADMAP C.4): a leaf
    left oversized by a degenerate split has its triangles past the
    fourth never tested.  Both traversals miss the triangle the ray meets;
    brute force finds it."""
    mesh = _leaf_cap_mesh(facing)
    assert mesh.num_triangles > ttrav.BRUTE_FORCE_THRESHOLD
    assert int(mesh.node_count[0]) == 0 and int(mesh.node_count.max()) == 6
    o = np.array([[0.0, 0.2, -10.0], [0.1, 0.1, -5.0]], np.float32)
    d = np.array([[0.0, 0.0, 1.0], [0.0, 0.0, 1.0]], np.float32)
    want = jtrav.intersect_mesh(*_j(o, d), jax_mesh(mesh))
    got = ttrav.intersect_mesh(*_t(o, d), mesh)
    assert not np.asarray(want["hit"]).any() and not bool(got["hit"].any())
    brute = ttrav._intersect_brute(*_t(o, d), mesh, None)
    assert bool(brute["hit"].all())


@pytest.mark.parametrize("which", ["vertex", "normal"])
def test_make_mesh_rejects_out_of_range_indices(which):
    """A face index past the end of its array (a malformed OBJ file) is
    refused at load time: the mesh kernel reads indices unchecked."""
    v, n, tri, tn = cube_arrays()
    tri, tn = tri.copy(), tn.copy()
    (tri if which == "vertex" else tn)[3, 1] = len(v) if which == "vertex" else len(n)
    with pytest.raises(ValueError, match=which):
        tobj.make_mesh((v, n, tri, tn), device="cpu")
