"""Card-only tests: each CUDA kernel of bhx_torch against its plain torch
version on the card (the mesh kernel M1 in both branches, with active
masks, and its one launch for all meshes with the merge inside), proof that CUDA tensors launch the kernels (with and without
autograd, and with meshes in the scene), the card's frames against the
CPU's (and ``bench.parity_check``), the card's gradient against the CPU's
(and d/d(yaw, pitch) through ``Camera.rotated``), the camera's pose
methods on the card, and the sharded trace over a world of one NCCL rank.
Every test here is marked ``gpu`` and skips without a CUDA device.

On a machine with a card (the root conftest.py imports jax, which such a
machine need not have):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import bhx_torch
from bhx_torch import checks
from bhx_torch.kernels import launch_counts, replay_counts, reset_launch_counts
from bhx_torch.kernels import march as tmarch
from bhx_torch.kernels import mesh as tmesh
from bhx_torch.kernels import shade as tshade
from bhx_torch.kernels import sky as tsky
from bhx_torch.geometry import traverse
from bhx_torch.scene import Camera, with_spin
from bhx_torch.tracer import march_batch
from bhx_torch.tracer import march_kwargs as tmarch_kwargs

# tests/ is on sys.path under pytest (it has no __init__.py); a package
# named ``tests`` elsewhere on the path would shadow ``tests.torch_mesh_data``.
from torch_mesh_data import cube_arrays, torus_arrays, write_obj

_SLOTS = slice(tmarch.OUT_FIXED, tmarch.OUT_FIXED + tmarch.SLOT_ROWS)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def frame():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return bhx_torch.Scene.default(torch.device("cuda")), bhx_torch.RenderConfig()


def test_march_level0_matches_plain(frame):
    scene, cfg = frame
    rays, params, _ = march_batch(scene, cfg, *cfg.ladder_for_output().resolution(0))
    r = checks.compare_march(rays, params, cfg)
    assert r["ok"], {k: v for k, v in r.items() if k != "out"}


def test_dense_trace_kernels_match_plain(frame):
    scene, cfg = frame
    rays, params, cam = march_batch(scene, cfg, 640, 361)
    r = checks.compare_march(rays, params, cfg)
    assert r["ok"], {k: v for k, v in r.items() if k != "out"}
    c = checks.compare_composite(r["out"][_SLOTS], cam,
                                 checks.shade_params(scene), scene.disk_gain, cfg)
    assert c["ok"], c
    i = checks.compare_ingredients(r["out"][_SLOTS], cam, checks.shade_params(scene), cfg)
    assert i["ok"], i
    record = bhx_torch.pipeline.trace_image_record_rows(scene, cfg, 640, 361)
    s = checks.compare_sky(record.reshape(8, -1), cfg)
    assert s["ok"], s
    f = checks.compare_sky_finalize(record.reshape(8, -1).t().contiguous(), cfg)
    assert f["ok"], f


@pytest.mark.parametrize("branch", ["rk45", "kerr"])
def test_rk45_and_kerr_marches_match_plain(frame, branch):
    scene, cfg = frame
    if branch == "kerr":
        scene, cfg = with_spin(scene, 0.9), cfg.replace(geodesics="kerr")
    else:
        cfg = cfg.replace(integrator=bhx_torch.Integrator.RK45)
    for size in (cfg.ladder_for_output().resolution(0), (640, 361)):
        rays, params, _ = march_batch(scene, cfg, *size)
        before = launch_counts()[f"march_{branch}"]
        r = checks.compare_march(rays, params, cfg)
        assert r["ok"], {k: v for k, v in r.items() if k != "out"}
        assert launch_counts()[f"march_{branch}"] == before + 1


def _branch(frame, branch):
    scene, cfg = frame
    cfg = cfg.replace(width=96, height=54, use_ladder=False, max_iterations=300)
    if branch == "kerr":
        return with_spin(scene, 0.9), cfg.replace(geodesics="kerr")
    if branch == "rk45":
        return scene, cfg.replace(integrator=bhx_torch.Integrator.RK45)
    return scene, cfg


def _edge_batches(rays, params, case):
    """The (rays, params) launches of one edge case, from a dense 96x54
    batch (N = 5184 = 40.5 blocks of 128, every lane live)."""
    n = rays.shape[1]
    rays = rays.clone()
    if case == "no_live":
        rays[7] = 0.0
    elif case == "one_live":
        rays[7] = 0.0
        rays[7, n // 2 + 5] = 1.0
    elif case == "ragged_last_block":
        assert n % 128
        rays[7, :n - n % 128] = 0.0
    elif case == "below_one_warp":
        rays = rays[:, 1000:1020].contiguous()
    elif case == "all_to_budget":
        # Five steps left of the budget: no ray exits or is absorbed in them.
        rays[9] = params[tmarch._P["budget"]] - 5.0
    elif case == "two_in_a_row":
        return [(rays, params), (rays[:, ::3].contiguous(), params)]
    return [(rays, params)]


@pytest.mark.parametrize("case", ["no_live", "one_live", "ragged_last_block",
                                  "below_one_warp", "two_in_a_row", "all_to_budget"])
@pytest.mark.parametrize("branch", ["euler", "rk45", "kerr"])
def test_march_edge_cases_bit_identical(frame, branch, case):
    """The compacting kernel against the plain march at its edges: every
    output bit-identical, the queue and its counters fresh in every launch."""
    scene, cfg = _branch(frame, branch)
    kw = tmarch_kwargs(cfg)
    rays, params, _ = march_batch(scene, cfg, cfg.width, cfg.height)
    batches = _edge_batches(rays, params, case)
    got = [tmarch.march(r, p, **kw) for r, p in batches]
    torch.cuda.synchronize()
    for (r, p), g in zip(batches, got):
        want = tmarch.march_torch(r, p, **kw)
        assert g.shape == want.shape
        assert float((g - want).abs().max()) == 0.0
    steps = got[0][tmarch._OUT_FIXED["steps"]]
    live = (batches[0][0][7] > 0.5).sum()
    assert int((steps > 0).sum()) == int(live)
    if case == "all_to_budget":
        assert bool((steps == 5.0).all())


@pytest.mark.parametrize("toggle", ["show_disk_0", "tex_opacity_min_1"])
@pytest.mark.parametrize("branch", ["euler", "rk45", "kerr"])
def test_march_toggles_bit_identical(frame, branch, toggle):
    """The kernel's two feature arguments -- no disk (``show_disk=0``) and no
    disk texture (``tex_opacity_min=1.0``) -- bit-identical to the plain
    march."""
    scene, cfg = _branch(frame, branch)
    cfg = cfg.replace(**({"show_disk": False} if toggle == "show_disk_0"
                         else {"show_disk_texture": False}))
    kw = tmarch_kwargs(cfg)
    assert kw["tex_opacity_min"] == 1.0 and kw["show_disk"] == (toggle != "show_disk_0")
    rays, params, _ = march_batch(scene, cfg, cfg.width, cfg.height)
    got = tmarch.march(rays, params, **kw)
    want = tmarch.march_torch(rays, params, **kw)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) == 0.0
    if toggle == "show_disk_0":
        assert not bool(got[_SLOTS].any())


def _random_slots(n: int, case: str, seed: int = 0):
    """Random crossing slots on the card, (SLOT_ROWS, n), their camera
    distances and a random disk_gain grid.  Each slot is valid on its own
    (not a prefix); "blocks": the first 256-ray block has no valid slot,
    the second all 1,024 valid."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-9, 9, (4, 3, n))
    dirs = rng.normal(size=(4, 3, n))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    valid = rng.uniform(size=(4, n)) < np.array([[0.3], [0.4], [0.2], [0.1]])
    if case == "blocks":
        valid[:, :256] = False
        valid[:, 256:512] = True
    slots = np.concatenate([pos, dirs, valid[:, None, :]], axis=1).reshape(4 * 7, n)
    cam = rng.uniform(15, 25, (n,))
    gain = rng.uniform(0.3, 1.7, (16, 16, 4))
    return [torch.tensor(a, dtype=torch.float32, device="cuda") for a in (slots, cam, gain)]


@pytest.mark.parametrize("show_texture", [True, False])
@pytest.mark.parametrize("show_redshift", [True, False])
@pytest.mark.parametrize("case,n", [("random", 5000), ("blocks", 5000), ("random", 1),
                                    ("random", 255), ("random", 257), ("random", 0),
                                    ("random", 400_001)])
def test_shade_kernels_bit_identical_at_edges(frame, case, n, show_texture, show_redshift):
    """The block-compacting composite and the thread-per-slot ingredients
    kernel against their plain versions, bit for bit, one launch each (none
    for no ray); 400,001 rays are more chunks than the card holds blocks,
    so each block takes several, the last one ragged."""
    scene, _ = frame
    slots, cam, gain = _random_slots(n, case)
    params = checks.shade_params(scene)
    flags = dict(show_texture=show_texture, show_redshift=show_redshift)
    reset_launch_counts()
    got = tshade.composite(slots, cam, params, gain, **flags)
    ing = tshade.ingredients(slots, cam, params, **flags)
    torch.cuda.synchronize()
    assert launch_counts()["composite"] == launch_counts()["ingredients"] == int(n > 0)
    want = tshade.composite_torch(slots, cam, params, gain, **flags)
    want_ing = tshade.ingredients_torch(slots, cam, params, **flags)
    assert got.shape == want.shape == (4, n)
    assert ing.shape == want_ing.shape == (4 * tshade.ING_FIELDS, n)
    assert checks._max_abs_err(got, want) == 0.0
    assert checks._max_abs_err(ing, want_ing) == 0.0
    if case == "blocks":
        assert bool((got[:, :256] == torch.tensor([[0.0], [0.0], [0.0], [1.0]],
                                                  device="cuda")).all())
        assert bool((got[3, 256:512] < 1.0).any())


def test_composite_backward_replays_after_one_launch(frame):
    """The composite's backward is the replay of its plain version: one
    kernel launch, one replay, the gradient of the plain version."""
    scene, _ = frame
    slots, cam, gain = _random_slots(5000, "blocks")
    params = checks.shade_params(scene)
    leaves = [t.clone().requires_grad_() for t in (params, gain)]
    reset_launch_counts()
    out = tshade.composite(slots, cam, *leaves)
    grads = torch.autograd.grad((out * out).sum(), leaves)
    torch.cuda.synchronize()
    assert (launch_counts()["composite"], replay_counts()["composite"]) == (1, 1)
    plain = [t.clone().requires_grad_() for t in (params, gain)]
    want = tshade.composite_torch(slots, cam, *plain)
    assert checks._max_abs_err(out, want) == 0.0
    # The gain's cotangent is summed by atomic index_add_, in no fixed order.
    for g, w in zip(grads, torch.autograd.grad((want * want).sum(), plain)):
        assert bool(torch.isfinite(g).all())
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("requires_grad", [False, True], ids=["forward", "backward"])
def test_cuda_tensors_never_reach_plain_versions(frame, monkeypatch, requires_grad):
    """The forward launches the kernels, under autograd too; the backward
    launches none and reaches only the replay entries."""
    scene, cfg = frame

    def boom(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((tmarch, "march_torch"), (tshade, "composite_torch"),
                      (tsky, "sky_rows_torch")):
        monkeypatch.setattr(mod, name, boom)
    if requires_grad:
        mass = scene.black_hole.mass.detach().clone().requires_grad_()
        scene = dataclasses.replace(scene, black_hole=dataclasses.replace(
            scene.black_hole, mass=mass))
    reset_launch_counts()
    img = bhx_torch.render(scene, cfg.replace(width=96, height=54, use_ladder=False))
    torch.cuda.synchronize()
    after = launch_counts()
    assert img.is_cuda and bool(torch.isfinite(img).all())
    # Two march rounds, one composite, one sky pass.
    assert after["march"] == 2
    assert after["composite"] == 1
    assert after["sky"] == 1
    if requires_grad:
        (g,) = torch.autograd.grad(img.sum(), mass)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(g)) and float(g) != 0.0
        assert launch_counts() == after
        replays = replay_counts()
        assert (replays["march"], replays["composite"], replays["sky"]) == (2, 1, 1)


def test_small_frame_matches_cpu(frame):
    scene, _ = frame
    cfg = bhx_torch.RenderConfig(
        width=96, height=54, use_ladder=False, max_iterations=600,
        bloom=bhx_torch.BloomConfig(enabled=False),
        fxaa=bhx_torch.FxaaConfig(enabled=False), tonemap=False,
    )
    on_card = bhx_torch.render(scene, cfg).cpu()
    on_cpu = bhx_torch.render(scene.to("cpu"), cfg)
    bad = float((on_card - on_cpu).abs().gt(2e-2).any(-1).float().mean())
    assert bad <= 0.02, bad


def test_parity_check(frame):
    """bench.parity_check at its defaults: the card's 192x108 frame against
    the CPU's plain one, at most 2% of pixels over 2e-2."""
    from bhx_torch.bench import parity_check

    r = parity_check()
    assert r["parity_ok"], r


def test_world_one_nccl_trace_sharded_bit_identical(frame):
    """trace_image_sharded over a world of one NCCL rank (the gather runs)
    equals the dense record bit for bit, and launches the march and the
    composite."""
    import torch.distributed as dist

    from bhx_torch import parallel
    from bhx_torch.tracer import trace_image_record

    scene, _ = frame
    cfg = bhx_torch.RenderConfig(use_ladder=False)
    parallel.init_distributed(f"localhost:{parallel.free_port()}", 1, 0, "nccl")
    try:
        mesh = parallel.tile_mesh(device=scene.time.device)
        assert mesh.group is not None and mesh.size == 1
        reset_launch_counts()
        got = parallel.trace_image_sharded(scene, cfg, mesh, 640, 361)
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        dist.destroy_process_group()
    want = trace_image_record(scene, cfg, 640, 361)
    assert launches["march"] == 2 and launches["composite"] == 1, launches
    assert float((got - want).abs().max()) == 0.0


def test_small_frame_gradient_matches_cpu(frame):
    """The gradient of one fixed weighted-pixel loss with respect to every
    fitted scene parameter and ``disk_gain`` at 96x54 (dense, 300
    iterations, no tonemap): the card (kernel forward, replayed backward)
    against the plain path on the CPU, each parameter within 1e-3 of its
    largest entry (``checks.compare_gradients``: the weights are zero off
    the FD-stable pixels and where the two forwards part)."""
    scene, _ = frame
    cfg = bhx_torch.RenderConfig(
        width=96, height=54, use_ladder=False, max_iterations=300,
        bloom=bhx_torch.BloomConfig(enabled=False),
        fxaa=bhx_torch.FxaaConfig(enabled=False), tonemap=False,
    )
    r = checks.compare_gradients(scene, cfg)
    assert r["kept_frac"] > 0.3, r
    assert r["ok"], r


def test_pose_methods_stay_on_card(frame):
    """``Camera.look_at``, ``right`` and ``rotated`` on a camera on the card
    give tensors on the card, equal to the same calls on the CPU within
    2e-6; a tensor angle on the card keeps its graph."""
    cam = frame[0].camera
    posed = dataclasses.replace(cam, position=torch.tensor([6.0, -2.0, -18.0], device="cuda"))
    yaw = torch.tensor(0.35, device="cuda", requires_grad=True)
    for on_card, on_cpu in (
            (cam.rotated(yaw, -0.15), cam.to("cpu").rotated(0.35, -0.15)),
            (posed.look_at((0.0, 0.0, 0.0)), posed.to("cpu").look_at((0.0, 0.0, 0.0))),
            (cam.look_at([3.0, 1.0, 0.0]).rotated(-0.5, 0.2),
             cam.to("cpu").look_at([3.0, 1.0, 0.0]).rotated(-0.5, 0.2))):
        for got, want in ((on_card.forward, on_cpu.forward), (on_card.right(), on_cpu.right())):
            assert got.device.type == "cuda"
            torch.testing.assert_close(got.detach().cpu(), want, atol=2e-6, rtol=0)
    assert cam.rotated(yaw, -0.15).forward.grad_fn is not None


def test_pose_gradient_matches_cpu(frame):
    """d/d(yaw, pitch) of one fixed weighted-pixel loss through
    ``Camera.rotated`` at 96x54 (dense, 300 iterations, no post): the card
    against the plain path on the CPU within 1e-3 of the larger entry
    (``checks.compare_pose_gradients``)."""
    scene, _ = frame
    cfg = bhx_torch.RenderConfig(
        width=96, height=54, use_ladder=False, max_iterations=300,
        bloom=bhx_torch.BloomConfig(enabled=False),
        fxaa=bhx_torch.FxaaConfig(enabled=False), tonemap=False,
    )
    r = checks.compare_pose_gradients(scene, cfg, 0.35, -0.15)
    assert r["kept_frac"] > 0.3, r
    assert r["ok"], r


@pytest.fixture(scope="module")
def mesh_scene(frame, tmp_path_factory):
    """The default scene seen from outside the relativity sphere with the
    viewer's cube (brute force) and a 2,048-triangle torus loaded from an
    OBJ file (BVH), on the card."""
    scene, _ = frame
    path = tmp_path_factory.mktemp("obj") / "torus.obj"
    write_obj(path, *torus_arrays(32, 32))
    cube = bhx_torch.make_mesh(cube_arrays(), position=(6.0, 0.0, -30.0), name="cube",
                               scale=1.0, flip_y=False)
    torus = bhx_torch.make_mesh(str(path), position=(-6.0, 0.0, -27.0), name="torus")
    camera = Camera(position=torch.tensor([0.0, 0.0, -40.0], device="cuda"),
                    forward=torch.tensor([0.0, 0.0, 1.0], device="cuda"),
                    fov=torch.tensor(1.0, device="cuda"))
    return dataclasses.replace(scene, camera=camera, meshes=(cube, torus))


def _mesh_rays(n: int = 20000, seed: int = 3):
    """Rays from around the outside camera toward both meshes (some through
    the torus hole), and an active mask with a quarter of the lanes off."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.0, -40.0]) + rng.normal(0.0, 1.0, (n, 3))
    centers = np.where(rng.random((n, 1)) < 0.5, [-6.0, 0.0, -27.0], [6.0, 0.0, -30.0])
    d = centers + rng.uniform(-4.5, 4.5, (n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    as_t = lambda a: torch.tensor(a, dtype=torch.float32, device="cuda")  # noqa: E731
    return as_t(o), as_t(d), torch.tensor(rng.random(n) < 0.75, device="cuda")


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("branch", ["brute", "bvh"])
def test_mesh_kernel_bit_identical(mesh_scene, branch, masked):
    mesh = mesh_scene.meshes[0 if branch == "brute" else 1]
    o, d, active = _mesh_rays()
    before = launch_counts()["mesh"]
    r = checks.compare_mesh(o, d, mesh, active if masked else None)
    assert r["ok"] and r["hits"] > 1000, r
    assert launch_counts()["mesh"] == before + 1
    if masked:
        got = tmesh.intersect_mesh_cuda(o, d, mesh, active)
        assert not bool(got["hit"][~active].any())


def test_mesh_kernel_leaf_cap(mesh_scene):
    """Leaves of up to 16 triangles (leaf_size=16): the kernel tests their
    first 4, as the plain traversal does."""
    p, n, tri = torus_arrays(32, 32)
    mesh = bhx_torch.make_mesh((p, n, tri, tri), position=(-6.0, 0.0, -27.0),
                               leaf_size=16)
    assert int(mesh.node_count.max()) > 4
    o, d, active = _mesh_rays()
    r = checks.compare_mesh(o, d, mesh, active)
    assert r["ok"] and r["hits"] > 1000, r


def _tie_cube(cube):
    """The cube again, its vertex normals negated: same geometry, another
    color, so a tie shows which mesh won."""
    return dataclasses.replace(cube, normals=-cube.normals)


def _hidden(mesh):
    return dataclasses.replace(mesh, visible=torch.tensor(False, device="cuda"))


def _scene_case(mesh_scene, case: str):
    cube, torus = mesh_scene.meshes
    return {"1": [torus], "2": [cube, torus], "3": [cube, torus, _tie_cube(cube)],
            "hidden": [cube, _hidden(torus), _tie_cube(cube)]}[case]


@pytest.mark.parametrize("masked", [False, True], ids=["all", "active"])
@pytest.mark.parametrize("case", ["1", "2", "3", "hidden"])
def test_fused_meshes_bit_identical(mesh_scene, case, masked):
    """One launch for all the meshes, the merge inside, against the plain
    traversals and merge: bit-identical in t, hit, color and normal."""
    meshes = _scene_case(mesh_scene, case)
    o, d, active = _mesh_rays()
    before = launch_counts()["mesh"]
    r = checks.compare_meshes(o, d, meshes, active if masked else None)
    assert r["ok"] and r["hits"] > 1000, r
    assert launch_counts()["mesh"] == before + 1
    if case == "3":
        # The tie cube never wins: the result is the cube's and the torus's.
        got = tmesh.intersect_meshes_cuda(o.unbind(1), d.unbind(1), meshes[:2])
        want = tmesh.intersect_meshes_cuda(o.unbind(1), d.unbind(1), meshes)
        for k in got:
            assert torch.equal(got[k], want[k]), k


def test_fused_meshes_leaf16(mesh_scene):
    """Leaves of up to 16 triangles beside the cube, in one launch: the
    first 4 of a leaf tested, as the plain traversal does."""
    p, n, tri = torus_arrays(32, 32)
    mesh = bhx_torch.make_mesh((p, n, tri, tri), position=(-6.0, 0.0, -27.0),
                               leaf_size=16)
    assert int(mesh.node_count.max()) > 4
    o, d, active = _mesh_rays()
    r = checks.compare_meshes(o, d, [mesh_scene.meshes[0], mesh], active)
    assert r["ok"] and r["hits"] > 1000, r


@pytest.mark.parametrize("case", ["no rays", "no live lane"])
def test_fused_meshes_empty(mesh_scene, case):
    o, d, active = _mesh_rays()
    if case == "no rays":
        o, d, active = o[:0], d[:0], active[:0]
    else:
        active = torch.zeros_like(active)
    r = checks.compare_meshes(o, d, mesh_scene.meshes, active)
    assert r["ok"] and r["hits"] == 0, r


def test_fused_meshes_past_the_cap(mesh_scene):
    """Ten cubes and the torus: more meshes than one launch takes, so a
    second launch reads the merged hit of the first and writes it in place.
    Cubes stacked in depth overlap on screen; one is hidden, and the last
    one repeats the first (another color), so a tie spans the launches."""
    cube, torus = mesh_scene.meshes
    cubes = [dataclasses.replace(cube, position=torch.tensor(
        [4.0 + 2.0 * (k % 3), 2.0 * (k // 3) - 3.0, -30.0 - 1.5 * k], device="cuda"))
        for k in range(9)]
    cubes[3] = _hidden(cubes[3])
    meshes = cubes + [torus, _tie_cube(cubes[0])]
    assert [len(g) for g in tmesh.launch_groups(meshes)] == [8, 3]
    o, d, active = _mesh_rays()
    before = launch_counts()["mesh"]
    r = checks.compare_meshes(o, d, meshes, active)
    assert r["ok"] and r["hits"] > 1000, r
    assert launch_counts()["mesh"] == before + 2


def test_fused_meshes_read_rows_in_place(mesh_scene):
    """The tracer's rows as they come: contiguous, strided and broadcast
    (stride 0, a camera's origin); the same bits as the plain merge of the
    stacked rays."""
    _, d, active = _mesh_rays()
    origin = torch.tensor([0.0, 0.0, -40.0], device="cuda")
    rows_o = (origin[0].expand(d.shape[0]), origin[1].expand(d.shape[0]),
              origin[2].expand(d.shape[0]))
    rows_d = (d[:, 0].contiguous(), d[:, 1], d[:, 2])
    got = traverse.intersect_meshes(rows_o, rows_d, mesh_scene.meshes, active)
    want = traverse.intersect_meshes_torch(torch.stack(rows_o, -1), d, mesh_scene.meshes,
                                           active)
    assert bool(want["hit"].any())
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_mesh_call_makes_no_host_sync(mesh_scene):
    """After a first call (the light vector and the packing are made and
    cached), a mesh call queues its work and never waits on the card."""
    o, d, active = _mesh_rays()
    rows = o.unbind(1), d.unbind(1)
    traverse.intersect_meshes(*rows, mesh_scene.meshes, active)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = traverse.intersect_meshes(*rows, mesh_scene.meshes, active)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(got["hit"].any())


def test_mesh_frame_launches_the_kernel(mesh_scene, monkeypatch):
    """With meshes in the scene, CUDA tensors reach M1 and never the plain
    traversal or merge: one launch for both meshes per straight phase (3
    in a dense trace), and a fit through it still has a gradient."""
    def boom(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain traversal")

    monkeypatch.setattr(traverse, "intersect_mesh_torch", boom)
    monkeypatch.setattr(traverse, "intersect_meshes_torch", boom)
    mass = mesh_scene.black_hole.mass.detach().clone().requires_grad_()
    scene = dataclasses.replace(mesh_scene, black_hole=dataclasses.replace(
        mesh_scene.black_hole, mass=mass))
    cfg = bhx_torch.RenderConfig(width=96, height=54, use_ladder=False)
    reset_launch_counts()
    img = bhx_torch.render(scene, cfg)
    torch.cuda.synchronize()
    assert launch_counts()["mesh"] == 3
    (g,) = torch.autograd.grad(img.sum(), mass)
    assert bool(torch.isfinite(img).all()) and bool(torch.isfinite(g))


def test_mesh_frame_matches_cpu(mesh_scene):
    cfg = bhx_torch.RenderConfig(
        width=64, height=36, use_ladder=False, max_iterations=600,
        bloom=bhx_torch.BloomConfig(enabled=False),
        fxaa=bhx_torch.FxaaConfig(enabled=False), tonemap=False,
    )
    on_card = bhx_torch.render(mesh_scene, cfg).cpu()
    on_cpu = bhx_torch.render(mesh_scene.to("cpu"), cfg)
    without = bhx_torch.render(mesh_scene.to("cpu"), cfg.replace(render_meshes=False))
    bad = float((on_card - on_cpu).abs().gt(2e-2).any(-1).float().mean())
    assert bad <= 0.02, bad
    assert float((on_cpu - without).abs().gt(2e-2).any(-1).float().mean()) > 0.05
