"""The whole bhx_torch slice against the JAX reference on the CPU: camera
rays, the ladder refine decision, each post stage, the phase identities,
and ``bhx_torch.render`` against ``bhx.render(march_mode="fast")`` and the
``ladder_post``, ``rk45_disk_shift``, ``kerr_spin09``, ``mesh_feather`` and
``euler_sky`` golden images; with meshes (the viewer's cube and a
2,048-triangle torus seen from outside the relativity sphere), densely and
on the ladder; and the feature toggles, with and without meshes."""

from __future__ import annotations

import dataclasses
import enum
import functools
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhx.config as jcfg
import bhx.post as jpost
from bhx.pipeline import _refine_masks as jax_refine_masks
from bhx.pipeline import render_jit
from bhx.scene import Camera as JaxCamera
from bhx.scene import scene_to_state
from bhx.tracer import camera_rays as jax_camera_rays

import bhx_torch
from bhx_torch import post as tpost
from bhx_torch import tracer as ttracer
from bhx_torch.pipeline import _refine_masks, final_level_retrace_mask

from tests.common import FAST_CFG, LADDER_CFG, outside_camera, small_scene
from tests.test_golden import _cases as golden_cases
from tests.torch_mesh_data import cube_arrays, jax_mesh, torus_arrays, write_obj

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LADDER_POST_CFG = dataclasses.replace(
    LADDER_CFG, bloom=jcfg.BloomConfig(enabled=True),
    fxaa=jcfg.FxaaConfig(enabled=True), tonemap=True,
)


def _port(value, like):
    """A bhx config value as its bhx_torch counterpart."""
    if isinstance(value, enum.Enum):
        return type(like)[value.name]
    if dataclasses.is_dataclass(value):
        return type(like)(**{f.name: getattr(value, f.name)
                             for f in dataclasses.fields(like)})
    return value


def torch_cfg(cfg: jcfg.RenderConfig) -> bhx_torch.RenderConfig:
    """The bhx_torch RenderConfig with every shared field of ``cfg``."""
    base = bhx_torch.RenderConfig()
    return base.replace(**{
        f.name: _port(getattr(cfg, f.name), getattr(base, f.name))
        for f in dataclasses.fields(base)
    })


@functools.lru_cache(maxsize=1)
def _torch_scene():
    return bhx_torch.scene_from_state(scene_to_state(small_scene()), "cpu")


@functools.lru_cache(maxsize=4)
def _renders(name: str):
    cfg = {"fast": FAST_CFG, "ladder_post": LADDER_POST_CFG}[name]
    want = np.asarray(render_jit(small_scene(), cfg), np.float32)
    got = bhx_torch.render(_torch_scene(), torch_cfg(cfg)).numpy()
    return got, want


def _bad_frac(got, want):
    return float((np.abs(got - want) > 2e-2).any(-1).mean())


@pytest.mark.parametrize("size", [(64, 36), (85, 49)])
def test_camera_rays_match(size):
    cams = [small_scene().camera,
            JaxCamera.default().look_at(jnp.asarray([3.0, 1.0, 0.0])).rotated(0.3, -0.2)]
    for cam in cams:
        tcam = bhx_torch.Camera(**{k: torch.tensor(np.asarray(getattr(cam, k)))
                                   for k in ("position", "forward", "fov")})
        o_j, d_j = jax_camera_rays(cam, *size)
        o_t, d_t = ttracer.camera_rays(tcam, *size)
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=1e-6, rtol=0)
        np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=1e-6, rtol=0)


def test_refine_masks_bit_equal():
    """The same coarse record through both refine decisions: a smooth
    escape-direction field with jitter and scattered hit pixels, so every
    branch (copy, interpolate, re-trace) occurs."""
    rng = np.random.default_rng(3)
    w0, h0 = 30, 17
    cfg = dataclasses.replace(LADDER_CFG, ladder=jcfg.LadderConfig(base=(w0, h0), levels=2))
    w, h = cfg.ladder.resolution(1)
    _, d = jax_camera_rays(JaxCamera.default(), w0, h0)
    d = np.moveaxis(np.asarray(d), -1, 0) + rng.normal(0, 0.004, (3, h0, w0))
    rows = np.concatenate([
        rng.uniform(0, 1, (3, h0, w0)),
        (rng.uniform(size=(1, h0, w0)) < 0.15),
        rng.uniform(0, 1, (1, h0, w0)),
        d,
    ]).astype(np.float32)
    needs_j, known_j = jax_refine_masks(tuple(jnp.asarray(r) for r in rows), cfg, w, h)
    needs_t, known_t = _refine_masks(torch.from_numpy(rows), torch_cfg(cfg), w, h)
    needs_j = np.asarray(needs_j)
    assert 0.05 < needs_j.mean() < 0.9
    np.testing.assert_array_equal(needs_t.numpy(), needs_j)
    np.testing.assert_array_equal(known_t.numpy(), np.stack([np.asarray(k) for k in known_j]))


def _chw(seed: int = 5, h: int = 49, w: int = 85):
    """A fixed HDR image with smooth structure, hard edges and noise."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 0.6 + 0.5 * np.sin(xx / 7.0)[None] * np.cos(yy / 5.0)[None]
    disk = ((xx - w / 2) ** 2 + (yy - h / 2) ** 2 < (h / 3) ** 2)[None] * 1.5
    return (base + disk + rng.uniform(0, 0.3, (3, h, w))).astype(np.float32)


def _stage(name, lib, img):
    if name == "bloom":
        cfg = jcfg.BloomConfig() if lib is jpost else bhx_torch.BloomConfig()
        return lib.bloom_chain_chw(img, cfg)
    if name == "mix":
        return lib.mix_pass(img, img[:, ::-1] * 0.5, 0.7)
    if name == "tonemap":
        return lib.tonemap_pass(img, channel_major=True)
    cfg = jcfg.FxaaConfig() if lib is jpost else bhx_torch.FxaaConfig()
    return lib.fxaa_pass_chw(lib.tonemap_pass(img, channel_major=True), cfg)


@pytest.mark.parametrize("stage", ["bloom", "mix", "tonemap", "fxaa"])
def test_post_stage_matches(stage):
    img = _chw()
    want = np.asarray(_stage(stage, jpost, jnp.asarray(img)))
    timg = torch.from_numpy(img)
    if stage == "mix":
        got = tpost.mix_pass(timg, torch.flip(timg, [1]) * 0.5, 0.7).numpy()
    else:
        got = _stage(stage, tpost, timg).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_phases_with_no_live_ray_change_nothing():
    """After a trace no ray waits for a straight phase or a march, so the
    re-entry phases, which run without a host-side gate, are identities."""
    scene = _torch_scene()
    cfg = torch_cfg(FAST_CFG)
    o, d = ttracer.camera_rays(scene.camera, 32, 18)
    state = ttracer._init_state(o.reshape(-1, 3), d.reshape(-1, 3))
    state = ttracer._trace_phases(state, scene, cfg, 2)
    state = ttracer._straight_phase(state, scene, cfg)
    state["status"] = torch.where(state["status"] == 1, 2, state["status"]).to(torch.int32)
    assert not bool(((state["status"] == 0) | (state["status"] == 1)).any())
    assert bool((state["count"] > 0).any())  # there are slots to preserve
    _, normal = scene.black_hole.disk_frame()
    params = bhx_torch.kernels.march.pack_params(scene.black_hole, normal, cfg)
    after = ttracer._march_phase(
        ttracer._straight_phase(state, scene, cfg),
        scene.black_hole, params, cfg, first_phase=False,
    )
    assert after.keys() == state.keys()
    for k in state:
        assert torch.equal(after[k], state[k]), k


def test_final_level_march_batch():
    """The final ladder level's first march launch, as the card checks
    build it: the re-trace mask is the active set, and the active lanes
    march exactly what the unmasked batch marches."""
    scene = _torch_scene()
    cfg = torch_cfg(LADDER_CFG)
    lad = cfg.ladder_for_output()
    w, h = lad.resolution(lad.levels - 1)
    mask = final_level_retrace_mask(scene, cfg)
    assert mask.shape == (w * h,) and 0.0 < float(mask.float().mean()) < 1.0
    rays, params, cam = ttracer.march_batch(scene, cfg, w, h, active=mask)
    full, full_params, full_cam = ttracer.march_batch(scene, cfg, w, h)
    assert rays.shape == (10, w * h) and bool((rays[7] > 0.5).any())
    torch.testing.assert_close(rays[7], torch.where(mask, full[7], 0.0), atol=0, rtol=0)
    marching = rays[7] > 0.5
    torch.testing.assert_close(rays[:, marching], full[:, marching], atol=0, rtol=0)
    torch.testing.assert_close(params, full_params, atol=0, rtol=0)
    torch.testing.assert_close(cam, full_cam, atol=0, rtol=0)


@pytest.mark.parametrize("name", ["fast", "ladder_post"])
def test_render_matches_bhx(name):
    got, want = _renders(name)
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.min() >= 0.0
    bad = _bad_frac(got, want)
    assert bad <= 0.02, f"{bad:.2%} pixels differ by more than 2e-2"


def test_render_matches_ladder_post_golden():
    got, _ = _renders("ladder_post")
    path = os.path.join(REPO, "tests", "golden", "ladder_post.npz")
    want = np.load(path)["img"].astype(np.float32)
    bad = _bad_frac(got, want)
    assert bad <= 0.02, f"{bad:.2%} pixels differ by more than 2e-2"


# Each golden of a march branch or a mesh scene the port renders, with its
# gate: RK45 and the mesh scene (the cube, BASELINE config 3) at the port's
# 2% bad-pixel gate, Kerr at 3%, the reference's own allowance for its
# Kerr kernel against its jnp march (tests/test_pallas.py:70-74).
_GOLDEN_GATES = {"rk45_disk_shift": 0.02, "kerr_spin09": 0.03, "mesh_feather": 0.02}


@pytest.mark.parametrize("name", sorted(_GOLDEN_GATES))
def test_render_matches_march_golden(name):
    """``render`` on the CPU against the committed golden of the same scene
    and config (tests/test_golden.py; 64x36, no post, meshes converted
    through ``scene_to_state``), rendered by bhx's jnp march, which
    composites every crossing as it goes."""
    scene, cfg = golden_cases()[name]
    tscene = bhx_torch.scene_from_state(scene_to_state(scene), "cpu")
    got = bhx_torch.render(tscene, torch_cfg(cfg)).numpy()
    want = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))["img"]
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.min() >= 0.0
    bad = _bad_frac(got, want.astype(np.float32))
    assert bad <= _GOLDEN_GATES[name], f"{bad:.2%} pixels differ by more than 2e-2"


def test_config_carries_the_march_fields():
    """torch_cfg brings RK45, Kerr and the controller fields across."""
    _, cfg = golden_cases()["rk45_disk_shift"]
    tcfg = torch_cfg(dataclasses.replace(cfg, rk_rtol=2e-4, rk_h_max=0.5))
    assert tcfg.integrator == bhx_torch.Integrator.RK45
    assert (tcfg.rk_rtol, tcfg.rk_h_max) == (2e-4, 0.5)
    assert ttracer.march_kwargs(tcfg)["integrator"] == "rk45"
    _, kcfg = golden_cases()["kerr_spin09"]
    assert ttracer.march_kwargs(torch_cfg(kcfg))["geodesics"] == "kerr"


def test_import_and_render_pull_in_no_jax():
    code = (
        "import dataclasses, sys, torch, bhx_torch\n"
        "torch.set_num_threads(2)\n"
        "cfg = bhx_torch.RenderConfig(width=32, height=18, use_ladder=False,"
        " max_iterations=200)\n"
        "scene = bhx_torch.Scene.default('cpu')\n"
        "img = bhx_torch.render(scene, cfg)\n"
        "assert tuple(img.shape) == (18, 32, 3), img.shape\n"
        "from tests.torch_mesh_data import cube_arrays, torus_arrays\n"
        "p, n, tri = torus_arrays(16, 16)\n"
        "meshes = (bhx_torch.make_mesh(cube_arrays(), (6.0, 0.0, -30.0), scale=1.0,"
        " flip_y=False, device='cpu'),"
        " bhx_torch.make_mesh((p, n, tri, tri), (-6.0, 0.0, -27.0), leaf_size=2,"
        " device='cpu'))\n"
        "far = dataclasses.replace(scene.camera, position=torch.tensor([0.0, 0.0, -40.0]))\n"
        "with_meshes = dataclasses.replace(scene, camera=far, meshes=meshes)\n"
        "img = bhx_torch.render(with_meshes, cfg)\n"
        "bare = bhx_torch.render(with_meshes, cfg.replace(render_meshes=False))\n"
        "assert float((img - bare).abs().max()) > 0.05\n"
        "kerr = dataclasses.replace(scene, black_hole=dataclasses.replace("
        "scene.black_hole, spin=torch.tensor(0.9)))\n"
        "img = bhx_torch.render(kerr, cfg.replace(geodesics='kerr'))\n"
        "assert tuple(img.shape) == (18, 32, 3) and bool(torch.isfinite(img).all())\n"
        "import bhx_torch.bench\n"
        "from bhx_torch.parallel import fit_scene\n"
        "params, losses = fit_scene(scene, img.detach(), cfg, steps=1)\n"
        "assert set(params) >= {'mass', 'cam_position'} and len(losses) == 1\n"
        "import bhx_torch.geometry.traverse, bhx_torch.geometry.native, bhx_torch.checks\n"
        "import bhx_torch.physics, bhx_torch.entry\n"
        "from bhx_torch.parallel import render_sharded\n"
        "sharded = render_sharded(scene, cfg)\n"
        "assert float((sharded - bhx_torch.render(scene, cfg)).abs().max()) <= 1e-6\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'bhx'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


def test_host_side_and_array_render_pull_in_no_jax():
    """The host-side modules import, and an array-texture frame renders,
    without jax or bhx."""
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(2)\n"
        "import bhx_torch, bhx_torch.io, bhx_torch.cli, bhx_torch.viewer\n"
        "import bhx_torch.profiling, bhx_torch.assets, bhx_torch.entry\n"
        "from bhx_torch import assets\n"
        "scene = bhx_torch.Scene.default('cpu', disk_texture=assets.disk_texture(64),"
        " sky_texture=assets.sky_texture(128, 64), temp_lut=assets.blackbody_lut(64, 16))\n"
        "cfg = bhx_torch.RenderConfig(width=32, height=18, use_ladder=False,"
        " max_iterations=200, texture_mode='array')\n"
        "img = bhx_torch.render(scene, cfg)\n"
        "assert tuple(img.shape) == (18, 32, 3) and bool(torch.isfinite(img).all())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'bhx'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("ok")


@pytest.fixture(scope="module")
def mesh_scenes(tmp_path_factory):
    """(bhx scene, bhx_torch scene): ``small_scene`` from the outside
    camera with the viewer's cube (brute force) and a 2,048-triangle torus
    (BVH) loaded through the port's ``make_mesh`` from an OBJ file; bhx
    gets the same arrays."""
    path = tmp_path_factory.mktemp("obj") / "torus.obj"
    write_obj(path, *torus_arrays(32, 32))
    cube = bhx_torch.make_mesh(cube_arrays(), position=(6.0, 0.0, -30.0), name="cube",
                               scale=1.0, flip_y=False, device="cpu")
    torus = bhx_torch.make_mesh(str(path), position=(-6.0, 0.0, -27.0), name="torus",
                                device="cpu")
    jscene = dataclasses.replace(small_scene(), camera=outside_camera(),
                                 meshes=(jax_mesh(cube), jax_mesh(torus)))
    return jscene, bhx_torch.scene_from_state(scene_to_state(jscene), "cpu")


@pytest.mark.parametrize("name", ["dense", "ladder"])
def test_mesh_render_matches_bhx(mesh_scenes, name):
    """The mesh scene against ``bhx.render`` (fast), dense at 64x36 and on
    the small ladder; the meshes change a fifth of the pixels."""
    jscene, tscene = mesh_scenes
    cfg = {"dense": FAST_CFG, "ladder": LADDER_CFG}[name]
    want = np.asarray(render_jit(jscene, cfg), np.float32)
    got = bhx_torch.render(tscene, torch_cfg(cfg)).numpy()
    bare = bhx_torch.render(tscene, torch_cfg(cfg).replace(render_meshes=False)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = _bad_frac(got, want)
    assert bad <= 0.02, f"{bad:.2%} pixels differ by more than 2e-2"
    assert _bad_frac(got, bare) > 0.1


def _cube_scenes(visible: bool):
    scene = _torch_scene()
    cube = bhx_torch.make_mesh(cube_arrays(), position=(6.0, 0.0, -30.0), name="cube",
                               scale=1.0, flip_y=False, device="cpu")
    cube = dataclasses.replace(cube, visible=torch.tensor(visible))
    far = dataclasses.replace(scene.camera, position=torch.tensor([0.0, 0.0, -40.0]))
    return (dataclasses.replace(scene, camera=far, meshes=(cube,)),
            dataclasses.replace(scene, camera=far))


def test_mesh_visible_outside_sphere():
    """tests/test_tracer.py:107 for the port: a cube outside the sphere,
    seen from outside, shows in the record."""
    with_cube, without = _cube_scenes(True)
    cfg = torch_cfg(FAST_CFG)
    rec_m = bhx_torch.pipeline.trace_image_record_rows(with_cube, cfg, 64, 36)
    rec_n = bhx_torch.pipeline.trace_image_record_rows(without, cfg, 64, 36)
    assert float((rec_m - rec_n)[:3].abs().max()) > 0.05


def test_mesh_invisible_when_visibility_false():
    """tests/test_tracer.py:118 for the port: ``visible=False`` hides it."""
    with_cube, without = _cube_scenes(False)
    cfg = torch_cfg(FAST_CFG)
    rec_m = bhx_torch.pipeline.trace_image_record_rows(with_cube, cfg, 64, 36)
    rec_n = bhx_torch.pipeline.trace_image_record_rows(without, cfg, 64, 36)
    torch.testing.assert_close(rec_m, rec_n, atol=1e-6, rtol=0)


_TOGGLES = {
    "euler_sky": None,  # the golden of BASELINE config 1
    "texture_off": dict(show_disk_texture=False),
    "redshift_off": dict(show_redshift=False),
    "texture_and_redshift_off": dict(show_disk_texture=False, show_redshift=False),
    "sky_off": dict(show_sky=False),
    # The mesh scene: with no disk the transmission is 1 and the mesh color
    # goes in unweighted; with meshes off the straight phases skip them.
    "meshes_disk_off": dict(show_disk=False),
    "meshes_off": dict(render_meshes=False),
}


@pytest.mark.parametrize("name", list(_TOGGLES))
def test_toggles_match_bhx(name, mesh_scenes):
    """Each feature toggle at 64x36 (dense, no post) against bhx's fast
    render of the same scene and config, at the 2% bad-pixel gate; the
    mesh cases on the mesh scene, ``euler_sky`` against its golden."""
    if name == "euler_sky":
        scene, cfg = golden_cases()[name]
        want = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))["img"]
        tscene = bhx_torch.scene_from_state(scene_to_state(scene), "cpu")
    else:
        cfg = dataclasses.replace(FAST_CFG, **_TOGGLES[name])
        scene, tscene = (mesh_scenes if name.startswith("meshes")
                         else (small_scene(), _torch_scene()))
        want = render_jit(scene, cfg)
    got = bhx_torch.render(tscene, torch_cfg(cfg)).numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = _bad_frac(got, want)
    assert bad <= 0.02, f"{bad:.2%} pixels differ by more than 2e-2"
