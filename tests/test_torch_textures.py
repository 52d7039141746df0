"""Array texture mode of bhx_torch against the JAX reference on the CPU: the
bilinear sample, the sky lookup and the disk shade of ``bhx.shading`` (run
in jnp, as bhx's own tests run them), their gradients with respect to the
three textures against ``jax.grad``, and ``render(texture_mode="array")``
against ``bhx.render`` (``march_mode="fast"``), with and without a mesh.
Inputs come from numpy seeds; bhx's parameters and textures reach the
port through ``scene_from_state(scene_to_state(...))``."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhx.shading as jshade
from bhx.pipeline import render_jit
from bhx.scene import scene_to_state

import bhx_torch
from bhx_torch import shading as tshade

from tests.common import FAST_CFG, outside_camera, small_scene
from tests.test_torch_pipeline import _bad_frac, torch_cfg
from tests.torch_mesh_data import cube_arrays, jax_mesh

torch.set_num_threads(2)

ARRAY_CFG = dataclasses.replace(FAST_CFG, texture_mode="array")


def _t(x):
    return torch.from_numpy(np.array(x))


def _scenes():
    """(bhx small_scene, the port's copy of it on the CPU)."""
    scene = small_scene()
    return scene, bhx_torch.scene_from_state(scene_to_state(scene), "cpu")


@pytest.mark.parametrize("wrap", [False, True])
def test_sample_bilinear_matches_bhx(wrap):
    rng = np.random.default_rng(11)
    tex = rng.uniform(0.0, 1.0, (24, 40, 4)).astype(np.float32)
    # Out of [0, 1] too, so the edges and the wrap are reached.
    u = rng.uniform(-0.2, 1.2, 4000).astype(np.float32)
    v = rng.uniform(-0.2, 1.2, 4000).astype(np.float32)
    got = tshade.sample_bilinear(_t(tex), _t(u), _t(v), wrap=wrap).numpy()
    for fn in (jshade.sample_bilinear, jshade.sample_bilinear_fast):
        want = np.asarray(fn(jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v), wrap=wrap))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _dirs(seed: int, n: int) -> np.ndarray:
    d = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_sample_sky_array_matches_bhx():
    jscene, tscene = _scenes()
    d = _dirs(12, 5000)
    want = np.asarray(jshade.sample_sky(jscene.sky_texture, jnp.asarray(d), "array"))
    got = tshade.sample_sky(tscene.sky_texture, _t(d), "array").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _crossings(seed: int = 13, n: int = 3000):
    """Disk crossings of small_scene's hole: points on the tilted disk plane
    at radii 1.5-11 (inside, across and past the disk), ray directions, the
    cameras' distances; the first 8 points at the origin, as invalid slots
    sit."""
    rng = np.random.default_rng(seed)
    rot, _ = small_scene().black_hole.disk_frame()
    rot = np.asarray(rot)
    r = rng.uniform(1.5, 11.0, n)
    a = rng.uniform(0.0, 2 * np.pi, n)
    local = np.stack([r * np.cos(a), np.zeros(n), r * np.sin(a)], -1)
    hit = (local @ rot.T).astype(np.float32)
    hit[:8] = 0.0
    cam = rng.uniform(15.0, 40.0, n).astype(np.float32)
    return hit, _dirs(seed + 1, n), cam


def _jax_shade(jscene, hit, dirs, cam, tex, lut, show_texture=True, show_redshift=True):
    rot, _ = jscene.black_hole.disk_frame()
    return jshade.disk_shade(jnp.asarray(hit), jnp.asarray(dirs), jnp.asarray(cam),
                             jscene.black_hole, rot, tex, lut, jscene.time,
                             show_texture=show_texture, show_redshift=show_redshift,
                             texture_mode="array")


# Jitted: one compile costs less here than bhx's op-by-op dispatch.
_jax_shade_jit = jax.jit(_jax_shade, static_argnames=("show_texture", "show_redshift"))


def _torch_shade(tscene, hit, dirs, cam, tex, lut, **kw):
    rot, _ = tscene.black_hole.disk_frame()
    return tshade.disk_shade(_t(hit), _t(dirs), _t(cam), tscene.black_hole, rot,
                             tex, lut, tscene.time, **kw)


@pytest.mark.parametrize("show_texture", [True, False])
@pytest.mark.parametrize("show_redshift", [True, False])
def test_disk_shade_array_matches_bhx(show_texture, show_redshift):
    jscene, tscene = _scenes()
    hit, dirs, cam = _crossings()
    kw = dict(show_texture=show_texture, show_redshift=show_redshift)
    rgb_j, op_j = _jax_shade_jit(jscene, hit, dirs, cam, jscene.disk_texture,
                                 jscene.temp_lut, **kw)
    rgb_t, op_t = _torch_shade(tscene, hit, dirs, cam, tscene.disk_texture, tscene.temp_lut,
                               **kw)
    assert np.isfinite(rgb_t.numpy()).all() and np.isfinite(op_t.numpy()).all()
    assert float(op_t.max()) > 0.5  # the disk is dense somewhere
    np.testing.assert_allclose(op_t.numpy(), np.asarray(op_j), atol=1e-5, rtol=0)
    got, want = rgb_t.numpy(), np.asarray(rgb_j)
    if show_redshift:
        # The redshift multiplies by the LUT at a shift that the optical
        # depth (up to ~80) amplifies: ROADMAP C.1's quantile gate.
        err = np.abs(got - want)
        assert np.quantile(err, 0.995) < 1e-4, np.quantile(err, 0.995)
        assert err.max() < 2e-3, err.max()
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_texture_gradients_match_jax_grad():
    """d/d(disk_texture, temp_lut, sky_texture) of a fixed weighted sum of
    the array shade's color and opacity and the sky's radiance."""
    jscene, tscene = _scenes()
    hit, dirs, cam = _crossings(seed=17, n=2000)
    sky_dirs = _dirs(19, 2000)
    rng = np.random.default_rng(21)
    w_rgb = rng.uniform(0.0, 1.0, (2000, 3)).astype(np.float32)
    w_op = rng.uniform(0.0, 1.0, 2000).astype(np.float32)
    w_sky = rng.uniform(0.0, 1.0, (2000, 3)).astype(np.float32)

    def jax_loss(tex, lut, sky):
        rgb, op = _jax_shade(jscene, hit, dirs, cam, tex, lut)
        s = jshade.sample_sky(sky, jnp.asarray(sky_dirs), "array")
        return jnp.sum(rgb * w_rgb) + jnp.sum(op * w_op) + jnp.sum(s * w_sky)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2)))(
        jscene.disk_texture, jscene.temp_lut, jscene.sky_texture)

    leaves = [t.clone().requires_grad_()
              for t in (tscene.disk_texture, tscene.temp_lut, tscene.sky_texture)]
    rgb, op = _torch_shade(tscene, hit, dirs, cam, leaves[0], leaves[1])
    s = tshade.sample_sky(leaves[2], _t(sky_dirs), "array")
    loss = (rgb * _t(w_rgb)).sum() + (op * _t(w_op)).sum() + (s * _t(w_sky)).sum()
    got = torch.autograd.grad(loss, leaves)
    # rtol 1e-4, with a floor of 1e-5 of the largest entry: a texel's
    # cotangent sums its samples' weights in another order in each package,
    # and a few small entries cancel (~1e-5 of the largest apart).
    for name, g, w in zip(("disk_texture", "temp_lut", "sky_texture"), got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0.0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


@pytest.fixture(scope="module")
def mesh_scenes():
    """small_scene seen from outside the relativity sphere with the viewer's
    cube: (bhx scene, the port's)."""
    cube = bhx_torch.make_mesh(cube_arrays(), position=(6.0, 0.0, -30.0), name="cube",
                               scale=1.0, flip_y=False, device="cpu")
    jscene = dataclasses.replace(small_scene(), camera=outside_camera(),
                                 meshes=(jax_mesh(cube),))
    return jscene, bhx_torch.scene_from_state(scene_to_state(jscene), "cpu")


@pytest.mark.parametrize("name", ["euler", "euler_mesh"])
def test_array_render_matches_bhx(name, mesh_scenes):
    jscene, tscene = mesh_scenes if name == "euler_mesh" else _scenes()
    want = np.asarray(render_jit(jscene, ARRAY_CFG), np.float32)
    got = bhx_torch.render(tscene, torch_cfg(ARRAY_CFG)).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = _bad_frac(got, want)
    assert bad <= 0.02, f"{bad:.2%} pixels differ by more than 2e-2"
    # The array textures are what the frame shows: the procedural render of
    # the same scene differs (bilinear resampling of a 64-texel disk).
    procedural = bhx_torch.render(tscene, torch_cfg(FAST_CFG)).numpy()
    assert _bad_frac(got, procedural) > 0.01


def test_array_render_gradient_reaches_textures():
    """render's gradient reaches every texture in array mode; procedural
    mode reads none of them (there the disk_gain grid carries the disk
    content)."""
    _, tscene = _scenes()
    cfg = torch_cfg(ARRAY_CFG).replace(width=32, height=18)
    names = ("disk_texture", "sky_texture", "temp_lut")
    leaves = {n: getattr(tscene, n).clone().requires_grad_() for n in names}
    scene = dataclasses.replace(tscene, **leaves)
    img = bhx_torch.render(scene, cfg)
    for n, g in zip(names, torch.autograd.grad(img.sum(), list(leaves.values()))):
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0.0, n
    assert not bhx_torch.render(scene, cfg.replace(texture_mode="procedural")).requires_grad
