"""bhx_torch procedural math, shading helpers, config and scene against the
JAX reference ``bhx`` on the CPU.  Inputs come from numpy seeds and go
through both packages."""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhx.config as jcfg
import bhx.procedural as jproc
import bhx.shading as jshade
from bhx.scene import scene_to_state

import bhx_torch
from bhx_torch import procedural as tproc
from bhx_torch import shading as tshade

from tests.common import small_scene

torch.set_num_threads(2)


def _t(x):
    return torch.from_numpy(np.array(x))


def _lattice(seed: int, n: int = 4096):
    """int32 lattice coordinates, negatives and both extremes included."""
    rng = np.random.default_rng(seed)
    ix = rng.integers(-(2 ** 31), 2 ** 31, n, dtype=np.int64).astype(np.int32)
    iy = rng.integers(-300, 300, n).astype(np.int32)
    ix[:4] = [0, -1, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    return ix, iy


def test_hash_bit_equal_to_numpy_path():
    ix, iy = _lattice(0)
    want = jproc._hash2(ix, iy, xp=np).astype(np.int64)
    got = tproc._hash2(_t(ix), _t(iy)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tproc.hash01(_t(ix), _t(iy)).numpy(), jproc.hash01(ix, iy, xp=np)
    )
    for g, w in zip(tproc._grad(_t(ix), _t(iy)), jproc._grad(ix, iy, xp=np)):
        np.testing.assert_array_equal(g.numpy(), w)


def test_tint_coeffs_bit_equal():
    np.testing.assert_array_equal(tproc._tint_coeffs(), jproc._tint_coeffs())


def test_perlin_matches_jnp():
    rng = np.random.default_rng(1)
    x = rng.uniform(-50.0, 150.0, 20000).astype(np.float32)
    y = rng.uniform(-50.0, 150.0, 20000).astype(np.float32)
    want = np.asarray(jproc.perlin(jnp.asarray(x), jnp.asarray(y)))
    got = tproc.perlin(_t(x), _t(y)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_tint_matches_jnp():
    s = np.random.default_rng(2).uniform(-0.2, 1.2, 20000).astype(np.float32)
    want = jproc.blackbody_tint_channels(jnp.asarray(s))
    for g, w in zip(tproc.blackbody_tint_channels(_t(s)), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5, rtol=0)


def _quantile_gate(got, want):
    # Star splats and octave-100 Perlin cells turn a last-bit difference in
    # sin/cos/atan2 into a visible step on a few samples.
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.isfinite(np.asarray(got)).all()
    assert np.quantile(err, 0.995) < 1e-4, np.quantile(err, 0.995)
    assert err.max() < 2e-2, err.max()


def test_disk_texel_matches_jnp():
    rng = np.random.default_rng(3)
    u = rng.uniform(0.0, 1.0, 20000).astype(np.float32)
    v = rng.uniform(0.0, 1.0, 20000).astype(np.float32)
    u[0] = v[0] = 0.5  # the degenerate center
    want = jproc.disk_texel_m(jnp.asarray(u), jnp.asarray(v))
    _quantile_gate(tproc.disk_texel_m(_t(u), _t(v)).numpy(), want)


def test_sky_radiance_matches_jnp():
    rng = np.random.default_rng(4)
    u = rng.uniform(0.0, 1.0, 20000).astype(np.float32)
    v = rng.uniform(0.0, 1.0, 20000).astype(np.float32)
    want = jproc.sky_radiance_channels(jnp.asarray(u), jnp.asarray(v))
    got = tproc.sky_radiance_channels(_t(u), _t(v))
    _quantile_gate(np.stack([g.numpy() for g in got]),
                   np.stack([np.asarray(w) for w in want]))


def test_sky_uv_matches_jnp():
    d = np.random.default_rng(5).normal(size=(20000, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = jshade.sky_uv(jnp.asarray(d))
    got = tshade.sky_uv(*_t(d).unbind(-1))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_aces_matches_jnp():
    x = np.random.default_rng(6).uniform(0.0, 4.0, (3, 40, 30)).astype(np.float32)
    want = jshade.aces_tonemap(jnp.asarray(x), channel_major=True)
    got = tshade.aces_tonemap(_t(x), channel_major=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_gain_sample_matches_hat_basis():
    rng = np.random.default_rng(7)
    grid = rng.uniform(0.5, 1.5, (16, 16, 4)).astype(np.float32)
    u = rng.uniform(-0.1, 1.1, 5000).astype(np.float32)
    v = rng.uniform(-0.1, 1.1, 5000).astype(np.float32)
    want = np.asarray(jshade.sample_grid_mxu(jnp.asarray(grid), jnp.asarray(u),
                                             jnp.asarray(v)))
    got = torch.stack(tshade.sample_gain(_t(grid), _t(u), _t(v)), -1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_scene_from_state_matches_bhx():
    scene = small_scene()
    ts = bhx_torch.scene_from_state(scene_to_state(scene), "cpu")
    for part, tpart in ((scene.camera, ts.camera), (scene.black_hole, ts.black_hole)):
        for f in dataclasses.fields(tpart):
            np.testing.assert_array_equal(
                getattr(tpart, f.name).numpy(), np.asarray(getattr(part, f.name))
            )
    np.testing.assert_array_equal(ts.disk_gain.numpy(), np.asarray(scene.disk_gain))
    rot_j, up_j = scene.black_hole.disk_frame()
    rot_t, up_t = ts.black_hole.disk_frame()
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), atol=1e-6, rtol=0)
    np.testing.assert_allclose(up_t.numpy(), np.asarray(up_j), atol=1e-6, rtol=0)
    # Scene.default agrees with the reference's defaults.
    d = bhx_torch.Scene.default("cpu")
    np.testing.assert_array_equal(d.black_hole.disk_rotation.numpy(),
                                  np.asarray(scene.black_hole.disk_rotation))
    np.testing.assert_array_equal(d.camera.position.numpy(),
                                  np.asarray(scene.camera.position))


def test_scene_constructors_need_the_card_unless_asked_for_the_cpu(monkeypatch):
    """With no device the constructors put the scene on the CUDA card, and
    raise, naming the missing card, where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    state = scene_to_state(small_scene())
    for make in (bhx_torch.Scene.default, bhx_torch.Camera.default,
                 bhx_torch.BlackHole.default, lambda: bhx_torch.scene_from_state(state)):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bhx_torch.Scene.default("cuda")
    assert bhx_torch.Scene.default("cpu").camera.position.device.type == "cpu"


def test_scene_default_cpu_matches_bhx():
    """``Scene.default("cpu")``: every leaf equals bhx's default scene."""
    from bhx.scene import Scene as JaxScene

    want = JaxScene.default()
    got = bhx_torch.Scene.default("cpu")
    for part, tpart in ((want.camera, got.camera), (want.black_hole, got.black_hole)):
        for f in dataclasses.fields(tpart):
            t = getattr(tpart, f.name)
            assert t.device.type == "cpu" and t.dtype == torch.float32, f.name
            np.testing.assert_array_equal(t.numpy(), np.asarray(getattr(part, f.name)),
                                          err_msg=f.name)
    np.testing.assert_array_equal(got.time.numpy(), np.asarray(want.time))
    np.testing.assert_array_equal(got.disk_gain.numpy(), np.asarray(want.disk_gain))


def test_scene_with_meshes_raises():
    """Meshes are ported; a mesh state without its other fields is refused,
    naming them."""
    state = scene_to_state(small_scene())
    state["meshes"] = ({"points": np.zeros((3, 3), np.float32)},)
    with pytest.raises(ValueError, match="normals"):
        bhx_torch.scene_from_state(state, "cpu")


@pytest.mark.parametrize("kw, item", [
    (dict(texture_mode="array"), "A13"),
])
def test_config_rejects_unported_modes(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        bhx_torch.RenderConfig(**kw)


def test_config_rejects_unknown_geodesics():
    with pytest.raises(ValueError, match="geodesics"):
        bhx_torch.RenderConfig(geodesics="bogus")
    for ok in (dict(integrator=bhx_torch.Integrator.RK45), dict(geodesics="kerr")):
        bhx_torch.RenderConfig(**ok)


def test_ladder_matches_bhx():
    for w, h in ((1918, 1081), (85, 49), (640, 360)):
        lt = bhx_torch.LadderConfig.for_resolution(w, h)
        lj = jcfg.LadderConfig.for_resolution(w, h)
        assert (lt.base, lt.levels, lt.multiplier) == (lj.base, lj.levels, lj.multiplier)
        assert lt.final_resolution == lj.final_resolution
    assert bhx_torch.RenderConfig().ladder_for_output().final_resolution == (1918, 1081)
