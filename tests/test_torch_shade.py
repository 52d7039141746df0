"""The plain torch disk composite, slot ingredients and sky finalize
against the JAX reference's jnp mirrors ``_composite_jnp``,
``_ingredients_jnp``, ``_sky_rows_jnp`` and ``_sky_finalize_jnp`` on the
CPU (the Pallas kernels' polynomial atan2 is not what the port computes,
so the mirrors are the reference)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhx.kernels.shade_pallas as jshade
from bhx.kernels.shade_pallas import (
    ShadeKernelConfig, SkyKernelConfig, _composite_jnp, _ingredients_jnp,
    _sky_finalize_jnp, _sky_rows_jnp, pack_shade_params as jax_pack_shade_params,
)

import bhx_torch
from bhx_torch.kernels import shade as tshade
from bhx_torch.kernels import sky as tsky

from tests.common import small_scene

torch.set_num_threads(2)


def _slots(n: int = 600, k: int = 4, seed: int = 0):
    """Random crossing slots (as tests/test_pallas.py builds them): K*7
    rows hx hy hz dx dy dz valid, and camera distances."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-9, 9, (k, 3, n)).astype(np.float32)
    dirs = rng.normal(size=(k, 3, n)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    valid = (rng.uniform(size=(k, n)) < 0.5).astype(np.float32)
    slots = np.concatenate([pos, dirs, valid[:, None, :]], axis=1).reshape(k * 7, n)
    cam = rng.uniform(15, 25, (n,)).astype(np.float32)
    return slots, cam


def _params():
    scene = small_scene()
    rot, _ = scene.black_hole.disk_frame()
    return np.array(jax_pack_shade_params(scene.black_hole, rot, jnp.float32(0.7)))


@pytest.mark.parametrize("show_texture", [True, False])
@pytest.mark.parametrize("show_redshift", [True, False])
def test_composite_matches_jnp(show_texture, show_redshift):
    slots, cam = _slots()
    params = _params()
    gain = np.random.default_rng(1).uniform(0.3, 1.7, (16, 16, 4)).astype(np.float32)
    kcfg = ShadeKernelConfig(max_crossings=4, show_texture=show_texture,
                             show_redshift=show_redshift)
    want = np.stack([np.asarray(r) for r in _composite_jnp(
        tuple(jnp.asarray(r) for r in slots), jnp.asarray(cam),
        jnp.asarray(params), jnp.asarray(gain), kcfg)])
    got = tshade.composite_torch(
        torch.from_numpy(slots), torch.from_numpy(cam), torch.from_numpy(params),
        torch.from_numpy(gain), show_texture=show_texture,
        show_redshift=show_redshift,
    ).numpy()
    assert got.shape == (4, slots.shape[1])
    assert np.isfinite(got).all()
    assert (want[3] < 0.999).mean() > 0.3  # many rays composite something
    if not show_redshift:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        return
    # The reference's degree-10 tint polynomial has coefficients up to
    # 1.7e4, so its float32 Horner sum carries ~1e-3 of rounding noise near
    # shift = 1: one ulp of shift (jnp's approximate rsqrt against torch's)
    # moves the tint by up to 3e-4 (ROADMAP section C).  Every other output
    # holds 1e-4, and the shift itself holds 1e-5 (test_slot_shift_matches_jnp).
    err = np.abs(got - want)
    assert np.quantile(err, 0.995) < 1e-4, np.quantile(err, 0.995)
    assert err.max() < 2e-3, err.max()


def test_slot_shift_matches_jnp(monkeypatch):
    """The Doppler x gravitational shift of every slot against the
    reference's at 1e-5, so that only the tint polynomial runs under the
    redshift cases' looser gate above.  With the tint stubbed out to pass
    its argument through in both packages, the tint rows carry shift^2."""
    def passthrough(s, xp=None):
        return s, s, s

    monkeypatch.setattr(jshade, "blackbody_tint_channels", passthrough)
    monkeypatch.setattr(tshade, "blackbody_tint_channels", passthrough)
    slots, cam = _slots()
    params = _params()
    kcfg = ShadeKernelConfig(max_crossings=4, show_texture=False, show_redshift=True)
    p_jax = {name: jnp.asarray(params)[i] for name, i in jshade._SP.items()}
    p_torch = {name: torch.from_numpy(params)[i] for name, i in tshade._SP.items()}
    for k in range(4):
        hx, hy, hz, dx, dy, dz = slots[k * 7:k * 7 + 6]
        want = np.asarray(jshade._slot_ingredients(
            *(jnp.asarray(r) for r in (hx, hy, hz, dx, dy, dz)), jnp.asarray(cam),
            p_jax, kcfg)[2])
        got = tshade._slot_ingredients(
            *(torch.from_numpy(r) for r in (hx, hy, hz, dx, dz, cam)), p_torch,
            False, True)[2].numpy()
        assert ((want > 0.05) & (want < 0.95)).mean() > 0.5  # not clamped
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_pack_shade_params_matches_bhx():
    ts = bhx_torch.Scene.default("cpu")
    rot, _ = ts.black_hole.disk_frame()
    got = tshade.pack_shade_params(ts.black_hole, rot, torch.tensor(0.7)).numpy()
    np.testing.assert_allclose(got, _params(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("show_texture", [True, False])
@pytest.mark.parametrize("show_redshift", [True, False])
def test_ingredients_match_jnp(show_texture, show_redshift):
    """Every slot's 7 ingredient rows, on the valid slots (as
    tests/test_pallas.py:115-119 compares them) and the invalid ones alike:
    the plain version shades every slot, as ``_ingredients_jnp`` does."""
    slots, cam = _slots()
    params = _params()
    kcfg = ShadeKernelConfig(max_crossings=4, show_texture=show_texture,
                             show_redshift=show_redshift)
    want = np.stack([np.asarray(r) for r in _ingredients_jnp(
        tuple(jnp.asarray(r) for r in slots), jnp.asarray(cam), jnp.asarray(params),
        kcfg)])
    got = tshade.ingredients_torch(
        torch.from_numpy(slots), torch.from_numpy(cam), torch.from_numpy(params),
        show_texture=show_texture, show_redshift=show_redshift,
    ).numpy()
    assert got.shape == want.shape == (4 * tshade.ING_FIELDS, slots.shape[1])
    assert np.isfinite(got).all()
    got, want = got.reshape(4, 7, -1), want.reshape(4, 7, -1)
    valid = np.broadcast_to((slots.reshape(4, 7, -1)[:, 6] > 0.5)[:, None], got.shape)
    assert (want[:, 0][valid[:, 0]] > 0.0).mean() > 0.3  # optical depth present
    # od, m, u, v at 1e-4; the tint rows at the reference's own gate for
    # this kernel (tests/test_pallas.py:119), since its tint polynomial
    # carries ~1e-3 of float32 rounding noise (ROADMAP section C).
    plain = [0, 1, 5, 6]
    np.testing.assert_allclose(got[:, plain], want[:, plain], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[:, 2:5], want[:, 2:5], atol=2e-3, rtol=1e-3)


def _record(n: int = 600, seed: int = 2):
    rng = np.random.default_rng(seed)
    rec = rng.uniform(0, 1, (8, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    rec[5:8] = d / np.linalg.norm(d, axis=0, keepdims=True)
    rec[4, :50] = 0.0005  # below the sky weight threshold
    return rec


@pytest.mark.parametrize("show_sky", [True, False])
def test_sky_rows_match_jnp(show_sky):
    rec = _record()
    want = np.stack([np.asarray(r) for r in _sky_rows_jnp(
        tuple(jnp.asarray(r) for r in rec), SkyKernelConfig(show_sky=show_sky))])
    got = tsky.sky_rows_torch(torch.from_numpy(rec), show_sky).numpy()
    assert got.shape == (3, rec.shape[1])
    assert np.isfinite(got).all()
    if not show_sky:
        np.testing.assert_array_equal(got, rec[:3])
        return
    np.testing.assert_array_equal(got[:, :50], rec[:3, :50])
    # A star splat's edge moves with the last bit of the uv mapping, so the
    # gate is a quantile plus a loose maximum (tests/test_pallas.py:143-145).
    err = np.abs(got - want)
    assert np.quantile(err, 0.995) < 2e-3
    assert err.max() < 0.2


@pytest.mark.parametrize("show_sky", [True, False])
def test_sky_finalize_matches_jnp(show_sky):
    """The interleaved (N, 8) record, at tests/test_pallas.py:137-145's
    tolerances; the same numbers as the rows version, transposed."""
    rec = np.ascontiguousarray(_record().T.reshape(20, 30, 8))
    want = np.asarray(_sky_finalize_jnp(jnp.asarray(rec), SkyKernelConfig(show_sky=show_sky)))
    got = tsky.sky_finalize_torch(torch.from_numpy(rec), show_sky).numpy()
    assert got.shape == want.shape == (20, 30, 3)
    assert np.isfinite(got).all()
    rows = tsky.sky_rows_torch(torch.from_numpy(_record()), show_sky).numpy()
    np.testing.assert_array_equal(got.reshape(-1, 3), rows.T)
    if not show_sky:
        np.testing.assert_array_equal(got, rec[..., :3])
        return
    err = np.abs(got - want)
    assert np.quantile(err, 0.995) < 2e-3
    assert err.max() < 0.2

