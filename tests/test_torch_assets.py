"""The port's baked array textures (``bhx_torch.assets``) against ``bhx.assets``
on the CPU, ``tests/test_assets.py``'s checks on the port's bakes, and where
the bakes are cached."""

from __future__ import annotations

import os

import numpy as np
import torch

from bhx import assets as jassets

from bhx_torch import assets as tassets
from bhx_torch.kernels.build import BUILD_DIR

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _quantile_gate(got, want):
    # The procedural tests' gate: octave-100 Perlin cells and star splats
    # turn a last-bit difference of sin/cos/atan2 into a step on a few texels.
    err = np.abs(np.asarray(got) - np.asarray(want))
    assert np.isfinite(np.asarray(got)).all()
    assert np.quantile(err, 0.995) < 1e-4, np.quantile(err, 0.995)
    assert err.max() < 2e-2, err.max()


def test_disk_texture_matches_bhx():
    got, want = tassets.disk_texture(64), jassets.disk_texture(64)
    assert got.shape == want.shape == (64, 64, 4) and got.dtype == np.float32
    _quantile_gate(got, want)


def test_sky_texture_matches_bhx():
    got, want = tassets.sky_texture(128, 64), jassets.sky_texture(128, 64, num_stars=200)
    assert got.shape == want.shape == (64, 128, 3) and got.dtype == np.float32
    _quantile_gate(got, want)


def test_blackbody_lut_matches_bhx():
    got, want = tassets.blackbody_lut(64, 16), jassets.blackbody_lut(64, 16)
    assert got.shape == (16, 64, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# tests/test_assets.py's four checks, on the port's bakes.

def test_perlin_deterministic_and_bounded():
    xs, ys = np.meshgrid(np.linspace(0, 7, 64), np.linspace(0, 7, 64))
    a = tassets.perlin(xs, ys)
    b = tassets.perlin(xs, ys)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0.0 and a.max() <= 1.0
    assert a.std() > 0.05


def test_disk_texture_shape_and_determinism():
    a = tassets.disk_texture(64)
    b = tassets.disk_texture(64)
    assert a.shape == (64, 64, 4)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float32
    assert 0.0 <= a.min() and a.max() <= 1.0


def test_blackbody_lut_physical_ordering():
    lut = tassets.blackbody_lut(64, 16)
    assert lut.shape == (16, 64, 3)
    # At full shift (x=1) the hot blackbody is bluish white: b >= r.
    hot = lut[0, -1]
    assert hot[2] >= hot[0] - 0.05
    # Strongly redshifted (bottom row, T=1e4 K; x=4/64, ~700 K): dim and red.
    cold = lut[-1, 4]
    hot_row = lut[-1, -1]
    assert cold[0] >= cold[2]
    assert cold.sum() < hot_row.sum()


def test_sky_texture_stars_present():
    sky = tassets.sky_texture(128, 64, num_stars=200)
    assert sky.shape == (64, 128, 3)
    assert sky.max() <= 1.0 and sky.min() >= 0.0
    # Stored ^(1/4); the rendered sky is sky^4 (sky.wgsl:25), where only
    # the stars stay bright.
    rendered = sky ** 4
    bright = (rendered.max(-1) > 0.5).mean()
    assert 0.0005 < bright < 0.1
    assert rendered.mean() < 0.2


def _tree(root):
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, _, files in os.walk(root) for f in files}


def test_bake_writes_under_build_only(tmp_path, monkeypatch):
    """The default cache lies in the repository's build directory, not in a
    package, and a bake writes its cache file there and nothing under bhx/
    or bhx_torch/."""
    assert tassets.CACHE_DIR.parent == BUILD_DIR
    assert os.path.relpath(tassets.CACHE_DIR, REPO).split(os.sep)[0] == "build"
    monkeypatch.setattr(tassets, "CACHE_DIR", tmp_path / "assets")
    before = {p: _tree(os.path.join(REPO, p)) for p in ("bhx", "bhx_torch")}
    a = tassets.disk_texture(24)
    assert os.listdir(tmp_path / "assets") == ["disk_v2_24.npz"]
    np.testing.assert_array_equal(tassets.disk_texture(24), a)  # read back
    after = {p: _tree(os.path.join(REPO, p)) for p in ("bhx", "bhx_torch")}
    for p in before:
        assert {k: v for k, v in after[p].items() if "__pycache__" not in k} == \
            {k: v for k, v in before[p].items() if "__pycache__" not in k}, p


def test_default_textures_once_per_device():
    """Scene.default leaves the textures unset; the array path's resolution
    bakes and uploads them once per device."""
    import bhx_torch
    from bhx_torch.scene import TEXTURE_FIELDS, texture

    scene = bhx_torch.Scene.default("cpu")
    assert all(getattr(scene, n) is None for n in TEXTURE_FIELDS)
    got = [texture(scene, n) for n in TEXTURE_FIELDS]
    assert [tuple(t.shape) for t in got] == [(512, 512, 4), (1024, 2048, 3), (64, 256, 3)]
    again = [texture(bhx_torch.Scene.default("cpu"), n) for n in TEXTURE_FIELDS]
    assert all(a is b for a, b in zip(got, again))
