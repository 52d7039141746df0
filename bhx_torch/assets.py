"""Baked array textures: the accretion-disk texture, the star sky and the
blackbody LUT (counterpart of ``bhx/assets/__init__.py``).

Each bake evaluates the port's own procedural samplers
(:mod:`bhx_torch.procedural`) on the CPU in float32 at texel centers, so
``texture_mode="array"`` agrees with the procedural mode up to bilinear
resampling.  The blackbody LUT is float64 numpy, as in ``bhx``.  Bakes are
cached as ``.npz`` under ``build/bhx_torch/assets/`` at the repository
root (the build directory of ``bhx_torch.kernels.build``); nothing is
written beside the package.  :func:`default_textures` uploads the three
default bakes once per device, for scenes that leave a texture unset.
"""

from __future__ import annotations

import functools
import os
import shutil
import zipfile
from typing import Dict

import numpy as np
import torch

from bhx_torch.kernels.build import BUILD_DIR

CACHE_DIR = BUILD_DIR / "assets"

# Rows of the sky baked at a time: bounds the bake's host memory.
_BAKE_ROWS = 256


def _cached(name: str, fn) -> np.ndarray:
    """The array cached as ``name``, or ``fn()`` baked and cached (written
    to a temporary file, then renamed, so a concurrent reader never sees
    half a file)."""
    path = CACHE_DIR / f"{name}.npz"
    if path.exists():
        try:
            with np.load(path) as z:
                return z["data"]
        except (OSError, ValueError, KeyError, zipfile.BadZipFile):
            pass  # a damaged cache file is baked again
    data = fn()
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{name}.{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        np.savez_compressed(f, data=data)
    os.replace(tmp, path)
    return data


def _uv(width: int, height: int):
    """float32 texel-center coordinates, (height, width) each."""
    us = torch.from_numpy((np.arange(width, dtype=np.float32) + 0.5) / width)
    vs = torch.from_numpy((np.arange(height, dtype=np.float32) + 0.5) / height)
    v, u = torch.meshgrid(vs, us, indexing="ij")
    return u, v


def perlin(x, y) -> np.ndarray:
    """Perlin noise in [0, 1] (the sampler the renderer evaluates per sample
    in procedural mode), numpy in and out."""
    from bhx_torch import procedural

    x = torch.from_numpy(np.asarray(x, np.float32))
    y = torch.from_numpy(np.asarray(y, np.float32))
    return procedural.perlin(x, y).numpy()


def disk_texture(size: int = 512) -> np.ndarray:
    """Accretion disk RGBA texture in [0, 1], (size, size, 4) float32: the
    procedural texel at texel centers (perlin/src/main.rs:133-148, four
    spiral-warped octaves)."""

    def gen():
        from bhx_torch import procedural

        m = procedural.disk_texel_m(*_uv(size, size))
        return torch.stack([m, m, m, m], dim=-1).numpy()

    return _cached(f"disk_v2_{size}", gen)


def _cie_xyz_bar(lam_nm: np.ndarray):
    """Wyman/Sloan/Shirley multi-lobe Gaussian fits of the CIE 1931 observer."""

    def g(x, mu, s1, s2):
        s = np.where(x < mu, s1, s2)
        return np.exp(-0.5 * ((x - mu) / s) ** 2)

    x = (
        1.056 * g(lam_nm, 599.8, 37.9, 31.0)
        + 0.362 * g(lam_nm, 442.0, 16.0, 26.7)
        - 0.065 * g(lam_nm, 501.1, 20.4, 26.2)
    )
    y = 0.821 * g(lam_nm, 568.8, 46.9, 40.5) + 0.286 * g(lam_nm, 530.9, 16.3, 31.1)
    z = 1.217 * g(lam_nm, 437.0, 11.8, 36.0) + 0.681 * g(lam_nm, 459.0, 26.0, 13.8)
    return x, y, z


def planck_rgb(temps: np.ndarray) -> np.ndarray:
    """Linear-sRGB chromaticity (max-normalized) of a blackbody at ``temps`` K.

    Verbatim copy of ``bhx/assets/__init__.py:79-119``: the blackbody tint
    polynomial (:func:`bhx_torch.procedural._tint_coeffs`) is fitted to it."""
    lam = np.linspace(380.0, 780.0, 81)  # nm
    lam_m = lam * 1e-9
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    t = np.asarray(temps, np.float64)[..., None]
    # Spectral radiance (arbitrary scale).
    expo = np.clip(h * c / (lam_m * kb * np.maximum(t, 1.0)), 1e-6, 700.0)
    rad = 1.0 / (lam_m ** 5 * np.expm1(expo))
    xb, yb, zb = _cie_xyz_bar(lam)
    X = np.trapezoid(rad * xb, lam, axis=-1)
    Y = np.trapezoid(rad * yb, lam, axis=-1)
    Z = np.trapezoid(rad * zb, lam, axis=-1)
    xyz = np.stack([X, Y, Z], axis=-1)
    xyz /= np.maximum(xyz.sum(axis=-1, keepdims=True), 1e-12)
    m = np.array(
        [
            [3.2406, -1.5372, -0.4986],
            [-0.9689, 1.8758, 0.0415],
            [0.0557, -0.2040, 1.0570],
        ]
    )
    rgb = xyz @ m.T
    rgb = np.clip(rgb, 0.0, None)
    rgb /= np.maximum(rgb.max(axis=-1, keepdims=True), 1e-12)
    return rgb


def blackbody_lut(width: int = 256, height: int = 64) -> np.ndarray:
    """Colour-temperature LUT, (height, width, 3) float32.

    x in [0, 1] is the total shift factor (1 = unshifted); y picks the
    emitter temperature in [1e4, 1e5] K with y = 0 at 1e5 K (ray.wgsl:644-647).
    The chromaticity is baked at T * shift and dimmed by sqrt(shift)."""

    def gen():
        xs = (np.arange(width) + 0.5) / width
        ys = (np.arange(height) + 0.5) / height
        temp = 1e5 - ys * (1e5 - 1e4)  # y=0 -> Tmax
        t_eff = temp[:, None] * np.maximum(xs[None, :], 1e-3)
        rgb = planck_rgb(t_eff.reshape(-1)).reshape(height, width, 3)
        dim = np.clip(xs[None, :, None] ** 0.5, 0.0, 1.0)
        return (rgb * dim).astype(np.float32)

    return _cached(f"blackbody_{width}x{height}", gen)


def sky_texture(width: int = 2048, height: int = 1024, num_stars: int = 6000,
                seed: int = 7) -> np.ndarray:
    """Equirect star-field + nebula texture, (height, width, 3) float32.

    The procedural sky radiance (cell-hash star grid + Perlin nebula) at
    texel centers, stored as radiance^(1/4) because the renderer applies
    the reference's ``sky^4`` transfer (sky.wgsl:25).  ``num_stars`` and
    ``seed`` are ``bhx``'s legacy arguments: the grid hash fixes the stars,
    so they change nothing."""

    def gen():
        from bhx_torch import procedural

        u, v = _uv(width, height)
        bands = []
        for r0 in range(0, height, _BAKE_ROWS):
            rad = torch.stack(procedural.sky_radiance_channels(
                u[r0:r0 + _BAKE_ROWS], v[r0:r0 + _BAKE_ROWS]), dim=-1)
            img = torch.clamp(rad, 0.0, 4.0) ** 0.25
            bands.append(torch.clamp(img, 0.0, 1.0).numpy())
        return np.concatenate(bands)

    return _cached(f"sky_v2_{width}x{height}", gen)


def clear_cache() -> None:
    """Remove every cached bake."""
    if CACHE_DIR.is_dir():
        shutil.rmtree(CACHE_DIR)


@functools.lru_cache(maxsize=None)
def default_textures(device: torch.device) -> Dict[str, torch.Tensor]:
    """The default bakes at full size (``bhx.Scene.default``'s: disk 512,
    sky 2048x1024, LUT 256x64) as float32 tensors on ``device``, under the
    scene's field names; baked (or read from the cache) and uploaded once
    per device.  Shared between callers: never write to them."""
    return dict(
        disk_texture=torch.from_numpy(disk_texture()).to(device),
        sky_texture=torch.from_numpy(sky_texture()).to(device),
        temp_lut=torch.from_numpy(blackbody_lut()).to(device),
    )
