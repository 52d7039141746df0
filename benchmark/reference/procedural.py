"""Procedural textures: hash-gradient Perlin, the spiral-warped accretion
texel, the blackbody tint polynomial and the star-grid + nebula sky.

The hash is 32-bit unsigned arithmetic, run in int64 with every
intermediate masked to 32 bits: negative lattice coordinates wrap as two's
complement (``& 0xFFFFFFFF``), and each 32x32-bit product is split into
16-bit halves so that no int64 product overflows.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32) without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _rotl16(a: torch.Tensor) -> torch.Tensor:
    return ((a << 16) | (a >> 16)) & _M32


def _hash2(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """2x32-bit integer mix; returns the uint32 hash as int64 in [0, 2^32)."""
    a = ix.to(torch.int64) & _M32
    b = iy.to(torch.int64) & _M32
    a = _mul32(a, 0x9E3779B1)
    b = b ^ _rotl16(a)
    b = _mul32(b, 0x85EBCA77)
    a = a ^ _rotl16(b)
    return _mul32(a, 0xC2B2AE3D)


def hash01(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
    """Uniform [0,1) float32 from the hash's top 24 bits (exact in float32)."""
    h = _hash2(ix, iy) >> 8
    return h.to(torch.int32).to(torch.float32) * (1.0 / 16777216.0)


def _grad(ix: torch.Tensor, iy: torch.Tensor):
    """Unit-ish lattice gradient from two 16-bit slices of the hash."""
    h = _hash2(ix, iy)
    gx = (h & 0xFFFF).to(torch.int32).to(torch.float32) * np.float32(2.0 / 65535.0) - 1.0
    gy = (h >> 16).to(torch.int32).to(torch.float32) * np.float32(2.0 / 65535.0) - 1.0
    inv = torch.rsqrt(gx * gx + gy * gy + 1e-12)
    return gx * inv, gy * inv


def _fade(t):
    return ((t * 6.0 - 15.0) * t + 10.0) * t * t * t


def perlin(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Perlin noise in [0,1] at (x, y)."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    sx = x - x0
    sy = y - y0
    x0i = x0.to(torch.int32)
    y0i = y0.to(torch.int32)

    def grad_dot(ox, oy):
        gx, gy = _grad(x0i + ox, y0i + oy)
        return (sx - ox) * gx + (sy - oy) * gy

    n00 = grad_dot(0, 0)
    n10 = grad_dot(1, 0)
    n01 = grad_dot(0, 1)
    n11 = grad_dot(1, 1)
    u = _fade(sx)
    v = _fade(sy)
    nx0 = n00 + (n10 - n00) * u
    nx1 = n01 + (n11 - n01) * u
    val = nx0 + (nx1 - nx0) * v
    return val * 0.5 + 0.5


# ---------------------------------------------------------------------------
# Accretion-disk texture (4 spiral-warped octaves, perlin/src/main.rs:133-148)
# ---------------------------------------------------------------------------

DISK_DENSITIES = (4.0, 20.0, 50.0, 100.0)
SPIRAL_AMOUNT = 2.0


def disk_texel_m(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Scalar texel value m of the procedural accretion texture at uv."""
    rx = u * 2.0 - 1.0
    ry = v * 2.0 - 1.0
    r2 = rx * rx + ry * ry
    r = torch.sqrt(r2 + 1e-20)
    # Degenerate-center guard: atan2(0, 0) is replaced by atan2(0, 1) (the
    # same forward value) so a later gradient stays finite.
    theta = torch.atan2(ry, torch.where(r2 < 1e-24, 1.0, rx)) \
        + torch.sqrt(r) * (np.pi * SPIRAL_AMOUNT)
    sx = r * torch.cos(theta) * 0.5 + 0.5
    sy = r * torch.sin(theta) * 0.5 + 0.5

    o0 = perlin(sx * DISK_DENSITIES[0], sy * DISK_DENSITIES[0])
    o1 = perlin(sx * DISK_DENSITIES[1] + 31.0, sy * DISK_DENSITIES[1] + 7.0)
    o2 = perlin(sx * DISK_DENSITIES[2] + 101.0, sy * DISK_DENSITIES[2] + 53.0)
    o3 = perlin(sx * DISK_DENSITIES[3] + 211.0, sy * DISK_DENSITIES[3] + 157.0)
    m = 0.5 * o3 + 0.5 * o2
    m = 0.5 * m + 0.5 * o1
    m = 0.5 * m + 0.5 * o0
    return m


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
    """Linear-sRGB chromaticity (max-normalized) of a blackbody at ``temps``
    K: the blackbody tint polynomial (:func:`_tint_coeffs`) is fitted to it."""
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


# ---------------------------------------------------------------------------
# Blackbody tint: polynomial fit of the Planck locus
# ---------------------------------------------------------------------------

TINT_DEG = 10


@functools.lru_cache(maxsize=8)
def _tint_coeffs(temp: float = 15000.0) -> np.ndarray:
    """(3, deg+1) float32 coefficients, highest power first, fitting
    tint(shift) = planck_rgb(temp * max(shift, 1e-3)) * sqrt(shift) on
    [0, 1].  Read-only: the array is shared by every caller."""
    s = np.linspace(0.0, 1.0, 512)
    rgb = planck_rgb(float(temp) * np.maximum(s, 1e-3)) * np.sqrt(s)[:, None]
    coeffs = np.stack(
        [np.polyfit(s, rgb[:, c], TINT_DEG) for c in range(3)]
    ).astype(np.float32)
    coeffs.setflags(write=False)
    return coeffs


def blackbody_tint_channels(shift: torch.Tensor, temp: float = 15000.0):
    """Per-channel (r, g, b) tint by Horner evaluation of the fit."""
    c = _tint_coeffs(temp)
    s = torch.clamp(shift, 0.0, 1.0)
    out = []
    for ch in range(3):
        acc = torch.full_like(s, float(c[ch, 0]))
        for k in range(1, TINT_DEG + 1):
            acc = acc * s + float(c[ch, k])
        out.append(torch.clamp(acc, 0.0, 1.0))
    return tuple(out)


# ---------------------------------------------------------------------------
# Star-grid sky (radiance domain)
# ---------------------------------------------------------------------------

SKY_CELLS_X = 256
SKY_CELLS_Y = 128
SKY_STAR_PROB = 0.22       # per-cell star probability at the equator
SKY_STAR_RADIUS_UV = 0.0024  # splat radius in uv units
NEBULA_TINT = (0.45, 0.35, 0.65)


def sky_radiance_channels(u: torch.Tensor, v: torch.Tensor):
    """HDR sky radiance (r, g, b) at equirect uv in [0,1]^2: a two-octave
    Perlin nebula plus a hash cell grid of stars, each cell's 3x3
    neighbourhood summed with a quadratic splat."""
    neb = (
        perlin(u * 6.0, v * 3.0) * 0.6
        + perlin(u * 24.0 + 91.0, v * 12.0 + 17.0) * 0.4
    )
    neb = torch.clamp(neb - 0.35, min=0.0) * 0.9
    out_r = neb * NEBULA_TINT[0]
    out_g = neb * NEBULA_TINT[1]
    out_b = neb * NEBULA_TINT[2]

    gx = u * SKY_CELLS_X
    gy = v * SKY_CELLS_Y
    cx0 = torch.floor(gx).to(torch.int32)
    cy0 = torch.floor(gy).to(torch.int32)
    inv_r2 = 1.0 / (SKY_STAR_RADIUS_UV * SKY_STAR_RADIUS_UV)

    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            cx = cx0 + ox
            cy = cy0 + oy
            # Wrap in x (CELLS_X is a power of two), clamp rows.
            cxw = cx & (SKY_CELLS_X - 1)
            row_ok = (cy >= 0) & (cy < SKY_CELLS_Y)
            h0 = hash01(cxw * 3 + 1, cy * 7 + 11)
            h1 = hash01(cxw * 5 + 29, cy * 3 + 41)
            h2 = hash01(cxw * 7 + 97, cy * 11 + 61)
            h3 = hash01(cxw * 11 + 13, cy * 13 + 17)
            cell_v = (cy.to(torch.float32) + 0.5) / SKY_CELLS_Y
            sin_t = torch.sin(np.pi * torch.clamp(cell_v, 0.0, 1.0))
            present = (h0 < SKY_STAR_PROB * sin_t) & row_ok
            su = (cx.to(torch.float32) + h1) / SKY_CELLS_X
            sv = (cy.to(torch.float32) + h2) / SKY_CELLS_Y
            du = u - su
            dv = v - sv
            d2 = du * du + dv * dv
            w = torch.clamp(1.0 - d2 * inv_r2, min=0.0)
            w = w * w
            h32 = h3 * h3
            h34 = h32 * h32
            bright = (h34 * h34) * 3.0 + 0.3
            amp = torch.where(present, w * bright, 0.0)
            s_shift = 0.2 + 0.6 * hash01(cxw * 17 + 23, cy * 19 + 5)
            cr, cg, cb = blackbody_tint_channels(s_shift)
            out_r = out_r + amp * cr
            out_g = out_g + amp * cg
            out_b = out_b + amp * cb
    return out_r, out_g, out_b
