"""Analytic Planck -> CIE -> sRGB chromaticity (host numpy).

Verbatim copy of ``bhx/assets/__init__.py:79-119``: the blackbody tint
polynomial (:func:`bhx_torch.procedural._tint_coeffs`) is fitted to it.
"""

from __future__ import annotations

import numpy as np


# Wyman/Sloan/Shirley multi-lobe Gaussian fits of the CIE 1931 observer.
def _cie_xyz_bar(lam_nm: np.ndarray):
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
    """Linear-sRGB chromaticity (max-normalized) of a blackbody at ``temps`` K."""
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
