"""Exact Kerr null geodesics (counterpart of ``bhx/kerr.py``).

The super-Hamiltonian in Kerr-Schild Cartesian coordinates, with the
conserved energy p_t = -1 folded in:

    H(x, p) = 1/2 (|p|^2 - 1 - f (1 + l . p)^2)
    r^2 = ((rho^2 - a^2) + sqrt((rho^2 - a^2)^2 + 4 a^2 z^2)) / 2
    f   = 2 M r^3 / (r^4 + a^2 z^2)
    l   = ((r x + a y) / (r^2 + a^2), (r y - a x) / (r^2 + a^2), z / r)

Hamilton's equations are dx/dlam = p - f (1 + l . p) l and
dp/dlam = -dH/dx.  bhx takes dH/dx with ``jax.vjp``; here it is written
out by hand with the chain rule (:func:`dh_dx`), operation for operation
as ``csrc/march.cu`` computes it, so the march kernel and its plain
version round alike.  The row functions follow the march kernel's
component form (``bhx/kernels/march_substep.py:40-75``).

Spin is dimensionless: the physical spin parameter is a = spin * M.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _scalars(rx, ry, rz, mass, a):
    """(r, f, lx, ly, lz) and the intermediates dH/dx reuses, for
    hole-relative position rows (``march_substep.kerr_scalars``)."""
    a2 = a * a
    rho2 = rx * rx + ry * ry + rz * rz
    b = rho2 - a2
    d = torch.sqrt(b * b + 4.0 * a2 * rz * rz + 1e-20)
    r2_raw = 0.5 * (b + d)
    r2 = torch.clamp(r2_raw, min=1e-12)
    r = torch.sqrt(r2)
    q = r2 * r2 + a2 * rz * rz + 1e-20
    f = 2.0 * mass * r2 * r / q
    den = r2 + a2
    lx = (r * rx + a * ry) / den
    ly = (r * ry - a * rx) / den
    lz = rz / r
    aux = dict(a2=a2, b=b, d=d, free=r2_raw > 1e-12, r2=r2, q=q, den=den)
    return r, f, lx, ly, lz, aux


def scalars_rows(rx, ry, rz, mass, a):
    """(r, f, lx, ly, lz): Kerr-Schild radius, potential and null vector
    of hole-relative position rows; ``a = spin * mass``."""
    return _scalars(rx, ry, rz, mass, a)[:5]


def _dh_component(xi, g_extra, q_extra, ex, ey, ez, rx, ry, qx, qy, qz,
                  mass, r, f, lx, ly, lz, lp, aux):
    """dh/dx_i of h = -0.5 f lp^2, lp = 1 + l . q, by the chain rule
    through :func:`_scalars`.  The Kronecker terms of component i ride in
    ``g_extra`` (4 a^2 z for z), ``q_extra`` (2 a^2 z for z) and
    (``ex``, ``ey``, ``ez``) = d(r x + a y, r y - a x, z)/dx_i without
    their dr terms: (r, -a, 0), (a, r, 0), (0, 0, 1)."""
    dr2 = 0.5 * (2.0 * xi + (2.0 * aux["b"] * xi + g_extra) / aux["d"])
    dr2 = torch.where(aux["free"], dr2, 0.0)
    dr = dr2 / (2.0 * r)
    dq = 2.0 * aux["r2"] * dr2 + q_extra
    df = 2.0 * mass * (dr2 * r + aux["r2"] * dr) / aux["q"] - f * dq / aux["q"]
    den = aux["den"]
    dlx = (dr * rx + ex) / den - lx * dr2 / den
    dly = (dr * ry + ey) / den - ly * dr2 / den
    dlz = ez / r - lz * dr / r
    dlp = dlx * qx + dly * qy + dlz * qz
    return -0.5 * df * lp * lp - f * lp * dlp


def _dh_rows(rx, ry, rz, qx, qy, qz, mass, a, r, f, lx, ly, lz, lp, aux):
    """The three rows of dh/dx from :func:`_scalars`' results and lp."""
    common = (rx, ry, qx, qy, qz, mass, r, f, lx, ly, lz, lp, aux)
    a2 = aux["a2"]
    gx = _dh_component(rx, 0.0, 0.0, r, -a, 0.0, *common)
    gy = _dh_component(ry, 0.0, 0.0, a, r, 0.0, *common)
    gz = _dh_component(rz, 4.0 * a2 * rz, 2.0 * a2 * rz, 0.0, 0.0, 1.0, *common)
    return gx, gy, gz


def rhs_rows(rx, ry, rz, qx, qy, qz, mass, a):
    """Hamilton's equations on rows (``march_substep.kerr_rhs``):
    dx = q - f lp l, dq = -dh/dx.  Returns the six derivative rows and r."""
    r, f, lx, ly, lz, aux = _scalars(rx, ry, rz, mass, a)
    lp = 1.0 + lx * qx + ly * qy + lz * qz
    flp = f * lp
    gx, gy, gz = _dh_rows(rx, ry, rz, qx, qy, qz, mass, a, r, f, lx, ly, lz, lp, aux)
    return (qx - flp * lx, qy - flp * ly, qz - flp * lz, -gx, -gy, -gz), r


def kerr_scalars(x: torch.Tensor, mass, a) -> Tuple[torch.Tensor, torch.Tensor,
                                                    torch.Tensor]:
    """(r, f, l) for positions x (..., 3); l is (..., 3)."""
    r, f, lx, ly, lz = scalars_rows(x[..., 0], x[..., 1], x[..., 2], mass, a)
    return r, f, torch.stack([lx, ly, lz], dim=-1)


def hamiltonian(x: torch.Tensor, p: torch.Tensor, mass, spin) -> torch.Tensor:
    """H(x, p) with p_t = -1; x, p (..., 3)."""
    _, f, l = kerr_scalars(x, mass, spin * mass)
    lp = 1.0 + (l * p).sum(-1)
    return 0.5 * ((p * p).sum(-1) - 1.0 - f * lp * lp)


def null_momentum(x: torch.Tensor, direction: torch.Tensor, mass, spin
                  ) -> torch.Tensor:
    """Spatial momentum p = s * direction with H(x, p) = 0 and s > 0 (the
    future-directed root of (1 - f c^2) s^2 - 2 f c s - (1 + f) = 0,
    c = l . direction)."""
    _, f, l = kerr_scalars(x, mass, spin * mass)
    c = (l * direction).sum(-1)
    qa = 1.0 - f * c * c
    qb = -2.0 * f * c
    qc = -(1.0 + f)
    disc = torch.sqrt(torch.clamp(qb * qb - 4.0 * qa * qc, min=0.0))
    s = (-qb + disc) / (2.0 * qa)
    return direction * s[..., None]


def dh_dx(x: torch.Tensor, q: torch.Tensor, mass, a) -> torch.Tensor:
    """dh/dx (..., 3) of h(x) = -0.5 f(x) (1 + l(x) . q)^2, written out by
    hand; equal to dH/dx of :func:`hamiltonian` (a = spin * mass)."""
    rx, ry, rz = x.unbind(-1)
    qx, qy, qz = q.unbind(-1)
    r, f, lx, ly, lz, aux = _scalars(rx, ry, rz, mass, a)
    lp = 1.0 + lx * qx + ly * qy + lz * qz
    g = _dh_rows(rx, ry, rz, qx, qy, qz, mass, a, r, f, lx, ly, lz, lp, aux)
    return torch.stack(g, dim=-1)


def horizon_radius(mass, spin):
    """Outer horizon r+ = M (1 + sqrt(1 - spin^2)), Boyer-Lindquist r."""
    return mass * (1.0 + torch.sqrt(torch.clamp(1.0 - spin * spin, 0.0, 1.0)))


def bl_radius(x: torch.Tensor, mass, spin) -> torch.Tensor:
    """Kerr-Schild / Boyer-Lindquist radial coordinate r at x (..., 3)."""
    return kerr_scalars(x, mass, spin * mass)[0]
