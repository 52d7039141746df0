"""Exact Kerr null geodesics: the Hamiltonian RK4 step of the march's
Kerr branch.

The super-Hamiltonian in Kerr-Schild Cartesian coordinates, with the
conserved energy p_t = -1 folded in:

    H(x, p) = 1/2 (|p|^2 - 1 - f (1 + l . p)^2)
    r^2 = ((rho^2 - a^2) + sqrt((rho^2 - a^2)^2 + 4 a^2 z^2)) / 2
    f   = 2 M r^3 / (r^4 + a^2 z^2)
    l   = ((r x + a y) / (r^2 + a^2), (r y - a x) / (r^2 + a^2), z / r)

Hamilton's equations are dx/dlam = p - f (1 + l . p) l and dp/dlam =
-dH/dx, with dH/dx written out by the chain rule.  A ray enters the march
with the null momentum along its direction (:func:`null_momentum`); one
substep is a classical RK4 step whose size grows with the radius, and the
ray is captured once its new radius is inside the outer horizon
(:func:`proposal`).  The operations and their order are fixed, so that a
program that computes the same in float32 rounds alike.

Spin is dimensionless: the physical spin parameter is a = spin * M.
"""

from __future__ import annotations

import torch


def _scalars(rx, ry, rz, mass, a):
    """(r, f, lx, ly, lz) and the intermediates dH/dx reuses, for
    hole-relative position rows."""
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


def rhs_rows(rx, ry, rz, qx, qy, qz, mass, a):
    """Hamilton's equations on rows: dx = q - f lp l, dq = -dh/dx.  Returns
    the six derivative rows and r."""
    r, f, lx, ly, lz, aux = _scalars(rx, ry, rz, mass, a)
    lp = 1.0 + lx * qx + ly * qy + lz * qz
    flp = f * lp
    common = (rx, ry, qx, qy, qz, mass, r, f, lx, ly, lz, lp, aux)
    a2 = aux["a2"]
    gx = _dh_component(rx, 0.0, 0.0, r, -a, 0.0, *common)
    gy = _dh_component(ry, 0.0, 0.0, a, r, 0.0, *common)
    gz = _dh_component(rz, 4.0 * a2 * rz, 2.0 * a2 * rz, 0.0, 0.0, 1.0, *common)
    return (qx - flp * lx, qy - flp * ly, qz - flp * lz, -gx, -gy, -gz), r


def null_momentum(x: torch.Tensor, direction: torch.Tensor, mass, spin) -> torch.Tensor:
    """Spatial momentum p = s * direction with H(x, p) = 0 and s > 0 (the
    future-directed root of (1 - f c^2) s^2 - 2 f c s - (1 + f) = 0,
    c = l . direction), for hole-relative positions x (..., 3)."""
    _, f, lx, ly, lz, _ = _scalars(x[..., 0], x[..., 1], x[..., 2], mass, spin * mass)
    l = torch.stack([lx, ly, lz], dim=-1)  # noqa: E741
    c = (l * direction).sum(-1)
    qa = 1.0 - f * c * c
    qb = -2.0 * f * c
    qc = -(1.0 + f)
    disc = torch.sqrt(torch.clamp(qb * qb - 4.0 * qa * qc, min=0.0))
    s = (-qb + disc) / (2.0 * qa)
    return direction * s[..., None]


def horizon_radius(mass, spin):
    """Outer horizon r+ = M (1 + sqrt(1 - spin^2)), Boyer-Lindquist r."""
    return mass * (1.0 + torch.sqrt(torch.clamp(1.0 - spin * spin, 0.0, 1.0)))


def proposal(s, p):
    """One Hamiltonian RK4 step of the state rows ``s`` (px py pz qx qy qz)
    under the scalars ``p``: the chord direction, the new position and
    momentum, the chord length, and the capture test r_new <= r+."""
    mass = p["mass"]
    spin = p["spin"]
    a = spin * mass
    rx, ry, rz = s["px"] - p["bh_x"], s["py"] - p["bh_y"], s["pz"] - p["bh_z"]
    qx, qy, qz = s["qx"], s["qy"], s["qz"]
    x0 = (rx, ry, rz, qx, qy, qz)

    k1, r0 = rhs_rows(*x0, mass, a)
    # Field-strength-scaled step clip(h (r/3M)^1.5, 2e-3, 1), pow-free.
    t = r0 * (1.0 / (3.0 * mass))
    hk = torch.clamp(p["step_size"] * t * torch.sqrt(t), 2e-3, 1.0)
    half = 0.5 * hk
    k2, _ = rhs_rows(*(x0[c] + half * k1[c] for c in range(6)), mass, a)
    k3, _ = rhs_rows(*(x0[c] + half * k2[c] for c in range(6)), mass, a)
    k4, _ = rhs_rows(*(x0[c] + hk * k3[c] for c in range(6)), mass, a)
    sixth = hk * (1.0 / 6.0)
    nx = [x0[c] + sixth * (k1[c] + 2 * k2[c] + 2 * k3[c] + k4[c]) for c in range(6)]
    sgx, sgy, sgz = nx[0] - rx, nx[1] - ry, nx[2] - rz
    seg_len = torch.sqrt(sgx * sgx + sgy * sgy + sgz * sgz + 1e-24)
    inv_seg = 1.0 / seg_len
    nd = (sgx * inv_seg, sgy * inv_seg, sgz * inv_seg)
    npos = (nx[0] + p["bh_x"], nx[1] + p["bh_y"], nx[2] + p["bh_z"])
    r_plus = horizon_radius(mass, spin)
    r_new = _scalars(nx[0], nx[1], nx[2], mass, a)[0]
    return nd, npos, nx[3:], seg_len, r_new <= r_plus
