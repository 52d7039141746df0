"""Geodesic integrator steps, fixed-step Euler and adaptive Cash-Karp
RK45, and the Cash-Karp tableau (counterpart of ``bhx/integrate.py``).

The tableau is Python floats computed the way bhx computes them: each
quotient in double, the error weights ``E = B - BH`` as double
differences.  The march's plain version multiplies float32 rows by them
(torch rounds each constant once to float32), and ``csrc/march.cu`` writes
each as that double rounded once to float.  The march inlines its
stepping (``bhx_torch/kernels/march.py``), as the reference inlines it in
its kernel (``bhx/kernels/march_substep.py:195-240``); :func:`euler_step`
and :func:`rk45_step` are the stand-alone steps over any batch of rays.

The tableau is the correct Cash-Karp one; the reference renderer's
``a_43 * k_2`` typo (ray.wgsl:431) is not copied, as bhx does not copy it.
RK45 rejection is the caller's: a rejected lane keeps its state and
retries with ``h_next`` (no inner loop), and only the direction is an RK
state; the position advances along the old direction.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from bhx_torch.physics import angular_momentum_sq, geodesic_accel

A21 = 1.0 / 5.0
A31, A32 = 3.0 / 40.0, 9.0 / 40.0
A41, A42, A43 = 3.0 / 10.0, -9.0 / 10.0, 6.0 / 5.0
A51, A52, A53, A54 = -11.0 / 54.0, 5.0 / 2.0, -70.0 / 27.0, 35.0 / 27.0
A61, A62, A63, A64, A65 = (
    1631.0 / 55296.0,
    175.0 / 512.0,
    575.0 / 13824.0,
    44275.0 / 110592.0,
    253.0 / 4096.0,
)
# 5th-order solution weights.
B1, B2, B3, B4, B5, B6 = (
    37.0 / 378.0,
    0.0,
    250.0 / 621.0,
    125.0 / 594.0,
    0.0,
    512.0 / 1771.0,
)
# Embedded 4th-order weights.
BH1, BH2, BH3, BH4, BH5, BH6 = (
    2825.0 / 27648.0,
    0.0,
    18575.0 / 48384.0,
    13525.0 / 55296.0,
    277.0 / 14336.0,
    1.0 / 4.0,
)
# Error weights (b - b_hat).
E1, E2, E3, E4, E5, E6 = (
    B1 - BH1,
    B2 - BH2,
    B3 - BH3,
    B4 - BH4,
    B5 - BH5,
    B6 - BH6,
)


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v * torch.reciprocal(torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True)) + eps)


def euler_step(pos, direction, h, bh_pos, mass):
    """One fixed-step Euler update (reference next_ray_euler,
    ray.wgsl:467-480): pos, direction (..., 3), h scalar or (...,).
    Returns (new_pos, new_dir); the position advances along the new
    direction."""
    rel = pos - bh_pos
    h2 = angular_momentum_sq(rel, direction)
    acc = geodesic_accel(rel, h2, mass)
    hh = torch.as_tensor(h, dtype=pos.dtype, device=pos.device)[..., None]
    new_dir = _normalize(direction + acc * hh)
    return pos + new_dir * hh, new_dir


class RKResult(NamedTuple):
    pos: torch.Tensor  # proposed new position (..., 3)
    direction: torch.Tensor  # proposed new direction (..., 3)
    h_used: torch.Tensor  # (...,) the step size of this proposal
    h_next: torch.Tensor  # (...,) the controller's next step size
    accept: torch.Tensor  # (...,) bool: the proposal meets the tolerance


def rk45_step(pos, direction, h, bh_pos, mass, rtol: float = 1e-3, safety: float = 0.9,
              min_factor: float = 0.2, max_factor: float = 1.5, h_min: float = 1e-3,
              h_max: float = 1.0) -> RKResult:
    """One adaptive Cash-Karp RK45 proposal for the ray direction.  h^2 is
    taken once a step; the radius in the acceleration at every stage.  The
    controller's factor is safety * err_ratio^-0.25, as two rsqrts, for
    growth and shrinkage alike, clamped to [1, max_factor] on accept and
    [min_factor, 1] on reject."""
    h2 = angular_momentum_sq(pos - bh_pos, direction)
    h = torch.as_tensor(h, dtype=pos.dtype, device=pos.device)
    hh = h[..., None]

    def f(p):
        return geodesic_accel(p - bh_pos, h2, mass)

    k1 = f(pos)
    k2 = f(pos + (A21 * k1) * hh)
    k3 = f(pos + (A31 * k1 + A32 * k2) * hh)
    k4 = f(pos + (A41 * k1 + A42 * k2 + A43 * k3) * hh)
    k5 = f(pos + (A51 * k1 + A52 * k2 + A53 * k3 + A54 * k4) * hh)
    k6 = f(pos + (A61 * k1 + A62 * k2 + A63 * k3 + A64 * k4 + A65 * k5) * hh)

    incr = B1 * k1 + B3 * k3 + B4 * k4 + B6 * k6  # B2 = B5 = 0
    err_vec = hh * (E1 * k1 + E3 * k3 + E4 * k4 + E5 * k5 + E6 * k6)  # E2 = 0
    err_ratio = torch.amax(torch.abs(err_vec), dim=-1) / rtol
    accept = err_ratio <= 1.0
    factor = safety * torch.rsqrt(torch.rsqrt(err_ratio + 1e-12))
    factor = torch.where(accept, torch.clamp(factor, 1.0, max_factor),
                         torch.clamp(factor, min_factor, 1.0))
    return RKResult(pos=pos + direction * hh, direction=_normalize(direction + hh * incr),
                    h_used=h, h_next=torch.clamp(h * factor, h_min, h_max), accept=accept)
