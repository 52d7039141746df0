"""Geodesic physics: the bending acceleration and conserved quantities
(counterpart of ``bhx/physics.py``).

The reference renderer's pseudo-Newtonian force bends light like a hole of
mass 0.5; bhx makes the mass physical,

    f(pos) = -3 * M * h^2 * r_vec / r^5,   h^2 = |r_vec x dir|^2,

so capture happens at b = 3*sqrt(3)*M and the weak-field deflection is
4M/b.  The default scene's M = 0.5 reproduces the reference's bending.
``h^2`` is taken from the position relative to the black hole.

Every function broadcasts over leading dimensions, (..., 3) -> (...,) or
(..., 3).  The march (``bhx_torch/kernels/march.py``) inlines the same
arithmetic; these are the stand-alone forms.
"""

from __future__ import annotations

import math

import torch


def angular_momentum_sq(rel_pos: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """The conserved h^2 = |r x v|^2 of a ray, batched over leading dims."""
    cx = rel_pos[..., 1] * direction[..., 2] - rel_pos[..., 2] * direction[..., 1]
    cy = rel_pos[..., 2] * direction[..., 0] - rel_pos[..., 0] * direction[..., 2]
    cz = rel_pos[..., 0] * direction[..., 1] - rel_pos[..., 1] * direction[..., 0]
    return cx * cx + cy * cy + cz * cz


def geodesic_accel(rel_pos: torch.Tensor, h2, mass, eps: float = 1e-12) -> torch.Tensor:
    """The bending acceleration -3 * M * h2 * rel_pos / |rel_pos|^5.

    ``rel_pos`` (..., 3) is the position relative to the black hole, ``h2``
    (...,), ``mass`` a scalar or (...,).  ``eps`` regularises the pole at
    the singularity; rays inside the horizon end at the opaque sphere, so
    it never reaches a visible pixel."""
    r2 = torch.sum(rel_pos * rel_pos, dim=-1)
    scale = (-3.0) * mass * h2 * (r2 + eps) ** -2.5
    return scale[..., None] * rel_pos


def geodesic_accel_components(rx, ry, rz, h2, mass, eps: float = 1e-12):
    """:func:`geodesic_accel` with the relative position given as three
    same-shaped tensors; returns (ax, ay, az)."""
    r2 = rx * rx + ry * ry + rz * rz
    scale = (-3.0) * mass * h2 * (r2 + eps) ** -2.5
    return scale * rx, scale * ry, scale * rz


def photon_sphere_radius(mass):
    """r_ph = 3M for Schwarzschild."""
    return 3.0 * mass


def critical_impact_parameter(mass):
    """b_crit = 3*sqrt(3)*M: rays with a smaller impact parameter are
    captured."""
    return 3.0 * math.sqrt(3.0) * mass


def weak_field_deflection(mass, impact_parameter):
    """The first-order deflection angle 4M/b of a ray passing far from the
    hole."""
    return 4.0 * mass / impact_parameter
