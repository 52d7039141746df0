"""bhx_torch.physics and the steppers of bhx_torch.integrate against
bhx.physics and bhx.integrate on seeded numpy inputs, and the closed-form
properties of tests/test_physics.py on the port: capture at
b = 3*sqrt(3)*M and the weak-field deflection 4M/b."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import bhx.integrate as jint
import bhx.physics as jphys

from bhx_torch import integrate as tint
from bhx_torch import physics as tphys

torch.set_num_threads(2)

# float32 on both sides; the two round pow, sqrt and the reciprocal in
# their own ways, a few ulp of each result.
RTOL, ATOL = 1e-5, 1e-7


def _rays(n: int = 4096, seed: int = 0, box: float = 20.0, h_max: float = 0.5):
    """Positions in a box of half-width ``box`` around the origin, unit
    directions, step sizes in [0.01, h_max], the hole's position (within 1
    of the origin) and mass: numpy float32."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-box, box, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    h = rng.uniform(0.01, h_max, n).astype(np.float32)
    bh = rng.uniform(-1.0, 1.0, 3).astype(np.float32)
    return pos, d, h, bh, np.float32(0.5)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_physics_functions_match_bhx():
    pos, d, _, bh, mass = _rays()
    rel = pos - bh
    t = torch.from_numpy
    h2 = tphys.angular_momentum_sq(t(rel), t(d))
    _close(h2, jphys.angular_momentum_sq(rel, d))
    _close(tphys.geodesic_accel(t(rel), h2, mass),
           jphys.geodesic_accel(rel, np.asarray(h2), mass))
    for got, want in zip(tphys.geodesic_accel_components(*t(rel).unbind(-1), h2, mass),
                         jphys.geodesic_accel_components(*rel.T, np.asarray(h2), mass)):
        _close(got, want)
    masses = t(np.linspace(0.1, 2.0, 7, dtype=np.float32))
    b = t(np.linspace(5.0, 500.0, 7, dtype=np.float32))
    _close(tphys.photon_sphere_radius(masses), jphys.photon_sphere_radius(masses.numpy()))
    _close(tphys.critical_impact_parameter(masses),
           jphys.critical_impact_parameter(masses.numpy()))
    _close(tphys.weak_field_deflection(masses, b),
           jphys.weak_field_deflection(masses.numpy(), b.numpy()))


@pytest.mark.parametrize("scalar_h", [False, True])
def test_euler_step_matches_bhx(scalar_h):
    pos, d, h, bh, mass = _rays(seed=1)
    h = np.float32(0.15) if scalar_h else h
    got = tint.euler_step(torch.from_numpy(pos), torch.from_numpy(d), torch.as_tensor(h),
                          torch.from_numpy(bh), mass)
    for g, w in zip(got, jint.euler_step(pos, d, h, bh, mass)):
        _close(g, w)


@pytest.mark.parametrize("rtol", [1e-3, 1e-5])
def test_rk45_step_matches_bhx(rtol):
    """Every field of the proposal, near the hole and with long steps, so
    that some proposals are rejected; the accept flags agree on every ray
    (none lies within float32 rounding of the tolerance)."""
    pos, d, h, bh, mass = _rays(seed=2, box=6.0, h_max=2.0)
    got = tint.rk45_step(torch.from_numpy(pos), torch.from_numpy(d), torch.from_numpy(h),
                         torch.from_numpy(bh), mass, rtol=rtol)
    want = jint.rk45_step(pos, d, h, bh, mass, rtol=rtol)
    assert got._fields == want._fields
    np.testing.assert_array_equal(got.accept.numpy(), np.asarray(want.accept))
    assert 0 < int(got.accept.sum()) < len(h)
    for f in ("pos", "direction", "h_used", "h_next"):
        _close(getattr(got, f), getattr(want, f))


def _march(b: float, h: float, r_escape: float, max_steps: int, mass: float = 1.0):
    """Euler-march a ray from x = -r_escape/2 at impact parameter ``b``
    (float64, the port's euler_step) until it falls inside 2M or escapes
    past ``r_escape``: (status, final direction)."""
    pos = torch.tensor([[-r_escape / 2, b, 0.0]], dtype=torch.float64)
    d = torch.tensor([[1.0, 0.0, 0.0]], dtype=torch.float64)
    bh = torch.zeros(3, dtype=torch.float64)
    for _ in range(max_steps):
        r = float(torch.linalg.vector_norm(pos))
        if r < 2.0 * mass:
            return "captured", d[0].numpy()
        if r > r_escape:
            return "escaped", d[0].numpy()
        pos, d = tint.euler_step(pos, d, h, bh, mass)
    return "timeout", d[0].numpy()


@pytest.mark.parametrize("factor,expect", [(0.9, "captured"), (1.15, "escaped")])
def test_photon_capture_critical_impact_parameter(factor, expect):
    """Rays with b < 3*sqrt(3)*M are captured, b > 3*sqrt(3)*M escape
    (tests/test_physics.py, on the port's stepper)."""
    b = float(tphys.critical_impact_parameter(1.0)) * factor
    status, _ = _march(b, h=0.05, r_escape=400.0, max_steps=40000)
    assert status == expect


def test_weak_field_deflection_angle():
    """The deflection at b = 50 is 4M/b + (15*pi/4)(M/b)^2 within
    integrator error (tests/test_physics.py, on the port's stepper)."""
    b = 50.0
    status, d_out = _march(b, h=0.25, r_escape=2000.0, max_steps=40000)
    assert status == "escaped"
    angle = np.arccos(np.clip(np.dot(d_out, [1.0, 0.0, 0.0]), -1, 1))
    expected = float(tphys.weak_field_deflection(1.0, b)) + 15.0 * np.pi / 4.0 / b**2
    assert angle == pytest.approx(expected, rel=0.03)
