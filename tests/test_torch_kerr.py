"""bhx_torch.kerr against bhx.kerr and the Pallas kernel's Kerr right-hand
side (``bhx.kernels.march_substep.kerr_rhs``) on the CPU, and the Cash-Karp
tableau against bhx.integrate."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhx.integrate as jintegrate
from bhx import kerr as jkerr
from bhx.kernels.march_substep import kerr_rhs as jax_kerr_rhs

import bhx_torch.integrate as tintegrate
from bhx_torch import kerr as tkerr

torch.set_num_threads(2)

MASS = 0.5
SPIN = 0.9


def _points(n: int = 512, seed: int = 0):
    """Hole-relative positions: a shell outside the horizon, points within
    1e-3 of the equatorial plane, and points near the ring rho = a (but off
    it, where the Kerr-Schild radius is smooth); unit directions and
    momenta of the size a null ray carries."""
    rng = np.random.default_rng(seed)
    a = SPIN * MASS
    m = n // 3
    shell = rng.normal(size=(m, 3))
    shell *= (rng.uniform(1.2, 20.0, (m, 1)) / np.linalg.norm(shell, axis=1, keepdims=True))
    phi = rng.uniform(0, 2 * np.pi, m)
    rad = rng.uniform(1.0, 15.0, m)
    equator = np.stack([rad * np.cos(phi), rng.uniform(-1e-3, 1e-3, m), rad * np.sin(phi)], 1)
    k = n - 2 * m
    phi = rng.uniform(0, 2 * np.pi, k)
    rad = a + rng.choice([-1, 1], k) * rng.uniform(0.05, 0.2, k)
    ring = np.stack([rad * np.cos(phi), rad * np.sin(phi), rng.uniform(0.05, 0.2, k)], 1)
    x = np.concatenate([shell, equator, ring]).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    q = (d * rng.uniform(0.5, 2.0, (n, 1))).astype(np.float32)
    return x, d.astype(np.float32), q


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_tableau_matches_bhx():
    names = [n for n in dir(jintegrate)
             if n.rstrip("0123456789") in ("A", "B", "BH", "E") and n[-1].isdigit()]
    assert len(names) == 33
    for name in names:
        assert getattr(tintegrate, name) == getattr(jintegrate, name), name


def test_scalars_match_bhx():
    x, _, _ = _points()
    a = SPIN * MASS
    r_j, f_j, l_j = jkerr._kerr_scalars(jnp.asarray(x), MASS, a)
    r_t, f_t, l_t = tkerr.kerr_scalars(_t(x), torch.tensor(MASS), torch.tensor(a))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-6, rtol=1e-6)
    bl = tkerr.bl_radius(_t(x), torch.tensor(MASS), torch.tensor(SPIN))
    np.testing.assert_allclose(bl.numpy(), np.asarray(r_j), atol=1e-6, rtol=1e-6)
    rp = tkerr.horizon_radius(torch.tensor(MASS), torch.tensor(SPIN))
    assert abs(float(rp) - float(jkerr.horizon_radius(MASS, SPIN))) < 1e-7


def test_null_momentum_and_hamiltonian_match_bhx():
    x, d, q = _points()
    mass, spin = torch.tensor(MASS), torch.tensor(SPIN)
    p_j = np.asarray(jkerr.null_momentum(jnp.asarray(x), jnp.asarray(d), MASS, SPIN))
    p_t = tkerr.null_momentum(_t(x), _t(d), mass, spin)
    # The tracer solves for the momentum at the relativity sphere; inside
    # the outer horizon the quadratic's leading coefficient 1 - f c^2 can
    # vanish and the root is ill-conditioned, so only points outside it.
    outside = tkerr.bl_radius(_t(x), mass, spin).numpy() > float(
        tkerr.horizon_radius(mass, spin))
    assert outside.mean() > 0.6
    np.testing.assert_allclose(p_t.numpy()[outside], p_j[outside], atol=1e-6, rtol=1e-6)
    h_j = np.asarray(jkerr.hamiltonian(jnp.asarray(x), jnp.asarray(q), MASS, SPIN))
    h_t = tkerr.hamiltonian(_t(x), _t(q), mass, spin).numpy()
    np.testing.assert_allclose(h_t, h_j, atol=1e-6, rtol=1e-6)
    # A null ray: H(x, null_momentum) = 0 to float32 rounding of |p|^2.
    h0 = tkerr.hamiltonian(_t(x), p_t, mass, spin).numpy()
    scale = 1.0 + (p_t * p_t).sum(-1).numpy()
    assert np.abs(h0 / scale)[outside].max() < 1e-6


def test_dh_dx_matches_jax_vjp():
    """The hand-written gradient against the Pallas kernel's: kerr_rhs
    returns -dh/dx of its h_of_x, taken with jax.vjp."""
    x, _, q = _points()
    a = SPIN * MASS
    rows = [jnp.asarray(c) for c in (*x.T, *q.T)]
    want = -np.stack([np.asarray(g) for g in jax_kerr_rhs(*rows, MASS, a)[3:]], -1)
    got = tkerr.dh_dx(_t(x), _t(q), torch.tensor(MASS), torch.tensor(a)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # The position part of the right-hand side, for the same rows.
    dx_j = np.stack([np.asarray(g) for g in jax_kerr_rhs(*rows, MASS, a)[:3]], -1)
    k, _ = tkerr.rhs_rows(*(_t(c) for c in (*x.T, *q.T)), torch.tensor(MASS),
                          torch.tensor(a))
    np.testing.assert_allclose(torch.stack(k[:3], -1).numpy(), dx_j, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(-torch.stack(k[3:], -1).numpy(), want, rtol=1e-4, atol=1e-5)


def test_dh_dx_matches_autograd():
    """... and against torch.autograd.grad of the plain Hamiltonian."""
    x, _, q = _points(seed=1)
    mass, spin = torch.tensor(MASS), torch.tensor(SPIN)
    xt = _t(x).requires_grad_(True)
    (want,) = torch.autograd.grad(tkerr.hamiltonian(xt, _t(q), mass, spin).sum(), xt)
    got = tkerr.dh_dx(_t(x), _t(q), mass, spin * mass)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("spin", [0.0, 0.7])
def test_dh_dx_spins(spin):
    """Schwarzschild (a = 0, where r = |x|) and a mid spin, against jax.vjp."""
    x, _, q = _points(seed=2)
    a = spin * MASS
    rows = [jnp.asarray(c) for c in (*x.T, *q.T)]
    want = -np.stack([np.asarray(g) for g in jax_kerr_rhs(*rows, MASS, a)[3:]], -1)
    got = tkerr.dh_dx(_t(x), _t(q), torch.tensor(MASS), torch.tensor(a)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
