"""The plain torch march (bhx_torch.kernels.march) against the JAX
reference's step-exact mirror ``march_jnp`` on the CPU, for the Euler,
RK45 and exact-Kerr branches."""

from __future__ import annotations

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhx import kerr as jkerr

from bhx.config import RenderConfig as JaxRenderConfig
from bhx.kernels.march_grad import march_jnp, total_steps
from bhx.kernels.march_pallas import MarchKernelConfig
from bhx.kernels.march_pallas import pack_params as jax_pack_params

import bhx_torch
from bhx_torch.kernels import march as tmarch

from tests.common import small_scene

torch.set_num_threads(2)

STEPS = 300
KERR_SPIN = 0.7


@functools.lru_cache(maxsize=1)
def _setup(n: int = 2048):
    """Camera rays of the default view (origin (0, 0, -19), inside the
    relativity sphere) in random directions across its field of view: a
    mix of disk crossings, horizon captures and exits."""
    rng = np.random.default_rng(0)
    d = np.stack([
        rng.uniform(-1.0, 1.0, n), rng.uniform(-0.56, 0.56, n),
        np.full(n, 1.0 / np.tan(0.5)),
    ])
    d /= np.linalg.norm(d, axis=0)
    rows = np.concatenate([
        np.zeros((2, n)), np.full((1, n), -19.0), d,
        np.full((1, n), 0.15),  # h
        np.ones((2, n)),  # active, amount
        np.zeros((1, n)),  # steps done
    ]).astype(np.float32)
    scene = small_scene()
    _, normal = scene.black_hole.disk_frame()
    params = np.array(jax_pack_params(
        scene.black_hole, normal, JaxRenderConfig(max_iterations=STEPS)
    ))
    return rows, params


@functools.lru_cache(maxsize=1)
def _setup_kerr():
    """The same rays around a hole of spin KERR_SPIN, with the momentum
    rows built as tests/test_march_grad.py:_setup_mode builds them."""
    rows, _ = _setup()
    scene = small_scene()
    bh = dataclasses.replace(scene.black_hole, spin=jnp.float32(KERR_SPIN))
    _, normal = bh.disk_frame()
    params = np.array(jax_pack_params(bh, normal, JaxRenderConfig(max_iterations=STEPS)))
    pos = jnp.asarray(rows[0:3].T)
    mom = jkerr.null_momentum(pos - bh.position, jnp.asarray(rows[3:6].T), bh.mass, bh.spin)
    return np.concatenate([rows, np.asarray(mom).T]).astype(np.float32), params


def _march_t(rows, params, **kw):
    return tmarch.march_torch(torch.from_numpy(rows), torch.from_numpy(params),
                              max_iterations=STEPS, **kw).numpy()


# (integrator, geodesics, share of rays allowed over 1e-3): Euler and RK45
# at the march gate of bhx_torch/checks.py, Kerr at the kernel-vs-mirror
# gate of tests/test_march_grad.py:170-171.
_BRANCHES = [("euler", "pseudo", 0.01), ("rk45", "pseudo", 0.01), ("euler", "kerr", 0.02)]


@pytest.mark.parametrize("integrator, geodesics, frac", _BRANCHES,
                         ids=["euler", "rk45", "kerr"])
def test_march_matches_march_jnp(integrator, geodesics, frac, monkeypatch):
    rows, params = _setup_kerr() if geodesics == "kerr" else _setup()
    # vote_every == unroll gives march_jnp the exact step budget.
    kcfg = MarchKernelConfig(integrator=integrator, geodesics=geodesics,
                             max_iterations=STEPS, vote_every=4, unroll=4)
    assert total_steps(kcfg) == STEPS
    want = np.stack([np.asarray(r) for r in march_jnp(
        tuple(jnp.asarray(r) for r in rows), jnp.asarray(params), kcfg)])
    rejected = []
    proposal = tmarch._rk45_proposal

    def counting(s, p, h2):
        res = proposal(s, p, h2)
        rejected.append(int((s["act"] & ~res[3]).sum()))
        return res

    monkeypatch.setattr(tmarch, "_rk45_proposal", counting)
    got = _march_t(rows, params, integrator=integrator, geodesics=geodesics)
    assert got.shape == want.shape == (tmarch.out_fields(geodesics), rows.shape[1])
    o = tmarch._OUT_FIXED
    # The data exercises every branch.
    assert (want[o["horizon"]] > 0.5).sum() > 20
    assert (want[o["exited"]] > 0.5).sum() > 20
    assert (want[o["count"]] > 0.5).sum() > 20
    if integrator == "rk45":
        assert sum(rejected) > 0  # the controller rejects steps
    assert np.isfinite(got).all()
    bad = (np.abs(got - want) > 1e-3).any(axis=0)
    assert bad.mean() <= frac, f"{bad.mean():.3%} rays differ"


@pytest.mark.parametrize("toggle", [dict(show_disk=False), dict(tex_opacity_min=1.0)],
                         ids=["show_disk_0", "tex_opacity_min_1"])
def test_march_toggles_match_march_jnp(toggle):
    """The march's two feature arguments (no disk: no crossing recorded;
    no disk texture: the transmission bound's opacity factor 1.0) against
    march_jnp with the same arguments, Euler."""
    rows, params = _setup()
    kcfg = MarchKernelConfig(max_iterations=STEPS, vote_every=4, unroll=4, **toggle)
    want = np.stack([np.asarray(r) for r in march_jnp(
        tuple(jnp.asarray(r) for r in rows), jnp.asarray(params), kcfg)])
    got = _march_t(rows, params, **toggle)
    assert np.isfinite(got).all()
    bad = (np.abs(got - want) > 1e-3).any(axis=0)
    assert bad.mean() <= 0.01, f"{bad.mean():.3%} rays differ"
    o, base = tmarch._OUT_FIXED, _march_t(rows, params)
    if "show_disk" in toggle:
        assert (base[o["count"]] > 0.5).sum() > 20 and not got[o["count"]].any()
        assert not got[tmarch.OUT_FIXED:tmarch.OUT_FIXED + tmarch.SLOT_ROWS].any()
    else:
        # The bound takes a crossing's opacity factor at 1.0, not at least
        # 0.7: crossings dim the transmission bound more.
        assert (got[o["amount"]] < base[o["amount"]] - 1e-3).sum() > 20


@pytest.mark.parametrize("integrator, geodesics", [("euler", "pseudo"), ("rk45", "pseudo"),
                                                   ("euler", "kerr")],
                         ids=["euler", "rk45", "kerr"])
def test_march_inactive_lanes_unchanged(integrator, geodesics):
    full_rows, params = _setup_kerr() if geodesics == "kerr" else _setup()
    rows = full_rows.copy()
    rows[7, ::2] = 0.0  # every other lane enters inactive
    rows[9, 1::4] = float(STEPS)  # and some have no step budget left
    kw = dict(integrator=integrator, geodesics=geodesics)
    got = _march_t(rows, params, **kw)
    o = tmarch._OUT_FIXED
    dead = (rows[7] < 0.5) | (rows[9] >= STEPS)
    for name, row in (("px", 0), ("py", 1), ("pz", 2), ("dx", 3), ("dy", 4),
                      ("dz", 5), ("h", 6), ("amount", 8)):
        np.testing.assert_array_equal(got[o[name], dead], rows[row, dead])
    for name in ("steps", "horizon", "exited", "count"):
        assert (got[o[name], dead] == 0.0).all(), name
    slots = slice(tmarch.OUT_FIXED, tmarch.OUT_FIXED + tmarch.SLOT_ROWS)
    assert (got[slots, dead] == 0.0).all()
    if geodesics == "kerr":  # the momentum comes back as it went in
        np.testing.assert_array_equal(got[-3:, dead], rows[10:13, dead])
    # Live lanes are independent of their dead neighbours.
    full = _march_t(full_rows, params, **kw)
    np.testing.assert_array_equal(got[:, ~dead], full[:, ~dead])


@pytest.mark.parametrize("integrator, geodesics", [("euler", "pseudo"), ("rk45", "pseudo"),
                                                   ("euler", "kerr")],
                         ids=["euler", "rk45", "kerr"])
def test_march_lane_subset_is_exact(integrator, geodesics):
    """A lane's output is a function of its own input row: the plain march
    of a permuted subset of the lanes (live and dead) equals the same
    columns of the full call bit for bit.  The kernel rests on it when it
    marches the live lanes compacted, in queue order, refilling a warp's
    retired lanes with any others."""
    full_rows, params = _setup_kerr() if geodesics == "kerr" else _setup()
    rows = full_rows.copy()
    rows[7, ::5] = 0.0  # some lanes enter dead
    kw = dict(integrator=integrator, geodesics=geodesics)
    full = _march_t(rows, params, **kw)
    idx = np.random.default_rng(1).permutation(rows.shape[1])[:rows.shape[1] // 3]
    sub = _march_t(np.ascontiguousarray(rows[:, idx]), params, **kw)
    assert (rows[7, idx] > 0.5).any() and (rows[7, idx] < 0.5).any()
    np.testing.assert_array_equal(sub, full[:, idx])


def test_pack_params_matches_bhx():
    scene = small_scene()
    _, normal = scene.black_hole.disk_frame()
    want = np.asarray(jax_pack_params(scene.black_hole, normal, JaxRenderConfig()))
    ts = bhx_torch.Scene.default("cpu")
    _, tnormal = ts.black_hole.disk_frame()
    got = tmarch.pack_params(ts.black_hole, tnormal, bhx_torch.RenderConfig()).numpy()
    assert got.shape == (tmarch.NUM_PARAMS,)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_pack_params_rk_fields_and_spin_match_bhx():
    """Every RK45 controller field and the spin reach their slots."""
    rk = dict(rk_rtol=3e-4, rk_safety=0.8, rk_min_factor=0.3, rk_max_factor=2.0,
              rk_h_min=5e-4, rk_h_max=0.7)
    scene = small_scene()
    bh = dataclasses.replace(scene.black_hole, spin=jnp.float32(0.9))
    _, normal = bh.disk_frame()
    want = np.asarray(jax_pack_params(bh, normal, JaxRenderConfig(max_iterations=700, **rk)))
    ts = bhx_torch.Scene.default("cpu")
    tbh = dataclasses.replace(ts.black_hole, spin=torch.tensor(0.9))
    _, tnormal = tbh.disk_frame()
    cfg = bhx_torch.RenderConfig(max_iterations=700, geodesics="kerr",
                                 integrator=bhx_torch.Integrator.RK45, **rk)
    got = tmarch.pack_params(tbh, tnormal, cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)
    assert got[tmarch._P["rtol"]] == np.float32(3e-4)
    assert got[tmarch._P["spin"]] == np.float32(0.9)

