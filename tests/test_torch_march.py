"""The plain torch march (bhx_torch.kernels.march) against the JAX
reference's step-exact mirror ``march_jnp`` on the CPU."""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import torch

from bhx.config import RenderConfig as JaxRenderConfig
from bhx.kernels.march_grad import march_jnp, total_steps
from bhx.kernels.march_pallas import MarchKernelConfig
from bhx.kernels.march_pallas import pack_params as jax_pack_params

import bhx_torch
from bhx_torch.kernels import march as tmarch

from tests.common import small_scene

torch.set_num_threads(2)

STEPS = 300


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


def _march_t(rows, params):
    return tmarch.march_torch(torch.from_numpy(rows), torch.from_numpy(params),
                              max_iterations=STEPS).numpy()


def test_march_matches_march_jnp():
    rows, params = _setup()
    # vote_every == unroll gives march_jnp the exact step budget.
    kcfg = MarchKernelConfig(integrator="euler", max_iterations=STEPS,
                             vote_every=4, unroll=4)
    assert total_steps(kcfg) == STEPS
    want = np.stack([np.asarray(r) for r in march_jnp(
        tuple(jnp.asarray(r) for r in rows), jnp.asarray(params), kcfg)])
    got = _march_t(rows, params)
    assert got.shape == want.shape == (tmarch.OUT_FIELDS, rows.shape[1])
    o = tmarch._OUT_FIXED
    # The data exercises every branch.
    assert (want[o["horizon"]] > 0.5).sum() > 20
    assert (want[o["exited"]] > 0.5).sum() > 20
    assert (want[o["count"]] > 0.5).sum() > 20
    assert np.isfinite(got).all()
    bad = (np.abs(got - want) > 1e-3).any(axis=0)
    assert bad.mean() <= 0.01, f"{bad.mean():.3%} rays differ"


def test_march_inactive_lanes_unchanged():
    rows, params = _setup()
    rows = rows.copy()
    rows[7, ::2] = 0.0  # every other lane enters inactive
    rows[9, 1::4] = float(STEPS)  # and some have no step budget left
    got = _march_t(rows, params)
    o = tmarch._OUT_FIXED
    dead = (rows[7] < 0.5) | (rows[9] >= STEPS)
    for name, row in (("px", 0), ("py", 1), ("pz", 2), ("dx", 3), ("dy", 4),
                      ("dz", 5), ("h", 6), ("amount", 8)):
        np.testing.assert_array_equal(got[o[name], dead], rows[row, dead])
    for name in ("steps", "horizon", "exited", "count"):
        assert (got[o[name], dead] == 0.0).all(), name
    assert (got[tmarch.OUT_FIXED:, dead] == 0.0).all()
    # Live lanes are independent of their dead neighbours.
    full = _march_t(_setup()[0], params)
    np.testing.assert_array_equal(got[:, ~dead], full[:, ~dead])


def test_pack_params_matches_bhx():
    scene = small_scene()
    _, normal = scene.black_hole.disk_frame()
    want = np.asarray(jax_pack_params(scene.black_hole, normal, JaxRenderConfig()))
    ts = bhx_torch.Scene.default()
    _, tnormal = ts.black_hole.disk_frame()
    got = tmarch.pack_params(ts.black_hole, tnormal, bhx_torch.RenderConfig()).numpy()
    assert got.shape == (tmarch.NUM_PARAMS,)
    np.testing.assert_allclose(got, want, atol=1e-7, rtol=0)


def test_march_wrapper_runs_plain_version_for_cpu_tensors():
    rows, params = _setup()
    before = tmarch.launches
    got = tmarch.march(torch.from_numpy(rows[:, :64].copy()),
                       torch.from_numpy(params), max_iterations=50)
    want = tmarch.march_torch(torch.from_numpy(rows[:, :64].copy()),
                              torch.from_numpy(params), max_iterations=50)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert tmarch.launches == before
