"""Scene fitting on one device (bhx_torch.parallel) against the
single-device part of bhx.parallel on the CPU, with inputs made from a
seed by numpy."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import bhx.parallel as jpar
from bhx.pipeline import render as jax_render

import bhx_torch
from bhx_torch import parallel as tpar
from bhx_torch.kernels import replay_counts, reset_launch_counts

from tests.common import FAST_CFG, small_scene
from tests.test_torch_pipeline import _torch_scene, torch_cfg

torch.set_num_threads(2)


def test_scene_params_match_bhx():
    """Same keys in the same order and the same values; a dict of numpy
    arrays (as one made by bhx) applies to the port's scene as
    ``bhx.parallel.apply_params`` applies it to bhx's, and every field
    outside the fitted set is left as it was."""
    jscene, tscene = small_scene(), _torch_scene()
    want = jpar.scene_params(jscene)
    got = tpar.scene_params(tscene)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))

    rng = np.random.default_rng(0)
    moved = {k: (np.asarray(v) + rng.uniform(-0.1, 0.1, np.shape(v))).astype(np.float32)
             for k, v in want.items()}
    applied = tpar.apply_params(tscene, moved)
    j = jpar.scene_params(jpar.apply_params(jscene, {k: jnp.asarray(v)
                                                     for k, v in moved.items()}))
    for k, v in tpar.scene_params(applied).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(j[k]))
    assert applied.camera.forward is tscene.camera.forward
    assert applied.black_hole.relativity_radius is tscene.black_hole.relativity_radius
    assert applied.disk_gain is tscene.disk_gain


def test_adam_steps_match_optax():
    """``make_optimizer``'s Adam against ``optax.adam`` (lr 1e-2, the
    defaults otherwise) over three steps of the same random gradients,
    bias correction included: parameters within rtol 1e-6 / atol 1e-6
    (1e-4 of one step; the two round the moments' quotient differently)."""
    rng = np.random.default_rng(1)
    shapes = {k: np.shape(v) for k, v in jpar.scene_params(small_scene()).items()}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]

    opt = optax.adam(1e-2)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    topt = tpar.make_optimizer(tp, lr=1e-2)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()}, state)
        jp = optax.apply_updates(jp, updates)
        for k, v in tp.items():
            v.grad = torch.from_numpy(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)


# bhx fit's render (no ladder, no bloom or FXAA, tonemap) cut to 24x14 and
# 200 iterations, without the star sky, looking at the disk's far side
# through a narrow field (forward toward (10, 0, 0), fov 0.3), so that every
# ray passes far from the photon sphere.  Near that sphere the two float
# programs' pointwise gradients part exponentially, and the squared error
# weights a pixel by its residual, which no target makes zero in both
# programs at once; the star splats' edges (radius 2.4e-3 uv) do the same
# at 1e-2.  tests/test_torch_grad.py holds the default view with FD-stable
# weights instead.
FIT_CFG = dataclasses.replace(FAST_CFG, width=24, height=14, max_iterations=200,
                              tonemap=True, show_sky=False)
_FORWARD = np.array([10.0, 0.0, 19.0], np.float32) / np.float32(np.hypot(10.0, 19.0))
_FOV = 0.3


def test_train_step_matches_bhx_loss_and_grad():
    """``train_step``'s loss and gradients against ``jax.value_and_grad``
    of bhx.parallel's loss (``mean((render(apply_params(scene, p)) -
    target)**2)``, ``bhx/parallel.py:298-301``) on bhx's kernel path
    (``march_mode="pallas_interpret"``, vote = unroll), for the port's
    render at mass 0.6 as the target: the loss within 1e-4 relative, each
    gradient within 2e-3 of its largest entry (measured at most 8.5e-4,
    the field of view), exactly zero where the reference's is (spin under
    the pseudo force; the feather, which no ray of this view reaches).
    The step then applies Adam's first update, -lr * g / (|g| + eps)."""
    base = _torch_scene()
    scene = dataclasses.replace(base, camera=dataclasses.replace(
        base.camera, forward=torch.from_numpy(_FORWARD), fov=torch.tensor(_FOV)))
    cfg = torch_cfg(FIT_CFG)
    target = bhx_torch.render(tpar.apply_params(scene, dict(tpar.scene_params(scene),
                                                            mass=0.6)), cfg).detach()
    params = {k: v.detach().clone().requires_grad_() for k, v in tpar.scene_params(scene).items()}
    before = {k: v.detach().clone() for k, v in params.items()}
    reset_launch_counts()
    loss = float(tpar.train_step(params, tpar.make_optimizer(params, lr=1e-2), scene, target,
                                 cfg))
    assert replay_counts()["march"] == 2 and replay_counts()["composite"] == 1
    got = {k: v.grad.numpy() for k, v in params.items()}

    jcfg = dataclasses.replace(FIT_CFG, march_mode="pallas_interpret", pallas_vote_every=4,
                               pallas_unroll=4, pallas_sublanes=8, pallas_shade_sublanes=8)
    jbase = small_scene()
    jscene = dataclasses.replace(jbase, camera=dataclasses.replace(
        jbase.camera, forward=jnp.asarray(_FORWARD), fov=jnp.float32(_FOV)))
    jtarget = jnp.asarray(target.numpy())

    def loss_fn(p):
        return jnp.mean((jax_render(jpar.apply_params(jscene, p), jcfg) - jtarget) ** 2)

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(jpar.scene_params(jscene))
    assert abs(loss - float(want_loss)) <= 1e-4 * float(want_loss)
    for k, g in got.items():
        w = np.asarray(want[k])
        assert np.isfinite(g).all(), k
        if not w.any():
            assert not g.any(), k
            continue
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 2e-3, (k, err)
    assert np.abs(got["mass"]).max() > 0.0 and np.abs(got["cam_fov"]).max() > 0.0

    for k, v in params.items():
        g = torch.from_numpy(got[k])
        np.testing.assert_allclose(v.detach().numpy(),
                                   (before[k] - 1e-2 * g / (g.abs() + 1e-8)).numpy(),
                                   rtol=1e-6, atol=1e-7)


def test_fit_scene_lowers_the_loss():
    """Three Adam steps at 32x18 from the default scene (mass 0.5) toward
    its render at mass 0.6, at bhx fit's defaults otherwise (no ladder, no
    bloom or FXAA, tonemap, lr 1e-2) but without the star sky, as the
    card's fit runs (chip_smoke.py phase 6c: a star splat's slope is no
    slope of the loss at any usable step): every loss finite and below the
    one before (the reference's gate is the last below the first,
    tests/test_dist.py:103-134), the mass moved toward 0.6 by Adam steps
    of at most lr each, the callback called after each step, and the
    scene's own tensors left as they were."""
    cfg = bhx_torch.RenderConfig(width=32, height=18, use_ladder=False, max_iterations=200,
                                 bloom=bhx_torch.BloomConfig(enabled=False),
                                 fxaa=bhx_torch.FxaaConfig(enabled=False), show_sky=False)
    scene = bhx_torch.Scene.default("cpu")
    target = bhx_torch.render(tpar.apply_params(scene, dict(tpar.scene_params(scene),
                                                            mass=0.6)), cfg).detach()
    seen = []
    fitted, losses = tpar.fit_scene(scene, target, cfg, steps=3, lr=1e-2,
                                    callback=lambda i, loss: seen.append((i, loss)))
    assert [i for i, _ in seen] == [0, 1, 2] and [loss for _, loss in seen] == losses
    assert np.isfinite(losses).all() and losses[2] < losses[1] < losses[0], losses
    assert 0.5 < float(fitted["mass"]) <= 0.5 + 3e-2 + 1e-6
    assert all(not v.requires_grad for v in fitted.values())
    assert float(scene.black_hole.mass) == 0.5 and not scene.black_hole.mass.requires_grad
