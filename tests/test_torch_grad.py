"""Reverse-mode gradients of bhx_torch against the JAX reference on the CPU.

Each kernel wrapper of the port is a ``torch.autograd.Function`` whose
backward replays the kernel's plain version under autograd, as each Pallas
call of bhx is a ``jax.custom_vjp`` whose backward replays its jnp mirror.
Held here, with the inputs made from a seed by numpy:

* each Function's vector-Jacobian product against ``jax.vjp`` of the
  reference's mirror (``march_jnp``, ``_composite_jnp``,
  ``_ingredients_jnp``, ``_sky_rows_jnp``, ``_sky_finalize_jnp``), and the
  post stages' against ``jax.vjp`` of bhx's;
* ``bhx_torch.render``'s gradient against ``jax.grad`` of ``bhx.render`` on
  its kernel path (``march_mode="pallas_interpret"``, vote = unroll, which
  replays exact step budgets) -- not ``march_mode="diff"``, a different
  program whose gradient sits ~10% away;
* the ladder-on gradient against the port's own central differences;
* each Function's backward against plain autograd through its plain
  version, with the march replayed in several ray chunks and step segments.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bhx.post as jpost
from bhx.config import LadderConfig as JaxLadderConfig
from bhx.kernels.march_grad import march_jnp
from bhx.kernels.march_pallas import MarchKernelConfig
from bhx.kernels.shade_pallas import (
    ShadeKernelConfig, SkyKernelConfig, _composite_jnp, _ingredients_jnp,
    _sky_finalize_jnp, _sky_rows_jnp,
)
from bhx.pipeline import render as jax_render

import bhx_torch
from bhx_torch import post as tpost
from bhx_torch.bench import fd_stable, pose_fd_stable, rotated
from bhx_torch.kernels import march as tmarch
from bhx_torch.kernels import replay_counts, reset_launch_counts
from bhx_torch.kernels import shade as tshade
from bhx_torch.kernels import sky as tsky
from bhx_torch.scene import const, with_spin

from tests.common import FAST_CFG, small_scene
from tests.test_torch_march import STEPS, _setup, _setup_kerr
from tests.test_torch_pipeline import _chw, _stage, _torch_scene, torch_cfg
from tests.test_torch_shade import _params, _record, _slots

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _flush_denormals():
    """The replayed adjoint of rays near the photon sphere underflows into
    denormal floats, which the CPU computes many times slower than normal
    ones; flushing them to zero halves the march replays' time here and
    moves no value above 1.2e-38."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


# Every Kerr lane of the parity data is done within this many substeps
# (Kerr steps grow to 1.0 away from the hole; asserted below), so it
# replays the same trajectories as STEPS, and the reference's second-order
# VJP compiles one 32-step leaf instead of three step bodies.
KERR_STEPS = 96


def _grads(fn, inputs, cotangent):
    """Cotangents of ``inputs`` for ``cotangent`` of ``fn(*inputs)``."""
    inputs = [t.detach().clone().requires_grad_() for t in inputs]
    return torch.autograd.grad(fn(*inputs), inputs, cotangent)


def _jax_vjp(fn, inputs, cotangent):
    return jax.vjp(fn, *inputs)[1](cotangent)


def _close_frac(got, want, rtol=1e-3, atol=1e-5):
    return float((np.abs(got - want) <= atol + rtol * np.abs(want)).mean())


def _rel(got, want):
    """Per-entry relative error against the larger of the two magnitudes."""
    return np.abs(got - want) / np.maximum(np.maximum(np.abs(got), np.abs(want)), 1e-30)


def _significant(want, frac=1e-6):
    """Entries above ``frac`` of the largest magnitude."""
    return np.abs(want) > frac * np.abs(want).max()


# --- (a) the march --------------------------------------------------------

@pytest.mark.parametrize("integrator, geodesics", [("euler", "pseudo"), ("rk45", "pseudo"),
                                                   ("euler", "kerr")],
                         ids=["euler", "rk45", "kerr"])
def test_march_vjp_matches_march_jnp(integrator, geodesics):
    """The march Function's backward against ``jax.vjp(march_jnp)`` on the
    parity data of tests/test_torch_march.py, for a random cotangent of
    every output row.  Ray cotangents: 99.5% of entries within rtol 1e-3 /
    atol 1e-5 (the rest are rays near the photon sphere, where the adjoint
    grows exponentially and two float programs part).  Parameter
    cotangents, spin included: within 1e-3 relative, for the cotangent with
    the rays that fail the ray gate or end at the step budget zeroed (a
    parameter's cotangent sums every ray's, so one chaotic ray would
    decide it)."""
    kerr = geodesics == "kerr"
    rows, params = _setup_kerr() if kerr else _setup()
    steps = KERR_STEPS if kerr else STEPS
    kcfg = MarchKernelConfig(integrator=integrator, geodesics=geodesics,
                             max_iterations=steps, vote_every=4, unroll=4)
    rng = np.random.default_rng(1)
    g = rng.normal(size=(tmarch.out_fields(geodesics), rows.shape[1])).astype(np.float32)

    vjp = jax.jit(lambda r, p, gg: _jax_vjp(lambda r, p: march_jnp(r, p, kcfg), (r, p), gg))

    def want(cot):
        gr, gp = vjp(tuple(jnp.asarray(r) for r in rows), jnp.asarray(params),
                     tuple(jnp.asarray(x) for x in cot))
        return np.stack([np.asarray(x) for x in gr]), np.asarray(gp)

    rays = torch.from_numpy(rows).requires_grad_()
    tparams = torch.from_numpy(params).requires_grad_()
    reset_launch_counts()
    out = tmarch.march(rays, tparams, max_iterations=steps, integrator=integrator,
                       geodesics=geodesics)
    steps_taken = out[tmarch._OUT_FIXED["steps"]].detach().numpy()
    if kerr:
        assert steps_taken.max() < steps  # every lane is done: same as STEPS
    gr_t, gp_t = torch.autograd.grad(out, (rays, tparams), torch.from_numpy(g))
    name = tmarch.KERNEL_NAMES[tmarch._mode(integrator, geodesics)]
    assert replay_counts()[name] == 1
    gr_t, gp_t = gr_t.numpy(), gp_t.numpy()
    assert np.isfinite(gr_t).all() and np.isfinite(gp_t).all()

    gr_j, _ = want(g)
    ok = np.abs(gr_t - gr_j) <= 1e-5 + 1e-3 * np.abs(gr_j)
    assert ok.mean() >= 0.995, f"{1 - ok.mean():.3%} of ray cotangents differ"

    chaotic = ~ok.all(0) | (steps_taken >= steps)
    assert chaotic.mean() < 0.05
    g_calm = g * ~chaotic
    _, gp_j = want(g_calm)
    (gp_t,) = torch.autograd.grad(
        tmarch.march(rays, tparams, max_iterations=steps, integrator=integrator,
                     geodesics=geodesics),
        tparams, torch.from_numpy(g_calm))
    gp_t = gp_t.numpy()
    sig = _significant(gp_j)
    assert sig[tmarch._P["mass"]] and sig[tmarch._P["spin"]] == kerr
    rel = _rel(gp_t, gp_j)
    assert rel[sig].max() <= 1e-3, {k: rel[i] for k, i in tmarch._P.items() if sig[i]}


# --- (b) composite, ingredients and sky -----------------------------------

def _slot_inputs():
    slots, cam = _slots()
    gain = np.random.default_rng(1).uniform(0.3, 1.7, (16, 16, 4)).astype(np.float32)
    return slots, cam, _params(), gain


def _hold_per_ray(got, want):
    """Per-ray cotangents: 99.5% of entries within rtol 1e-3 / atol 1e-4,
    and every one within 1e-3 of the largest.  The forward values agree to
    1e-4, but two slopes carry their float32 rounding further: the
    texel's finest Perlin octave (density 100), whose chain rule sums
    terms of order 100 that cancel, and the reference's degree-10 tint
    polynomial (ROADMAP C.1)."""
    frac = _close_frac(got, want, atol=1e-4)
    assert frac >= 0.995, frac
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-3, err


def _hold_shift_path(got, want):
    """Camera-distance cotangents, which reach the color only through the
    gravitational shift and the slope of the tint polynomial: 95% of
    entries within rtol 1e-2 / atol 1e-6 of the largest, and every one
    within 5e-3 of the largest.  The polynomial's float32 rounding noise
    (~1e-3 in value near shift 1, ROADMAP C.1) is larger in its slope
    (measured: 98.3% of entries within 1e-2, largest error 2.0e-3)."""
    scale = np.abs(want).max()
    err = np.abs(got - want)
    frac = float((err <= 1e-2 * np.abs(want) + 1e-6 * scale).mean())
    assert frac >= 0.95, frac
    assert err.max() <= 5e-3 * scale, err.max() / scale


@pytest.mark.parametrize("show_texture, show_redshift", [(True, True), (True, False),
                                                         (False, True)],
                         ids=["texture+redshift", "texture", "redshift"])
def test_composite_vjp_matches_jnp(show_texture, show_redshift):
    """The composite Function's cotangents of the slots, camera distances,
    the 16 shade parameters and ``disk_gain`` against ``jax.vjp`` of
    ``_composite_jnp``.  The gain is sampled by a direct 2x2 fetch here and
    by the hat basis there: the same bilinear weights, so the same
    cotangent, scatter-added into the four texels."""
    slots, cam, params, gain = _slot_inputs()
    kcfg = ShadeKernelConfig(max_crossings=4, show_texture=show_texture,
                             show_redshift=show_redshift)
    g = np.random.default_rng(2).normal(size=(4, slots.shape[1])).astype(np.float32)
    want = _jax_vjp(lambda s, c, p, ga: _composite_jnp(s, c, p, ga, kcfg),
                    (tuple(jnp.asarray(r) for r in slots), jnp.asarray(cam),
                     jnp.asarray(params), jnp.asarray(gain)),
                    tuple(jnp.asarray(x) for x in g))
    want = [np.stack([np.asarray(r) for r in want[0]]), *(np.asarray(w) for w in want[1:])]
    reset_launch_counts()
    got = _grads(lambda *a: tshade.composite(*a, show_texture=show_texture,
                                            show_redshift=show_redshift),
                 [torch.from_numpy(x) for x in (slots, cam, params, gain)],
                 torch.from_numpy(g))
    assert replay_counts()["composite"] == 1
    got = [x.numpy() for x in got]
    assert all(np.isfinite(x).all() for x in got)
    _hold_per_ray(got[0], want[0])
    # The camera distance enters only the gravitational shift, the gain
    # only the texture.
    if show_redshift:
        _hold_shift_path(got[1], want[1])
    else:
        assert not want[1].any() and not got[1].any()
    if show_texture:
        assert (np.abs(got[3]) > 0.0).mean() > 0.5  # the gain grid is reached
    else:
        assert not want[3].any() and not got[3].any()
    # Parameters and gain sum over the 600 rays: held relative to their
    # largest entry.
    for name, gt, wt in zip(("params", "gain"), got[2:], want[2:]):
        if wt.any():
            err = np.abs(gt - wt).max() / np.abs(wt).max()
            assert err <= 1e-3, (name, err)


@pytest.mark.parametrize("show_redshift", [True, False], ids=["redshift", "plain"])
def test_ingredients_vjp_matches_jnp(show_redshift):
    slots, cam, params, _ = _slot_inputs()
    kcfg = ShadeKernelConfig(max_crossings=4, show_texture=True, show_redshift=show_redshift)
    g = np.random.default_rng(3).normal(size=(4 * tshade.ING_FIELDS, slots.shape[1]))
    g = g.astype(np.float32)
    want = _jax_vjp(lambda s, c, p: _ingredients_jnp(s, c, p, kcfg),
                    (tuple(jnp.asarray(r) for r in slots), jnp.asarray(cam),
                     jnp.asarray(params)),
                    tuple(jnp.asarray(x) for x in g))
    want = [np.stack([np.asarray(r) for r in want[0]]), *(np.asarray(w) for w in want[1:])]
    reset_launch_counts()
    got = _grads(lambda *a: tshade.ingredients(*a, show_redshift=show_redshift),
                 [torch.from_numpy(x) for x in (slots, cam, params)], torch.from_numpy(g))
    assert replay_counts()["ingredients"] == 1
    got = [x.numpy() for x in got]
    assert all(np.isfinite(x).all() for x in got)
    _hold_per_ray(got[0], want[0])
    if show_redshift:
        _hold_shift_path(got[1], want[1])
    err = np.abs(got[2] - want[2]).max() / np.abs(want[2]).max()
    assert err <= 1e-3, err


@pytest.mark.parametrize("interleaved", [False, True], ids=["rows", "interleaved"])
def test_sky_vjp_matches_jnp(interleaved):
    """The sky Functions' cotangent of the record: 99.5% of entries within
    rtol 1e-3 / atol 1e-4 (the forward's own quantile gate: a star splat's
    edge moves with the last bit of the uv mapping), the color and amount
    rows exactly as the reference's (the color passes through, amount
    scales the sky radiance)."""
    rec = _record()
    g = np.random.default_rng(4).normal(size=(3, rec.shape[1])).astype(np.float32)
    kcfg = SkyKernelConfig(show_sky=True)
    reset_launch_counts()
    if interleaved:
        want = np.asarray(_jax_vjp(lambda r: _sky_finalize_jnp(r, kcfg),
                                   (jnp.asarray(rec.T),), jnp.asarray(g.T))[0]).T
        (got,) = _grads(tsky.sky_finalize, [torch.from_numpy(rec.T.copy())],
                        torch.from_numpy(g.T.copy()))
        got = got.numpy().T
    else:
        (want,) = _jax_vjp(lambda r: _sky_rows_jnp(r, kcfg),
                           (tuple(jnp.asarray(r) for r in rec),),
                           tuple(jnp.asarray(x) for x in g))
        want = np.stack([np.asarray(r) for r in want])
        (got,) = _grads(tsky.sky_rows, [torch.from_numpy(rec)], torch.from_numpy(g))
        got = got.numpy()
    assert replay_counts()["sky_finalize" if interleaved else "sky"] == 1
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:3], g)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-3, atol=1e-4)
    assert np.abs(want[5:]).max() > 0.0
    assert _close_frac(got, want, atol=1e-4) >= 0.995


@pytest.mark.parametrize("stage", ["bloom", "mix", "tonemap", "fxaa"])
def test_post_stage_vjp_matches(stage):
    """Each post stage's cotangent against ``jax.vjp`` of bhx's; FXAA's
    blend weight carries none (the reference stops its gradient)."""
    img = _chw()
    g = np.random.default_rng(6).normal(size=img.shape).astype(np.float32)
    if stage == "mix":
        def jfn(x):
            return jpost.mix_pass(x, x[:, ::-1] * 0.5, 0.7)

        def tfn(x):
            return tpost.mix_pass(x, torch.flip(x, [1]) * 0.5, 0.7)
    else:
        def jfn(x):
            return _stage(stage, jpost, x)

        def tfn(x):
            return _stage(stage, tpost, x)
    (want,) = _jax_vjp(jfn, (jnp.asarray(img),), jnp.asarray(g))
    (got,) = _grads(tfn, [torch.from_numpy(img)], torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


# --- (c) the render against bhx's kernel path -------------------------------

GRAD_CFG = dataclasses.replace(FAST_CFG, width=24, height=14, max_iterations=200)


# bhx's kernel path (Pallas in interpret mode), the gradient reference.
KERNEL_CFG = dataclasses.replace(
    GRAD_CFG, march_mode="pallas_interpret", pallas_vote_every=4, pallas_unroll=4,
    pallas_sublanes=8, pallas_shade_sublanes=8,
)


def _replace(scene, **leaves):
    """``scene`` (of either package) with black-hole fields, camera fields
    (``cam_`` prefix, as in ``bhx.parallel.scene_params``), ``disk_gain``
    or ``time`` replaced."""
    bh = {k: v for k, v in leaves.items() if k in ("mass", "spin", "disk_rotation",
                                                    "disk_inner", "disk_outer", "feather")}
    cam = {k[4:]: v for k, v in leaves.items() if k.startswith("cam_")}
    top = {k: v for k, v in leaves.items() if k in ("disk_gain", "time")}
    return dataclasses.replace(scene, black_hole=dataclasses.replace(scene.black_hole, **bh),
                               camera=dataclasses.replace(scene.camera, **cam), **top)


def _port_grads(scene, cfg, weights, names):
    """d/d(named leaves) of sum(weights * render) on the port."""
    leaves = {n: getattr(scene, n) if n in ("disk_gain", "time") else
              getattr(scene.camera, n[4:]) if n.startswith("cam_") else
              getattr(scene.black_hole, n) for n in names}
    leaves = {n: v.detach().clone().requires_grad_() for n, v in leaves.items()}
    loss = (bhx_torch.render(_replace(scene, **leaves), cfg) * torch.from_numpy(weights)).sum()
    return dict(zip(names, (g.numpy() for g in torch.autograd.grad(loss, list(leaves.values())))))


def test_render_grad_matches_bhx_kernel_path():
    """d/d(mass, disk_gain, camera position, fov) of sum(w * image) at
    24x14: the port on the CPU (plain march forward, replayed backward)
    against ``jax.grad`` through bhx's kernel path, with the weights
    (``default_rng(0)``) zero off the FD-stable pixels.  Each gradient
    within 1e-3 of its largest entry (measured 1e-5 to 2.3e-4: the two
    programs round differently along 200 steps)."""
    scene, cfg = _torch_scene(), torch_cfg(GRAD_CFG)
    stable = fd_stable(scene, cfg, ["mass", "cam_fov", "cam_position"])
    assert stable.mean() > 0.4
    w = (np.random.default_rng(0).random(stable.shape) * stable).astype(np.float32)

    jscene = small_scene()
    names = ["mass", "disk_gain", "cam_position", "cam_fov"]

    def loss(*vals):
        return jnp.sum(jax_render(_replace(jscene, **dict(zip(names, vals))), KERNEL_CFG) * w)

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(
        jscene.black_hole.mass, jscene.disk_gain, jscene.camera.position, jscene.camera.fov)
    want = dict(zip(names, (np.asarray(x) for x in want)))
    reset_launch_counts()
    got = _port_grads(scene, cfg, w, names)
    counts = replay_counts()
    assert counts["march"] == 2 and counts["composite"] == 1 and counts["sky"] == 1
    for k in names:
        assert np.isfinite(got[k]).all(), k
        err = np.abs(got[k] - want[k]).max() / np.abs(want[k]).max()
        assert err <= 1e-3, (k, err)
    assert (np.abs(want["disk_gain"]) > 0).mean() > 0.1  # texels the frame reaches


@functools.lru_cache(maxsize=1)
def _jax_pose_grad():
    """d/d(yaw, pitch) of sum(w * render) through bhx's kernel path, with
    the camera ``rotated(yaw, pitch)``: one compile for every pose."""
    jscene = small_scene()

    def loss(yaw, pitch, w):
        cam = jscene.camera.rotated(yaw, pitch)
        return jnp.sum(jax_render(dataclasses.replace(jscene, camera=cam), KERNEL_CFG) * w)

    return jax.jit(jax.grad(loss, argnums=(0, 1)))


@pytest.mark.parametrize("yaw, pitch", [(0.35, -0.15), (-0.6, 0.3)])
def test_pose_grad_matches_bhx_kernel_path(yaw, pitch):
    """d/d(yaw, pitch) of sum(w * image) at 24x14 through
    ``Camera.rotated``: the port on the CPU against ``jax.grad`` through
    bhx's kernel path, with the weights (``default_rng(0)``) zero off the
    pixels FD-stable along yaw and along pitch.  Within 1e-3 of the larger
    entry."""
    scene, cfg = _torch_scene(), torch_cfg(GRAD_CFG)
    angles = torch.tensor([yaw, pitch])
    stable = pose_fd_stable(scene, cfg, angles)
    assert stable.mean() > 0.4
    w = (np.random.default_rng(0).random(stable.shape) * stable).astype(np.float32)
    want = np.asarray(_jax_pose_grad()(jnp.float32(yaw), jnp.float32(pitch), jnp.asarray(w)))
    a = angles.clone().requires_grad_()
    reset_launch_counts()
    loss = (bhx_torch.render(rotated(scene, a), cfg) * torch.from_numpy(w)).sum()
    (got,) = torch.autograd.grad(loss, a)
    counts = replay_counts()
    assert counts["march"] == 2 and counts["composite"] == 1 and counts["sky"] == 1
    got = got.numpy()
    assert np.isfinite(got).all() and np.abs(want).min() > 0.0
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 1e-3, (got, want, err)


def test_render_grad_reaches_every_fitted_leaf():
    """Every leaf ``bhx.parallel`` fits, ``disk_gain`` and ``time`` gets a
    finite, non-zero gradient, spin under exact Kerr geodesics; the cached
    constants stay out of every graph and keep their values.  The wide
    field of view sends rays out of the relativity sphere in the feather's
    band."""
    cached = [const((0.0, -1.0, 0.0), torch.device("cpu")),
              const((0.0, 0.0, 1.0), torch.device("cpu"))]
    before = [c.clone() for c in cached]
    names = ["mass", "disk_rotation", "disk_inner", "disk_outer", "feather",
             "cam_position", "cam_fov", "disk_gain", "time"]
    cfg = torch_cfg(GRAD_CFG).replace(tonemap=True)
    scene = _replace(bhx_torch.Scene.default("cpu"), cam_fov=torch.tensor(2.0))
    w = np.random.default_rng(0).random((cfg.height, cfg.width, 3)).astype(np.float32)
    for geodesics, extra in (("pseudo", []), ("kerr", ["spin"])):
        s = with_spin(scene, 0.6) if geodesics == "kerr" else scene
        got = _port_grads(s, cfg.replace(geodesics=geodesics), w, names + extra)
        for n, g in got.items():
            assert np.isfinite(g).all() and np.abs(g).max() > 0.0, (geodesics, n)
    for c, b in zip(cached, before):
        assert not c.requires_grad and c.grad_fn is None and torch.equal(c, b)


# --- (d) the ladder against the port's own finite differences ---------------

def test_ladder_grad_matches_fd():
    """Gradient parity through the coarse-to-fine ladder's copy /
    interpolate / re-trace select (tests/test_grad.py:146-186 on the
    port): d/dmass of sum(w * image) against central differences, with the
    FD itself required stable under halving the step."""
    cfg = torch_cfg(dataclasses.replace(
        FAST_CFG, use_ladder=True, width=40, height=23, max_iterations=128,
        ladder=JaxLadderConfig(base=(14, 9), multiplier=3, levels=2)))
    scene = _torch_scene()
    w = torch.from_numpy(np.random.default_rng(3).uniform(0.1, 1.0, (23, 40, 3))
                         .astype(np.float32))

    def f(mass):
        bh = dataclasses.replace(scene.black_hole, mass=mass)
        return (w * bhx_torch.render(dataclasses.replace(scene, black_hole=bh), cfg)).sum()

    mass = torch.tensor(0.5, requires_grad=True)
    (g_ad,) = torch.autograd.grad(f(mass), mass)
    g_ad = float(g_ad)

    def fd(e):
        return (float(f(torch.tensor(0.5 + e))) - float(f(torch.tensor(0.5 - e)))) / (2.0 * e)

    fd1, fd2 = fd(1e-3), fd(5e-4)
    assert np.isfinite(g_ad) and g_ad != 0.0
    assert abs(fd1 - fd2) <= 0.1 * max(abs(fd1), abs(fd2)), (fd1, fd2)
    assert abs(g_ad - fd1) <= 0.1 * max(abs(g_ad), abs(fd1)), (g_ad, fd1)


# --- (e) each Function's backward against plain autograd --------------------

@pytest.mark.parametrize("integrator, geodesics", [("euler", "pseudo"), ("rk45", "pseudo"),
                                                   ("euler", "kerr")],
                         ids=["euler", "rk45", "kerr"])
def test_march_replay_equals_plain_autograd(integrator, geodesics, monkeypatch):
    """The replay in chunks of 40 rays and segments of 8 steps, with lanes
    that enter inactive or without budget, equals autograd straight through
    ``march_torch``: ray cotangents to rounding, parameter cotangents (a
    sum over chunks) to 1e-5 relative."""
    monkeypatch.setattr(tmarch, "REPLAY_CHUNK_RAYS", 40)
    monkeypatch.setattr(tmarch, "SEGMENT_STEPS", 8)
    rows, params = _setup_kerr() if geodesics == "kerr" else _setup()
    rows = rows[:, :128].copy()
    rows[7, ::5] = 0.0
    rows[9, 1::7] = float(STEPS)
    kw = dict(max_iterations=60, integrator=integrator, geodesics=geodesics)
    g = torch.from_numpy(np.random.default_rng(5).normal(
        size=(tmarch.out_fields(geodesics), rows.shape[1])).astype(np.float32))
    inputs = [torch.from_numpy(rows), torch.from_numpy(params)]
    got = _grads(lambda r, p: tmarch.march(r, p, **kw), inputs, g)
    want = _grads(lambda r, p: tmarch.march_torch(r, p, **kw), inputs, g)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    assert float(want[1].abs().max()) > 0.0


def test_shade_and_sky_replays_equal_plain_autograd():
    """The composite, ingredients and both sky Functions' backward equal
    autograd through their plain versions exactly: the replay is the same
    operations on the same inputs."""
    slots, cam, params, gain = (torch.from_numpy(x) for x in _slot_inputs())
    rng = np.random.default_rng(7)

    def cot(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    n = slots.shape[1]
    cases = [
        (tshade.composite, tshade.composite_torch, [slots, cam, params, gain], cot(4, n)),
        (tshade.ingredients, tshade.ingredients_torch, [slots, cam, params],
         cot(4 * tshade.ING_FIELDS, n)),
    ]
    rec = torch.from_numpy(_record())
    cases += [(tsky.sky_rows, tsky.sky_rows_torch, [rec], cot(3, rec.shape[1])),
              (tsky.sky_finalize, tsky.sky_finalize_torch, [rec.t().contiguous()],
               cot(rec.shape[1], 3))]
    for fn, plain, inputs, g in cases:
        for got, want in zip(_grads(fn, inputs, g), _grads(plain, inputs, g)):
            torch.testing.assert_close(got, want, rtol=0, atol=0)
