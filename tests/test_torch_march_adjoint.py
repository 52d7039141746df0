"""The march's backward pass: which route it takes, and the Euler adjoint
kernel against ``march_replay``.

On the CPU: CPU tensors, and the RK45 and Kerr branches anywhere, take
``march_replay``; CUDA tensors under Euler take ``euler_adjoint``; every
backward pass counts in ``kernels.replay_counts``; the profiler's counters
``replay.march_calls`` / ``replay.march_adjoints`` count only while a
profiler records.

On the card (marked ``gpu``, skipped without a CUDA device): the kernel
against ``march_replay`` on the same inputs (seeded rays of a dense
240x135 frame and rays across the photon ring, random cotangents on all
41 rows) by the gate of ``checks.compare_march_adjoint`` (bit-identical
ray rows, mass and disk normal), two calls equal bit for bit, and the
fault control (the slot cotangents dropped) failing the gate.  On a
machine with a card:

    python -m pytest --noconftest -m gpu tests/test_torch_march_adjoint.py
"""

from __future__ import annotations

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import bhx_torch
from bhx_torch import checks, profiling
from bhx_torch.kernels import adjoint_counts, entries, replay_counts, reset_launch_counts
from bhx_torch.kernels import march as tmarch
from bhx_torch.scene import with_spin
from bhx_torch.tracer import march_batch, march_kwargs

W, H = 240, 135


def _cfg(max_iterations: int, show_disk: bool = True, **kw) -> bhx_torch.RenderConfig:
    return bhx_torch.RenderConfig(width=W, height=H, use_ladder=False,
                                  max_iterations=max_iterations, show_disk=show_disk, **kw)


def _cotangent(n: int, device, rows: int = tmarch.out_fields(), seed: int = 5) -> torch.Tensor:
    g = np.random.default_rng(seed).standard_normal((rows, n))
    return torch.tensor(g, dtype=torch.float32, device=device)


# --- the route, on the CPU ---------------------------------------------------

@pytest.mark.parametrize("device,integrator,geodesics,route", [
    ("cuda", "euler", "pseudo", "adjoint"),
    ("cuda", "rk45", "pseudo", "replay"),
    ("cuda", "euler", "kerr", "replay"),
    ("cpu", "euler", "pseudo", "replay"),
])
def test_backward_route(monkeypatch, device, integrator, geodesics, route):
    taken = []
    monkeypatch.setattr(tmarch, "euler_adjoint", lambda *a, **kw: taken.append("adjoint"))
    monkeypatch.setattr(tmarch, "march_replay", lambda *a, **kw: taken.append("replay"))
    rays = types.SimpleNamespace(device=torch.device(device))
    tmarch.march_backward(rays, None, None, max_iterations=10, integrator=integrator,
                          geodesics=geodesics)
    assert taken == [route]


def _cpu_backward(integrator: str = "euler", geodesics: str = "pseudo"):
    scene = bhx_torch.Scene.default("cpu")
    cfg = bhx_torch.RenderConfig(width=16, height=9, use_ladder=False, max_iterations=60,
                                 integrator=bhx_torch.Integrator[integrator.upper()],
                                 geodesics=geodesics)
    if geodesics == "kerr":
        scene = with_spin(scene, 0.9)
    rays, params, _ = march_batch(scene, cfg, 16, 9)
    kw = march_kwargs(cfg)
    rays, params = rays.requires_grad_(), params.requires_grad_()
    out = tmarch.march(rays, params, **kw)
    g = _cotangent(out.shape[1], "cpu", rows=out.shape[0])
    got = torch.autograd.grad(out, (rays, params), g)
    want = tmarch.march_replay(rays.detach(), params.detach(), g, **kw)
    return got, want


@pytest.mark.parametrize("integrator,geodesics,name", [
    ("euler", "pseudo", "march"), ("rk45", "pseudo", "march_rk45"),
    ("euler", "kerr", "march_kerr")])
def test_cpu_backward_is_the_replay_and_counts(integrator, geodesics, name):
    reset_launch_counts()
    (got_r, got_p), (want_r, want_p) = _cpu_backward(integrator, geodesics)
    assert torch.equal(got_r, want_r) and torch.equal(got_p, want_p)
    # The autograd backward and the direct call: two replays, no adjoint.
    assert replay_counts()[name] == 2
    assert adjoint_counts() == {"march": 0}


def test_backward_counters_count_only_while_recording():
    profiling.reset_counts()
    _cpu_backward()
    assert profiling.counts()[profiling.MARCH_BACKWARDS] == 0
    assert profiling.counts()[profiling.MARCH_ADJOINTS] == 0
    with profile(activities=[ProfilerActivity.CPU]):
        _cpu_backward()
        profiling.count_march_backward(adjoint=True)
    counts = profiling.counts()
    profiling.reset_counts()
    # Two replays (autograd's and the direct call's), one counted adjoint.
    assert (counts[profiling.MARCH_BACKWARDS], counts[profiling.MARCH_ADJOINTS]) == (3, 1)
    assert profiling.counts()[profiling.MARCH_BACKWARDS] == 0


def test_reset_zeroes_the_adjoint_count():
    for _ in range(3):
        entries.count(entries.ADJOINT, "march")
    assert adjoint_counts() == {"march": 3}
    reset_launch_counts()
    assert adjoint_counts() == {"march": 0}


# --- the kernel, on the card -------------------------------------------------

@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rays(card, cfg, inactive: bool, ring: bool = False):
    rays, params, _ = march_batch(bhx_torch.Scene.default(card), cfg, W, H)
    rays = rays.contiguous()
    if ring:
        # From the camera at (0, 0, -19), across the photon ring's critical
        # impact parameter (polar angle 0.13734-0.13785 from the line to the
        # hole, in the y-z plane), with the disk's inner edge at 1.1, inside
        # the photon sphere: up to 6 crossings a ray (285 over K), horizon
        # hits, and rays that run past 400 substeps.
        theta = torch.linspace(0.13734, 0.13785, rays.shape[1], device=card)
        rays[3] = 0.0
        rays[4] = torch.sin(theta)
        rays[5] = torch.cos(theta)
        params = params.clone()
        params[tmarch._P["disk_inner"]] = 1.1
    if inactive:
        # Lanes that enter inactive, and lanes with steps done whose budget
        # ends inside a segment (and one step before it).
        rays[7, ::7] = 0.0
        rays[9, 1::5] = 45.0
        rays[9, 2::11] = float(cfg.max_iterations - 1)
    return rays, params


@pytest.mark.gpu
@pytest.mark.parametrize("max_iterations,show_disk,inactive,ring", [
    (400, True, True, False), (400, True, False, False), (400, False, True, False),
    (37, True, True, False), (400, True, True, True), (2000, True, False, True)])
def test_adjoint_matches_the_replay(card, max_iterations, show_disk, inactive, ring):
    cfg = _cfg(max_iterations, show_disk)
    rays, params = _rays(card, cfg, inactive, ring)
    r = checks.compare_march_adjoint(rays, params, _cotangent(rays.shape[1], card), cfg)
    assert r["ok"], r
    if ring:
        # The cases the adjoint must follow: lanes with more than K
        # crossings, and horizon hits.
        assert r["over_k"] > 0 and r["horizon_hits"] > 0, r


@pytest.mark.gpu
def test_fault_control_fails_the_gate(card):
    cfg = _cfg(400)
    rays, params = _rays(card, cfg, True)
    r = checks.compare_march_adjoint(rays, params, _cotangent(rays.shape[1], card), cfg,
                                     drop_slots=True)
    assert not r["ok"] and r["max_abs_err"] > 0.0 and r["diff_frac"] > 0.0, r


@pytest.mark.gpu
def test_no_live_lane(card):
    # As a trace's re-entry round often has it: every lane entered done.
    cfg = _cfg(400)
    rays, params = _rays(card, cfg, False)
    rays[7] = 0.0
    r = checks.compare_march_adjoint(rays, params, _cotangent(rays.shape[1], card), cfg)
    assert r["ok"] and r["live"] == 0, r


@pytest.mark.gpu
def test_no_lanes(card):
    cfg = _cfg(400)
    rays = torch.zeros((tmarch.IN_FIELDS, 0), device=card)
    params = march_batch(bhx_torch.Scene.default(card), cfg, 4, 4)[1]
    gr, gp = tmarch.euler_adjoint(rays, params, torch.zeros((tmarch.out_fields(), 0),
                                                            device=card), max_iterations=400)
    assert gr.shape == (tmarch.IN_FIELDS, 0) and torch.equal(gp, torch.zeros_like(params))


@pytest.mark.gpu
def test_autograd_on_the_card_takes_the_adjoint(card):
    reset_launch_counts()
    # The counts since the reset: the Euler backward's adjoint, then none.
    for integrator, name, adjoints in (("euler", "march", 1), ("rk45", "march_rk45", 1)):
        cfg = _cfg(100, integrator=bhx_torch.Integrator[integrator.upper()])
        rays, params, _ = march_batch(bhx_torch.Scene.default(card), cfg, 32, 18)
        params = params.requires_grad_()
        out = tmarch.march(rays, params, **march_kwargs(cfg))
        (gp,) = torch.autograd.grad(out, params, _cotangent(out.shape[1], card))
        torch.cuda.synchronize()
        assert bool(torch.isfinite(gp).all())
        assert replay_counts()[name] == 1 and adjoint_counts()["march"] == adjoints
