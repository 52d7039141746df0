"""A run with the timed path broken underneath comes out not correct: the
rest of a run (the harness, its drivers, the reference and the
comparison) on the CPU at a small size, with one fault planted in the
program each time.  The faults are those each cell can have: a step that
returns its state unchanged (from the start, or only once the first
steps are past); half of the batch left out, the mean taken over the
rest; an answer altered where it is produced.  (These cells run
on one card, with no exchange between cards to leave out; the fit over
ranks has its own faults in ``test_bench_fit_sharded.py``.)"""

import pytest
import torch

import bhx_torch
from bhx_torch import parallel
from benchmark import harness

SMALL = dict(width=40, height=24, max_iterations=120)
real_render = bhx_torch.render
real_loss = parallel.loss_fn
real_step = parallel.train_step


def _stale():
    """Every frame is the first one: the state never moves on."""
    first = []

    def render(scene, cfg):
        if not first:
            first.append(real_render(scene, cfg))
        return first[0]
    return render


def _half_rows(scene, cfg):
    """The top half of the frame rendered; the rest left out."""
    img = real_render(scene, cfg)
    return torch.cat([img[: img.shape[0] // 2], torch.zeros_like(img[img.shape[0] // 2:])])


def _altered(scene, cfg):
    """One channel altered where the frame is produced."""
    img = real_render(scene, cfg).clone()
    img[..., 2] = torch.clamp(img[..., 2] + 0.05, 0.0, 1.0)
    return img


@pytest.mark.parametrize("fault", ["sound", "stale", "half_rows", "altered"])
def test_orbit_faults(monkeypatch, fault):
    render = {"stale": _stale(), "half_rows": _half_rows, "altered": _altered}.get(fault)
    if render is not None:
        monkeypatch.setattr(bhx_torch, "render", render)
    result = harness.run_cell("euler.orbit", 2**31 + 11, 4.0, False, device="cpu",
                              overrides=SMALL)
    assert result["attempted"] >= 3
    assert result["correct"] is (fault == "sound"), result["checks"]


def _frozen(params, optimizer, scene, target, cfg, mesh=None):
    """A step that returns the state unchanged."""
    return parallel.loss_fn(params, scene, target, cfg).detach()


def _frozen_later():
    """Sound steps until the first three are past, then steps that return
    the state unchanged."""
    calls = []

    def step(params, optimizer, scene, target, cfg, mesh=None):
        calls.append(1)
        if len(calls) <= 3:
            return real_step(params, optimizer, scene, target, cfg)
        return _frozen(params, optimizer, scene, target, cfg)
    return step


def _half_loss(params, scene, target, cfg, mesh=None):
    """The loss over the frame's top half: half of the batch left out."""
    img = bhx_torch.render(parallel.apply_params(scene, params), cfg)
    h = img.shape[0] // 2
    return torch.mean((img[:h] - target[:h]) ** 2)


def _altered_loss(params, optimizer, scene, target, cfg, mesh=None):
    """The loss altered where the step produces it, by a tenth."""
    return real_step(params, optimizer, scene, target, cfg) * 1.1


@pytest.mark.parametrize("fault", ["sound", "frozen", "frozen_later", "half_batch", "altered"])
def test_fit_faults(monkeypatch, fault):
    if fault == "frozen":
        monkeypatch.setattr(parallel, "train_step", _frozen)
    elif fault == "frozen_later":
        monkeypatch.setattr(parallel, "train_step", _frozen_later())
    elif fault == "half_batch":
        monkeypatch.setattr(parallel, "loss_fn", _half_loss)
    elif fault == "altered":
        monkeypatch.setattr(parallel, "train_step", _altered_loss)
    result = harness.run_cell("euler.fit", 2**31 + 12, 0.1, False, device="cpu",
                              overrides=dict(width=32, height=18, max_iterations=100))
    assert result["correct"] is (fault == "sound"), result["checks"]
