"""The kernel entries' one seam (``bhx_torch.kernels.entries``) on the CPU.

Each of the five differentiable entries (the march, the composite, the
ingredients, the sky on record rows and on an interleaved record) runs its
plain version for CPU tensors, bit for bit, and launches nothing; its
backward under autograd is its replay, bit for bit, counted once under its
kernel's name.  Beside them: the dispatch by device and the flags' way
through the one ``autograd.Function``, and the counts' reset.
"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import bhx_torch
from bhx_torch import checks, kernels
from bhx_torch.kernels import entries
from bhx_torch.kernels import march as tmarch
from bhx_torch.kernels import shade as tshade
from bhx_torch.kernels import sky as tsky
from bhx_torch.tracer import march_batch, march_kwargs

N = 64


@functools.lru_cache(maxsize=1)
def _scene():
    return bhx_torch.Scene.default("cpu")


def _slots(seed: int = 0):
    """Random crossing slots (K*7 rows hx hy hz dx dy dz valid) and camera
    distances."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-9, 9, (4, 3, N))
    dirs = rng.normal(size=(4, 3, N))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    valid = (rng.uniform(size=(4, 1, N)) < 0.5).astype(np.float64)
    slots = np.concatenate([pos, dirs, valid], axis=1).reshape(tshade.SLOT_ROWS, N)
    cam = rng.uniform(15, 25, (N,))
    return (torch.tensor(slots, dtype=torch.float32), torch.tensor(cam, dtype=torch.float32))


def _record(seed: int = 2):
    """(8, N) record rows: color, alpha, amount, a unit escape direction."""
    rng = np.random.default_rng(seed)
    rec = rng.uniform(0, 1, (tsky.RECORD_ROWS, N))
    d = rng.normal(size=(3, N))
    rec[5:8] = d / np.linalg.norm(d, axis=0, keepdims=True)
    return torch.tensor(rec, dtype=torch.float32)


def _march_case():
    cfg = bhx_torch.RenderConfig(width=16, height=4, use_ladder=False, max_iterations=40)
    rays, params, _ = march_batch(_scene(), cfg, 16, 4)
    return (rays, params), march_kwargs(cfg)


def _composite_case():
    slots, cam = _slots()
    gain = torch.rand((16, 16, 4), generator=torch.Generator().manual_seed(1)) + 0.5
    return (slots, cam, checks.shade_params(_scene()), gain), dict(show_texture=True,
                                                                   show_redshift=True)


def _ingredients_case():
    slots, cam = _slots(3)
    return (slots, cam, checks.shade_params(_scene())), dict(show_texture=True,
                                                             show_redshift=True)


# name -> (entry, plain version, replay, inputs and flags, kernel name)
CASES = {
    "march": (tmarch.march, tmarch.march_torch, tmarch.march_replay, _march_case, "march"),
    "composite": (tshade.composite, tshade.composite_torch, tshade.composite_replay,
                  _composite_case, "composite"),
    "ingredients": (tshade.ingredients, tshade.ingredients_torch, tshade.ingredients_replay,
                    _ingredients_case, "ingredients"),
    "sky_rows": (tsky.sky_rows, tsky.sky_rows_torch, tsky.sky_rows_replay,
                 lambda: ((_record(),), dict(show_sky=True)), "sky"),
    "sky_finalize": (tsky.sky_finalize, tsky.sky_finalize_torch, tsky.sky_finalize_replay,
                     lambda: ((_record().t().contiguous().reshape(8, 8, 8),),
                              dict(show_sky=True)), "sky_finalize"),
}


@pytest.mark.parametrize("name", CASES)
def test_cpu_tensors_run_the_plain_version(name):
    entry, plain, _, case, _ = CASES[name]
    inputs, flags = case()
    kernels.reset_launch_counts()
    got = entry(*inputs, **flags)
    assert torch.equal(got, plain(*inputs, **flags))
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("name", CASES)
def test_backward_is_the_replay_counted_once(name):
    entry, _, replay, case, kernel = CASES[name]
    inputs, flags = case()
    leaves = [t.clone().requires_grad_() for t in inputs]
    out = entry(*leaves, **flags)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(7))
    kernels.reset_launch_counts()
    got = torch.autograd.grad(out, leaves, g)
    counts = kernels.replay_counts()
    assert counts == {**dict.fromkeys(counts, 0), kernel: 1}
    want = replay(*inputs, g, **flags)
    want = (want,) if torch.is_tensor(want) else want
    assert len(got) == len(want) == len(inputs)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert any(bool(w.abs().sum() > 0) for w in want)
    assert not any(kernels.launch_counts().values())
    assert kernels.adjoint_counts() == {"march": 0}


def test_entry_dispatches_by_device_and_passes_flags():
    """CPU tensors take the plain version, any other device the launcher;
    the flags reach all three by keyword, and a backward of one tensor may
    give its cotangent alone."""
    calls = []

    def plain(x, *, scale):
        calls.append(("plain", x.device.type, scale))
        return x * scale

    def launch(x, *, scale):
        calls.append(("launch", x.device.type, scale))
        return torch.empty_like(x)

    def backward(x, grad_out, *, scale):
        calls.append(("backward", x.device.type, scale))
        return grad_out * scale

    entry = entries.Entry(plain, launch, backward)
    x = torch.arange(3.0, requires_grad=True)
    (gx,) = torch.autograd.grad(entry(x, scale=2.0).sum(), x)
    assert torch.equal(gx, torch.full((3,), 2.0))
    entry(torch.empty(3, device="meta"), scale=3.0)
    assert calls == [("plain", "cpu", 2.0), ("backward", "cpu", 2.0), ("launch", "meta", 3.0)]


def test_reset_zeroes_every_kind():
    for kind, name in ((entries.LAUNCH, "mesh"), (entries.REPLAY, "sky"),
                       (entries.ADJOINT, "march")):
        entries.count(kind, name)
    assert (kernels.launch_counts()["mesh"], kernels.replay_counts()["sky"],
            kernels.adjoint_counts()["march"]) == (1, 1, 1)
    kernels.reset_launch_counts()
    for counts in (kernels.launch_counts(), kernels.replay_counts(),
                   kernels.adjoint_counts()):
        assert not any(counts.values())
