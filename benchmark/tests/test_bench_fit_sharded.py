"""The fit over more than one rank (the fit cell over two and over four
ranks, with ``euler.fit``'s limits and ``rank_gap``, exact): the rest of a
run on the CPU at a small size, the ranks joined through gloo.  A sound run is correct with every rank's
parameters equal to rank 0's.  With a fault planted in every rank's
program the run is not correct: the gradients' sum over the ranks left
out (each rank steps on its own band's gradient), a step that returns its
state unchanged, half of the batch left out, the loss altered where the
step produces it.  A rank that raises ends the run, well before its
deadline."""

import functools
import json
import time

import pytest
import torch

from bhx_torch import parallel
from benchmark import harness, spec
from benchmark.drivers import fit as fit_driver
from benchmark.drivers import ranks
from benchmark.drivers.common import reference_side
from benchmark.reference import fit as ref_fit
from benchmark.reference import frame as ref_frame
from benchmark.tests.conftest import scratch_root

SMALL = dict(width=40, height=24, max_iterations=120)
SEED = 2**31 + 23
real_step = parallel.train_step


def _own_gradient(t, mesh, op=None):
    """The sum over the ranks left out: this rank's gradient alone."""
    return t.detach().clone()


def _frozen(params, optimizer, scene, target, cfg, mesh=None):
    """A step that returns the state unchanged."""
    return parallel.loss_fn(params, scene, target, cfg, mesh).detach()


def _half_loss(params, scene, target, cfg, mesh=None):
    """The loss over the frame's top half: half of the batch left out."""
    img = parallel._step_image(parallel.apply_params(scene, params), cfg, mesh)
    h = img.shape[0] // 2
    return torch.mean((img[:h] - target[:h]) ** 2)


def _altered(params, optimizer, scene, target, cfg, mesh=None):
    """The loss altered where the step produces it, by a tenth."""
    return real_step(params, optimizer, scene, target, cfg, mesh) * 1.1


def _raises():
    """A step that raises on its second call."""
    calls = []

    def step(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("a planted fault")
        return real_step(*a, **kw)
    return step


FAULTS = {"no_all_reduce": ("_all_reduce", _own_gradient), "frozen": ("train_step", _frozen),
          "half_batch": ("loss_fn", _half_loss), "altered": ("train_step", _altered)}


def _faulty_rank(fault, *args):
    """A child rank with ``fault`` planted in its program."""
    attr, value = FAULTS[fault] if fault in FAULTS else ("train_step", _raises())
    setattr(parallel, attr, value)
    fit_driver.rank_main(*args)


def _run(cell, root, seconds=0.5):
    return harness.run_cell(cell, SEED, seconds, False, device="cpu", overrides=SMALL,
                            root=root)


@pytest.fixture
def ranks_root(tmp_path):
    """A checkout whose BENCHMARK.json adds the fit over two and over four
    ranks, each held to ``euler.fit``'s limits and to ``rank_gap`` 0:
    every rank applies the same summed gradient."""
    limits = json.loads((spec.HERE / "limits" / "euler.fit.json").read_text())
    limits["rank_gap"] = {"limit": 0.0}
    cells = [dict(name=f"euler.fit.{n}chip", config="bhusie_euler_1080p", traffic="fit",
                  chips=n, why="test") for n in (2, 4)]
    return scratch_root(tmp_path, workloads=cells, files={
        f"benchmark/limits/{c['name']}.json": limits for c in cells})


@pytest.mark.parametrize("chips", [2, 4])
def test_sharded_fit_is_correct(ranks_root, chips):
    result = _run(f"euler.fit.{chips}chip", ranks_root)
    assert result["device"]["count"] == chips
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["rank_gap"] == {"value": 0.0, "limit": 0.0}
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_sharded_fit_faults(ranks_root, monkeypatch, fault):
    monkeypatch.setattr(parallel, *FAULTS[fault])
    monkeypatch.setattr(fit_driver, "rank_main", functools.partial(_faulty_rank, fault))
    checks = _run("euler.fit.2chip", ranks_root)["checks"]
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
    if fault == "no_all_reduce":
        assert checks["rank_gap"]["value"] > 0.0
        assert checks["grad_gap"]["value"] > checks["grad_gap"]["limit"]


def test_a_rank_that_raises_ends_the_run(ranks_root, monkeypatch):
    monkeypatch.setattr(fit_driver, "rank_main", functools.partial(_faulty_rank, "raises"))
    start = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1"):
        _run("euler.fit.2chip", ranks_root, seconds=30.0)
    assert time.monotonic() - start < ranks.RANK_TIMEOUT_S
    assert not torch.distributed.is_initialized()


def test_reference_bands_sum_to_the_frame():
    """The reference's frame traced in bands of rows is its whole frame to
    the bit, and the bands' gradient sum is the whole frame's gradient to
    rounding."""
    cell = spec.load("euler.fit")
    render = {**cell.config["render"], **cell.traffic["render"], **SMALL}
    cfg, scene = reference_side(render, cell.config["scene"], "cpu")
    start = fit_driver.reference_params(cell.config["scene"], cell.traffic["params"], "cpu")
    with torch.no_grad():
        whole = ref_frame.render(scene, cfg)
        assert torch.equal(ref_frame.render([scene] * 3, cfg), whole)
    target = fit_driver.make_target(scene, cfg, cell.traffic, SEED, "cpu")
    grads = []
    for bands in (1, 4):
        leaves = {k: v.clone().requires_grad_() for k, v in start.items()}
        loss = ref_fit.backward(leaves, scene, target, cfg, {}, bands=bands)
        grads.append({k: v.grad for k, v in leaves.items() if v.grad is not None})
    assert sorted(grads[0]) == sorted(grads[1])
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=1e-5, atol=1e-7 * float(g.abs().max()))
    assert loss == float(torch.mean((whole - target) ** 2))
