"""The frozen reference against the program on the CPU at a tiny size:
the frame (dense and on the ladder, Euler and RK45, through a rotated
camera) and the fit step.  On the CPU both run plain PyTorch in the same
order of operations, so they agree bit for bit."""

import dataclasses

import pytest
import torch

import bhx_torch
from bhx_torch import parallel
from benchmark import port, spec
from benchmark.drivers import fit as fit_driver
from benchmark.drivers.common import reference_side
from benchmark.reference import fit as ref_fit
from benchmark.reference import frame as ref_frame
from benchmark.reference.scene import posed


def _sides(cell_name, device="cpu", **overrides):
    cell = spec.load(cell_name)
    render = dict(cell.config["render"], **overrides)
    numbers = cell.config["scene"]
    cfg, scene = port.render_config(render), port.scene(numbers, device)
    rcfg, rscene = reference_side(render, numbers, device)
    return cfg, scene, rcfg, rscene


@pytest.mark.parametrize("cell", ["euler.orbit", "rk45.orbit"])
@pytest.mark.parametrize("use_ladder", [False, True])
def test_frame_matches_program(cell, use_ladder):
    cfg, scene, rcfg, rscene = _sides(cell, width=64, height=36, max_iterations=200,
                                      use_ladder=use_ladder)
    yaw, pitch, t = (torch.tensor(v) for v in (0.3, -0.12, 1.25))
    got = bhx_torch.render(dataclasses.replace(
        scene, camera=scene.camera.rotated(yaw, pitch), time=t), cfg)
    want = ref_frame.render(posed(rscene, yaw, pitch, t), rcfg)
    assert got.shape == want.shape == (36, 64, 3)
    assert float(want.std()) > 0.01  # a frame with content
    assert torch.equal(got, want)


def test_fit_steps_match_program():
    cell = spec.load("euler.fit")
    traffic = cell.traffic
    render = {**cell.config["render"], **traffic["render"], "width": 40, "height": 24,
              "max_iterations": 120}
    numbers = cell.config["scene"]
    rcfg, rscene = reference_side(render, numbers, "cpu")
    target = fit_driver.make_target(rscene, rcfg, traffic, 3, "cpu")
    cfg, scene = port.render_config(render), port.scene(numbers, "cpu")
    params = {k: v.detach().clone().requires_grad_()
              for k, v in parallel.scene_params(scene).items()}
    opt = parallel.make_optimizer(params, traffic["lr"])
    losses = [float(parallel.train_step(params, opt, scene, target, cfg)) for _ in range(2)]
    start = fit_driver.reference_params(numbers, traffic["params"], "cpu")
    ref = ref_fit.fit_steps(start, rscene, target, rcfg, 2, traffic["lr"])
    assert losses == ref["losses"]
    for k, p in params.items():
        assert torch.allclose(p.detach() - start[k], ref["change"][k], rtol=0, atol=1e-6), k


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["euler.orbit", "rk45.orbit"])
def test_graphed_march_is_the_eager_one(card, cell):
    """On the card the reference replays its march segments as a CUDA
    graph; the frame is the uncaptured one to the bit."""
    _, _, rcfg, rscene = _sides(cell, card, width=480, height=271)
    yaw, pitch, t = (torch.tensor(v, device=card) for v in (0.3, -0.12, 1.25))
    s = posed(rscene, yaw, pitch, t)
    with torch.no_grad():
        graphed = ref_frame.render(s, rcfg)
        eager = ref_frame.render(s, rcfg, dict(graphed=False))
    assert torch.equal(graphed, eager)
