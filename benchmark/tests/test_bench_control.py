"""The controls of the correctness check come out not correct: the
reference put in the program's place, one precision step down (the
bloom's products in TF32 for the orbit cells; the march state in bfloat16
for the fit, which has no product for TF32 to change), and the fit's
fault "half of the batch left out", each compared with the reference as a
run compares the program, at a size that a test run can hold, on three
seeds.  Needs the card (TF32 exists only there)."""

import pytest

from benchmark import control, spec

pytestmark = pytest.mark.gpu
SIZE = dict(width=480, height=271)
SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.parametrize("workload", ["euler.orbit", "rk45.orbit"])
def test_orbit_tf32_control_fails(card, workload):
    cell = spec.load(workload)
    for seed in SEEDS:
        rows = {r["control"]: r for r in control.orbit_controls(cell, seed, card, 300, SIZE)}
        assert any(rows["tf32"][m] > limit for m, limit in cell.limits.items()), rows


def test_fit_controls_fail(card):
    cell = spec.load("euler.fit")
    for seed in SEEDS:
        for r in control.fit_controls(cell, seed, card, dict(SIZE, max_iterations=200)):
            assert any(r[m] > limit for m, limit in cell.limits.items()), r
