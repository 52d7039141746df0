"""The port's exact-Kerr frame against the benchmark's plain reference, on
the CPU at a small size.

Both sides are built from the benchmark's Kerr configuration
(``benchmark/configs/bhusie_kerr09_1080p.json``) through the benchmark's
own adapters, as a run of the cell ``kerr09.orbit`` builds them, and
render the same posed frame: the port through ``bhx_torch.render`` (the
ladder and the tracer's Kerr straight and march phases), the reference
through ``benchmark.reference.frame.render``.  The reference is the
port's plain path frozen, so on the CPU the frames are equal bit for bit,
dense and on the ladder, at spins about the configuration's and through
camera poses of the cell's own orbit."""

from __future__ import annotations

import dataclasses
import json

import pytest
import torch

import bhx_torch
from benchmark import port, spec
from benchmark.drivers.common import reference_side
from benchmark.drivers.orbit import pose_rows
from benchmark.reference import frame as ref_frame
from benchmark.reference.scene import posed

torch.set_num_threads(2)

CELL = "kerr09.orbit"
CONFIG = spec.ROOT / "benchmark/configs/bhusie_kerr09_1080p.json"
SMALL = dict(width=64, height=36, max_iterations=200)
SPINS = (0.5, 0.9, 0.99)
# Two frames of the orbit traffic under a fixed seed.
POSE_SEED, POSE_FRAMES = 2**31 + 20, (0, 97)


def _poses():
    traffic = json.loads((spec.HERE / "workloads" / "orbit.json").read_text())
    return [tuple(float(v) for v in row)
            for row in pose_rows(traffic, POSE_SEED, POSE_FRAMES)]


@pytest.mark.parametrize("pose", range(len(POSE_FRAMES)))
@pytest.mark.parametrize("spin", SPINS)
@pytest.mark.parametrize("use_ladder", [False, True], ids=["dense", "ladder"])
def test_kerr_frame_equals_reference(use_ladder, spin, pose):
    config = json.loads(CONFIG.read_text())
    render = dict(config["render"], use_ladder=use_ladder, **SMALL)
    numbers = config["scene"]
    numbers["black_hole"]["spin"] = spin
    cfg, scene = port.render_config(render), port.scene(numbers, "cpu")
    rcfg, rscene = reference_side(render, numbers, "cpu")
    assert cfg.geodesics == rcfg.geodesics == "kerr"
    assert float(scene.black_hole.spin) == pytest.approx(spin)

    yaw, pitch, t = (torch.tensor(v) for v in _poses()[pose])
    got = bhx_torch.render(
        dataclasses.replace(scene, camera=scene.camera.rotated(yaw, pitch), time=t), cfg)
    want = ref_frame.render(posed(rscene, yaw, pitch, t), rcfg)
    assert got.shape == want.shape == (36, 64, 3)
    assert float(want.std()) > 0.01  # a frame with content
    assert torch.equal(got, want)


def test_cell_is_the_kerr_configuration():
    cell = spec.load(CELL)
    assert cell.chips == 1
    assert cell.config["name"] == "bhusie_kerr09_1080p"
    assert cell.config["render"]["geodesics"] == "kerr"
    assert cell.config["scene"]["black_hole"]["spin"] == 0.9
    assert cell.config["reduced"] == []
    assert set(cell.limits) == {"mean_abs_err", "bad_frac"}
    assert "frame_p95_ms" in cell.end_to_end and "setup_s" in cell.end_to_end
    assert "march_roofline.frame" in cell.per_layer
