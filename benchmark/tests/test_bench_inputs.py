"""The inputs a run makes from its seed: the same seed gives the same
orbit and target, and both sides are handed the same numbers."""

import numpy as np
import torch

from benchmark import port, spec
from benchmark.drivers import fit, orbit
from benchmark.drivers.common import reference_side
from benchmark.reference.scene import posed

BIG = 2**31 + 12345


def test_orbit_poses_repeat_and_differ_by_seed():
    traffic = spec.load("euler.orbit").traffic
    a, b = orbit.poses(traffic, BIG, 50), orbit.poses(traffic, BIG, 50)
    assert a.dtype == np.float32 and a.shape == (50, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, orbit.poses(traffic, BIG + 1, 50))
    w = traffic["warmup_frames"]
    assert np.allclose(a[w:, 2], traffic["time_start"] + np.arange(48) / 60.0)
    assert np.all(np.abs(a[:, 0]) <= traffic["yaw_amplitude"] + 1e-6)
    assert np.all(np.abs(a[:, 1]) <= traffic["pitch_amplitude"] + 1e-6)


def test_both_sides_get_the_same_pose():
    cell = spec.load("euler.orbit")
    table = orbit.poses(cell.traffic, BIG, 8)
    scene = port.scene(cell.config["scene"], "cpu")
    _, rscene = reference_side(cell.config["render"], cell.config["scene"], "cpu")
    row = torch.from_numpy(table)[5]
    got = scene.camera.rotated(row[0], row[1]).forward
    want = posed(rscene, *(torch.tensor(float(v)) for v in table[5])).camera.forward
    assert torch.equal(got, want)
    assert torch.equal(scene.camera.position, rscene.camera.position)
    for f in ("mass", "disk_rotation", "disk_inner", "disk_outer", "feather"):
        assert torch.equal(getattr(scene.black_hole, f), getattr(rscene.black_hole, f))


def test_fit_target_repeats():
    cell = spec.load("euler.fit")
    traffic = cell.traffic
    render = {**cell.config["render"], **traffic["render"], "width": 24, "height": 16,
              "max_iterations": 80}
    rcfg, rscene = reference_side(render, cell.config["scene"], "cpu")
    a = fit.make_target(rscene, rcfg, traffic, BIG, "cpu")
    b = fit.make_target(rscene, rcfg, traffic, BIG, "cpu")
    c = fit.make_target(rscene, rcfg, traffic, BIG + 7, "cpu")
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
