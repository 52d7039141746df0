"""A configuration may name exact Kerr geodesics: the frozen reference's
Kerr march against the program on the CPU at a tiny size (the frame,
dense and on the ladder, through a rotated camera, and the march work it
counts), the roofline's Kerr prices, and a rehearsal of an orbit cell over
a Kerr configuration.  A configuration without the key reads as before."""

import dataclasses
import json

import pytest
import torch

import bhx_torch
from bhx_torch import checks, tracer
from bhx_torch.kernels import march as program_march
from benchmark import harness, port, spec, tracing
from benchmark.drivers.common import reference_side
from benchmark.metrics import _bound
from benchmark.reference import frame as ref_frame
from benchmark.reference.config import Config
from benchmark.reference.scene import posed
from benchmark.tests.conftest import scratch_root

SPIN = 0.9
SMALL = dict(width=64, height=36, max_iterations=200)
POSE = (0.3, -0.12, 1.25)


def _kerr_config():
    """The Euler configuration under exact Kerr geodesics at spin 0.9."""
    config = json.loads((spec.ROOT / "benchmark/configs/bhusie_euler_1080p.json").read_text())
    config["name"] = "kerr09_test"
    config["render"]["geodesics"] = "kerr"
    config["scene"]["black_hole"]["spin"] = SPIN
    return config


def _sides(**overrides):
    config = _kerr_config()
    render = dict(config["render"], **overrides)
    numbers = config["scene"]
    cfg, scene = port.render_config(render), port.scene(numbers, "cpu")
    rcfg, rscene = reference_side(render, numbers, "cpu")
    yaw, pitch, t = (torch.tensor(v) for v in POSE)
    posed_program = dataclasses.replace(scene, camera=scene.camera.rotated(yaw, pitch), time=t)
    return cfg, posed_program, rcfg, posed(rscene, yaw, pitch, t)


@pytest.mark.parametrize("use_ladder", [False, True])
def test_kerr_frame_matches_program(use_ladder):
    cfg, scene, rcfg, rscene = _sides(use_ladder=use_ladder, **SMALL)
    assert cfg.geodesics == rcfg.geodesics == "kerr"
    got = bhx_torch.render(scene, cfg)
    want = ref_frame.render(rscene, rcfg)
    assert got.shape == want.shape == (36, 64, 3)
    assert float(want.std()) > 0.01  # a frame with content
    assert torch.equal(got, want)


def test_kerr_march_work_matches_program(monkeypatch):
    """The reference's (live rays, lane-substeps) of each march equal the
    program's: its march inputs' active rows and its record's steps."""
    cfg, scene, rcfg, rscene = _sides(use_ladder=True, **SMALL)
    seen = []
    real = tracer.march

    def counted(rays, params, **kw):
        out = real(rays, params, **kw)
        assert kw["geodesics"] == "kerr" and rays.shape[0] == 13 and out.shape[0] == 44
        seen.append((int((rays[7] > 0.5).sum()),
                     float(out[program_march._OUT_FIXED["steps"]].sum(dtype=torch.float64))))
        return out

    monkeypatch.setattr(tracer, "march", counted)
    bhx_torch.render(scene, cfg)
    work = []
    ref_frame.render(rscene, rcfg, dict(work=work))
    assert [(int(a), float(b)) for a, b in work] == seen
    assert len(seen) == 8 and sum(s for _, s in seen) > 0


def test_configs_without_the_key_read_as_before():
    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        render = json.loads((spec.ROOT / c["file"]).read_text())["render"]
        assert "geodesics" not in render
        pseudo = dict(render, geodesics="pseudo")
        assert port.render_config(render) == port.render_config(pseudo)
        assert port.render_config(render).geodesics == "pseudo"
        assert Config.from_render(render) == Config.from_render(pseudo)
        assert Config.from_render(render).geodesics == "pseudo"
    with pytest.raises(ValueError):
        Config.from_render(dict(render, geodesics="schwarzschild"))


def test_kerr_bound_is_the_programs_count():
    for branch, kernel in (("euler", "march"), ("rk45", "march_rk45"), ("kerr", "march_kerr")):
        assert _bound.SUBSTEP_OPS[branch] == checks.SUBSTEP_OPS[kernel]
        assert _bound.SUBSTEP_MUFU[branch] == checks.SUBSTEP_MUFU[kernel]
        geodesics = "kerr" if branch == "kerr" else "pseudo"
        rows = program_march.in_fields(geodesics) + program_march.out_fields(geodesics)
        assert _bound.RAY_BYTES[branch] == rows * 4
    assert (_bound.SUBSTEP_OPS["kerr"], _bound.SUBSTEP_MUFU["kerr"]) == (922, 150)


def test_roofline_prices_the_march_branch():
    kerr_render = _kerr_config()["render"]
    assert _bound.march_branch(kerr_render) == "kerr"
    assert _bound.march_branch(dict(kerr_render, geodesics="pseudo")) == "euler"
    rk45 = json.loads((spec.ROOT / "benchmark/configs/bhusie_rk45_1080p.json").read_text())
    assert _bound.march_branch(rk45["render"]) == "rk45"
    trace = tracing.Trace(device=[("march_kernel", 0, 1000)], host=[], lo=0, hi=2000, units=1,
                          info=dict(kind="orbit", integrator="kerr",
                                    march_work=[(1000.0, 5e5)]))
    got = tracing.reader("march_roofline.frame")(trace)
    ms = _bound.bound(5e5 * 922, 1000.0 * 57 * 4, 5e5 * 150)["bound_ms"]
    assert got == pytest.approx(100.0 * ms / 1e-3)


def test_kerr_orbit_rehearsal_is_correct(tmp_path):
    config = _kerr_config()
    root = scratch_root(
        tmp_path,
        configs=[dict(name="kerr09_test", source="https://github.com/cleggacus/bhusie",
                      file="benchmark/configs/kerr09_test.json", reduced=[], why="test")],
        workloads=[dict(name="kerr09.orbit", config="kerr09_test", traffic="orbit", chips=1,
                        why="test")],
        files={"benchmark/configs/kerr09_test.json": config,
               "benchmark/limits/kerr09.orbit.json": {"mean_abs_err": {"limit": 1e-5},
                                                      "bad_frac": {"limit": 5e-5}}})
    result = harness.run_cell("kerr09.orbit", 2**31 + 19, 1.0, False, device="cpu",
                              overrides=dict(width=40, height=24, max_iterations=120),
                              root=root)
    assert result["attempted"] >= 1
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["mean_abs_err"]["value"] == 0.0
