"""bhx_torch.parallel on the CPU: bring-up, the tile-sharded trace and
render, the sharded train step, bench_scaling, ``render --sharded`` under
torchrun and ``dryrun_multichip``, over 2 and 4 gloo ranks spawned in
processes of their own, against the port's dense single-process path and
against bhx.parallel on the 8-device CPU mesh.  Inputs are
``small_scene()`` through ``scene_from_state``.

Each spawned world has its own timeout and kills its ranks; one world of 2
ranks and one of 4 run every job of their size once (module fixtures)."""

from __future__ import annotations

import concurrent.futures
import dataclasses
import datetime
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

import bhx.config as jcfg
import bhx.parallel as jpar
from bhx.scene import scene_to_state

import bhx_torch
from bhx_torch import parallel as tpar
from bhx_torch import tracer as ttracer

from tests import torch_rank_programs as progs
from tests.common import FAST_CFG, cube_mesh, outside_camera, small_scene
from tests.test_torch_api import _parity
from tests.test_torch_pipeline import REPO, _bad_frac, torch_cfg

torch.set_num_threads(2)

SPAWN_TIMEOUT_S = 120.0

# Trace cases: (world size, width, height, with the cube); 37 rows are
# ragged for both world sizes.
TRACE_CASES = [(2, 48, 40, False), (2, 48, 37, False), (4, 48, 40, False), (4, 48, 37, False),
               (2, 48, 40, True)]
POST_CFG = dataclasses.replace(FAST_CFG, width=48, height=40, tonemap=True,
                               bloom=jcfg.BloomConfig(enabled=True),
                               fxaa=jcfg.FxaaConfig(enabled=True))
# The sharded train step: test_dist.py's size and march budget.
TRAIN_STEPS, TRAIN_LR = 5, 5e-3
TRAIN_CFGS = {
    "post_off": dataclasses.replace(FAST_CFG, width=32, height=16, max_iterations=60),
    "post_on": dataclasses.replace(FAST_CFG, width=32, height=16, max_iterations=60,
                                   tonemap=True, bloom=jcfg.BloomConfig(enabled=True),
                                   fxaa=jcfg.FxaaConfig(enabled=True)),
}


def _jax_scene(cube: bool):
    scene = small_scene()
    if cube:
        scene = dataclasses.replace(scene, meshes=(cube_mesh(),), camera=outside_camera())
    return scene


def _case_cfg(w: int, h: int):
    return dataclasses.replace(FAST_CFG, width=w, height=h)


def _state(cube: bool = False):
    return scene_to_state(_jax_scene(cube))


def _tscene(cube: bool = False):
    return bhx_torch.scene_from_state(_state(cube), "cpu")


def _train_target(cfg):
    """The port's render at mass 0.55, the target of the train step."""
    scene = _tscene()
    return bhx_torch.render(tpar.apply_params(scene, dict(tpar.scene_params(scene), mass=0.55)),
                            cfg).detach().numpy()


def _spawn(jobs, n):
    return tpar.spawn(tpar.run_jobs, n, device="cpu", timeout=SPAWN_TIMEOUT_S, args=(jobs,))


def _keyed(by_rank, keys):
    """{key: [rank 0's result, rank 1's, ...]} of run_jobs' results."""
    return {key: [r[i] for r in by_rank] for i, key in enumerate(keys)}


@pytest.fixture(scope="module")
def worlds():
    """One world of 2 ranks and one of 4, spawned at once from two threads,
    while this process computes the references: bhx.parallel's records and
    post-chain frame on the 8-device mesh and the port's dense records.

    The 2-rank world runs its trace cases, the post-chain frame, the train
    step with the post chain off and on, bench_scaling over [1, 2], and
    last lists the jax / bhx modules each rank had imported; the 4-rank
    world runs its trace cases."""
    two_keys = [c for c in TRACE_CASES if c[0] == 2] + ["post"]
    two_jobs = [(tpar.frame_job, (_state(cube), torch_cfg(_case_cfg(w, h))))
                for _, w, h, cube in two_keys[:-1]]
    two_jobs.append((tpar.frame_job, (_state(), torch_cfg(POST_CFG))))
    for name, cfg in TRAIN_CFGS.items():
        two_keys.append(name)
        two_jobs.append((tpar.fit_job, (_state(), _train_target(torch_cfg(cfg)), torch_cfg(cfg),
                                        TRAIN_STEPS, TRAIN_LR)))
    two_keys += ["bench", "modules"]
    two_jobs += [(tpar.bench_job, (_state(), torch_cfg(_case_cfg(32, 16)), [1, 2], 2)),
                 (progs.foreign_modules, ())]
    four_keys = [c for c in TRACE_CASES if c[0] == 4]
    four_jobs = [(tpar.frame_job, (_state(cube), torch_cfg(_case_cfg(w, h))))
                 for _, w, h, cube in four_keys]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        two = pool.submit(_spawn, two_jobs, 2)
        four = pool.submit(_spawn, four_jobs, 4)
        mesh8 = jpar.tile_mesh(jax.devices()[:8])
        out = dict(
            bhx={(w, h, cube): np.asarray(jpar.trace_image_sharded(
                _jax_scene(cube), _case_cfg(w, h), mesh8, w, h))
                for _, w, h, cube in TRACE_CASES},
            bhx_post=np.asarray(jpar.render_sharded(small_scene(), POST_CFG, mesh8)),
            dense={(w, h, cube): ttracer.trace_image_record(
                _tscene(cube), torch_cfg(_case_cfg(w, h)), w, h).numpy()
                for _, w, h, cube in TRACE_CASES},
            dense_post=bhx_torch.render(_tscene(), torch_cfg(POST_CFG)).numpy())
        out.update(_keyed(two.result(), two_keys))
        out.update(_keyed(four.result(), four_keys))
    return out


# --- bring-up ---

def test_init_distributed_noop_without_coordinator(monkeypatch):
    def boom(*a, **kw):  # must not be reached
        raise AssertionError("init_process_group called without a coordinator")

    monkeypatch.setattr(dist, "init_process_group", boom)
    for var in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    tpar.init_distributed()
    assert not dist.is_initialized()


def test_init_distributed_failure_surfaced_cleanly(monkeypatch):
    """A failed rendezvous carries the coordinator and the process's
    identity, in bhx's words (tests/test_dist.py)."""
    def boom(*a, **kw):
        raise ConnectionError("rendezvous timed out")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match=r"coordinator='badhost:1'.*"
                       r"num_processes=2.*process_id=0.*reachable"):
        tpar.init_distributed(coordinator="badhost:1", num_processes=2, process_id=0)


def test_init_distributed_missing_peer_fails_within_timeout():
    """A coordinator that nobody serves: the rendezvous gives up after its
    timeout instead of hanging."""
    coordinator = f"localhost:{tpar.free_port()}"
    with pytest.raises(RuntimeError, match="reachable"):
        tpar.init_distributed(coordinator, num_processes=2, process_id=1, backend="gloo",
                              timeout=datetime.timedelta(seconds=2))
    assert not dist.is_initialized()


def test_tile_mesh_is_a_world_of_one_without_a_group():
    mesh = tpar.tile_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device) == (None, 0, 1, torch.device("cpu"))
    with pytest.raises(ValueError):
        tpar.tile_mesh(group=object(), device="cpu")


@pytest.mark.parametrize("device,local_ranks,cards,want", [
    ("cuda", 4, 4, "nccl"),  # torchrun over 2 hosts of 4 cards: a world of 8
    ("cuda", 2, 1, "gloo"),  # 2 ranks sharing one card
    ("cpu", 1, 4, "gloo"),
])
def test_init_distributed_takes_default_backend(monkeypatch, device, local_ranks, cards, want):
    """With no backend named, init_distributed takes default_backend's,
    which counts the ranks on this host (LOCAL_WORLD_SIZE) against its
    cards, whatever the world size."""
    seen = {}

    def record(backend, **kw):
        seen.update(kw, backend=backend)

    monkeypatch.setattr(dist, "init_process_group", record)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: device == "cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    for var, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", "29500"),
                       ("WORLD_SIZE", "8"), ("RANK", "5"),
                       ("LOCAL_WORLD_SIZE", str(local_ranks))):
        monkeypatch.setenv(var, value)
    assert tpar.default_backend(device) == want
    tpar.init_distributed()
    assert (seen["backend"], seen["world_size"], seen["rank"]) == (want, 8, 5)


@pytest.mark.parametrize("launch", ["spawn", "dryrun_multichip"])
def test_launchers_run_on_the_card_unless_asked(monkeypatch, launch):
    """spawn and dryrun_multichip with no device named ask for the card,
    and raise before any rank starts when there is none."""
    from bhx_torch.entry import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        if launch == "spawn":
            tpar.spawn(progs.rank_one_raises, 2)
        else:
            dryrun_multichip(2)


@pytest.mark.parametrize("program,error", [
    (progs.rank_one_raises, "rank 1 failed"),
    (progs.rank_one_dies, "rank 1 exited with code 3"),
])
def test_spawn_raises_for_a_failed_rank(program, error):
    with pytest.raises(RuntimeError, match=error):
        tpar.spawn(program, 2, device="cpu", timeout=60)


def test_spawn_kills_a_hung_world():
    with pytest.raises(TimeoutError):
        tpar.spawn(progs.rank_one_hangs, 2, device="cpu", timeout=5)


# --- a world of one ---

@pytest.mark.parametrize("w,h", [(48, 40), (48, 37)])
def test_world_of_one_trace_equals_dense(w, h):
    scene, cfg = _tscene(), torch_cfg(_case_cfg(w, h))
    got = tpar.trace_image_sharded(scene, cfg, tpar.tile_mesh(device="cpu"), w, h)
    want = ttracer.trace_image_record(scene, cfg, w, h)
    assert got.shape == (h, w, 8)
    assert float((got - want).abs().max()) == 0.0


def test_world_of_one_render_sharded_equals_render():
    """render_sharded finalizes through the interleaved sky's plain version,
    render through the rows' one; both are ``_sky_rows``."""
    scene, cfg = _tscene(), torch_cfg(POST_CFG)
    got = tpar.render_sharded(scene, cfg)
    want = bhx_torch.render(scene, cfg)
    assert float((got - want).abs().max()) <= 1e-6


# --- the tile-sharded trace and render ---

CASE_IDS = [f"{n}ranks-{w}x{h}{'-cube' if c else ''}" for n, w, h, c in TRACE_CASES]


@pytest.mark.parametrize("case", TRACE_CASES, ids=CASE_IDS)
def test_sharded_trace_equals_dense(case, worlds):
    want = worlds["dense"][case[1:]]
    for r in worlds[case]:
        assert r["record"].shape == want.shape
        assert float(np.abs(r["record"] - want).max()) <= 1e-6, r["rank"]


@pytest.mark.parametrize("case", TRACE_CASES, ids=CASE_IDS)
def test_sharded_trace_matches_bhx(case, worlds):
    for r in worlds[case]:
        _parity(r["record"], worlds["bhx"][case[1:]])


def test_cube_is_in_view(worlds):
    """The cube case sees the cube: its record differs from the bare one."""
    assert not np.array_equal(worlds["dense"][(48, 40, True)], worlds["dense"][(48, 40, False)])


def test_render_sharded_equals_dense_render(worlds):
    for r in worlds["post"]:
        assert float(np.abs(r["image"] - worlds["dense_post"]).max()) <= 1e-6, r["rank"]


def test_render_sharded_matches_bhx(worlds):
    for r in worlds["post"]:
        bad = _bad_frac(r["image"], worlds["bhx_post"])
        assert bad <= 0.02, f"rank {r['rank']}: {bad:.2%} pixels differ by more than 2e-2"


def test_ranks_load_no_jax_or_bhx(worlds):
    assert worlds["modules"] == [[], []]


# --- the sharded train step ---

def _single_step(name):
    """One single-process train_step from the same scene and target:
    (loss, gradients, parameters after the update)."""
    cfg = torch_cfg(TRAIN_CFGS[name])
    scene = _tscene()
    params = {k: v.detach().clone().requires_grad_() for k, v in tpar.scene_params(scene).items()}
    loss = tpar.train_step(params, tpar.make_optimizer(params, TRAIN_LR), scene,
                           torch.from_numpy(_train_target(cfg)), cfg)
    return (float(loss), {k: v.grad.numpy() for k, v in params.items()},
            {k: v.detach().numpy() for k, v in params.items()})


@pytest.mark.parametrize("name", list(TRAIN_CFGS))
def test_sharded_step_equal_across_ranks(worlds, name):
    a, b = worlds[name]
    assert a["losses"] == b["losses"]
    for pa, pb in zip(a["params"], b["params"]):
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


@pytest.mark.parametrize("name", list(TRAIN_CFGS))
def test_sharded_step_matches_single_process(worlds, name):
    """The first sharded step's loss, summed gradients and updated
    parameters against one single-process step: rtol 1e-5, since the
    all-reduce sums the bands' gradients in another order."""
    loss, grads, params = _single_step(name)
    r = worlds[name][0]
    np.testing.assert_allclose(r["losses"][0], loss, rtol=1e-5)
    assert set(r["grads"][0]) == set(grads)
    for k, g in grads.items():
        np.testing.assert_allclose(r["grads"][0][k], g, rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(r["params"][0][k], params[k], rtol=1e-5, err_msg=k)
    assert any(np.any(g != 0) for g in grads.values())


@pytest.mark.parametrize("name", list(TRAIN_CFGS))
def test_sharded_step_loss_falls(worlds, name):
    losses = worlds[name][0]["losses"]
    assert len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses


def test_sharded_step_with_ladder_raises():
    mesh = tpar.TileMesh(None, 0, 2, torch.device("cpu"))
    scene = _tscene()
    params = {k: v.detach().clone().requires_grad_() for k, v in tpar.scene_params(scene).items()}
    cfg = torch_cfg(TRAIN_CFGS["post_off"]).replace(use_ladder=True)
    with pytest.raises(ValueError, match="use_ladder"):
        tpar.train_step(params, tpar.make_optimizer(params), scene,
                        torch.zeros(16, 32, 3), cfg, mesh)


# --- bench_scaling ---

def test_bench_scaling_rows(worlds):
    keys = {"devices", "seconds", "rays_per_s", "mrays_per_s", "efficiency",
            "overhead_efficiency", "platform", "device_kind"}
    a, b = worlds["bench"]
    assert a == b  # every rank reports the slowest rank's times
    assert [r["devices"] for r in a] == [1, 2]
    assert a[0]["efficiency"] == 1.0
    for r in a:
        assert set(r) == keys and (r["platform"], r["device_kind"]) == ("cpu", "cpu")
        for k in keys - {"platform", "device_kind"}:
            assert np.isfinite(r[k]) and r[k] > 0, (k, r)


# --- the command line under torchrun, and the dry run ---

def test_cli_render_sharded_under_torchrun(tmp_path):
    """Two processes under torchrun write one PNG, equal to a single
    process's dense render."""
    png = tmp_path / "sharded.png"
    args = ["render", "--device", "cpu", "--width", "32", "--height", "18",
            "--max-iterations", "300"]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--nnodes", "1", "--master-addr", "localhost",
           "--master-port", str(tpar.free_port()), "-m", "bhx_torch", *args,
           "--sharded", "-o", str(png)]
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("on 2 ranks") == 1, out.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["sharded.png"]
    from bhx_torch.cli import main
    from bhx_torch.io import load_image

    single = tmp_path / "single.png"
    assert main([*args, "--no-ladder", "-o", str(single)]) == 0
    np.testing.assert_array_equal(load_image(str(png)), load_image(str(single)))


def test_dryrun_multichip_on_the_cpu(capsys):
    from bhx_torch.entry import dryrun_multichip

    dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip(2): one sharded train step ok" in out, out
