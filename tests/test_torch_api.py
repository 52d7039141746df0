"""The host side of bhx_torch on the CPU: the public tracer API against
``bhx.tracer`` / ``bhx.pipeline`` (``march_mode="fast"``), the FXAA
presets, ``render_tiled``'s checkpoints and retries (the cases of
``tests/test_io.py``), PNG and scene I/O between the two packages, the
command line, the viewer (the cases of ``tests/test_viewer.py``),
``profiling.profile_trace``, the port's entry point and ``bench.parity_check``'s
frame."""

from __future__ import annotations

import dataclasses
import io as _io
import itertools
import json
import os

import jax
import numpy as np
import pytest
import torch

import bhx.config as jcfg
import bhx.io as jio
import bhx.tracer as jtracer
from bhx.pipeline import ladder_trace as jax_ladder_trace
from bhx.pipeline import render_tiled as jax_render_tiled
from bhx.pipeline import sky_pass as jax_sky_pass
from bhx.scene import scene_to_state

import bhx_torch
from bhx_torch import io as tio
from bhx_torch import tracer as ttracer
from bhx_torch.pipeline import ladder_trace, render_tiled, sky_pass

from tests.common import FAST_CFG, cube_mesh, small_scene
from tests.test_torch_pipeline import _bad_frac, torch_cfg

torch.set_num_threads(2)

W, H = 32, 18


def _scenes():
    scene = small_scene()
    return scene, bhx_torch.scene_from_state(scene_to_state(scene), "cpu")


def _parity(got: np.ndarray, want: np.ndarray) -> None:
    """Alpha agrees on at least 98% of rays; at most 2% of rays differ by
    more than 2e-2 in any channel (the chaotic rays near the photon sphere
    part between any two float programs)."""
    assert got.shape == want.shape and np.isfinite(got).all()
    alpha_agree = float((got[..., 3] == want[..., 3]).mean())
    assert alpha_agree >= 0.98, alpha_agree
    bad = _bad_frac(got, want)
    assert bad <= 0.02, f"{bad:.2%} rays differ by more than 2e-2"


@pytest.fixture(scope="module")
def records():
    """The dense 32x18 record of small_scene from each package, (H, W, 8)."""
    jscene, tscene = _scenes()
    trace = jax.jit(jtracer.trace_image_record, static_argnums=(1, 2, 3))
    want = np.asarray(trace(jscene, FAST_CFG, W, H))
    got = ttracer.trace_image_record(tscene, torch_cfg(FAST_CFG), W, H)
    return got, want


def test_trace_image_record_matches_bhx(records):
    got, want = records
    _parity(got.numpy(), want)


def test_trace_rays_record_is_the_flat_image_record(records):
    _, tscene = _scenes()
    o, d = ttracer.camera_rays(tscene.camera, W, H)
    rec = ttracer.trace_rays_record(o.reshape(-1, 3), d.reshape(-1, 3), tscene,
                                    torch_cfg(FAST_CFG))
    assert rec.shape == (W * H, 8) and rec.is_contiguous()
    torch.testing.assert_close(rec, records[0].reshape(-1, 8), atol=0, rtol=0)


@pytest.mark.parametrize("mode", ["procedural", "array"])
def test_finalize_matches_bhx(records, mode):
    """bhx's record through both packages' finalize_image and finalize_sky,
    and the alpha-encoded result through their sky passes: the same input,
    so only the sky's arithmetic can differ."""
    jscene, tscene = _scenes()
    want_rec = records[1]
    rec = torch.from_numpy(np.array(want_rec))
    got_img = ttracer.finalize_image(rec, tscene.sky_texture, True, mode).numpy()
    want_img = np.asarray(jtracer.finalize_image(want_rec, jscene.sky_texture, True, mode))
    got_sky = ttracer.finalize_sky(rec, tscene.sky_texture, True, mode).numpy()
    want_sky = np.asarray(jtracer.finalize_sky(want_rec, jscene.sky_texture, True, mode))
    assert got_img.shape == (H, W, 3) and got_sky.shape == (H, W, 4)
    # Procedural stars turn a last-bit difference into a step on a few rays.
    for got, want in ((got_img, want_img), (got_sky, want_sky)):
        err = np.abs(got - want)
        assert np.quantile(err, 0.995) < 1e-4 and err.max() < 2e-2, err.max()
    np.testing.assert_array_equal(got_sky[..., 3], want_rec[..., 3])
    escape = want_rec[..., 3] == 0.0
    np.testing.assert_array_equal(got_sky[escape][:, :3], want_rec[escape][:, 5:8])
    no_sky = ttracer.finalize_image(rec, tscene.sky_texture, False, mode).numpy()
    np.testing.assert_array_equal(no_sky, want_rec[..., :3])
    # The sky pass of the alpha-encoded image.
    got_pass = sky_pass(torch.from_numpy(np.array(want_sky)), tscene.sky_texture, mode).numpy()
    want_pass = np.asarray(jax_sky_pass(want_sky, jscene.sky_texture, mode))
    err = np.abs(got_pass - want_pass)
    assert np.quantile(err, 0.995) < 1e-4 and err.max() < 2e-2, err.max()


@pytest.mark.parametrize("mode", ["procedural", "array"])
def test_trace_rays_and_image_match_bhx(mode):
    jscene, tscene = _scenes()
    cfg = dataclasses.replace(FAST_CFG, texture_mode=mode)
    trace = jax.jit(jtracer.trace_image, static_argnums=(1, 2, 3))
    want = np.asarray(trace(jscene, cfg, W, H))
    got = ttracer.trace_image(tscene, torch_cfg(cfg), W, H)
    assert got.shape == (H, W, 4)
    _parity(got.numpy(), want)
    o, d = ttracer.camera_rays(tscene.camera, W, H)
    rays = ttracer.trace_rays(o.reshape(-1, 3), d.reshape(-1, 3), tscene, torch_cfg(cfg))
    torch.testing.assert_close(rays, got.reshape(-1, 4), atol=0, rtol=0)
    assert bhx_torch.trace_rays is ttracer.trace_rays


def test_ladder_trace_matches_bhx():
    jscene, tscene = _scenes()
    cfg = dataclasses.replace(FAST_CFG, width=W, height=H, use_ladder=True,
                              ladder=jcfg.LadderConfig.for_resolution(W, H, levels=2))
    want = np.asarray(jax.jit(jax_ladder_trace, static_argnums=1)(jscene, cfg))
    got = ladder_trace(tscene, torch_cfg(cfg)).numpy()
    assert got.shape == want.shape == (19, 34, 8)
    _parity(got, want)


def test_fxaa_presets_match_bhx():
    for lo, hi in itertools.product(jcfg.FxaaPreset, repeat=2):
        want = jcfg.FxaaConfig.from_presets(lo, hi, iterations=8, subpixel_quality=0.5)
        got = bhx_torch.FxaaConfig.from_presets(bhx_torch.FxaaPreset[lo.name],
                                                bhx_torch.FxaaPreset[hi.name],
                                                iterations=8, subpixel_quality=0.5)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (lo, hi)
    assert bhx_torch.FxaaConfig.from_presets() == bhx_torch.FxaaConfig()


# tests/test_io.py's render_tiled cases, on the port: 64x36, 3 bands of 16
# rows, the last anchored to the frame's bottom edge.

def _tiled(**kw):
    return render_tiled(_scenes()[1], torch_cfg(FAST_CFG), band_rows=16, **kw).numpy()


def test_render_tiled_resume_bitexact(tmp_path):
    """A render interrupted after band 1 resumes from its checkpoint and
    gives the uninterrupted result bit for bit."""
    ckpt = str(tmp_path / "bands.npz")
    full = _tiled()
    assert full.shape == (36, 64, 3)
    np.testing.assert_array_equal(full, _tiled(checkpoint_path=ckpt))
    z = dict(np.load(ckpt))
    rec = z["rec"].copy()
    rec[16:] = 0.0  # bands 2+ as if never rendered
    np.savez_compressed(ckpt, rec=rec, next_band=1, shape=z["shape"], band_rows=z["band_rows"])
    np.testing.assert_array_equal(full, _tiled(checkpoint_path=ckpt))


def test_render_tiled_retries_transient_band_failure(monkeypatch, tmp_path):
    """A band trace that throws once is retried and the render completes as
    an uninterrupted one; one that always throws propagates after the
    bounded retries, naming the band, with the checkpoint kept."""
    full = _tiled()
    real = ttracer.trace_rays_record
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected transient device failure")
        return real(*a, **kw)

    monkeypatch.setattr(ttracer, "trace_rays_record", flaky)
    np.testing.assert_array_equal(full, _tiled(max_retries=2))
    assert calls["n"] >= 2

    def fail_after_band_1(*a, **kw):
        calls["n"] += 1
        if calls["n"] > 1:
            raise RuntimeError("injected permanent failure")
        return real(*a, **kw)

    calls["n"] = 0
    monkeypatch.setattr(ttracer, "trace_rays_record", fail_after_band_1)
    ckpt = str(tmp_path / "bands.npz")
    with pytest.raises(RuntimeError, match="band 2/3 failed after 2 attempts"):
        _tiled(checkpoint_path=ckpt, max_retries=1)
    assert int(np.load(ckpt)["next_band"]) == 1
    monkeypatch.setattr(ttracer, "trace_rays_record", real)
    np.testing.assert_array_equal(full, _tiled(checkpoint_path=ckpt))


@pytest.mark.parametrize("mode", ["procedural", "array"])
def test_render_tiled_matches_bhx(mode):
    """render_tiled against bhx's on the same scene, with the whole post
    chain on: the bands' anchors (the last one at the bottom edge), their
    assembly, the sky and the post chain's order are the reference's."""
    jscene, tscene = _scenes()
    cfg = dataclasses.replace(FAST_CFG, texture_mode=mode, bloom=jcfg.BloomConfig(),
                              fxaa=jcfg.FxaaConfig(), tonemap=True)
    want = np.asarray(jax_render_tiled(jscene, cfg, band_rows=16))
    got = render_tiled(tscene, torch_cfg(cfg), band_rows=16).numpy()
    assert got.shape == want.shape == (36, 64, 3) and np.isfinite(got).all()
    bad = _bad_frac(got, want)
    assert bad <= 0.02, f"{bad:.2%} pixels differ by more than 2e-2"


def test_render_tiled_ignores_mismatched_checkpoint(tmp_path):
    ckpt = str(tmp_path / "bands.npz")
    np.savez_compressed(ckpt, rec=np.full((9, 9, 8), 7.0, np.float32), next_band=1,
                        shape=(9, 9), band_rows=3)
    np.testing.assert_array_equal(_tiled(), _tiled(checkpoint_path=ckpt))


def test_png_roundtrip_and_uint8(tmp_path):
    img = np.random.default_rng(0).random((16, 24, 3)).astype(np.float32)
    p = str(tmp_path / "x.png")
    tio.save_png(p, torch.from_numpy(img))
    np.testing.assert_allclose(tio.load_image(p), img, atol=1 / 255 + 1e-6)
    np.testing.assert_array_equal(jio.load_image(p), tio.load_image(p))
    assert tio.to_uint8(np.array([[[1.0, 0.0, 0.5]]])).tolist() == [[[255, 0, 128]]]
    assert tio.to_uint8(torch.tensor([[[1.2, -0.1, 0.25]]])).tolist() == [[[255, 0, 64]]]


def _assert_same_scene(a, b):
    """Two scenes' arrays, each a bhx or a bhx_torch scene, equal."""
    def arr(x):
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    for part in ("camera", "black_hole"):
        for f in dataclasses.fields(getattr(b, part)):
            np.testing.assert_array_equal(arr(getattr(getattr(a, part), f.name)),
                                          arr(getattr(getattr(b, part), f.name)), err_msg=f.name)
    for f in ("disk_texture", "sky_texture", "temp_lut", "time", "disk_gain"):
        np.testing.assert_array_equal(arr(getattr(a, f)), arr(getattr(b, f)), err_msg=f)
    assert len(a.meshes) == len(b.meshes) == 1
    for f in ("points", "normals", "tri_points", "tri_normals", "node_min", "node_max",
              "node_left", "node_count", "lookup", "position", "visible"):
        x, y = arr(getattr(a.meshes[0], f)), arr(getattr(b.meshes[0], f))
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_scene_npz_roundtrips_between_packages(tmp_path):
    """A scene with a mesh saved by either package loads in the other (and in
    itself) with every array equal."""
    jscene = dataclasses.replace(small_scene(), meshes=(cube_mesh(),))
    tscene = bhx_torch.scene_from_state(scene_to_state(jscene), "cpu")
    by_bhx, by_port = str(tmp_path / "bhx.npz"), str(tmp_path / "port.npz")
    jio.save_scene(by_bhx, jscene)
    tio.save_scene(by_port, tscene, torch_cfg(FAST_CFG))
    assert json.load(open(tmp_path / "port.json"))["width"] == 64
    _assert_same_scene(tio.load_scene(by_bhx, "cpu"), jscene)
    _assert_same_scene(jio.load_scene(by_port), tscene)
    _assert_same_scene(tio.load_scene(by_port, "cpu"), tscene)


def test_scene_to_state_matches_bhx():
    """The port's scene_to_state gives bhx's snapshot (keys, arrays, the
    mesh's fields and name), and scene_from_state reads it back."""
    from bhx_torch.scene import scene_to_state as tscene_to_state

    jscene = dataclasses.replace(small_scene(), meshes=(cube_mesh(),))
    want = scene_to_state(jscene)
    got = tscene_to_state(bhx_torch.scene_from_state(want, "cpu"))
    assert set(got) == set(want) - {"materials"}
    for part in ("camera", "black_hole"):
        assert set(got[part]) == set(want[part])
        for k, v in want[part].items():
            np.testing.assert_array_equal(got[part][k], v, err_msg=k)
    for k in ("time", "disk_gain", "disk_texture", "sky_texture", "temp_lut"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    (gm,), (wm,) = got["meshes"], want["meshes"]
    assert set(gm) == set(wm)
    for k, v in wm.items():
        np.testing.assert_array_equal(gm[k], v, err_msg=k)
    _assert_same_scene(bhx_torch.scene_from_state(got, "cpu"), jscene)


def test_cli_assets_and_render(tmp_path, capsys):
    from bhx_torch.cli import main

    assert main(["assets"]) == 0
    assert "disk (512, 512, 4) sky (1024, 2048, 3) lut (64, 256, 3)" in capsys.readouterr().out
    out = str(tmp_path / "frame.png")
    assert main(["render", "--device", "cpu", "--width", "32", "--height", "18",
                 "--no-ladder", "--max-iterations", "150", "--no-fxaa", "-o", out]) == 0
    assert "rendered 32x18" in capsys.readouterr().out
    img = tio.load_image(out)
    assert img.shape == (18, 32, 3) and img.max() > 0.0


def test_cli_look_at_is_camera_look_at():
    """``--look-at`` gives the forward of ``Camera.look_at`` from the
    ``--camera`` position, and bhx's camera gives the same."""
    import argparse

    from bhx.scene import Camera as JaxCamera

    from bhx_torch.cli import _add_scene_flags, _build_scene

    p = argparse.ArgumentParser()
    _add_scene_flags(p)
    args = p.parse_args(["--device", "cpu", "--camera", "6", "-2", "-18",
                         "--look-at", "1", "0.5", "0"])
    cam = _build_scene(args).camera
    want = dataclasses.replace(bhx_torch.Camera.default("cpu"),
                               position=torch.tensor([6.0, -2.0, -18.0])).look_at([1.0, 0.5, 0.0])
    torch.testing.assert_close(cam.forward, want.forward, atol=0, rtol=0)
    torch.testing.assert_close(cam.position, want.position, atol=0, rtol=0)
    jcam = dataclasses.replace(JaxCamera.default(), position=jax.numpy.asarray(
        [6.0, -2.0, -18.0], jax.numpy.float32)).look_at([1.0, 0.5, 0.0])
    np.testing.assert_allclose(cam.forward.numpy(), np.asarray(jcam.forward), atol=2e-6, rtol=0)


# tests/test_viewer.py's four cases on the port's viewer, at 32x18.
BASE_REQ = {
    "pos": [0, 0, -19], "forward": [0, 0, 1], "fov": 1.0,
    "mass": 0.5, "spin": 0.0, "disk_inner": 2.0, "disk_outer": 10.0,
    "feather": 0.3, "time": 0.0,
    "show_disk": True, "show_texture": True, "show_redshift": True,
    "show_sky": True, "bloom": False, "mix_ratio": 0.7,
    "fxaa": False, "tonemap": False, "ladder": False,
    "kerr": False, "integrator": "euler", "step_size": 0.15,
    "max_iter": 120,
}


def _server(w=32, h=18):
    from bhx_torch.viewer import ViewerServer

    return ViewerServer(width=w, height=h, max_iterations=120, device="cpu")


def _decode(png_bytes):
    from PIL import Image

    return np.asarray(Image.open(_io.BytesIO(png_bytes)))


def test_viewer_default_frame_and_stats_header():
    png, stats = _server().render_frame(dict(BASE_REQ))
    img = _decode(png)
    assert img.shape == (18, 32, 3) and img.max() > 0
    assert stats["mrays_per_s"] > 0 and stats["frame_s"] > 0
    json.dumps(stats)


def test_viewer_kerr_panel_combination():
    """The panel's Kerr toggle with the ladder and the RK45 selector."""
    req = dict(BASE_REQ, kerr=True, spin=0.9, ladder=True, integrator="rk45", max_iter=80)
    png, stats = _server().render_frame(req)
    assert _decode(png).shape == (18, 32, 3)
    assert np.isfinite(stats["frame_s"])


def test_viewer_mesh_request():
    req = dict(BASE_REQ, mesh_enabled=True, obj_path="", mesh_visible=True,
               mesh_pos=[6.0, 0.0, -30.0], pos=[0, 0, -40])
    srv = _server()
    img = _decode(srv.render_frame(req)[0])
    bare = _decode(srv.render_frame(dict(req, mesh_enabled=False))[0])
    assert img.shape == (18, 32, 3)
    assert np.abs(img.astype(int) - bare.astype(int)).max() > 10  # the cube shows


def test_viewer_overflow_stats_endpoint():
    srv = _server()
    stats = srv.overflow_stats(dict(BASE_REQ))
    assert set(stats) >= {"overflow_frac", "dropped_total", "max_count"}
    assert 0.0 <= stats["overflow_frac"] <= 1.0 and stats["max_count"] > 0
    # The diagnostic decodes the whole request: no disk, no crossings.
    no_disk = srv.overflow_stats(dict(BASE_REQ, show_disk=False))
    assert no_disk["max_count"] == 0 and no_disk["overflow_frac"] == 0.0


def test_frame_report_keys(tmp_path):
    """``profile_trace`` writes the block's trace, which holds the render's
    span, and its lane counters beside it."""
    from bhx_torch.profiling import ACTIVE_LANES, LANES, RENDER, profile_trace

    _, tscene = _scenes()
    cfg = torch_cfg(FAST_CFG).replace(width=W, height=H, use_ladder=True,
                                      ladder=bhx_torch.LadderConfig.for_resolution(W, H, 2),
                                      fxaa=bhx_torch.FxaaConfig(),
                                      bloom=bhx_torch.BloomConfig())
    with profile_trace(str(tmp_path / "trace")):
        bhx_torch.render(tscene, cfg)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert RENDER in {e.get("name") for e in trace["traceEvents"]}
    counts = json.loads((tmp_path / "trace" / "counts.json").read_text())
    assert set(counts) == {LANES, ACTIVE_LANES}
    # Level 0 traces 12x7 lanes, all live, and level 1 34x19, some live.
    assert counts[LANES] == 12 * 7 + 34 * 19
    assert 12 * 7 <= counts[ACTIVE_LANES] < counts[LANES]


def test_entry_renders():
    from bhx_torch.entry import entry

    fn, args = entry("cpu")
    img = fn(*args)
    assert tuple(img.shape) == (72, 128, 3) and bool(torch.isfinite(img).all())
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0


def test_parity_check_frame_matches_bhx(monkeypatch):
    """``bench.parity_check``'s frame (the default scene, dense, 600 march
    iterations, no bloom, FXAA or tonemap), here at 64x36: the port's
    plain pipeline within the gate's 2% of bhx's reference pipeline
    (``bhx.bench.parity_check``'s ``march_mode="fast"``); the gate's
    figures on the CPU against itself; and no card, no gate."""
    from bhx.pipeline import render_jit
    from bhx.scene import Scene as JaxScene

    from bhx_torch import bench

    r = bench.compare_frames(bhx_torch.Scene.default("cpu"), bench.parity_config(64, 36),
                             2e-2, 0.02)
    assert r == {"parity_bad_frac": 0.0, "parity_ok": True, "max_abs_err": 0.0}
    cfg = jcfg.RenderConfig(width=64, height=36, use_ladder=False, max_iterations=600,
                            fxaa=jcfg.FxaaConfig(enabled=False),
                            bloom=jcfg.BloomConfig(enabled=False), tonemap=False,
                            march_mode="fast")
    want = np.asarray(render_jit(JaxScene.default(), cfg))
    got = bhx_torch.render(bhx_torch.Scene.default("cpu"), torch_cfg(cfg)).numpy()
    assert _bad_frac(got, want) <= 0.02
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.parity_check()
