#!/usr/bin/env python3
"""Drive the bhx_torch main paths once on one CUDA card and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it finishes:

1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. the kernel build from ``bhx_torch/csrc`` (seconds, ptxas register report
   of every kernel instantiation);
3. each kernel against its plain torch version on the card: the Euler
   march on the 72x41 ladder level 0 and on a dense 640x361 batch, the
   composite, the slot ingredients, the sky on record rows and on an
   interleaved record, all on that trace, then march, composite and sky at
   the default frame's own shapes (the last ladder level's two march
   launches, round 0 and the re-entry round 1, and the final frame), timed
   with CUDA events beside their plain versions; every march, composite
   and ingredients launch bit-identical to its plain version (max |err|
   0.0).  Each composite line carries its work (``checks.composite_work``:
   valid slots, rays with one, SIMT efficiency one thread per ray and
   packed per block) and its bound (``checks.composite_bound``: every
   slot's valid row of every ray read).  Each last-level march line
   carries its live lanes, the sum and largest of its ``steps`` row, the
   SIMT efficiency of one thread per lane in pixel order, its bound
   (``checks.march_work``: float operations at the unfused float32 rate,
   special-function operations at theirs or bytes at the memory rate,
   whichever is largest, with ``bound_by`` and ``bound_ceiling``) and the
   kernel's share of it, and its serial floor (``checks.serial_floor``);
   every kernel line its bound;
3b. the RK45 march and the Kerr march (spin 0.9) the same way, at 72x41,
   640x361 (with the composite of the Kerr trace's slots) and the last
   ladder level's two launches;
3c. the slot-ingredients and interleaved-sky kernels, which lie on no
   render path, driven once through their entry points;
4. the default 1918x1081 frame through ``bhx_torch.bench.run_bench``:
   image checks, the kernel launches of the frames alone (zeroed just
   before, read just after the last frame), ms/frame, Mrays/s, crossing
   overflow;
4b. the same for the Kerr spin-0.9 frame and the RK45 frame;
5. a dense 192x108 frame on the card against the plain path on the CPU
   (bad-pixel fraction at 2e-2, gated at 2%);
5b. the same for Kerr spin 0.9 (gated at 3%) and RK45 (2%);
6. ``bhx_torch.bench.grad_check`` at its defaults (320x180): reverse-mode
   d/dmass through the kernels' forward and their replayed backward
   against Richardson-extrapolated central differences, gated on
   ``grad_ok``, with the march, composite and sky kernels launched and the
   march replayed during the call;
6b. the gradient of one fixed weighted-pixel loss with respect to every
   fitted scene parameter and ``disk_gain`` at 64x36 (dense, 300
   iterations), on the card (kernel forward, replayed backward) against
   the plain path on the CPU, for Euler, RK45 and Kerr spin 0.9, with the
   weights zero off the FD-stable pixels and where the two forwards part
   (``checks.compare_gradients``): each parameter's largest error under
   1e-3 of its largest entry;
6c. ``bhx_torch.parallel.fit_scene`` at ``bhx fit``'s defaults (1918x1081,
   no ladder, no bloom or FXAA, tonemap, 400 iterations, Euler, Adam at
   lr 1e-2) without the star sky: 3 steps from the default scene (mass 0.5) toward the port's
   own render at mass 0.6, each step timed with CUDA events, with its
   peak memory and its launches and replays; gated on finite, falling
   losses, the mass moving toward 0.6, and the march, composite and sky
   kernels launched and the march replayed in every step;
7. meshes: the viewer's 12-triangle cube (brute-force branch of the mesh
   kernel M1) and a 524,288-triangle torus generated from seed 0, written
   to an OBJ file and loaded through ``make_mesh`` (the C++ parser and BVH
   builder at full size; BVH branch), outside the relativity sphere, seen
   by a camera at (0, 0, -40): ``make_mesh``'s seconds; M1's one launch
   for all meshes, the merge inside, against the plain lockstep
   traversals and merge at the frame's own shapes (the last ladder level's
   first straight phase: the torus alone, the cube alone, and both;
   bit-identical, with its work, bound and the torus's packed layout
   bytes); the 1918x1081 frame through ``run_bench`` as in phase 4, with
   ``mesh`` launched 12 times a frame (4 traces x 3 straight phases, one
   launch for both meshes); at least 5% of the frame's pixels changed
   by the meshes; the frame's device time by kernel (``torch.profiler``)
   with the meshes and without them; and a dense 192x108 frame of the
   scene on the card against the plain path on the CPU (gated at 2%).

The second-to-last line is a JSON object with one entry per kernel (its
launches in the frames of phase 4, or of phase 7 for ``mesh``, its
launches per frame, max |err|, ms, plain ms, bound ms and what bounds it;
no single PyTorch call computes any of them, so ``library_ms`` is null);
the last line is the device record.  Exits non-zero, printing neither, when
there is no CUDA device, when ``bhx_torch`` cannot be imported, or when
any phase fails.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time


def _die(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> int:
    try:
        import torch
    except ImportError:
        _die("torch is not installed")
    if not torch.cuda.is_available():
        _die("no CUDA device available")
    try:
        import bhx_torch  # noqa: F401
    except ImportError as e:
        _die(f"cannot import bhx_torch ({e}); run from the repository root")

    import numpy as np

    import dataclasses

    # The meshes are the tests' own (numpy alone): the viewer's cube and the
    # seeded torus.
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from torch_mesh_data import cube_arrays, torus_arrays, write_obj

    from bhx_torch import checks
    from bhx_torch.bench import frame_profile, grad_check, run_bench
    from bhx_torch.config import BloomConfig, FxaaConfig, Integrator, RenderConfig
    from bhx_torch.kernels import build, launch_counts, replay_counts, reset_launch_counts
    from bhx_torch.kernels import mesh as mesh_mod
    from bhx_torch.kernels import shade, sky
    from bhx_torch.geometry import bvh, obj
    from bhx_torch.kernels.march import OUT_FIXED, SLOT_ROWS, march
    from bhx_torch.parallel import apply_params, fit_scene, scene_params
    from bhx_torch.pipeline import ladder_trace_rows, render, trace_image_record_rows
    from bhx_torch.scene import Camera, Scene, with_spin
    from bhx_torch.tracer import march_batch, march_kwargs

    failures = []
    start = time.perf_counter()

    def check(name: str, ok: bool, info: dict) -> None:
        shown = {k: v for k, v in info.items() if k != "out"}
        shown["at_s"] = round(time.perf_counter() - start, 1)
        print(f"{name}: {'ok' if ok else 'FAIL'} {json.dumps(shown)}", flush=True)
        if not ok:
            failures.append(name)

    # --- 1. the card ---
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}", flush=True)
    if torch.backends.cuda.matmul.allow_tf32:
        _die("torch.backends.cuda.matmul.allow_tf32 is on; bloom must run in float32")

    # --- 2. build ---
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s ({build.log_path().name})")
    for line in build.log_path().read_text().splitlines():
        if any(k in line for k in ("entry function", "registers", "spill")):
            print("  " + line.strip())

    # --- 3. each kernel against its plain version ---
    dev = torch.device("cuda")
    scene = Scene.default(dev)
    cfg = RenderConfig()
    w0, h0 = cfg.ladder_for_output().resolution(0)
    rays, params, _ = march_batch(scene, cfg, w0, h0)
    r = checks.compare_march(rays, params, cfg)
    check(f"march {w0}x{h0} level 0", r["ok"], r)

    rays, params, cam = march_batch(scene, cfg, 640, 361)
    r = checks.compare_march(rays, params, cfg)
    check("march 640x361 dense", r["ok"], r)
    dense_slots, dense_cam = r["out"][OUT_FIXED:OUT_FIXED + SLOT_ROWS], cam
    sp = checks.shade_params(scene)
    r = checks.compare_composite(dense_slots, dense_cam, sp, scene.disk_gain, cfg)
    check("composite 640x361 dense", r["ok"], r)
    ing_r = checks.compare_ingredients(dense_slots, dense_cam, sp, cfg, reps=10)
    check("ingredients 640x361 dense", ing_r["ok"], ing_r)
    record = trace_image_record_rows(scene, cfg, 640, 361).reshape(8, -1)
    r = checks.compare_sky(record, cfg)
    check("sky 640x361 dense", r["ok"], r)
    interleaved = record.t().contiguous()
    skyf_r = checks.compare_sky_finalize(interleaved, cfg, reps=10)
    check("sky_finalize 640x361 dense", skyf_r["ok"], skyf_r)

    def last_level(name: str, m_scene, m_cfg) -> dict:
        """The last ladder level's two march launches (its re-trace mask as
        the active set; round 0, then round 1 after the first march),
        timed against the plain march, with each one's work, bound, share
        of it and serial floor.  Returns round 0's."""
        kw = march_kwargs(m_cfg)
        rounds = []
        for rnd in (0, 1):
            rays, params, _ = checks.last_level_batch(m_scene, m_cfg, march_round=rnd)
            r = checks.compare_march(rays, params, m_cfg, reps=10)
            r.update(checks.serial_floor(rays, params, r["out"],
                                         lambda ra, pa: march(ra, pa, **kw)))
            r["bound_share"] = r["bound_ms"] / r["ms"]
            check(f"{name} last level" + (" round 1" if rnd else ""), r["ok"], r)
            rounds.append(r)
        return rounds[0]

    # The default frame's own shapes, timed: the last ladder level's march
    # launches, the composite of that level's slots, and the sky pass over
    # the final 1918x1081 record.
    march_r = last_level("march", scene, cfg)
    _, _, cam = checks.last_level_batch(scene, cfg)
    comp_r = checks.compare_composite(march_r["out"][OUT_FIXED:OUT_FIXED + SLOT_ROWS],
                                      cam, sp, scene.disk_gain, cfg, reps=10)
    check("composite last level", comp_r["ok"], comp_r)
    lw, lh = cfg.ladder_for_output().final_resolution
    x0, y0 = (lw - cfg.width) // 2, (lh - cfg.height) // 2
    frame = ladder_trace_rows(scene, cfg)[:, y0:y0 + cfg.height, x0:x0 + cfg.width]
    sky_r = checks.compare_sky(frame.reshape(8, -1).contiguous(), cfg, reps=10)
    check("sky final frame", sky_r["ok"], sky_r)

    # --- 3b. the RK45 and Kerr marches against their plain version ---
    kerr_scene = with_spin(scene, 0.9)
    branches = {
        "rk45": (scene, RenderConfig(integrator=Integrator.RK45)),
        "kerr": (kerr_scene, RenderConfig(geodesics="kerr")),
    }
    last = {}
    for name, (b_scene, b_cfg) in branches.items():
        rays, params, _ = march_batch(b_scene, b_cfg, w0, h0)
        r = checks.compare_march(rays, params, b_cfg)
        check(f"march_{name} {w0}x{h0} level 0", r["ok"], r)
        rays, params, cam = march_batch(b_scene, b_cfg, 640, 361)
        r = checks.compare_march(rays, params, b_cfg)
        check(f"march_{name} 640x361 dense", r["ok"], r)
        if name == "kerr":
            r = checks.compare_composite(r["out"][OUT_FIXED:OUT_FIXED + SLOT_ROWS], cam,
                                         checks.shade_params(b_scene),
                                         b_scene.disk_gain, b_cfg)
            check("composite 640x361 dense kerr", r["ok"], r)
        last[name] = last_level(f"march_{name}", b_scene, b_cfg)

    # --- 3c. the kernels on no render path, through their entry points ---
    reset_launch_counts()
    ing = shade.ingredients(dense_slots, dense_cam, sp)
    rgb = sky.sky_finalize(interleaved)
    torch.cuda.synchronize()
    aside = launch_counts()
    check("ingredients + sky_finalize entry points",
          aside["ingredients"] == 1 and aside["sky_finalize"] == 1
          and bool(torch.isfinite(ing).all()) and bool(torch.isfinite(rgb).all()),
          dict(launches=aside, shapes=[list(ing.shape), list(rgb.shape)]))

    # --- 4. the frames through the bench entry point ---
    # The counts are zeroed just before each run; run_bench reads them
    # just after its last frame, before its overflow diagnostic.
    def frame_phase(name: str, march_kernel: str, extra=(), **kw) -> dict:
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        bench = run_bench(1918, 1081, **kw)
        counts = bench["launches"]
        per_frame = bench["launches_per_frame"]
        img = bench.pop("image")
        bench["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        img_ok = (tuple(img.shape) == (1081, 1918, 3) and bool(torch.isfinite(img).all())
                  and float(img.min()) >= 0.0 and float(img.max()) <= 1.0)
        # Every frame makes the same launches, so the run's counts are
        # exactly frames x one frame's; each kernel of the path ran in every
        # frame and no other kernel ran.
        path = (march_kernel, "composite", "sky", *extra)
        counts_ok = all(
            (per_frame[k] > 0) == (k in path) and counts[k] == bench["frames"] * per_frame[k]
            for k in counts)
        check(name, img_ok and counts_ok,
              dict(bench, shape=list(img.shape), mean=float(img.mean())))
        return bench

    euler = frame_phase("frame 1918x1081", "march", iters=5)
    # --- 4b. the Kerr spin-0.9 frame and the RK45 frame ---
    kerr = frame_phase("frame 1918x1081 kerr(spin=0.9)", "march_kerr", iters=3,
                       geodesics="kerr", spin=0.9)
    rk45 = frame_phase("frame 1918x1081 rk45", "march_rk45", iters=3,
                       integrator=Integrator.RK45)

    # --- 5. small dense frames: the card against the plain path on the CPU ---
    small = RenderConfig(width=192, height=108, use_ladder=False, max_iterations=600,
                         bloom=BloomConfig(enabled=False),
                         fxaa=FxaaConfig(enabled=False), tonemap=False)
    for name, s_scene, s_cfg, gate in (
            ("frame 192x108 card vs cpu", scene, small, 0.02),
            ("frame 192x108 card vs cpu kerr(spin=0.9)", kerr_scene,
             small.replace(geodesics="kerr"), 0.03),
            ("frame 192x108 card vs cpu rk45", scene,
             small.replace(integrator=Integrator.RK45), 0.02)):
        on_card = render(s_scene, s_cfg).cpu()
        on_cpu = render(s_scene.to("cpu"), s_cfg)
        bad = float((on_card - on_cpu).abs().gt(2e-2).any(-1).float().mean())
        check(name, bool(torch.isfinite(on_card).all()) and bad <= gate,
              dict(bad_frac=bad, gate=gate,
                   max_abs_err=float((on_card - on_cpu).abs().max())))

    # --- 6. the gradient gate on the card ---
    path = ("march", "composite", "sky")
    reset_launch_counts()
    gc = grad_check()
    torch.cuda.synchronize()
    gc_launches, gc_replays = launch_counts(), replay_counts()
    check("grad_check 320x180", gc["grad_ok"] and all(gc_launches[k] > 0 for k in path)
          and all(gc_replays[k] > 0 for k in path),
          dict(gc, launches=gc_launches, replays=gc_replays))

    # --- 6b. the card's gradient against the plain path on the CPU ---
    grad_cfg = RenderConfig(width=64, height=36, use_ladder=False, max_iterations=300,
                            bloom=BloomConfig(enabled=False),
                            fxaa=FxaaConfig(enabled=False))
    for name, g_scene, g_cfg in (
            ("euler", scene, grad_cfg),
            ("rk45", scene, grad_cfg.replace(integrator=Integrator.RK45)),
            ("kerr(spin=0.9)", kerr_scene, grad_cfg.replace(geodesics="kerr"))):
        r = checks.compare_gradients(g_scene, g_cfg)
        check(f"grad 64x36 card vs cpu {name}", r["ok"], r)

    # --- 6c. fit_scene at bhx fit's defaults ---
    # Without the star sky: a splat (radius 2.4e-3 uv) has slopes that no
    # 1e-2 step sees, and at this size they outweigh the rest of the
    # gradient (AD d/dmass +4.2 against FD -0.079 with the sky, -0.080 /
    # -0.077 without), the reason bhx's own grad_check renders without it.
    fit_cfg = RenderConfig(width=1918, height=1081, use_ladder=False, max_iterations=400,
                           bloom=BloomConfig(enabled=False),
                           fxaa=FxaaConfig(enabled=False), tonemap=True, show_sky=False)
    target = render(apply_params(scene, dict(scene_params(scene), mass=0.6)),
                    fit_cfg).detach()
    steps = []
    marks = [torch.cuda.Event(enable_timing=True)]

    def on_step(i: int, loss: float) -> None:
        # The counts and the peak are zeroed just before each step and read
        # just after it.
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        steps.append(dict(step=i, loss=loss, s=marks[-1].elapsed_time(end) / 1e3,
                          peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                          launches=launch_counts(), replays=replay_counts()))
        print(f"fit step {i}: {json.dumps(steps[-1])}", flush=True)
        marks.append(end)
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    marks[0].record()
    fitted, losses = fit_scene(scene, target, fit_cfg, steps=3, lr=1e-2, callback=on_step)
    mass = float(fitted["mass"])
    check("fit_scene 1918x1081 3 steps",
          all(np.isfinite(losses)) and losses[-1] < losses[0] and 0.5 < mass < 0.6
          and all(st["launches"][k] > 0 for st in steps for k in path)
          and all(st["replays"]["march"] > 0 for st in steps),
          dict(losses=losses, mass=mass, s_per_step=[st["s"] for st in steps],
               peak_mem_gb=max(st["peak_mem_gb"] for st in steps)))

    # --- 7. meshes: the cube and a 524,288-triangle torus ---
    cube = obj.make_mesh(cube_arrays(), position=(6.0, 0.0, -30.0), name="cube",
                         scale=1.0, flip_y=False)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "torus.obj")
        t0 = time.perf_counter()
        write_obj(path, *torus_arrays(512, 512))
        gen_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        torus = obj.make_mesh(path, position=(-6.0, 0.0, -27.0), name="torus")
        torch.cuda.synchronize()
        make_mesh_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        parsed = obj.load_obj(path)
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree = bvh.build_bvh(parsed[0], parsed[2])
        bvh_s = time.perf_counter() - t0
    check("make_mesh torus", torus.num_triangles == 524288 and cube.num_triangles == 12,
          dict(triangles=torus.num_triangles, nodes=tree.num_nodes, depth=tree.max_depth(),
               max_leaf=int(tree.node_count.max()),
               obj_write_s=gen_s, make_mesh_s=make_mesh_s, parse_s=parse_s, bvh_s=bvh_s))
    mesh_scene = dataclasses.replace(
        scene, meshes=(cube, torus),
        camera=Camera(position=torch.tensor([0.0, 0.0, -40.0], device=dev),
                      forward=torch.tensor([0.0, 0.0, 1.0], device=dev),
                      fov=torch.tensor(1.0, device=dev)))
    # M1's one launch for all the meshes, the merge inside, against the
    # plain traversals and merge at the frame's largest mesh call: the torus
    # alone (BVH), the cube alone (brute force), and both, as the frame has
    # them.
    mesh_r = {}
    o, d, act = checks.last_level_rays(mesh_scene, cfg)
    for name, ms in (("torus", [torus]), ("cube", [cube]), ("both", [cube, torus])):
        r = checks.compare_meshes(o, d, ms, act, reps=10)
        r["bound_share"] = r["bound_ms"] / r["ms"]
        if name == "torus":
            r["packed_bytes"] = sum(t.numel() * t.element_size()
                                    for t in mesh_mod.packed(torus))
        check(f"mesh {name} last level", r["ok"], r)
        mesh_r[name] = r
    meshes = frame_phase("frame 1918x1081 meshes", "march", extra=("mesh",), iters=3,
                         scene=mesh_scene)
    if meshes["launches_per_frame"]["mesh"] != 12:
        check("mesh launches a frame", False, dict(meshes["launches_per_frame"]))
    with torch.no_grad():
        img = render(mesh_scene, cfg)
        bare = render(mesh_scene, cfg.replace(render_meshes=False))
    changed = float((img - bare).abs().gt(2e-2).any(-1).float().mean())
    check("frame 1918x1081 meshes in view", changed >= 0.05, dict(changed_frac=changed))
    # Where a frame's time goes, with the meshes and without them, same view.
    for name, p_cfg in (("meshes", cfg), ("meshes off", cfg.replace(render_meshes=False))):
        prof = frame_profile(mesh_scene, p_cfg)
        check(f"profile 1918x1081 {name}", prof["device_ms"] > 0.0, prof)
    on_card = render(mesh_scene, small).cpu()
    t0 = time.perf_counter()
    on_cpu = render(mesh_scene.to("cpu"), small)
    cpu_s = time.perf_counter() - t0
    bad = float((on_card - on_cpu).abs().gt(2e-2).any(-1).float().mean())
    check("frame 192x108 card vs cpu meshes", bool(torch.isfinite(on_card).all()) and bad <= 0.02,
          dict(bad_frac=bad, gate=0.02, max_abs_err=float((on_card - on_cpu).abs().max()),
               cpu_s=cpu_s))

    if failures:
        _die("failed phases: " + ", ".join(failures))

    def entry(name, source, replaces, bench, r):
        """A kernel's record: its launches in the frames of ``bench`` (the
        frame phase whose path runs it) and per frame, or, for a kernel on
        no render path, its launches through its entry point."""
        launches = bench["launches"][name] if bench else aside[name]
        return dict(name=name, route="cuda", source=f"bhx_torch/csrc/{source}",
                    replaces=replaces, launches=launches,
                    launches_per_frame=bench["launches_per_frame"][name] if bench else 0,
                    max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    bound_ceiling=r["bound_ceiling"], library_ms=None)

    march_at = "bhx/kernels/march_pallas.py:319"
    kernels = [
        entry("march", "march.cu", march_at, euler, march_r),
        entry("march_rk45", "march.cu", march_at, rk45, last["rk45"]),
        entry("march_kerr", "march.cu", march_at, kerr, last["kerr"]),
        entry("composite", "shade.cu", "bhx/kernels/shade_pallas.py:499", euler, comp_r),
        entry("sky", "sky.cu", "bhx/kernels/shade_pallas.py:639", euler, sky_r),
        entry("ingredients", "shade.cu", "bhx/kernels/shade_pallas.py:246", None, ing_r),
        entry("sky_finalize", "sky.cu", "bhx/kernels/shade_pallas.py:723", None, skyf_r),
        # No Pallas counterpart: M1 replaces the jnp lockstep traversal,
        # brute force and merge.  Its figures are the frame's launch (the
        # cube and the torus); the torus's alone (BVH branch) and the
        # cube's alone (brute force) ride beside them.
        dict(entry("mesh", "mesh.cu",
                   "bhx/geometry/traverse.py:143 (_intersect_bvh; :98 _intersect_brute; "
                   ":58 intersect_meshes; jnp, no pallas_call)", meshes, mesh_r["both"]),
             **{branch: {k: mesh_r[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "bound_by")}
                for branch, name in (("bvh", "torus"), ("brute", "cube"))}),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
