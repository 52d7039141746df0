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
3c. the slot-ingredients kernel, which lies on no render path, and the
   interleaved-sky kernel, driven once through their entry points;
4. the default 1918x1081 frame through ``bhx_torch.bench.run_bench``:
   image checks, the kernel launches of the frames alone (zeroed just
   before, read just after the last frame), ms/frame, Mrays/s, crossing
   overflow;
4b. the same for the Kerr spin-0.9 frame and the RK45 frame;
5. ``bhx_torch.bench.parity_check``: a dense 192x108 frame on the card
   against the plain path on the CPU (bad-pixel fraction at 2e-2, gated
   at 2%);
5b. the same comparison (``bhx_torch.bench.compare_frames``) for Kerr
    spin 0.9 (gated at 3%) and RK45 (2%);
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

8a. the array textures: seconds to bake each at full size (disk 512,
   sky 2048x1024, blackbody LUT 256x64) into an emptied cache, seconds to
   load each from the cache, and their upload to the card (shapes, bytes);
8b. the 1918x1081 frame in array texture mode through ``run_bench``: the
   march its only kernel (8 launches a frame; the array shade and sky are
   plain torch), and where its device time goes (``bench.frame_profile``:
   the array composite's and the array sky's device ms a frame);
8c. a dense 192x108 array frame on the card against the CPU (2%);
8d. the array frame's gradient, the three textures among its leaves, card
   against CPU (``checks.compare_gradients``, 1e-3);
8e. ``render_tiled`` of the procedural 1918x1081 frame in bands of 256
   rows: the whole frame (ms; march and composite launched per band, the
   interleaved sky kernel once a frame), then a run interrupted at band 4
   and resumed from its checkpoint, equal to the whole frame bit for bit;
   the interleaved sky kernel against its plain version on the frame's
   assembled (1081, 1918, 8) record, timed; the tiled frame against the
   same frame rendered densely in one batch (2%);
8f. ``trace_image`` (the public ``trace_rays``) at 640x361, card against
   CPU: alpha agreement (>= 98%) and bad-pixel fraction (2%);
8g. ``python -m bhx_torch render`` at 1918x1081 and ``... assets`` in
   processes of their own: exit 0, the PNG's shape, seconds;
8h. the viewer's ``render_frame`` of the default and of a Kerr request at
   480x270: PNGs of that size, the frame's seconds;
9a. ``bhx_torch.parallel`` over a world of one NCCL rank in this process:
   the sharded 1918x1081 record (dense, the march and composite launched)
   equal to the dense record bit for bit, and ``render_sharded`` (the
   interleaved sky kernel once) within 1e-6 of the dense no-ladder
   ``render`` (the sky kernel on rows), each frame's ms;
9b. two ranks spawned on the one card (``parallel.spawn``, gloo, which
   stages the collectives' tensors through the host): each rank's sharded
   record equal to the dense one bit for bit, its frame within 1e-6, the
   march, composite and interleaved sky kernels launched in its frame, its
   device and the frame's ms;
9c. two sharded train steps of 6c's fit (200 march iterations) on those
   ranks: losses and parameters equal across ranks, the first step's
   summed gradients within 1e-3 (of each parameter's largest entry) of one
   single-process step on the same inputs (its s and peak memory beside
   them), s/step and peak memory a rank;
9d. ``bench_scaling``'s rows for 1 and 2 ranks (two ranks on one card
   measure the sharded program's overhead, not hardware scaling); the
   phase within 90 s.  A rank that fails, dies or times out fails it;
9e. the sharded ladder, in a spawn of its own of two ranks sharing the
   card (gloo): each rank's ladder record of the default 1918x1081 frame
   equal to the single-process ``ladder_trace_rows`` bit for bit, each
   level's pixels to trace split over the ranks (their traced counts
   differ by at most one and sum to the level's count, the trace's ms
   each rank and in a world of one), the step's frame launching ``march``
   8 times, ``composite`` 4 and ``sky`` once on each rank; the ladder's
   ms in one process, each level masked and dense, and in a world of one,
   each level's pixels traced alone; then two
   sharded train steps of 6c's fit on the ladder (200 march iterations, as
   9c) on those ranks: losses and parameters equal across ranks, the first
   step's summed gradients within 1e-3 (of each parameter's largest entry)
   of one single-process ladder step on the same inputs, each step
   launching the kernels as the frame does; s/step and peak memory of
   both beside 9c's dense single-process step; the phase within 150 s;
10. the camera's pose on the card: (10a) ``Camera.rotated(0.35, -0.15)``
   of the default camera, and a camera at (6, -2, -18) that
   ``look_at``s the hole: forward and ``right()`` on the card within 2e-6
   of the same calls on the CPU, every tensor on the card; (10b) the
   default 1918x1081 ladder frame of the rotated scene through
   ``bench.frame_profile`` (ms a frame, device-busy ms, idle share, the
   kernels' ms), each of its frames launching march, composite and sky
   as phase 4's frame does, and nothing else, beside the card's name and
   power limit; (10c) its 192x108 frame on the card against the plain
   path on the CPU (2% bad pixels at 2e-2); (10d) d/d(yaw, pitch) of a
   weighted-pixel loss at 320x180 through ``rotated``, the card against
   the CPU within 1e-3 of the larger entry
   (``checks.compare_pose_gradients``), the kernels launched and
   replayed; the phase within 60 s.

The second-to-last line is a JSON object with one entry per kernel (its
launches in the frames of phase 4, of phase 7 for ``mesh`` and of phase
8e's whole frame for ``sky_finalize``, its launches per frame, and its
max |err|, ms, plain ms, bound ms and what bounds it at the shapes those
frames give it: phase 3's last-level and final-frame launches, phase 7's
mesh calls, 8e's assembled record; no single PyTorch call
computes any of them, so ``library_ms`` is null);
the last line is the device record.  Exits non-zero, printing neither, when
there is no CUDA device, when ``bhx_torch`` cannot be imported, or when
any phase fails.
"""

from __future__ import annotations

import io
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
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "tests"))
    from torch_mesh_data import cube_arrays, torus_arrays, write_obj

    from bhx_torch import checks
    from bhx_torch.bench import (compare_frames, frame_profile, grad_check, parity_check,
                                 parity_config, run_bench)
    from bhx_torch.config import BloomConfig, FxaaConfig, Integrator, RenderConfig
    from bhx_torch.kernels import build, launch_counts, replay_counts, reset_launch_counts
    from bhx_torch.kernels import mesh as mesh_mod
    from bhx_torch.kernels import shade, sky
    from bhx_torch.geometry import bvh, obj
    from bhx_torch.kernels.march import OUT_FIXED, SLOT_ROWS, march
    import torch.distributed as dist

    from bhx_torch import parallel
    from bhx_torch.parallel import (
        apply_params, fit_scene, make_optimizer, scene_params, train_step,
    )
    from bhx_torch import assets, tracer
    from bhx_torch.io import load_image
    from bhx_torch.pipeline import (
        ladder_trace_rows, render, render_tiled, trace_image_record_rows,
    )
    from bhx_torch.scene import (
        TEXTURE_FIELDS, Camera, Scene, scene_to_state, with_spin, with_textures,
    )
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
    r = checks.compare_sky_finalize(interleaved, cfg)
    check("sky_finalize 640x361 dense", r["ok"], r)

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

    # --- 3c. the ingredients kernel (on no render path) and the interleaved sky,
    # through their entry points ---
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
    def frame_phase(name: str, march_kernel: str, extra=(), shaded=("composite", "sky"),
                    **kw) -> dict:
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
        path = (march_kernel, *shaded, *extra)
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
    pc = parity_check()
    check("frame 192x108 card vs cpu", pc["parity_ok"], pc)
    small = parity_config(192, 108)
    for name, s_scene, s_cfg, gate in (
            ("frame 192x108 card vs cpu kerr(spin=0.9)", kerr_scene,
             small.replace(geodesics="kerr"), 0.03),
            ("frame 192x108 card vs cpu rk45", scene,
             small.replace(integrator=Integrator.RK45), 0.02)):
        r = compare_frames(s_scene, s_cfg, 2e-2, gate)
        check(name, r["parity_ok"], dict(r, gate=gate))

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

    # --- 8a. the array textures: bake, cache, upload ---
    assets.clear_cache()
    bake_s, load_s = {}, {}
    for name, bake in (("disk_texture", assets.disk_texture), ("sky_texture", assets.sky_texture),
                       ("temp_lut", assets.blackbody_lut)):
        t0 = time.perf_counter()
        bake()
        bake_s[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bake()
        load_s[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    textures = assets.default_textures(scene.time.device)  # the key texture() uses
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    tex_shapes = {k: list(t.shape) for k, t in textures.items()}
    tex_bytes = {k: t.numel() * t.element_size() for k, t in textures.items()}
    check("assets", tex_shapes == {"disk_texture": [512, 512, 4], "sky_texture": [1024, 2048, 3],
                                   "temp_lut": [64, 256, 3]}
          and all(t.device.type == "cuda" for t in textures.values()),
          dict(bake_s=bake_s, load_s=load_s, upload_s=upload_s, shapes=tex_shapes,
               device_bytes=tex_bytes, device_mb=sum(tex_bytes.values()) / 1e6))

    # --- 8b. the 1918x1081 frame in array texture mode ---
    # The array shade and sky are plain torch: the march is the frame's only
    # kernel, 8 launches a frame (4 traces x 2 rounds).
    array = frame_phase("frame 1918x1081 array", "march", shaded=(), iters=3,
                        texture_mode="array")
    if array["launches_per_frame"]["march"] != 8:
        check("array launches a frame", False, dict(array["launches_per_frame"]))
    array_cfg = cfg.replace(texture_mode="array")
    prof = frame_profile(scene, array_cfg)
    check("profile 1918x1081 array",
          prof["array_composite_ms"] > 0.0 and prof["array_sky_ms"] > 0.0
          and prof["composite_ms"] == 0.0 and prof["sky_ms"] == 0.0, prof)

    # --- 8c. card against CPU in array mode ---
    tex_scene = with_textures(scene)
    small_array = small.replace(texture_mode="array")
    on_card = render(tex_scene, small_array).cpu()
    on_cpu = render(tex_scene.to("cpu"), small_array)
    bad = float((on_card - on_cpu).abs().gt(2e-2).any(-1).float().mean())
    check("frame 192x108 card vs cpu array", bool(torch.isfinite(on_card).all()) and bad <= 0.02,
          dict(bad_frac=bad, gate=0.02, max_abs_err=float((on_card - on_cpu).abs().max())))

    # --- 8d. the gradient, the three textures among its leaves ---
    r = checks.compare_gradients(tex_scene, grad_cfg.replace(texture_mode="array"))
    check("grad 64x36 card vs cpu array",
          r["ok"] and all(k in r["rel_err"] for k in TEXTURE_FIELDS), r)

    # --- 8e. render_tiled: the whole frame, then one interrupted and resumed ---
    tiled_cfg = RenderConfig()
    n_bands = -(-tiled_cfg.height // 256)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "bands.npz")
        reset_launch_counts()
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        whole = render_tiled(scene, tiled_cfg, band_rows=256)
        end_ev.record()
        end_ev.synchronize()
        tiled_ms = start_ev.elapsed_time(end_ev)
        tiled_launches = launch_counts()
        real_trace = tracer.trace_rays_record
        calls = []

        def fail_at_band_4(*a, **kw):
            calls.append(1)
            if len(calls) == 4:
                raise RuntimeError("injected failure at band 4")
            return real_trace(*a, **kw)

        tracer.trace_rays_record = fail_at_band_4
        try:
            render_tiled(scene, tiled_cfg, band_rows=256, checkpoint_path=ckpt, max_retries=0)
            interrupted = False
        except RuntimeError as e:
            interrupted = "band 4/" in str(e)
        finally:
            tracer.trace_rays_record = real_trace
        with np.load(ckpt) as z:
            next_band = int(z["next_band"])
        reset_launch_counts()
        resumed = render_tiled(scene, tiled_cfg, band_rows=256, checkpoint_path=ckpt)
        torch.cuda.synchronize()
        resumed_launches = launch_counts()
        # The last checkpoint holds the whole frame's record, the (1081,
        # 1918, 8) input of the frame's one sky_finalize launch.
        with np.load(ckpt) as z:
            tiled_rec = torch.from_numpy(z["rec"]).to(dev)
    tiled_err = float((resumed - whole).abs().max())
    want = {"march": 2 * n_bands, "composite": n_bands, "sky_finalize": 1}
    check("render_tiled 1918x1081",
          interrupted and next_band == 3 and tiled_err == 0.0
          and tuple(whole.shape) == (1081, 1918, 3) and bool(torch.isfinite(whole).all())
          and all(tiled_launches[k] == want.get(k, 0) for k in tiled_launches)
          and resumed_launches["march"] == 2 * (n_bands - 3)
          and resumed_launches["sky_finalize"] == 1,
          dict(bands=n_bands, ms=tiled_ms, max_abs_err=tiled_err, next_band=next_band,
               launches=tiled_launches, resumed_launches=resumed_launches))
    tiled_bench = dict(launches=tiled_launches, launches_per_frame=tiled_launches)
    # B5 against its plain version on the record the tiled frame gives it.
    skyf_r = checks.compare_sky_finalize(tiled_rec, tiled_cfg, reps=10)
    check("sky_finalize 1918x1081 tiled", skyf_r["ok"], skyf_r)
    # The tiled frame against the same frame rendered densely in one batch
    # (each ray's trace does not depend on its band; the sky runs as B3 on
    # rows there).
    with torch.no_grad():
        dense = render(scene, tiled_cfg.replace(use_ladder=False))
    bad = float((whole - dense).abs().gt(2e-2).any(-1).float().mean())
    check("render_tiled 1918x1081 vs dense render", bad <= 0.02,
          dict(bad_frac=bad, gate=0.02, max_abs_err=float((whole - dense).abs().max())))

    # --- 8f. the public tracer API: card against CPU ---
    api_cfg = RenderConfig(max_iterations=600)
    reset_launch_counts()
    on_card = tracer.trace_image(scene, api_cfg, 640, 361).cpu()
    api_launches = launch_counts()
    on_cpu = tracer.trace_image(scene.to("cpu"), api_cfg, 640, 361)
    alpha = float((on_card[..., 3] == on_cpu[..., 3]).float().mean())
    bad = float((on_card - on_cpu).abs().gt(2e-2).any(-1).float().mean())
    check("trace_rays 640x361 card vs cpu",
          alpha >= 0.98 and bad <= 0.02 and api_launches["sky_finalize"] == 1,
          dict(alpha_agree=alpha, bad_frac=bad, gate=0.02, launches=api_launches))

    # --- 8g. the command line, in processes of its own ---
    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "frame.png")
        runs = {}
        for name, args in (("render", ["render", "-o", png]), ("assets", ["assets"])):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, "-m", "bhx_torch", *args], cwd=root,
                                  capture_output=True, text=True, timeout=300)
            runs[name] = dict(rc=proc.returncode, s=time.perf_counter() - t0,
                              out=proc.stdout.strip()[-300:], err=proc.stderr.strip()[-500:])
        shape = list(load_image(png).shape) if os.path.exists(png) else None
    check("cli render + assets", all(r["rc"] == 0 for r in runs.values())
          and shape == [1081, 1918, 3], dict(runs, png_shape=shape))

    # --- 8h. the viewer ---
    from bhx_torch.viewer import ViewerServer
    from PIL import Image

    server = ViewerServer()
    req = {"pos": [0, 0, -19], "forward": [0, 0, 1], "fov": 1.0, "mass": 0.5, "spin": 0.0,
           "disk_inner": 2.0, "disk_outer": 10.0, "feather": 0.3, "time": 0.0,
           "show_disk": True, "show_texture": True, "show_redshift": True, "show_sky": True,
           "bloom": True, "mix_ratio": 0.7, "fxaa": True, "tonemap": True, "ladder": False,
           "kerr": False, "integrator": "euler", "step_size": 0.15, "max_iter": 800}
    frames = {}
    for name, r_req in (("default", req), ("kerr", dict(req, kerr=True, spin=0.9))):
        server.render_frame(r_req)  # the first call of a setting builds and warms up
        png_bytes, stats = server.render_frame(r_req)
        img = np.asarray(Image.open(io.BytesIO(png_bytes)))
        frames[name] = dict(stats, shape=list(img.shape), png_bytes=len(png_bytes))
    check("viewer 480x270", all(f["shape"] == [270, 480, 3] for f in frames.values()), frames)

    # --- 9. distribution ---
    phase9_t0 = time.perf_counter()
    dense_cfg = RenderConfig(use_ladder=False)

    def timed_ms(fn, iters: int = 3) -> float:
        """CUDA-event ms of one call of ``fn`` after a warm-up call."""
        fn()
        start_ev, end_ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start_ev.record()
        for _ in range(iters):
            fn()
        end_ev.record()
        end_ev.synchronize()
        return start_ev.elapsed_time(end_ev) / iters

    # 9a. a world of one NCCL rank in this process: the sharded record and
    # frame against the dense ones.
    with torch.no_grad():
        dense_rec = tracer.trace_image_record(scene, dense_cfg, 1918, 1081)
        dense_img = render(scene, dense_cfg)
        dense_ms = timed_ms(lambda: render(scene, dense_cfg))
        parallel.init_distributed(f"localhost:{parallel.free_port()}", 1, 0, "nccl")
        try:
            mesh = parallel.tile_mesh(device=dev)
            reset_launch_counts()
            rec = parallel.trace_image_sharded(scene, dense_cfg, mesh, 1918, 1081)
            torch.cuda.synchronize()
            trace_launches = launch_counts()
            reset_launch_counts()
            img = parallel.render_sharded(scene, dense_cfg, mesh)
            torch.cuda.synchronize()
            render_launches = launch_counts()
            sharded_ms = timed_ms(lambda: parallel.render_sharded(scene, dense_cfg, mesh))
            world = (mesh.size, dist.get_backend(mesh.group))
        finally:
            dist.destroy_process_group()
    rec_err = float((rec - dense_rec).abs().max())
    img_err = float((img - dense_img).abs().max())
    check("sharded 1918x1081 world 1 nccl",
          world == (1, "nccl") and rec_err == 0.0 and img_err <= 1e-6
          and trace_launches["march"] > 0 and trace_launches["composite"] > 0
          and trace_launches["sky_finalize"] == 0
          and render_launches["sky_finalize"] == 1 and render_launches["sky"] == 0,
          dict(record_max_abs_err=rec_err, image_max_abs_err=img_err,
               trace_launches=trace_launches, render_launches=render_launches,
               sharded_ms=sharded_ms, dense_render_ms=dense_ms))

    # 9b-9d. two ranks sharing the card (gloo), spawned: the sharded record
    # and frame, two sharded train steps of 6c's fit, bench_scaling over 1
    # and 2 ranks.  The single-process step on the same inputs first.  The
    # steps march 200 iterations, not 400: two processes time-slice the
    # card, and the phase has 90 s.
    shard_fit_cfg = fit_cfg.replace(max_iterations=200)
    params = {k: v.detach().clone().requires_grad_() for k, v in scene_params(scene).items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_step(params, make_optimizer(params, 1e-2), scene, target, shard_fit_cfg)
    torch.cuda.synchronize()
    single_step = dict(s=time.perf_counter() - t0,
                       peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    single_grads = {k: v.grad.detach().cpu() for k, v in params.items() if v.grad is not None}
    del params
    torch.cuda.empty_cache()
    state = scene_to_state(scene)
    jobs = [(parallel.frame_job, (state, dense_cfg)),
            (parallel.fit_job, (state, target.cpu().numpy(), shard_fit_cfg, 2, 1e-2)),
            (parallel.bench_job, (state, dense_cfg, [1, 2], 3))]
    t0 = time.perf_counter()
    try:
        by_rank = parallel.spawn(parallel.run_jobs, 2, device="cuda", timeout=300, args=(jobs,))
    except (RuntimeError, TimeoutError) as e:
        by_rank = None
        check("sharded 2 ranks spawn", False, dict(error=str(e)[-3000:]))
    if by_rank is not None:
        spawn_s = time.perf_counter() - t0
        frames_2 = [r[0] for r in by_rank]
        dense_rec_np, dense_img_np = dense_rec.cpu().numpy(), dense_img.cpu().numpy()
        rows_b = [dict(rank=f["rank"], device=f["device"], device_name=f["device_name"],
                       ms=f["ms"], launches=f["launches"],
                       record_max_abs_err=float(np.abs(f["record"] - dense_rec_np).max()),
                       image_max_abs_err=float(np.abs(f["image"] - dense_img_np).max()))
                  for f in frames_2]
        check("sharded 1918x1081 2 ranks gloo",
              all(r["record_max_abs_err"] == 0.0 and r["image_max_abs_err"] <= 1e-6
                  and all(r["launches"][k] > 0 for k in ("march", "composite", "sky_finalize"))
                  for r in rows_b),
              dict(ranks=rows_b, dense_render_ms=dense_ms, spawn_s=spawn_s))
        fits = [r[1] for r in by_rank]
        grad_err = {}
        for k, g in single_grads.items():
            scale = float(g.abs().max())
            got = torch.from_numpy(fits[0]["grads"][0][k])
            grad_err[k] = float((got - g).abs().max()) / scale if scale > 0 else float(
                got.abs().max())
        same = (fits[0]["losses"] == fits[1]["losses"]
                and all(np.array_equal(a[k], b[k]) for a, b in zip(fits[0]["params"],
                                                                   fits[1]["params"])
                        for k in a))
        check("sharded fit 1918x1081 2 ranks 2 steps",
              same and all(np.isfinite(f["losses"]).all() for f in fits)
              and all(e <= 1e-3 for e in grad_err.values())
              and all(st["march"] > 0 for f in fits for st in f["launches"]),
              dict(losses=fits[0]["losses"], grad_rel_err=grad_err,
                   one_process_step=single_step,
                   s_per_step={f["rank"]: [ms / 1e3 for ms in f["ms"]] for f in fits},
                   peak_mem_gb={f["rank"]: f["peak_mem_gb"] for f in fits}))
        rows_d = by_rank[0][2]
        check("bench_scaling 1918x1081 1,2 ranks (2 ranks share one card: sharded-program "
              "overhead, not scaling)",
              [r["devices"] for r in rows_d] == [1, 2] and rows_d[0]["efficiency"] == 1.0
              and rows_d == by_rank[1][2]
              and all(np.isfinite(r["rays_per_s"]) and r["rays_per_s"] > 0 for r in rows_d),
              dict(rows=rows_d))
    phase9_s = time.perf_counter() - phase9_t0
    check("phase 9 time", phase9_s <= 90.0, dict(s=phase9_s))

    # --- 9e. the sharded ladder: two ranks sharing the card (gloo) ---
    # The record at the default frame; the step is 6c's fit on the ladder,
    # at 9c's 200 march iterations, toward the ladder's own render at mass
    # 0.6.  The single-process references first.
    phase9e_t0 = time.perf_counter()
    ladder_path = dict(march=8, composite=4, sky=1)

    def path_launches(launches: dict) -> bool:
        return all(launches[k] == ladder_path.get(k, 0) for k in launches)

    ladder_fit_cfg = shard_fit_cfg.replace(use_ladder=True)
    with torch.no_grad():
        ladder_rec = ladder_trace_rows(scene, cfg).cpu().numpy()
        one_levels = []
        one_mesh = parallel.tile_mesh(device=dev)
        one_rec = parallel._sharded_ladder_rows(scene, cfg, one_mesh, one_levels)
        one_rec_err = float(np.abs(one_rec.cpu().numpy() - ladder_rec).max())
        del one_rec
        # The ladder traced as one process does (each level masked and
        # dense) against a world of one tracing each level's pixels alone.
        ladder_ms = dict(
            masked=timed_ms(lambda: ladder_trace_rows(scene, cfg)),
            compacted_world_of_one=timed_ms(
                lambda: parallel._sharded_ladder_rows(scene, cfg, one_mesh)))
        ladder_target = render(apply_params(scene, dict(scene_params(scene), mass=0.6)),
                               ladder_fit_cfg)
    params = {k: v.detach().clone().requires_grad_() for k, v in scene_params(scene).items()}
    opt = make_optimizer(params, 1e-2)
    one_steps, ladder_grads = [], None
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss = train_step(params, opt, scene, ladder_target, ladder_fit_cfg)
        torch.cuda.synchronize()
        one_steps.append(dict(s=time.perf_counter() - t0, loss=float(loss),
                              peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                              launches=launch_counts()))
        if i == 0:
            ladder_grads = {k: v.grad.detach().cpu() for k, v in params.items()
                            if v.grad is not None}
    del params, opt
    torch.cuda.empty_cache()
    jobs = [(parallel.ladder_job, (state, cfg)),
            (parallel.fit_job, (state, ladder_target.cpu().numpy(), ladder_fit_cfg, 2, 1e-2))]
    t0 = time.perf_counter()
    try:
        by_rank = parallel.spawn(parallel.run_jobs, 2, device="cuda", timeout=300, args=(jobs,))
    except (RuntimeError, TimeoutError) as e:
        by_rank = None
        check("sharded ladder 2 ranks spawn", False, dict(error=str(e)[-3000:]))
    if by_rank is not None:
        spawn_s = time.perf_counter() - t0
        lads = [r[0] for r in by_rank]
        levels = []
        for lvl, one in enumerate(one_levels):
            mine = [lad["levels"][lvl] for lad in lads]
            levels.append(dict(level=lvl, size=[one["width"], one["height"]],
                               retrace=one["retrace"], one_process_ms=one["ms"],
                               traced=[m["traced"] for m in mine],
                               padded=[m["padded"] for m in mine],
                               ms=[m["ms"] for m in mine]))
        rec_errs = [float(np.abs(lad["record"] - ladder_rec).max()) for lad in lads]
        check("sharded ladder 1918x1081 2 ranks gloo",
              one_rec_err == 0.0 and all(e == 0.0 for e in rec_errs)
              and all(sum(lv["traced"]) == lv["retrace"] for lv in levels)
              and all(max(lv["traced"]) - min(lv["traced"]) <= 1 for lv in levels)
              and all(lad["levels"][i]["retrace"] == lv["retrace"]
                      for lad in lads for i, lv in enumerate(levels))
              and all(path_launches(lad["launches"]) for lad in lads),
              dict(record_max_abs_err=rec_errs, world_of_one_record_max_abs_err=one_rec_err,
                   one_process_ladder_ms=ladder_ms, levels=levels, launches={lad["rank"]: lad["launches"] for lad in lads},
                   spawn_s=spawn_s))
        fits = [r[1] for r in by_rank]
        grad_err = {}
        for k, g in ladder_grads.items():
            scale = float(g.abs().max())
            got = torch.from_numpy(fits[0]["grads"][0][k])
            grad_err[k] = float((got - g).abs().max()) / scale if scale > 0 else float(
                got.abs().max())
        same = (fits[0]["losses"] == fits[1]["losses"]
                and all(np.array_equal(a[k], b[k]) for a, b in zip(fits[0]["params"],
                                                                   fits[1]["params"])
                        for k in a))
        check("sharded ladder fit 1918x1081 2 ranks 2 steps",
              same and all(np.isfinite(f["losses"]).all() for f in fits)
              and set(grad_err) == set(fits[0]["grads"][0])
              and all(e <= 1e-3 for e in grad_err.values())
              and all(path_launches(st) for f in fits for st in f["launches"])
              and all(path_launches(st["launches"]) for st in one_steps),
              dict(losses=fits[0]["losses"], grad_rel_err=grad_err,
                   one_process_ladder_steps=[{k: v for k, v in st.items() if k != "launches"}
                                             for st in one_steps],
                   one_process_dense_step=single_step,
                   s_per_step={f["rank"]: [ms / 1e3 for ms in f["ms"]] for f in fits},
                   peak_mem_gb={f["rank"]: f["peak_mem_gb"] for f in fits},
                   launches_per_step=fits[0]["launches"][0]))
    phase9e_s = time.perf_counter() - phase9e_t0
    # 76.7 s in its first run on one H100 (700 W); twice that with headroom.
    check("phase 9e time", phase9e_s <= 150.0, dict(s=phase9e_s))

    # --- 10. the camera's pose on the card ---
    phase10_t0 = time.perf_counter()
    base = Scene.default(dev)
    rot_scene = dataclasses.replace(base, camera=base.camera.rotated(0.35, -0.15))
    eye = (6.0, -2.0, -18.0)
    look_cam = dataclasses.replace(base.camera, position=torch.tensor(eye, device=dev))
    cpu_cam = base.camera.to("cpu")
    # 10a. the pose methods on the card against the same calls on the CPU.
    poses = {
        "rotated": (rot_scene.camera, cpu_cam.rotated(0.35, -0.15)),
        "look_at": (look_cam.look_at((0.0, 0.0, 0.0)),
                    dataclasses.replace(cpu_cam, position=torch.tensor(eye))
                    .look_at((0.0, 0.0, 0.0))),
    }
    pose_err, on_card, forwards = {}, True, {}
    for name, (card_cam, cpu_pose) in poses.items():
        forwards[name] = card_cam.forward.tolist()
        for part, got, want in (("forward", card_cam.forward, cpu_pose.forward),
                                ("right", card_cam.right(), cpu_pose.right())):
            on_card = on_card and got.device.type == "cuda"
            pose_err[f"{name} {part}"] = float((got.cpu() - want).abs().max())
    check("pose card vs cpu", on_card and max(pose_err.values()) <= 2e-6,
          dict(max_abs_err=pose_err, gate=2e-6, forward=forwards))

    # 10b. the rotated scene's default frame: every frame that frame_profile
    # renders launches what phase 4's frame launches.
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    reset_launch_counts()
    prof = frame_profile(rot_scene, RenderConfig())
    torch.cuda.synchronize()
    counts = launch_counts()
    path = ("march", "composite", "sky")
    counts_ok = all(counts[k] == prof["frames"] * euler["launches_per_frame"][k]
                    and (counts[k] > 0) == (k in path) for k in counts)
    with torch.no_grad():
        img = render(rot_scene, RenderConfig())
        unposed = render(base, RenderConfig())
    moved = float((img - unposed).abs().gt(2e-2).any(-1).float().mean())
    check("frame 1918x1081 rotated", counts_ok and bool(torch.isfinite(img).all())
          and tuple(img.shape) == (1081, 1918, 3) and moved >= 0.2,
          dict(prof, launches=counts,
               launches_per_frame={k: v / prof["frames"] for k, v in counts.items()},
               phase4_launches_per_frame=euler["launches_per_frame"],
               changed_frac=moved, card=card))

    # 10c. card against CPU.
    r = compare_frames(rot_scene, parity_config(192, 108), 2e-2, 0.02)
    check("frame 192x108 card vs cpu rotated", r["parity_ok"], dict(r, gate=0.02))

    # 10d. d/d(yaw, pitch) through rotated, card against CPU.
    reset_launch_counts()
    t0 = time.perf_counter()
    r = checks.compare_pose_gradients(base, grad_cfg.replace(width=320, height=180),
                                      0.35, -0.15)
    r["s"] = time.perf_counter() - t0
    pose_launches, pose_replays = launch_counts(), replay_counts()
    check("grad 320x180 card vs cpu yaw, pitch",
          r["ok"] and r["kept_frac"] > 0.3 and all(pose_launches[k] > 0 for k in path)
          and all(pose_replays[k] > 0 for k in path),
          dict(r, gate=checks.GRAD_REL, launches=pose_launches, replays=pose_replays))
    phase10_s = time.perf_counter() - phase10_t0
    check("phase 10 time", phase10_s <= 60.0, dict(s=phase10_s))

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
        entry("sky_finalize", "sky.cu", "bhx/kernels/shade_pallas.py:723", tiled_bench, skyf_r),
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
