"""Measure the march kernel, the composite and ingredients kernels, or the
mesh kernel M1, at the default frame's shapes (the mesh frame's for M1)
on one CUDA card.

``--study march`` (the default): for each branch (Euler, RK45, Kerr spin
0.9) and each of the last ladder level's two march launches (round 0 and
the re-entry round 1), print one JSON line with the launch's work and
bound (``checks.march_work``), the SIMT efficiency of one thread per lane
in pixel order and of the live lanes packed 32 to a warp, and, for every
kernel compared, its time (CUDA events, 10 calls after a warm-up, taken
in turns a, b, ..., b, a) and its serial floor (``checks.serial_floor``).

``--study shade``: one JSON line for the composite on the slots of the
last ladder level's round-0 march (Euler) and of the dense 640x361 trace
of Euler and of Kerr spin 0.9, with their work (``checks.composite_work``:
valid slots, rays with one, SIMT efficiency one thread per ray and packed
per block of 256 rays), the bound (``checks.composite_bound``; and
``slot0_bound_ms``, the bound under the narrower byte count of earlier
records, 4 (5n + 6v + v_0), which reads only slot 0's valid row of every
ray and a later slot's behind a valid one), every kernel's time in turns
on those slots, on the same slots with every valid row zeroed (the
streaming floor: loads and stores alone) and on the rays with a valid
slot alone (the shading, with little stream); after the Euler 640x361 line,
one for the ingredients on its slots, with their bound and times.

``--study mesh``: the mesh frame (PERF.md section 4: the cube and the
524,288-triangle torus seen from z = -40, 1918x1081 ladder) by the
``bhx_torch`` of each tree root given in ``--frames``, in turns a, b, ...,
b, a, each in a process of its own: the frame's 12 mesh calls (4 ladder
levels x 3 straight phases) recorded from one render and each timed with
the rays as that tree's tracer hands them over (CUDA events, 10 calls
after a warm-up), the M1 launches of one call, device ms
by kernel over the 12 calls (the rest is glue) and their device events
(``torch.profiler``), and ``bench.frame_profile`` of the frame with and
without the meshes; every call's output held against the first root's bit
for bit; then the work and bound of the last level's three calls
(``checks.meshes_work``, ``checks.mesh_bound``).  Against PR 6's tree:

    mkdir -p build/parent && git archive 07ddcdf bhx_torch tests | tar -x -C build/parent
    python -m bhx_torch.march_study --study mesh --frames build/parent,.

``--study array``: the 1918x1081 array-texture frame (PERF.md section 4)
by the ``bhx_torch`` of each tree root given in ``--frames``, in turns a,
b, ..., b, a, each in a process of its own: ``bench.run_bench``'s ms a
frame (CUDA events) and host ms a frame, ``bench.frame_profile``'s device
busy ms, idle share and the array composite's and sky's device ms a frame,
and one gradient step of the dense frame (no bloom or FXAA, 400
iterations, as ``fit_scene`` at ``bhx fit``'s defaults, with the sky) with
respect to the three textures: its ms (CUDA events, after a warm-up step) and peak
memory.  The frame and the gradients are held against the first root's.

Every march or shade kernel's output is held against the first one's (the march) or the
plain version's (the shade kernels) bit for bit.  The kernels: ``new``,
the package's ``csrc/``; ``old``, another ``march.cu`` with the first
port's entry point (no scratch pointers) or another ``shade.cu``, given
by ``--old``.  Each is called through its C entry point here, with
scratch of its own, and counted here: the package's launch counts do not
move.  ``--profile`` adds each kernel's device time by CUDA kernel
(``torch.profiler``, three calls).

``--frames ROOT,...`` adds each branch's default 1918x1081 frame rendered
by the ``bhx_torch`` package of each tree root (``.``, or an earlier
commit unpacked with ``git archive``), in turns a, b, ..., b, a, each in a
process of its own: ms a frame (CUDA events over 3 frames after 2 warm-up
frames) and, from ``torch.profiler`` over 3 frames, the device's busy ms
a frame (the union of its kernels' intervals), the march's and the
composite's.  Run from the repository root, against an earlier commit:

    mkdir -p build/parent && git archive a26d756 | tar -x -C build/parent
    python -m bhx_torch.march_study --study shade \\
        --old build/parent/bhx_torch/csrc/shade.cu --kernels old,new \\
        --frames build/parent,.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from bhx_torch import checks
from bhx_torch.config import Integrator, RenderConfig
from bhx_torch.kernels import build
from bhx_torch.kernels import march as march_mod
from bhx_torch.kernels import shade as shade_mod
from bhx_torch.scene import Scene, with_spin
from bhx_torch.tracer import march_batch, march_kwargs

# The first port's march entry point: rays, params, out, n, max_iterations,
# tex_opacity_min, show_disk, mode.
OLD_SIGNATURE = {"bhx_march": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                               ctypes.c_int, ctypes.c_int)}
# The shade entry points, unchanged since the first port.
SHADE_SIGNATURES = {k: build.SIGNATURES[k] for k in ("bhx_composite", "bhx_ingredients")}

# Launches of each kernel made by this study.
launches: dict = {}


def _march_runner(name: str, lib: ctypes.CDLL, scratch: bool):
    """march(rays, params, **march_kwargs) through ``lib``'s ``bhx_march``;
    ``scratch``: the entry point takes the queue and its counters."""
    def run(rays, params, **kw):
        n = rays.shape[1]
        out = torch.empty((march_mod.out_fields(kw["geodesics"]), n),
                          dtype=torch.float32, device=rays.device)
        if n:
            extra = ((torch.empty((n,), dtype=torch.int32, device=rays.device),
                      torch.zeros((3,), dtype=torch.int32, device=rays.device))
                     if scratch else ())
            build.call(lib, "bhx_march", rays, params, out, *extra, n,
                       int(kw["max_iterations"]), float(kw["tex_opacity_min"]),
                       int(kw["show_disk"]),
                       march_mod._mode(kw["integrator"], kw["geodesics"]))
            launches[name] += 1
        return out
    return run


def _shade_runners(name: str, lib: ctypes.CDLL):
    """composite(slots, cam, params, gain, cfg) and ingredients(slots, cam,
    params, cfg) through ``lib``'s ``bhx_composite`` and
    ``bhx_ingredients``."""
    def composite(slots, cam, params, gain, cfg):
        n = slots.shape[1]
        out = torch.empty((4, n), dtype=torch.float32, device=slots.device)
        build.call(lib, "bhx_composite", slots, cam, params, gain, int(gain.shape[0]),
                   int(gain.shape[1]), shade_mod.tint_table(slots.device), out, n,
                   int(cfg.show_disk_texture), int(cfg.show_redshift))
        launches[f"{name} composite"] += 1
        return out

    def ingredients(slots, cam, params, cfg):
        n = slots.shape[1]
        out = torch.empty((shade_mod.MAX_CROSSINGS * shade_mod.ING_FIELDS, n),
                          dtype=torch.float32, device=slots.device)
        build.call(lib, "bhx_ingredients", slots, cam, params,
                   shade_mod.tint_table(slots.device), out, n,
                   int(cfg.show_disk_texture), int(cfg.show_redshift))
        launches[f"{name} ingredients"] += 1
        return out
    return composite, ingredients


def _libraries(names, old_path, study: str):
    """name -> the library of every kernel compared; prints each build's
    ptxas report.  ``old`` is ``old_path`` built alone (a march.cu) or
    beside the package's march.cu, which holds the error-string entry (a
    shade.cu)."""
    libs, report = {}, {}
    for name in names:
        if name == "old":
            paths = [Path(old_path).resolve()]
            if study == "shade":
                paths.append(build.CSRC / "march.cu")
            libs[name] = build.compile_library(
                paths, OLD_SIGNATURE if study == "march" else SHADE_SIGNATURES,
                name=f"lib{study}_old")
            log = build.log_path(paths).read_text()
        elif name == "new":
            libs[name] = build.library()
            log = build.log_path().read_text()
        else:
            raise ValueError(f"unknown kernel {name!r}: new or old")
        report[name] = [ln.strip() for ln in log.splitlines()
                        if any(k in ln for k in ("entry function", "registers", "spill"))]
    for name, lines in report.items():
        print(json.dumps(dict(ptxas=name, lines=lines)), flush=True)
    return libs


def _turns(fns: dict, reps: int) -> dict:
    """ms a call of each of ``fns`` (name -> call), ``reps`` calls after a
    warm-up, in turns a, b, ..., b, a."""
    times = {n: [] for n in fns}
    for n in list(fns) + list(reversed(list(fns))):
        times[n].append(checks._timed(fns[n], reps)[1])
    return times


def _live_steps(rays, params, out) -> torch.Tensor:
    live = (rays[7] > 0.5) & (rays[9] < params[march_mod._P["budget"]])
    return out[march_mod._OUT_FIXED["steps"]][live].double()


def _packed_simt(steps: torch.Tensor):
    """SIMT efficiency with the live lanes packed 32 to a warp in pixel
    order (compaction without refill)."""
    if not steps.numel():
        return None
    warp_max = torch.nn.functional.pad(steps, (0, (-steps.numel()) % 32)).reshape(-1, 32)
    return float(steps.sum()) / (32.0 * float(warp_max.amax(1).sum()))


def _steps_quantiles(steps: torch.Tensor) -> dict:
    if not steps.numel():
        return {}
    q = torch.quantile(steps, torch.tensor([0.5, 0.9, 0.99, 0.999], dtype=torch.float64,
                                           device=steps.device))
    return dict(p50=float(q[0]), p90=float(q[1]), p99=float(q[2]), p999=float(q[3]),
                at_max=int((steps == steps.max()).sum()))


def _profile(fn, calls: int = 3) -> dict:
    """Device microseconds per call of each CUDA kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / calls for e in prof.key_averages()
            if e.device_time_total > 0}


def _branches():
    scene = Scene.default()
    return {
        "march": (scene, RenderConfig()),
        "march_rk45": (scene, RenderConfig(integrator=Integrator.RK45)),
        "march_kerr": (with_spin(scene, 0.9), RenderConfig(geodesics="kerr")),
    }


def study(kernel_names, old_path=None, reps: int = 10, profile: bool = False):
    libs = _libraries(kernel_names, old_path, "march")
    kernels = {n: _march_runner(n, lib, scratch=n == "new") for n, lib in libs.items()}
    for n in kernels:
        launches[n] = 0
    rows = []
    for branch, (b_scene, cfg) in _branches().items():
        kw = march_kwargs(cfg)
        for rnd in (0, 1):
            rays, params, _ = checks.last_level_batch(b_scene, cfg, march_round=rnd)
            outs = {n: fn(rays, params, **kw) for n, fn in kernels.items()}
            first = outs[kernel_names[0]]
            steps = _live_steps(rays, params, first)
            row = dict(kernel=branch, round=rnd,
                       **checks.march_work(rays, params, first, branch),
                       packed_simt_eff=_packed_simt(steps),
                       steps_q=_steps_quantiles(steps),
                       max_abs_err={n: float((o - first).abs().max()) for n, o in outs.items()})
            row["ms"] = _turns({n: (lambda f=f: f(rays, params, **kw))
                                for n, f in kernels.items()}, reps)
            row["floor"] = {n: checks.serial_floor(rays, params, first,
                                                   lambda r, p, f=f: f(r, p, **kw))
                            for n, f in kernels.items()}
            if profile:
                row["profile_us"] = {n: _profile(lambda f=f: f(rays, params, **kw))
                                     for n, f in kernels.items()}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(dict(launches=launches)), flush=True)
    return rows


def shade_study(kernel_names, old_path=None, reps: int = 10, profile: bool = False):
    libs = _libraries(kernel_names, old_path, "shade")
    runners = {n: _shade_runners(n, lib) for n, lib in libs.items()}
    for n in runners:
        launches[f"{n} composite"] = launches[f"{n} ingredients"] = 0
    branches = _branches()
    scene, cfg = branches["march"]
    cases = {"last level": (scene, cfg, checks.last_level_batch(scene, cfg)),
             "640x361": (scene, cfg, march_batch(scene, cfg, 640, 361))}
    kerr_scene, kerr_cfg = branches["march_kerr"]
    cases["640x361 kerr"] = (kerr_scene, kerr_cfg, march_batch(kerr_scene, kerr_cfg, 640, 361))
    rows = []

    def record(row, fns, plain, **parts):
        want = plain()
        row["max_abs_err"] = {n: checks._max_abs_err(f(), want) for n, f in fns.items()}
        row["ms"] = _turns(fns, reps)
        for name, part_fns in parts.items():
            row[name] = _turns(part_fns, reps)
        if profile:
            row["profile_us"] = {n: _profile(f) for n, f in fns.items()}
        rows.append(row)
        print(json.dumps(row), flush=True)

    for case, (s, c, (rays, params, cam)) in cases.items():
        slots = march_mod.march(rays, params, **march_kwargs(c))[
            march_mod.OUT_FIXED:march_mod.OUT_FIXED + march_mod.SLOT_ROWS]
        sp = checks.shade_params(s)
        flags = dict(show_texture=c.show_disk_texture, show_redshift=c.show_redshift)
        no_valid = slots.clone()
        no_valid[march_mod.CROSS_FIELDS - 1::march_mod.CROSS_FIELDS] = 0.0
        crossing = checks._valid_slots(slots).any(0)
        only, only_cam = slots[:, crossing].contiguous(), cam[crossing].contiguous()
        work, bnd = checks.composite_work(slots), checks.composite_bound(slots, c)
        slot0_bytes = 4.0 * (5 * work["n"] + 6 * work["v"] + work["v_by_k"][0])
        row = dict(kernel="composite", case=case, **work, **bnd,
                   slot0_bound_ms=max(bnd["ops_ms"],
                                      slot0_bytes / checks.PEAK_BYTES_PER_S * 1e3))
        record(row,
               {n: (lambda f=comp: f(slots, cam, sp, s.disk_gain, c))
                for n, (comp, _) in runners.items()},
               lambda: shade_mod.composite_torch(slots, cam, sp, s.disk_gain, **flags),
               floor_ms={n: (lambda f=comp: f(no_valid, cam, sp, s.disk_gain, c))
                         for n, (comp, _) in runners.items()},
               crossing_ms={n: (lambda f=comp: f(only, only_cam, sp, s.disk_gain, c))
                            for n, (comp, _) in runners.items()})
        if case == "640x361":
            record(dict(kernel="ingredients", case=case, n=work["n"],
                        **checks.ingredients_bound(slots, c)),
                   {n: (lambda f=ing: f(slots, cam, sp, c)) for n, (_, ing) in runners.items()},
                   lambda: shade_mod.ingredients_torch(slots, cam, sp, **flags))
    print(json.dumps(dict(launches=launches)), flush=True)
    return rows


# Run in a process of its own by :func:`frames`, with a tree root's
# bhx_torch first on the path; uses only what every version of the
# package has.  Prints one JSON object: branch -> frame_ms, device_ms,
# march_device_ms, composite_device_ms.
_FRAME_SCRIPT = r"""
import json, sys
import torch
from torch.profiler import ProfilerActivity, profile
from bhx_torch.config import Integrator, RenderConfig
from bhx_torch.pipeline import render
from bhx_torch.scene import Scene, with_spin

iters = int(sys.argv[1])
scene = Scene.default("cuda")
branches = {
    "march": (scene, RenderConfig()),
    "march_rk45": (scene, RenderConfig(integrator=Integrator.RK45)),
    "march_kerr": (with_spin(scene, 0.9), RenderConfig(geodesics="kerr")),
}


def busy(spans):
    # The length of the union of (start, end) intervals: overlapping
    # kernels counted once.
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def busy_ms(kernels, part=""):
    return busy([(e.time_range.start, e.time_range.end)
                 for e in kernels if part in e.name]) / iters / 1e3


rows = {}
for name, (s, cfg) in branches.items():
    for _ in range(2):
        render(s, cfg)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        render(s, cfg)
    b.record()
    b.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            render(s, cfg)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    # The composite's kernel is the only one whose name holds "shade".
    rows[name] = dict(frame_ms=a.elapsed_time(b) / iters, device_ms=busy_ms(kernels),
                      march_device_ms=busy_ms(kernels, "march"),
                      composite_device_ms=busy_ms(kernels, "shade"))
print(json.dumps(rows))
"""


def frames(roots, iters: int = 3):
    """Each branch's default frame rendered by the package of each tree
    root in ``roots``, in turns a, b, ..., b, a (see the module
    docstring).  Returns branch -> {measure: {root: [one value a turn]}}."""
    rows = {}
    for root in list(roots) + list(reversed(roots)):
        path = str(Path(root).resolve())
        proc = subprocess.run([sys.executable, "-c", _FRAME_SCRIPT, str(iters)], cwd=path,
                              env=dict(os.environ, PYTHONPATH=path), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"frames under {root} failed:\n{proc.stderr[-4000:]}")
        for branch, measures in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            for measure, value in measures.items():
                rows.setdefault(branch, {}).setdefault(measure, {}).setdefault(
                    root, []).append(value)
    for branch, row in rows.items():
        print(json.dumps(dict(frames=branch, **row)), flush=True)
    return rows


# Run in a process of its own by :func:`mesh_study`, with a tree root's
# bhx_torch first on the path; uses only what every version of the package
# since meshes has.  Arguments: the torus's OBJ file, a file for the
# recorded calls and their outputs, calls a timing.  Prints one JSON
# object.
_MESH_SCRIPT = r"""
import dataclasses, json, os, sys
import torch
from torch.profiler import ProfilerActivity, profile
import bhx_torch.tracer as tracer
from bhx_torch import checks
from bhx_torch.bench import frame_profile
from bhx_torch.config import RenderConfig
from bhx_torch.geometry import obj, traverse
from bhx_torch.kernels import launch_counts, reset_launch_counts
from bhx_torch.pipeline import render
from bhx_torch.scene import Camera, Scene

sys.path.insert(0, "tests")
from torch_mesh_data import cube_arrays

obj_path, record_path, reps = sys.argv[1], sys.argv[2], int(sys.argv[3])
dev = torch.device("cuda")
cube = obj.make_mesh(cube_arrays(), position=(6.0, 0.0, -30.0), name="cube", scale=1.0,
                     flip_y=False)
torus = obj.make_mesh(obj_path, position=(-6.0, 0.0, -27.0), name="torus")
scene = dataclasses.replace(
    Scene.default(dev), meshes=(cube, torus),
    camera=Camera(position=torch.tensor([0.0, 0.0, -40.0], device=dev),
                  forward=torch.tensor([0.0, 0.0, 1.0], device=dev),
                  fov=torch.tensor(1.0, device=dev)))
cfg = RenderConfig()

# The frame's own mesh calls: (origin, direction, active) of each, (N, 3)
# whatever the tracer hands over; and the rays as this tree's tracer hands
# them (three rows each, or (N, 3)), which each call is replayed with.
calls, given, original = [], [], tracer.intersect_meshes


def copy(x):
    return x.clone() if torch.is_tensor(x) else tuple(r.clone() for r in x)


def record(origin, direction, meshes, active=None):
    rays = [x if torch.is_tensor(x) else torch.stack(tuple(x), -1)
            for x in (origin, direction)]
    calls.append([r.clone() for r in rays] + [active.clone()])
    given.append((copy(origin), copy(direction)))
    return original(origin, direction, meshes, active)


tracer.intersect_meshes = record
with torch.no_grad():
    render(scene, cfg)
tracer.intersect_meshes = original
torch.cuda.synchronize()


def run(k):
    return traverse.intersect_meshes(*given[k], scene.meshes, calls[k][2])


outs, ms = [], []
for k in range(len(calls)):
    got, t = checks._timed(lambda k=k: run(k), reps)
    outs.append({key: v.cpu() for key, v in got.items()})
    ms.append(t)
reset_launch_counts()
run(len(calls) - 3)
torch.cuda.synchronize()
launches = launch_counts()["mesh"]
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for k in range(len(calls)):
        run(k)
    torch.cuda.synchronize()
kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
by_kernel = {}
for e in kernels:
    name = e.name.split("(")[0].split("::")[-1]
    if "mesh" not in e.name:
        name = "glue"
    by_kernel[name] = by_kernel.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
torch.save(dict(calls=[[t.cpu() for t in c] for c in calls], outs=outs), record_path)
frames = {name: frame_profile(scene, c) for name, c in
          (("meshes", cfg), ("meshes off", cfg.replace(render_meshes=False)))}
print(json.dumps(dict(
    n=[int(c[0].shape[0]) for c in calls], active=[int(c[2].sum()) for c in calls],
    call_ms=ms, launches_a_call=launches, calls_device_events=len(kernels),
    calls_device_ms_by_kernel=by_kernel, frames=frames)))
"""


# Run in a process of its own by :func:`array_study`, with a tree root's
# bhx_torch first on the path.  Arguments: frames a timing, a file for the
# frame and the gradients.  Prints one JSON object.
_ARRAY_SCRIPT = r"""
import dataclasses, json, sys
import torch
from bhx_torch.bench import frame_profile, run_bench
from bhx_torch.config import BloomConfig, FxaaConfig, RenderConfig
from bhx_torch.pipeline import render
from bhx_torch.scene import TEXTURE_FIELDS, Scene, with_textures

iters, out_path = int(sys.argv[1]), sys.argv[2]
bench = run_bench(1918, 1081, iters=iters, texture_mode="array")
image = bench.pop("image")
scene = with_textures(Scene.default("cuda"))
prof = frame_profile(scene, RenderConfig(texture_mode="array"), iters=iters)
cfg = RenderConfig(use_ladder=False, max_iterations=400, bloom=BloomConfig(enabled=False),
                   fxaa=FxaaConfig(enabled=False), texture_mode="array")


def step():
    leaves = {k: getattr(scene, k).detach().clone().requires_grad_() for k in TEXTURE_FIELDS}
    loss = render(dataclasses.replace(scene, **leaves), cfg).square().mean()
    return torch.autograd.grad(loss, list(leaves.values()))


step()
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats()
a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
a.record()
grads = step()
b.record()
b.synchronize()
torch.save(dict(image=image.cpu(), grads=[g.cpu() for g in grads]), out_path)
print(json.dumps(dict(
    ms_per_frame=bench["ms_per_frame"], host_ms_per_frame=bench["host_ms_per_frame"],
    launches_per_frame=bench["launches_per_frame"], device_ms=prof["device_ms"],
    idle_frac=prof["idle_frac"], device_events=prof["device_events"],
    array_composite_ms=prof["array_composite_ms"], array_sky_ms=prof["array_sky_ms"],
    grad_step_ms=a.elapsed_time(b),
    grad_peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)))
"""


def array_study(roots, iters: int = 5):
    """The 1918x1081 array-texture frame and its texture gradient by the
    package of each tree root in ``roots``, in turns a, b, ..., b, a, each
    in a process of its own (see the module docstring); the frame and the
    gradients held against the first root's.  Returns root -> [row a
    turn]."""
    import tempfile

    turns: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        for t, root in enumerate(list(roots) + list(reversed(roots))):
            path = str(Path(root).resolve())
            out = os.path.join(tmp, f"array_{t}.pt")
            proc = subprocess.run([sys.executable, "-c", _ARRAY_SCRIPT, str(iters), out],
                                  cwd=path, env=dict(os.environ, PYTHONPATH=path),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"array study under {root} failed:\n{proc.stderr[-4000:]}")
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            got = torch.load(out)
            if not turns:
                first = got
            row["image_max_abs_err"] = checks._max_abs_err(got["image"], first["image"])
            row["grad_max_rel_err"] = max(
                float((g - f).abs().max() / f.abs().max().clamp_min(1e-30))
                for g, f in zip(got["grads"], first["grads"]))
            turns.setdefault(root, []).append(row)
            print(json.dumps(dict(array_turn=t, root=root, **row)), flush=True)
    return turns


def _mesh_data():
    """The tests' numpy mesh generator (``tests/torch_mesh_data.py``)."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tests"))
    import torch_mesh_data

    return torch_mesh_data


def mesh_study(roots, reps: int = 10):
    """The mesh frame's M1 calls (its 12 straight phases: 4 ladder levels x
    3) and the mesh frame itself, by the package of each tree root in
    ``roots``, in turns a, b, ..., b, a, each in a process of its own (see
    the module docstring).  Every call's output is held against the first
    root's, bit for bit; the work of the last level's calls is counted here
    by ``checks.meshes_work``.  Returns the rows."""
    import tempfile

    from bhx_torch.geometry import obj

    turns: dict = {}
    with tempfile.TemporaryDirectory() as tmp:
        obj_path = os.path.join(tmp, "torus.obj")
        data = _mesh_data()
        data.write_obj(obj_path, *data.torus_arrays(512, 512))
        for t, root in enumerate(list(roots) + list(reversed(roots))):
            path = str(Path(root).resolve())
            record = os.path.join(tmp, f"record_{t}.pt")
            proc = subprocess.run([sys.executable, "-c", _MESH_SCRIPT, obj_path, record,
                                   str(reps)], cwd=path, env=dict(os.environ, PYTHONPATH=path),
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"mesh study under {root} failed:\n{proc.stderr[-4000:]}")
            row = json.loads(proc.stdout.strip().splitlines()[-1])
            rec = torch.load(record)
            if not turns:
                first_rec = rec
            row["max_abs_err"] = max(
                checks._max_abs_err(got[k].float(), want[k].float())
                for got, want in zip(rec["outs"], first_rec["outs"]) for k in want)
            turns.setdefault(root, []).append(row)
            print(json.dumps(dict(mesh_turn=t, root=root, **row)), flush=True)
        meshes = (obj.make_mesh(data.cube_arrays(), position=(6.0, 0.0, -30.0),
                                name="cube", scale=1.0, flip_y=False),
                  obj.make_mesh(obj_path, position=(-6.0, 0.0, -27.0), name="torus"))
    # The work of the last level's three calls (the frame's largest).
    work = []
    for k in range(len(first_rec["calls"]) - 3, len(first_rec["calls"])):
        o, d, act = (x.cuda() for x in first_rec["calls"][k])
        w = checks.meshes_work(o, d, meshes, act)
        w.update(checks.mesh_bound(w), call=k)
        work.append(w)
        print(json.dumps(dict(mesh_work=w)), flush=True)
    return dict(turns=turns, work=work)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--study", choices=("march", "shade", "mesh", "array"), default="march",
                    help="the march kernel, the composite and ingredients kernels, "
                         "the mesh kernel M1 by tree (--frames), or the array-texture "
                         "frame by tree (--frames)")
    ap.add_argument("--old", help="a march.cu with the first port's entry point, or a "
                                  "shade.cu (with --study shade)")
    ap.add_argument("--kernels", default="new", help="comma-separated: new, old")
    ap.add_argument("--profile", action="store_true",
                    help="device time by CUDA kernel")
    ap.add_argument("--frames", help="comma-separated tree roots whose bhx_torch renders "
                                     "each branch's default frame, in turns")
    ap.add_argument("--out", help="also write the rows here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("march_study: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    if args.study == "mesh":
        if not args.frames:
            ap.error("--study mesh takes the tree roots to compare in --frames")
        rows, frame_rows = mesh_study(args.frames.split(",")), {}
    elif args.study == "array":
        if not args.frames:
            ap.error("--study array takes the tree roots to compare in --frames")
        rows, frame_rows = array_study(args.frames.split(",")), {}
    else:
        run = study if args.study == "march" else shade_study
        rows = run(args.kernels.split(","), args.old, profile=args.profile)
        frame_rows = frames(args.frames.split(",")) if args.frames else {}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=smi.stdout.strip(), rows=rows,
                                                  launches=launches, frames=frame_rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
