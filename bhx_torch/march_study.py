"""Measure the march kernel at the default frame's shapes on one CUDA card.

For each branch (Euler, RK45, Kerr spin 0.9) and each of the last ladder
level's two march launches (round 0 and the re-entry round 1), print one
JSON line with the launch's work and bound (``checks.march_work``), the
SIMT efficiency of one thread per lane in pixel order and of the live
lanes packed 32 to a warp, and, for every kernel compared, its time
(CUDA events, 10 calls after a warm-up, taken in turns a, b, ..., b, a)
and its serial floor (``checks.serial_floor``).  Every kernel's output is
held against the first one's bit for bit.

The kernels: ``new``, the package's ``csrc/march.cu``; ``old``, another
``march.cu`` with the first port's entry point (no scratch pointers),
given by ``--old``.  Each is called through its C entry point here, with
scratch of its own, and counted here: the package's launch counts do not
move.  ``--profile`` adds each kernel's device time by CUDA kernel
(``torch.profiler``, three calls).

``--frames ROOT,...`` adds each branch's default 1918x1081 frame rendered
by the ``bhx_torch`` package of each tree root (``.``, or an earlier
commit unpacked with ``git archive``), in turns a, b, ..., b, a, each in a
process of its own: ms a frame (CUDA events over 3 frames after 2 warm-up
frames) and, from ``torch.profiler`` over 3 frames, the device's busy ms
a frame (the union of its kernels' intervals) and the march's.  Run from
the repository root, against the first port's commit:

    mkdir -p build/parent && git archive 8d5ac58 | tar -x -C build/parent
    python -m bhx_torch.march_study --old build/parent/bhx_torch/csrc/march.cu \\
        --kernels old,new --frames build/parent,.
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
from bhx_torch.scene import Scene, with_spin
from bhx_torch.tracer import march_kwargs

# The first port's entry point: rays, params, out, n, max_iterations,
# tex_opacity_min, show_disk, mode.
OLD_SIGNATURE = {"bhx_march": (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_int, ctypes.c_float,
                               ctypes.c_int, ctypes.c_int)}

# Launches of each kernel made by this study.
launches: dict = {}


def _runner(name: str, lib: ctypes.CDLL, scratch: bool):
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


def _kernels(names, old_path):
    """name -> march(rays, params, **kw) for every kernel compared, and the
    ptxas report of every build."""
    kernels, logs = {}, {}
    for name in names:
        launches[name] = 0
        if name == "old":
            paths = [Path(old_path).resolve()]
            lib = build.compile_library(paths, OLD_SIGNATURE, name="libmarch_old")
            kernels[name] = _runner(name, lib, scratch=False)
            logs[name] = build.log_path(paths).read_text()
        elif name == "new":
            kernels[name] = _runner(name, build.library(), scratch=True)
            logs[name] = build.log_path().read_text()
        else:
            raise ValueError(f"unknown kernel {name!r}: new or old")
    report = {name: [ln.strip() for ln in text.splitlines()
                     if "march" in ln and "entry function" in ln or "registers" in ln
                     or "spill" in ln] for name, text in logs.items()}
    return kernels, report


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


def study(kernel_names, old_path=None, reps: int = 10, profile: bool = False):
    scene = Scene.default()
    branches = {
        "march": (scene, RenderConfig()),
        "march_rk45": (scene, RenderConfig(integrator=Integrator.RK45)),
        "march_kerr": (with_spin(scene, 0.9), RenderConfig(geodesics="kerr")),
    }
    kernels, report = _kernels(kernel_names, old_path)
    for name, lines in report.items():
        print(json.dumps(dict(ptxas=name, lines=lines)), flush=True)
    rows = []
    for branch, (b_scene, cfg) in branches.items():
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
            times = {n: [] for n in kernel_names}
            for n in list(kernel_names) + list(reversed(kernel_names)):
                times[n].append(checks._timed(lambda: kernels[n](rays, params, **kw), reps)[1])
            row["ms"] = times
            row["floor"] = {n: checks.serial_floor(rays, params, first,
                                                   lambda r, p: kernels[n](r, p, **kw))
                            for n in kernel_names}
            if profile:
                row["profile_us"] = {n: _profile(lambda: kernels[n](rays, params, **kw))
                                     for n in kernel_names}
            rows.append(row)
            print(json.dumps(row), flush=True)
    print(json.dumps(dict(launches=launches)), flush=True)
    return rows


# Run in a process of its own by :func:`frames`, with a tree root's
# bhx_torch first on the path; uses only what every version of the
# package has.  Prints one JSON object: branch -> frame_ms, device_ms,
# march_device_ms.
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
    rows[name] = dict(
        frame_ms=a.elapsed_time(b) / iters,
        device_ms=busy([(e.time_range.start, e.time_range.end) for e in kernels]) / iters / 1e3,
        march_device_ms=busy([(e.time_range.start, e.time_range.end)
                              for e in kernels if "march" in e.name]) / iters / 1e3)
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="a march.cu with the first port's entry point")
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
    rows = study(args.kernels.split(","), args.old, profile=args.profile)
    frame_rows = frames(args.frames.split(",")) if args.frames else {}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=smi.stdout.strip(), rows=rows,
                                                  launches=launches, frames=frame_rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
