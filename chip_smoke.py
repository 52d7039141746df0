#!/usr/bin/env python3
"""Drive the bhx_torch main path once on one CUDA card and check it.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it finishes:

1. the card (nvidia-smi name and power limit) and the torch / CUDA versions;
2. the kernel build from ``bhx_torch/csrc`` (seconds, ptxas register report);
3. each kernel against its plain torch version on the card: the march on
   the 72x41 ladder level 0 and on a dense 640x361 batch, the composite
   and the sky on that trace, then all three at the default frame's own
   shapes (the last ladder level and the final frame), timed with CUDA
   events beside their plain versions;
4. the default 1918x1081 frame through ``bhx_torch.bench.run_bench``:
   image checks, the kernel launches of the frames alone (zeroed just
   before, read just after the last frame), ms/frame, Mrays/s, crossing
   overflow;
5. a dense 192x108 frame on the card against the plain path on the CPU
   (bad-pixel fraction at 2e-2, gated at 2%).

The second-to-last line is a JSON object with one entry per kernel; the
last line is the device record.  Exits non-zero, printing neither, when
there is no CUDA device, when ``bhx_torch`` cannot be imported, or when
any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
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

    from bhx_torch import checks
    from bhx_torch.bench import run_bench
    from bhx_torch.config import BloomConfig, FxaaConfig, RenderConfig
    from bhx_torch.kernels import build, reset_launch_counts
    from bhx_torch.kernels.march import OUT_FIXED
    from bhx_torch.pipeline import ladder_trace_rows, render, trace_image_record_rows
    from bhx_torch.scene import Scene
    from bhx_torch.tracer import first_march_batch

    failures = []

    def check(name: str, ok: bool, info: dict) -> None:
        shown = {k: v for k, v in info.items() if k != "out"}
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
    rays, params, _ = first_march_batch(scene, cfg, w0, h0)
    r = checks.compare_march(rays, params, cfg)
    check(f"march {w0}x{h0} level 0", r["ok"], r)

    rays, params, cam = first_march_batch(scene, cfg, 640, 361)
    r = checks.compare_march(rays, params, cfg)
    check("march 640x361 dense", r["ok"], r)
    sp = checks.shade_params(scene)
    r = checks.compare_composite(r["out"][OUT_FIXED:], cam, sp, scene.disk_gain, cfg)
    check("composite 640x361 dense", r["ok"], r)
    record = trace_image_record_rows(scene, cfg, 640, 361).reshape(8, -1)
    r = checks.compare_sky(record, cfg)
    check("sky 640x361 dense", r["ok"], r)

    # The default frame's own shapes, timed: the last ladder level's march
    # launch (its re-trace mask as the active set), the composite of that
    # trace's slots, and the sky pass over the final 1918x1081 record.
    rays, params, cam = checks.last_level_batch(scene, cfg)
    march_r = checks.compare_march(rays, params, cfg, reps=10)
    check("march last level", march_r["ok"], march_r)
    comp_r = checks.compare_composite(march_r["out"][OUT_FIXED:], cam, sp,
                                      scene.disk_gain, cfg, reps=10)
    check("composite last level", comp_r["ok"], comp_r)
    lw, lh = cfg.ladder_for_output().final_resolution
    x0, y0 = (lw - cfg.width) // 2, (lh - cfg.height) // 2
    frame = ladder_trace_rows(scene, cfg)[:, y0:y0 + cfg.height, x0:x0 + cfg.width]
    sky_r = checks.compare_sky(frame.reshape(8, -1).contiguous(), cfg, reps=10)
    check("sky final frame", sky_r["ok"], sky_r)

    # --- 4. the default frame through the bench entry point ---
    # The counts are zeroed just before the frames; run_bench reads them
    # just after its last frame, before its overflow diagnostic.
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    bench = run_bench(1918, 1081, iters=5)
    counts = bench["launches"]
    per_frame = bench["launches_per_frame"]
    img = bench.pop("image")
    bench["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    img_ok = (tuple(img.shape) == (1081, 1918, 3) and bool(torch.isfinite(img).all())
              and float(img.min()) >= 0.0 and float(img.max()) <= 1.0)
    # Every frame makes the same launches, so the run's counts are exactly
    # frames x one frame's, and each kernel ran in every frame.
    counts_ok = all(per_frame[k] > 0 and counts[k] == bench["frames"] * per_frame[k]
                    for k in counts)
    check("frame 1918x1081", img_ok and counts_ok,
          dict(bench, shape=list(img.shape), mean=float(img.mean())))

    # --- 5. a small dense frame: the card against the plain path on the CPU ---
    small = RenderConfig(width=192, height=108, use_ladder=False, max_iterations=600,
                         bloom=BloomConfig(enabled=False),
                         fxaa=FxaaConfig(enabled=False), tonemap=False)
    on_card = render(scene, small).cpu()
    on_cpu = render(scene.to("cpu"), small)
    bad = float((on_card - on_cpu).abs().gt(2e-2).any(-1).float().mean())
    check("frame 192x108 card vs cpu", bool(torch.isfinite(on_card).all()) and bad <= 0.02,
          dict(bad_frac=bad, max_abs_err=float((on_card - on_cpu).abs().max())))

    if failures:
        _die("failed phases: " + ", ".join(failures))

    kernels = [
        dict(name="march", route="cuda", source="bhx_torch/csrc/march.cu",
             replaces="bhx/kernels/march_pallas.py:319", launches=counts["march"],
             max_abs_err=march_r["max_abs_err"], ms=march_r["ms"],
             plain_ms=march_r["plain_ms"]),
        dict(name="composite", route="cuda", source="bhx_torch/csrc/shade.cu",
             replaces="bhx/kernels/shade_pallas.py:499", launches=counts["composite"],
             max_abs_err=comp_r["max_abs_err"], ms=comp_r["ms"],
             plain_ms=comp_r["plain_ms"]),
        dict(name="sky", route="cuda", source="bhx_torch/csrc/sky.cu",
             replaces="bhx/kernels/shade_pallas.py:639", launches=counts["sky"],
             max_abs_err=sky_r["max_abs_err"], ms=sky_r["ms"], plain_ms=sky_r["plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
