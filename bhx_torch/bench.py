"""Throughput of the default frame on one CUDA card (counterpart of
``bhx/bench.py:run_bench``).

The frame is the full default pipeline -- 4-level ladder, the march
(Euler by default, or RK45, or exact Kerr geodesics at a given spin),
procedural disk with Doppler and gravitational shift, procedural sky,
bloom, mix, ACES, FXAA -- at ``width`` x ``height``.  Rays are the final
frame's pixels.  Frames are timed with CUDA events after warm-up; every
result names the card it ran on.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import torch

from bhx_torch.config import Integrator, LadderConfig, RenderConfig
from bhx_torch.kernels import build, launch_counts
from bhx_torch.pipeline import render
from bhx_torch.scene import Scene, with_spin
from bhx_torch.tracer import crossing_overflow_stats


def run_bench(width: int = 1918, height: int = 1081, iters: int = 5,
              warmup: int = 2, geodesics: str = "pseudo", spin: float = 0.0,
              integrator: Integrator = Integrator.EULER) -> Dict:
    """Render ``iters`` timed frames after ``warmup`` and return Mrays/s,
    ms/frame, the kernel build and first-frame seconds, the K-slot
    crossing-overflow fraction, the kernel launches of one frame, the
    launch counts read just after the last frame (``launches``: every
    frame's launches since the caller last reset the counts, and nothing
    of the overflow diagnostic, which runs after that read), the number of
    frames rendered and the last frame itself.  ``spin`` is set on
    ``Scene.default``'s black hole.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("run_bench measures on a CUDA device; none is available")
    dev = torch.device("cuda")
    scene = with_spin(Scene.default(dev), spin)
    cfg = RenderConfig(
        width=width, height=height,
        ladder=LadderConfig.for_resolution(width, height, 4),
        geodesics=geodesics, integrator=integrator,
    )

    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0

    def at(t: float) -> Scene:
        return dataclasses.replace(scene, time=torch.full((), t, device=dev))

    t0 = time.perf_counter()
    render(at(0.0), cfg)
    torch.cuda.synchronize()
    first_frame_s = time.perf_counter() - t0
    for i in range(warmup):
        render(at(1.0 + 0.1 * i), cfg)

    before = launch_counts()
    render(at(1.5), cfg)
    after = launch_counts()
    per_frame = {k: after[k] - before[k] for k in after}

    scenes = [at(2.0 + 0.1 * i) for i in range(iters)]
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for s in scenes:
        img = render(s, cfg)
    end.record()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / iters
    ms = start.elapsed_time(end) / iters
    launches = launch_counts()

    stats = crossing_overflow_stats(
        scene, cfg.replace(use_ladder=False), 640, 361
    )
    # The frame's name in bhx/bench.py's form, "+rk45" for RK45.
    label = "schwarzschild" if geodesics == "pseudo" else f"kerr(spin={spin})"
    return {
        "label": label + ("+rk45" if integrator == Integrator.RK45 else ""),
        "mrays_per_s": width * height / (ms * 1e-3) / 1e6,
        "ms_per_frame": ms,
        "host_ms_per_frame": host_ms,
        "build_s": build_s,
        "first_frame_s": first_frame_s,
        "overflow_frac": float(stats["overflow_frac"]),
        "max_crossing_count": float(stats["max_count"]),
        "launches_per_frame": per_frame,
        "launches": launches,
        "frames": 1 + warmup + 1 + iters,
        "resolution": [width, height],
        "device": torch.cuda.get_device_name(0),
        "image": img,
    }
