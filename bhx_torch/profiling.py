"""Timing, rays/s counters and profiler hooks (counterpart of
``bhx/profiling.py``).

On a CUDA scene each stage is timed with CUDA events around its launches;
on the CPU with the host clock.  Every report names the device it ran on.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, Optional

import torch


class Timer:
    """dt + total elapsed (reference src/timer.rs:20-33)."""

    def __init__(self):
        self.start = time.perf_counter()
        self.last = self.start

    def update(self) -> float:
        now = time.perf_counter()
        dt = now - self.last
        self.last = now
        return dt

    def total(self) -> float:
        return time.perf_counter() - self.start


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, warmup: int = 1, iters: int = 5, **kw) -> Dict:
    """Wall time of ``fn(*args, **kw)``, waiting for the card after each
    call: {mean_s, min_s, runs}, the ``warmup`` calls (the kernel build)
    excluded."""
    for _ in range(warmup):
        fn(*args, **kw)
        _sync()
    runs = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kw)
        _sync()
        runs.append(time.perf_counter() - t0)
    return {"mean_s": sum(runs) / len(runs), "min_s": min(runs), "runs": runs}


def mrays_per_sec(num_rays: int, seconds: float) -> float:
    return num_rays / seconds / 1e6


def _stage_timer(device: torch.device, iters: int):
    """``timed(fn, *args) -> (least ms of iters calls, last output)``, after
    two warm-up calls: CUDA events on the card, the host clock on the CPU."""

    def timed(fn, *args):
        for _ in range(2):
            out = fn(*args)
        best = float("inf")
        for _ in range(iters):
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn(*args)
                end.record()
                end.synchronize()
                ms = start.elapsed_time(end)
            else:
                t0 = time.perf_counter()
                out = fn(*args)
                ms = (time.perf_counter() - t0) * 1e3
            best = min(best, ms)
        return best, out

    return timed


def frame_report(scene, cfg, iters: int = 4) -> Dict:
    """Stage times (ms, the least of ``iters`` runs) of one frame of
    ``scene`` under ``cfg``: the ladder's levels (or the dense trace), the
    sky (on a CUDA scene in procedural mode, the sky kernel on record rows;
    in array mode the texture sample), bloom, mix + tonemap, FXAA, and the
    whole frame; with the device's name and the frame's Mrays/s."""
    from bhx_torch.pipeline import (
        _refine_level, ladder_trace_rows, render, trace_image_record_rows,
    )
    from bhx_torch.post import bloom_chain_chw, fxaa_pass_chw, mix_pass, tonemap_pass
    from bhx_torch.tracer import finalize_image_rows, sky_texture_for

    device = scene.time.device
    timed = _stage_timer(device, iters)
    report: Dict = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    with torch.no_grad():
        if cfg.use_ladder:
            lad = cfg.ladder_for_output()
            w0, h0 = lad.resolution(0)
            report["L0 trace"], rows = timed(
                lambda: trace_image_record_rows(scene, cfg, w0, h0))
            for lvl in range(1, lad.levels):
                w, h = lad.resolution(lvl)
                report[f"L{lvl} refine {w}x{h}"], rows = timed(
                    lambda prev=rows, w=w, h=h: _refine_level(prev, scene, cfg, w, h))
            report["ladder total"], _ = timed(lambda: ladder_trace_rows(scene, cfg))
        else:
            report["dense trace"], rows = timed(
                lambda: trace_image_record_rows(scene, cfg, cfg.width, cfg.height))

        sky_tex = sky_texture_for(scene, cfg)
        report["sky finalize"], rgb = timed(
            lambda: finalize_image_rows(rows, sky_tex, cfg.show_sky, cfg.texture_mode))
        rgb = rgb[:, :cfg.height, :cfg.width]
        if cfg.bloom.enabled:
            report["bloom"], bl = timed(lambda: bloom_chain_chw(rgb, cfg.bloom))
            report["mix+tonemap"], rgb = timed(lambda: tonemap_pass(
                mix_pass(rgb, bl, cfg.bloom.mix_ratio), channel_major=True))
        if cfg.fxaa.enabled:
            report["fxaa"], _ = timed(lambda: fxaa_pass_chw(rgb, cfg.fxaa))
        report["full frame"], _ = timed(lambda: render(scene, cfg))
    report["mrays_per_s"] = cfg.width * cfg.height / (report["full frame"] * 1e-3) / 1e6
    return report


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """``torch.profiler`` over the block (the card's kernels too, where there
    is one), written as a Chrome trace to ``logdir/trace.json``; nothing
    when ``logdir`` is empty."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
