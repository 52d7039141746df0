"""Throughput of the default frame on one CUDA card (counterpart of
``bhx/bench.py:run_bench``), the card's numerics gate (:func:`parity_check`)
and its gradient gate (:func:`grad_check`), counterparts of
``bhx/bench.py``'s.

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

import numpy as np
import torch

from bhx_torch.config import BloomConfig, FxaaConfig, Integrator, LadderConfig, RenderConfig
from bhx_torch.kernels import build, launch_counts
from bhx_torch.parallel import apply_params, scene_params
from bhx_torch.pipeline import render
from bhx_torch.scene import Scene, with_spin
from bhx_torch.profiling import KERNEL_COMPOSITE, KERNEL_SKY, PREFIX
from bhx_torch.tracer import crossing_overflow_stats


def run_bench(width: int = 1918, height: int = 1081, iters: int = 5,
              warmup: int = 2, geodesics: str = "pseudo", spin: float = 0.0,
              integrator: Integrator = Integrator.EULER, scene: Scene = None,
              texture_mode: str = "procedural", dense: bool = False) -> Dict:
    """Render ``iters`` timed frames after ``warmup`` and return Mrays/s,
    ms/frame, the kernel build and first-frame seconds, the K-slot
    crossing-overflow fraction, the kernel launches of one frame, the
    launch counts read just after the last frame (``launches``: every
    frame's launches since the caller last reset the counts, and nothing
    of the overflow diagnostic, which runs after that read), the number of
    frames rendered and the last frame itself.  The scene is ``scene``
    (on the card), or ``Scene.default`` with ``spin`` set on its black
    hole; ``texture_mode`` is the config's (array mode reads the scene's
    textures, the default bakes where unset), and ``dense`` turns the
    ladder off.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("run_bench measures on a CUDA device; none is available")
    dev = torch.device("cuda")
    if scene is None:
        scene = with_spin(Scene.default(dev), spin)
    cfg = RenderConfig(
        width=width, height=height,
        ladder=LadderConfig.for_resolution(width, height, 4),
        geodesics=geodesics, integrator=integrator, texture_mode=texture_mode,
        use_ladder=not dense,
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
        "label": label + ("+rk45" if integrator == Integrator.RK45 else "")
        + (f"+{len(scene.meshes)} meshes" if scene.meshes else "")
        + ("+array" if texture_mode == "array" else "") + ("+dense" if dense else ""),
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


def frame_profile(scene: Scene, cfg: RenderConfig, iters: int = 2) -> Dict:
    """One frame of ``scene`` under ``cfg`` on the card, after a warm-up:
    ms a frame by CUDA events, and by ``torch.profiler`` the device's busy
    ms a frame (the union of kernel intervals), its idle share, the busy
    ms of the march, composite, sky and mesh kernels (by name), the device
    ms of the kernels launched inside the composite's and the sky's kernel
    spans (``array_composite_ms``, ``array_sky_ms``: ``profiling.KERNEL_COMPOSITE``
    and ``KERNEL_SKY``, in array mode the plain-torch stages; a trace's CUDA
    graph records no composite span, so in procedural mode read
    ``composite_ms``), and the
    number of frames it rendered (``frames``: the warm-up, the timed and
    the profiled ones).  The program's spans are no device operations."""
    from torch.profiler import ProfilerActivity, profile

    render(scene, cfg)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        render(scene, cfg)
    end.record()
    end.synchronize()
    frame_ms = start.elapsed_time(end) / iters
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            render(scene, cfg)
        torch.cuda.synchronize()
    events = prof.events()
    kernels = [e for e in events
               if e.device_type.name == "CUDA" and not e.name.startswith(PREFIX)]

    def stage_ms(name: str) -> float:
        """Device ms a frame of the kernels that the ops inside the host
        range ``name`` launched (the range's own device span left out)."""
        total = 0.0
        for e in events:
            if e.device_type.name == "CPU" and e.name == name:
                total += sum(k.duration for k in e.kernels if k.name != name)
                total += sum(ch.device_time_total for ch in e.cpu_children)
        return total / iters / 1e3

    def busy_ms(part: str = "") -> float:
        total, reach = 0.0, float("-inf")
        for a, b in sorted((e.time_range.start, e.time_range.end)
                           for e in kernels if part in e.name):
            if b > reach:
                total += b - max(a, reach)
                reach = b
        return total / iters / 1e3

    device_ms = busy_ms()
    return dict(frames=1 + 2 * iters, frame_ms=frame_ms, device_ms=device_ms,
                idle_frac=1.0 - device_ms / frame_ms,
                device_events=len(kernels) / iters,
                # Kernel names: march_*, shade_composite_kernel,
                # sky_kernel, mesh_queue_kernel and mesh_kernel.
                march_ms=busy_ms("march"), composite_ms=busy_ms("shade_composite"),
                sky_ms=busy_ms("sky_kernel"), mesh_ms=busy_ms("mesh_"),
                array_composite_ms=stage_ms(KERNEL_COMPOSITE),
                array_sky_ms=stage_ms(KERNEL_SKY))


def grad_check(width: int = 320, height: int = 180, rel_tol: float = 0.1) -> Dict:
    """The card's gradient gate (counterpart of ``bhx/bench.py:grad_check``):
    one reverse-mode gradient of a weighted-pixel loss with respect to the
    mass, through the kernels' forward and their replayed backward on the
    card, against Richardson-extrapolated central differences of the same
    loss.

    As in the reference, the frame has no sky, disk texture or post chain
    (their feature scales lie below any usable step), and the pixel weights
    (``default_rng(7)``) are zero where FD(1e-3) and FD(5e-4) disagree: a
    visibility edge that moves with the mass gives FD a boundary term that
    the pointwise gradient does not have.  ``grad_ok`` needs more than half
    the pixels FD-stable and a relative error under ``rel_tol``.
    ``grad_s`` is the seconds of the gradient call (forward + backward).
    Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("grad_check measures on a CUDA device; none is available")
    out = _grad_check(torch.device("cuda"), width, height, rel_tol)
    out["device"] = torch.cuda.get_device_name(0)
    return out


# Central-difference steps of the FD-stability test, and its agreement
# tolerance (relative to the larger of the two, plus an absolute floor).
FD_STEPS = (1e-3, 5e-4)
FD_RTOL, FD_ATOL = 0.05, 1e-4


def _fd_images(img_of, x0: torch.Tensor, unit: torch.Tensor):
    """Central differences of ``img_of`` at ``x0`` along ``unit``, one image
    (numpy) per step of FD_STEPS."""
    with torch.no_grad():
        return [((img_of(x0 + e * unit) - img_of(x0 - e * unit)) / (2.0 * e)).cpu().numpy()
                for e in FD_STEPS]


def _fd_agree(fds) -> np.ndarray:
    scale = np.maximum(np.abs(fds[0]), np.abs(fds[1]))
    return np.abs(fds[0] - fds[1]) <= FD_RTOL * scale + FD_ATOL


def fd_stable(scene: Scene, cfg: RenderConfig, names) -> np.ndarray:
    """The (height, width, 3) pixels whose central differences at the two
    FD_STEPS agree, along every component of every named entry of
    ``parallel.scene_params(scene)``.  A gradient comparison weights the
    other pixels by zero (``tests/test_grad.py``'s discipline): a visibility
    edge that moves gives FD a boundary term the pointwise gradient lacks,
    and a ray near the photon sphere has an adjoint that grows
    exponentially, so two float programs' pointwise gradients part there
    by orders of magnitude."""
    base = scene_params(scene)
    stable = np.ones((cfg.height, cfg.width, 3), bool)
    for n in names:
        stable &= _stable_along(
            lambda x: render(apply_params(scene, dict(base, **{n: x})), cfg), base[n])
    return stable


def pose_fd_stable(scene: Scene, cfg: RenderConfig, angles: torch.Tensor) -> np.ndarray:
    """:func:`fd_stable` along the yaw and along the pitch of
    ``scene.camera.rotated(*angles)`` (``angles``: (yaw, pitch))."""
    return _stable_along(lambda a: render(rotated(scene, a), cfg), angles)


def rotated(scene: Scene, angles: torch.Tensor) -> Scene:
    """``scene`` with its camera ``rotated(yaw, pitch)``, ``angles`` = (yaw,
    pitch) (a tensor that requires grad keeps its graph)."""
    return dataclasses.replace(scene, camera=scene.camera.rotated(angles[0], angles[1]))


def _stable_along(img_of, x0: torch.Tensor) -> np.ndarray:
    """The pixels of ``img_of`` whose central differences at the two
    FD_STEPS agree along every component of ``x0``."""
    stable = True
    for c in range(x0.numel()):
        unit = torch.zeros(x0.numel(), dtype=x0.dtype, device=x0.device)
        unit[c] = 1.0
        stable = stable & _fd_agree(_fd_images(img_of, x0, unit.reshape(x0.shape)))
    return stable


def _grad_check(dev: torch.device, width: int, height: int, rel_tol: float) -> Dict:
    """:func:`grad_check` on ``dev`` (the CPU tests run it at a small size)."""
    scene = Scene.default(dev)
    cfg = RenderConfig(
        width=width, height=height, use_ladder=False, max_iterations=600,
        fxaa=FxaaConfig(enabled=False), bloom=BloomConfig(enabled=False),
        tonemap=False, show_sky=False, show_disk_texture=False,
    )

    def img_of(mass: torch.Tensor) -> torch.Tensor:
        bh = dataclasses.replace(scene.black_hole, mass=mass)
        return render(dataclasses.replace(scene, black_hole=bh), cfg)

    m0 = torch.full((), 0.5, dtype=torch.float32, device=dev)
    fds = _fd_images(img_of, m0, torch.ones_like(m0))
    stable = _fd_agree(fds)
    stable_frac = float(stable.mean())
    fd_ref = (4.0 * fds[1] - fds[0]) / 3.0  # Richardson, steps 1e-3 and 5e-4
    w = np.random.default_rng(7).random((height, width, 3)) * stable
    w_dev = torch.as_tensor(w, dtype=torch.float32, device=dev)

    t0 = time.perf_counter()
    mass = m0.clone().requires_grad_()
    loss = (img_of(mass) * w_dev).sum() / (width * height)
    (g,) = torch.autograd.grad(loss, mass)
    ad = float(g)  # waits for the device
    grad_s = time.perf_counter() - t0
    fd = float(np.sum(fd_ref * w)) / (width * height)
    rel = abs(ad - fd) / max(abs(ad), abs(fd), 1e-8)
    return {
        "grad_ad": ad,
        "grad_fd": fd,
        "grad_stable_frac": stable_frac,
        "grad_rel_err": rel,
        "grad_s": grad_s,
        "grad_ok": bool(stable_frac > 0.5 and rel < rel_tol),
    }


def parity_check(width: int = 192, height: int = 108, atol: float = 2e-2,
                 max_bad_frac: float = 0.02) -> Dict:
    """The card's numerics gate (counterpart of ``bhx/bench.py:parity_check``):
    the kernel pipeline on the card must reproduce the plain pipeline on
    the CPU for the default scene at :func:`parity_config`, by
    :func:`compare_frames`.  Raises without a CUDA device."""
    if not torch.cuda.is_available():
        raise RuntimeError("parity_check runs on a CUDA device; none is available")
    out = compare_frames(Scene.default("cuda"), parity_config(width, height), atol,
                         max_bad_frac)
    out["device"] = torch.cuda.get_device_name(0)
    return out


def parity_config(width: int, height: int) -> RenderConfig:
    """:func:`parity_check`'s frame: dense, 600 march iterations, no bloom,
    FXAA or tonemap."""
    return RenderConfig(width=width, height=height, use_ladder=False, max_iterations=600,
                        fxaa=FxaaConfig(enabled=False), bloom=BloomConfig(enabled=False),
                        tonemap=False)


def compare_frames(scene: Scene, cfg: RenderConfig, atol: float = 2e-2,
                   max_bad_frac: float = 0.02) -> Dict:
    """``scene``'s frame on its device against the same frame on the CPU,
    up to the chaotic rays near the photon sphere: at most ``max_bad_frac``
    of the pixels differ by more than ``atol`` in a channel, and every
    value is finite."""
    img = render(scene, cfg).cpu()
    ref = render(scene.to("cpu"), cfg)
    diff = (img - ref).abs()
    bad = float(diff.gt(atol).any(-1).float().mean())
    finite = bool(torch.isfinite(img).all())
    return {
        "parity_bad_frac": bad,
        "parity_ok": bool(finite and bad <= max_bad_frac),
        "max_abs_err": float(diff.max()),
    }
