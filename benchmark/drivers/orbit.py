"""The orbit: the program renders frame after frame through a camera that
orbits the hole, each frame submitted once the last has finished (the
viewer's closed loop).

Frame k (k < 0 are the warm-up frames) is seen through the configured
camera rotated by yaw = A_yaw sin(phi0 + r_yaw k) and pitch = A_pitch
sin(phi1 + r_pitch k) at scene time t0 + k dt; phi0 and phi1 come from the
seed.  The poses are float32 numbers made on the host and put on the
device a block of ``POSE_BLOCK`` frames at a time (the first in set-up);
both sides read the same ones.

``frame_p95_ms`` is the 95th percentile of one frame's latency, from the
render call to its synchronise, over all of the window's frames.  The
window's wall time over the frames it completed is logged; a traced run
hands its frames' mean outside the profiled stretch to the per-layer
readers (``unit_s``).  ``correct`` holds a sample of the
window's frames, drawn from the seed (a reservoir: every frame equally
likely), against the reference's frames of the same poses, by the
numbers that the cell's limits file names: ``mean_abs_err``, the mean
absolute error, and ``bad_frac``, the share of pixels whose largest
channel error exceeds ``bad_pixel_atol``.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import port
from benchmark.drivers.common import Outcome, check, log, peak_bytes, reference_side, sync
from benchmark.metrics._bound import march_branch
from benchmark.reference import frame as ref_frame
from benchmark.reference.scene import posed

# Frames whose poses go to the device together.
POSE_BLOCK = 1024


def pose_rows(traffic: Dict, seed: int, ks) -> np.ndarray:
    """(len(ks), 3) float32 rows yaw, pitch, time of frames ``ks``."""
    rng = np.random.default_rng(seed)
    phi0, phi1 = rng.uniform(0.0, 2.0 * math.pi, size=2)
    k = np.asarray(ks, dtype=np.float64)
    yaw = traffic["yaw_amplitude"] * np.sin(phi0 + traffic["yaw_rate"] * k)
    pitch = traffic["pitch_amplitude"] * np.sin(phi1 + traffic["pitch_rate"] * k)
    t = traffic["time_start"] + traffic["time_per_frame"] * k
    return np.stack([yaw, pitch, t], axis=1).astype(np.float32)


def pose_block(traffic: Dict, seed: int, b: int) -> np.ndarray:
    """The rows of block ``b``: frames b POSE_BLOCK - warmup onwards."""
    first = b * POSE_BLOCK - traffic["warmup_frames"]
    return pose_rows(traffic, seed, np.arange(first, first + POSE_BLOCK))


def poses(traffic: Dict, seed: int, count: int) -> np.ndarray:
    """(count, 3) float32 rows yaw, pitch, time of frames k = -warmup ..
    count - warmup - 1."""
    return pose_rows(traffic, seed, np.arange(count) - traffic["warmup_frames"])


class Reservoir:
    """A uniform sample of ``size`` of a stream of unknown length, drawn by
    ``rng``; kept frames are copied, since a program may reuse its output
    buffer."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.seen, self.kept = size, rng, 0, []

    def offer(self, k: int, img: torch.Tensor) -> None:
        slot = self.seen if self.seen < self.size else self.rng.randrange(self.seen + 1)
        self.seen += 1
        if slot < self.size:
            item = (k, img.detach().clone())
            if slot < len(self.kept):
                self.kept[slot] = item
            else:
                self.kept.append(item)


def frame_errors(img: torch.Tensor, want: torch.Tensor, atol: float) -> Dict[str, float]:
    """The share of pixels whose largest channel error exceeds ``atol``,
    and the mean absolute error."""
    if img.shape != want.shape or not bool(torch.isfinite(img).all()):
        return dict(bad_frac=1.0, mean_abs_err=float("inf"))
    diff = (img.to(want.device, torch.float32) - want).abs()
    return dict(bad_frac=float((diff.amax(-1) > atol).float().mean()),
                mean_abs_err=float(diff.mean()))


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        overrides: Dict = None, capture=None) -> Outcome:
    import bhx_torch

    traffic = cell.traffic
    render = dict(cell.config["render"], **(overrides or {}))
    cfg = port.render_config(render)
    scene = port.scene(cell.config["scene"], device)
    w = traffic["warmup_frames"]
    blocks: List[torch.Tensor] = []
    rng = random.Random(seed)
    lo, hi = traffic["trace_start"]
    trace_at = rng.randrange(lo, hi)

    def pose(j: int) -> torch.Tensor:
        """The device row of frame j - w, its block put there when first met."""
        while j // POSE_BLOCK >= len(blocks):
            blocks.append(torch.from_numpy(pose_block(traffic, seed, len(blocks))).to(device))
        return blocks[j // POSE_BLOCK][j % POSE_BLOCK]

    def frame(j: int) -> torch.Tensor:
        p = pose(j)
        s = dataclasses.replace(scene, camera=scene.camera.rotated(p[0], p[1]), time=p[2])
        return bhx_torch.render(s, cfg)

    for j in range(w):
        frame(j)
    sync(device)

    sample = Reservoir(traffic["check_frames"], rng)
    traced: List[tuple] = []
    latencies = []
    start = time.perf_counter()
    setup_s = start - t0
    k, now = 0, start

    def one(k: int, keep: List = None) -> float:
        a = time.perf_counter()
        img = frame(w + k)
        sync(device)
        b = time.perf_counter()
        latencies.append(b - a)
        sample.offer(k, img)
        if keep is not None:
            keep.append((k, img.detach().clone()))
        return b

    stretch_s = 0.0
    while True:
        if trace and k == trace_at:
            # The march's branch, by which the roofline prices its substeps.
            info = dict(kind="orbit", integrator=march_branch(render))
            a = time.perf_counter()
            with capture.stretch(traffic["trace_frames"], info):
                for _ in range(traffic["trace_frames"]):
                    now = one(k, traced)
                    k += 1
            now = time.perf_counter()
            stretch_s = now - a
        else:
            now = one(k)
            k += 1
        if now - start >= seconds and (not trace or traced):
            break
    window = now - start
    peak = peak_bytes(device)
    del scene, blocks

    # The reference, once the window has closed.
    rcfg, rscene = reference_side(render, cell.config["scene"], device)
    atol = traffic["bad_pixel_atol"]
    worst = dict(bad_frac=0.0, mean_abs_err=0.0)
    failed = 0
    work = []
    compared = {kk: img for kk, img in sample.kept}
    compared.update({kk: img for kk, img in traced})
    ref_start = time.perf_counter()
    for kk, img in sorted(compared.items()):
        row = pose_block(traffic, seed, (w + kk) // POSE_BLOCK)[(w + kk) % POSE_BLOCK]
        yaw, pitch, t = (torch.tensor(float(v), device=device) for v in row)
        opts = dict(work=work) if any(kk == tk for tk, _ in traced) else {}
        with torch.no_grad():
            want = ref_frame.render(posed(rscene, yaw, pitch, t), rcfg, opts)
        err = frame_errors(img, want, atol)
        if any(err[m] > limit for m, limit in cell.limits.items()):
            failed += 1
        worst = {m: max(worst[m], err[m]) for m in err}
    p95_ms = 1e3 * float(np.percentile(latencies, 95))
    log(f"set-up {setup_s:.1f} s; {k} frames in {window:.3f} s, {1e3 * window / k:.4f} ms "
        f"a frame, p95 {p95_ms:.4f} ms; the reference's {len(compared)} frames "
        f"{time.perf_counter() - ref_start:.1f} s")
    if trace:
        capture.info["march_work"] = [(float(a), float(b)) for a, b in work]
        if k > len(traced):
            capture.info["unit_s"] = (window - stretch_s) / (k - len(traced))
    checks = {}
    for m, limit in cell.limits.items():
        checks.update(check(m, worst[m], limit))
    metrics = dict(setup_s=setup_s, frame_p95_ms=p95_ms)
    return Outcome(metrics=metrics, attempted=k, failed=failed, checks=checks,
                   memory_peak_bytes=peak)
