"""Each CUDA kernel held against its plain torch version on the card, on
inputs the default frame gives it.  Used by ``chip_smoke.py`` and by the
card-only tests (``tests/test_torch_gpu.py``).

Tolerances, the same as the CPU tests' against the JAX reference:

* march (every branch): at most 1% of rays differ by more than 1e-3 in
  any output row (rays near the photon sphere are chaotic, so two float
  programs part on a few of them);
* composite and ingredients: max |err| <= 1e-4;
* sky on rows and on an interleaved record: 99.5% quantile of |err| <
  2e-3 and max < 0.2 (a star splat's edge moves with the last bit of the
  escape direction);
* the render's gradient on the card against the CPU's
  (:func:`compare_gradients`): every parameter within 1e-3 of its
  largest entry.

Each ``compare_*`` returns a dict with ``ok``, the error figures, and the
kernel's and the plain version's milliseconds per call (CUDA events; the
kernel averaged over ``reps`` calls after a warm-up call, the plain
version timed once).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from bhx_torch.bench import fd_stable
from bhx_torch.config import RenderConfig
from bhx_torch.kernels import march as march_mod
from bhx_torch.kernels import shade as shade_mod
from bhx_torch.kernels import sky as sky_mod
from bhx_torch.parallel import apply_params, scene_params
from bhx_torch.pipeline import final_level_retrace_mask, render
from bhx_torch.scene import Scene
from bhx_torch.tracer import first_march_batch, march_kwargs

MARCH_ATOL = 1e-3
MARCH_BAD_FRAC = 0.01
COMPOSITE_ATOL = 1e-4
SKY_Q995 = 2e-3
SKY_MAX = 0.2
GRAD_REL = 1e-3
# Pixels whose card and CPU forward values part by more than this are left
# out of the gradient comparison (the CPU tests' tolerance against bhx).
GRAD_FWD_ATOL = 1e-5


def _timed(fn: Callable, reps: int = 1) -> Tuple[torch.Tensor, float]:
    """(last result, ms per call) of ``reps`` calls, timed with CUDA events;
    with ``reps > 1`` after one untimed call (the first timed call of a
    kernel on the card reads up to 3x slower than the rest)."""
    if reps > 1:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def last_level_batch(scene: Scene, cfg: RenderConfig):
    """:func:`first_march_batch` of the ladder's final level, whose active
    set is that level's re-trace mask: the largest march launch of a frame."""
    lad = cfg.ladder_for_output()
    w, h = lad.resolution(lad.levels - 1)
    return first_march_batch(scene, cfg, w, h, active=final_level_retrace_mask(scene, cfg))


def shade_params(scene: Scene) -> torch.Tensor:
    rot, _ = scene.black_hole.disk_frame()
    return shade_mod.pack_shade_params(scene.black_hole, rot, scene.time)


def compare_march(rays, params, cfg: RenderConfig, reps: int = 1) -> Dict:
    kw = march_kwargs(cfg)
    got, ms = _timed(lambda: march_mod.march(rays, params, **kw), reps)
    want, plain_ms = _timed(lambda: march_mod.march_torch(rays, params, **kw))
    err = (got - want).abs()
    bad = float((err > MARCH_ATOL).any(0).float().mean())
    finite = bool(torch.isfinite(got).all())
    return dict(n=rays.shape[1], active=int((rays[7] > 0.5).sum()), bad_frac=bad,
                max_abs_err=float(err.max()), ms=ms, plain_ms=plain_ms,
                ok=finite and bad <= MARCH_BAD_FRAC, out=got)


def compare_ingredients(slots, cam_dist, params, cfg: RenderConfig,
                        reps: int = 1) -> Dict:
    kw = dict(show_texture=cfg.show_disk_texture, show_redshift=cfg.show_redshift)
    got, ms = _timed(lambda: shade_mod.ingredients(slots, cam_dist, params, **kw), reps)
    want, plain_ms = _timed(lambda: shade_mod.ingredients_torch(slots, cam_dist, params,
                                                                **kw))
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all())
    return dict(n=slots.shape[1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                ok=finite and err <= COMPOSITE_ATOL)


def compare_composite(slots, cam_dist, params, gain, cfg: RenderConfig,
                      reps: int = 1) -> Dict:
    kw = dict(show_texture=cfg.show_disk_texture, show_redshift=cfg.show_redshift)
    got, ms = _timed(lambda: shade_mod.composite(slots, cam_dist, params, gain, **kw),
                     reps)
    want, plain_ms = _timed(
        lambda: shade_mod.composite_torch(slots, cam_dist, params, gain, **kw))
    err = float((got - want).abs().max())
    finite = bool(torch.isfinite(got).all())
    return dict(n=slots.shape[1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                ok=finite and err <= COMPOSITE_ATOL)


def _compare_sky(kernel: Callable, plain: Callable, rec, cfg: RenderConfig,
                 reps: int) -> Dict:
    got, ms = _timed(lambda: kernel(rec, cfg.show_sky), reps)
    want, plain_ms = _timed(lambda: plain(rec, cfg.show_sky))
    err = (got - want).abs().reshape(-1)
    q995 = float(torch.quantile(err, 0.995))
    finite = bool(torch.isfinite(got).all())
    return dict(n=want.numel() // 3, q995_abs_err=q995, max_abs_err=float(err.max()),
                ms=ms, plain_ms=plain_ms,
                ok=finite and q995 < SKY_Q995 and float(err.max()) < SKY_MAX)


def compare_sky(rows, cfg: RenderConfig, reps: int = 1) -> Dict:
    """The sky kernel on (8, N) record rows."""
    return _compare_sky(sky_mod.sky_rows, sky_mod.sky_rows_torch, rows, cfg, reps)


def compare_sky_finalize(record, cfg: RenderConfig, reps: int = 1) -> Dict:
    """The sky kernel on an interleaved (..., 8) record."""
    return _compare_sky(sky_mod.sky_finalize, sky_mod.sky_finalize_torch, record,
                        cfg, reps)


def compare_gradients(scene: Scene, cfg: RenderConfig, seed: int = 7) -> Dict:
    """The gradient of ``sum(w * render(scene, cfg))`` with respect to every
    ``parallel.scene_params`` entry and ``disk_gain``: on the card (the
    kernels' forward, their replayed backward) against the plain path on
    the CPU.  ``scene`` lies on the card.

    ``w`` is ``default_rng(seed)`` uniform, zero where the two programs'
    pointwise derivatives may part by more than rounding: pixels that are
    not FD-stable along every fitted entry (``bench.fd_stable``: rays near
    the photon sphere, moving visibility edges), and pixels whose forward
    values differ by more than GRAD_FWD_ATOL (there the disk texture's
    finest octave, whose slope sums terms of order 100 that cancel, shows
    the two devices' float32 rounding).  ``ok``: every entry finite on the
    card, and each parameter whose largest entry exceeds 1e-6 of the
    largest of all within GRAD_REL of it."""
    names = [k for k in scene_params(scene) if k != "spin" or cfg.geodesics == "kerr"]
    cpu_scene = scene.to("cpu")
    with torch.no_grad():
        fwd_err = (render(scene, cfg).cpu() - render(cpu_scene, cfg)).abs().numpy()
    keep = fd_stable(scene, cfg, names) & (fwd_err <= GRAD_FWD_ATOL).all(-1, keepdims=True)
    weights = np.random.default_rng(seed).random((cfg.height, cfg.width, 3)) * keep

    def grads(s: Scene) -> Dict[str, torch.Tensor]:
        leaves = {k: v.detach().clone().requires_grad_() for k, v in scene_params(s).items()}
        leaves["disk_gain"] = s.disk_gain.detach().clone().requires_grad_()
        s = dataclasses.replace(apply_params(s, leaves), disk_gain=leaves["disk_gain"])
        img = render(s, cfg)
        loss = (img * torch.as_tensor(weights, dtype=img.dtype, device=img.device)).sum()
        return {k: g.cpu() for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values())))}

    on_card, on_cpu = grads(scene), grads(cpu_scene)
    largest = max(float(g.abs().max()) for g in on_cpu.values())
    rel = {k: float((on_card[k] - g).abs().max() / g.abs().max())
           for k, g in on_cpu.items() if float(g.abs().max()) > 1e-6 * largest}
    finite = all(bool(torch.isfinite(g).all()) for g in on_card.values())
    worst = max(rel, key=rel.get)
    return dict(kept_frac=float(keep.mean()), max_rel_err=rel[worst], worst=worst,
                rel_err=rel, ok=finite and rel[worst] < GRAD_REL)
