"""The render pipeline: adaptive ray ladder, sky pass, post chain
(counterpart of ``bhx/pipeline.py``).

    ladder trace -> sky -> bloom -> mix -> ACES -> FXAA

The sky is the sky kernel on record rows in procedural texture mode, and
a sample of the scene's sky texture in array mode.  :func:`render_tiled`
renders a frame densely in row bands with resumable checkpoints.

The record travels as an (8, H, W) tensor of planes
``cr cg cb alpha amount dx dy dz`` and the post chain as a channel-major
(3, H, W) image.  Each ladder level re-traces, as a masked dense batch,
only the pixels that can neither copy a coarse pixel nor interpolate an
escape direction (reference ray.wgsl:167-243).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from bhx_torch import tracer
from bhx_torch.config import RenderConfig
from bhx_torch.post import bloom_chain_chw, fxaa_pass_chw, mix_pass, tonemap_pass
from bhx_torch.profiling import (
    LADDER_MASKS, POST_BLOOM, POST_FXAA, POST_TONEMAP, RENDER, ladder_level, span,
)
from bhx_torch.scene import Scene
from bhx_torch.shading import sample_sky
from bhx_torch.tracer import (
    REC_ALPHA, REC_DIR, camera_rays, finalize_image, finalize_image_rows, sky_texture_for,
    trace_rays_record_rows,
)


def sky_pass(img4: torch.Tensor, sky_tex, texture_mode: str = "array") -> torch.Tensor:
    """Escape-encoded pixels (alpha 0, rgb = direction) to sky color, hit
    pixels passed through (reference sky.wgsl:17-29): (..., 4) -> (..., 3)."""
    sky = sample_sky(sky_tex, img4[..., :3], texture_mode)
    return torch.where((img4[..., 3] == 0.0).unsqueeze(-1), sky, img4[..., :3])


def _dirs_aligned_ch(a, b, cos_thresh: float):
    """angle(a, b) < acos(cos_thresh) for (3, ...) direction planes, as a
    dot-product compare."""
    dot = a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    n2 = (a[0] * a[0] + a[1] * a[1] + a[2] * a[2]) * (
        b[0] * b[0] + b[1] * b[1] + b[2] * b[2]
    )
    return dot > cos_thresh * torch.sqrt(torch.clamp(n2, min=1e-24))


def _refine_masks(prev_rows: torch.Tensor, cfg: RenderConfig, width: int,
                  height: int):
    """The ladder's per-fine-pixel decision (reference ray.wgsl:183-241).

    Returns ``(needs, known)``: the (H, W) re-trace mask and the (8, H, W)
    record of every pixel that is not re-traced (a coarse copy, or an
    interpolated escape).  The interpolate decision depends only on the 4
    coarse neighbours, so it is computed on the coarse grid and upsampled."""
    # Two spans, so that neither holds more operations than a trace's
    # breakdown looks back over for the range around an idle gap.
    with span(LADDER_MASKS):
        m = cfg.ladder.multiplier
        dev = prev_rows.device
        gy, gx = torch.meshgrid(torch.arange(height, device=dev),
                                torch.arange(width, device=dev), indexing="ij")
        tx = gx // m
        ty = gy // m
        exact = ((gx % m) == 0) & ((gy % m) == 0)

        def up(img):
            r = img.repeat_interleave(m, dim=-2).repeat_interleave(m, dim=-1)
            return r[..., :height, :width]

        def sh_x(p):
            return torch.cat([p[..., :, 1:], p[..., :, -1:]], dim=-1)

        def sh_y(p):
            return torch.cat([p[..., 1:, :], p[..., -1:, :]], dim=-2)

        ct = math.cos(cfg.angle_division_threshold)
        a_c = prev_rows[REC_ALPHA]
        d_c = prev_rows[REC_DIR]
        trd_c = sh_x(d_c)
        bld_c = sh_y(d_c)
        brd_c = sh_x(sh_y(d_c))
        aligned_c = (
            _dirs_aligned_ch(bld_c, d_c, ct)
            & _dirs_aligned_ch(brd_c, trd_c, ct)
            & _dirs_aligned_ch(d_c, trd_c, ct)
            & _dirs_aligned_ch(bld_c, brd_c, ct)
        )
    with span(LADDER_MASKS):
        all_escape_c = (
            (a_c == 0.0) & (sh_x(a_c) == 0.0) & (sh_y(a_c) == 0.0)
            & (sh_x(sh_y(a_c)) == 0.0)
        )
        can_interp = up(aligned_c & all_escape_c)

        tl = up(prev_rows)
        fx = gx / m - tx
        fy = gy / m - ty
        dir_interp = (
            (tl[REC_DIR] * (1 - fx) + up(trd_c) * fx) * (1 - fy)
            + (up(bld_c) * (1 - fx) + up(brd_c) * fx) * fy
        )

        # known = exact ? coarse copy : interpolated escape (no color, alpha 0,
        # full transmission).
        zeros = torch.zeros_like(fx)
        ones = torch.ones_like(fx)
        known = torch.stack([
            torch.where(exact, tl[0], zeros),
            torch.where(exact, tl[1], zeros),
            torch.where(exact, tl[2], zeros),
            torch.where(exact, tl[3], zeros),
            torch.where(exact, tl[4], ones),
            torch.where(exact, tl[5], dir_interp[0]),
            torch.where(exact, tl[6], dir_interp[1]),
            torch.where(exact, tl[7], dir_interp[2]),
        ])
    return ~exact & ~can_interp, known


def _refine_level(prev_rows: torch.Tensor, scene: Scene, cfg: RenderConfig,
                  width: int, height: int) -> torch.Tensor:
    """One ladder step: copy, interpolate, or re-trace each fine pixel; the
    re-trace is the whole level with the needs mask as its active set."""
    o, d = camera_rays(scene.camera, width, height)
    needs, known = _refine_masks(prev_rows, cfg, width, height)
    needs_flat = needs.reshape(-1)
    res = trace_rays_record_rows(
        o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg, active=needs_flat
    )
    return torch.where(needs_flat, res, known.reshape(8, -1)).reshape(8, height, width)


def trace_image_record_rows(scene: Scene, cfg: RenderConfig, width: int,
                            height: int) -> torch.Tensor:
    """Dense sky-free record planes, (8, height, width)."""
    o, d = camera_rays(scene.camera, width, height)
    rows = trace_rays_record_rows(o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg)
    return rows.reshape(8, height, width)


def ladder_trace_rows(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """Coarse-to-fine trace at the ladder's final resolution, (8, H, W)."""
    lad = cfg.ladder_for_output()
    with span(ladder_level(0)):
        rows = trace_image_record_rows(scene, cfg, *lad.resolution(0))
    for lvl in range(1, lad.levels):
        with span(ladder_level(lvl)):
            rows = _refine_level(rows, scene, cfg, *lad.resolution(lvl))
    return rows


def ladder_trace(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """Interleaved (H, W, 8) form of :func:`ladder_trace_rows`."""
    return ladder_trace_rows(scene, cfg).permute(1, 2, 0)


def final_level_retrace_mask(scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """The ladder's final level's re-trace mask, flat bool (W*H,): the
    active set of a frame's largest march launch."""
    lad = cfg.ladder_for_output()
    rows = trace_image_record_rows(scene, cfg, *lad.resolution(0))
    for lvl in range(1, lad.levels - 1):
        rows = _refine_level(rows, scene, cfg, *lad.resolution(lvl))
    needs, _ = _refine_masks(rows, cfg, *lad.resolution(lad.levels - 1))
    return needs.reshape(-1)


def crop_ladder(rows: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """The (8, height, width) center crop of a ladder record at the
    ladder's final resolution: the ladder overshoots the requested output."""
    lw, lh = cfg.ladder_for_output().final_resolution
    x0 = (lw - cfg.width) // 2
    y0 = (lh - cfg.height) // 2
    return rows[:, y0:y0 + cfg.height, x0:x0 + cfg.width]


def render(scene: Scene, cfg: RenderConfig = RenderConfig()) -> torch.Tensor:
    """Render the scene to a (height, width, 3) float32 image in [0, 1], on
    the scene's device."""
    with span(RENDER):
        if cfg.use_ladder:
            rows = crop_ladder(ladder_trace_rows(scene, cfg), cfg)
        else:
            rows = trace_image_record_rows(scene, cfg, cfg.width, cfg.height)
        return image_from_rows(rows, scene, cfg)


def image_from_rows(rows: torch.Tensor, scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """The (H, W, 3) frame from its (8, H, W) sky-free record rows: one sky
    pass for the whole frame (hit pixels' residual transmission and
    escapes' full sky in the same formula; the sky kernel on rows in
    procedural mode), then the post chain."""
    h, w = rows.shape[1], rows.shape[2]
    chw = finalize_image_rows(rows.reshape(8, h * w), sky_texture_for(scene, cfg),
                              cfg.show_sky, cfg.texture_mode).reshape(3, h, w)
    return _post(chw, cfg).permute(1, 2, 0)


def _post(chw: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """The post chain on a (3, H, W) image: bloom, mix, ACES, FXAA."""
    if cfg.bloom.enabled:
        with span(POST_BLOOM):
            bloom = bloom_chain_chw(chw, cfg.bloom)
    if cfg.bloom.enabled or cfg.tonemap:
        with span(POST_TONEMAP):
            if cfg.bloom.enabled:
                chw = mix_pass(chw, bloom, cfg.bloom.mix_ratio)
            if cfg.tonemap:
                chw = tonemap_pass(chw, channel_major=True)
    if cfg.fxaa.enabled:
        with span(POST_FXAA):
            chw = fxaa_pass_chw(chw, cfg.fxaa)
    return chw


def render_image(scene: Scene, cfg: RenderConfig = RenderConfig()) -> np.ndarray:
    """Render and convert to a (height, width, 3) uint8 numpy image."""
    rgb = render(scene, cfg).detach().cpu().numpy()
    return (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype("uint8")


def render_tiled(scene: Scene, cfg: RenderConfig, band_rows: int = 256,
                 checkpoint_path: str = None, verbose: bool = False,
                 max_retries: int = 2) -> torch.Tensor:
    """Render a (height, width, 3) frame densely in row bands, with
    resumable checkpoints (``bhx.pipeline.render_tiled``).

    After each band the record assembled so far is written to
    ``checkpoint_path`` (.npz; a temporary file, then renamed), so an
    interrupted render resumes at its next band; a checkpoint of another
    frame shape or banding is ignored.  A band is idempotent: a failure is
    retried up to ``max_retries`` times before it propagates, naming the
    band.  Every band traces ``band_rows`` rows (the last is anchored to
    the frame's bottom edge); the sky and the post chain run once, on the
    assembled frame."""
    h, w = cfg.height, cfg.width
    rec = np.zeros((h, w, 8), np.float32)
    start_band = 0
    n_bands = -(-h // band_rows)
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as z:
            if tuple(z["shape"]) == (h, w) and int(z["band_rows"]) == band_rows:
                rec = z["rec"]
                start_band = int(z["next_band"])

    o, d = camera_rays(scene.camera, w, h)
    for band in range(start_band, n_bands):
        y0 = band * band_rows
        y1 = min(y0 + band_rows, h)
        s0 = min(y0, max(h - band_rows, 0))
        ob = o[s0:s0 + band_rows].reshape(-1, 3)
        db = d[s0:s0 + band_rows].reshape(-1, 3)
        for attempt in range(max_retries + 1):
            try:
                out = tracer.trace_rays_record(ob, db, scene, cfg)
                out = out.detach().cpu().numpy().reshape(-1, w, 8)
                break
            except Exception as e:  # bounded retry: a band is idempotent
                if attempt == max_retries:
                    saved = (f" (progress saved to {checkpoint_path}; re-run to resume)"
                             if checkpoint_path else "")
                    raise RuntimeError(f"band {band + 1}/{n_bands} failed after "
                                       f"{max_retries + 1} attempts{saved}") from e
                if verbose:
                    print(f"band {band + 1}/{n_bands} attempt {attempt + 1} failed "
                          f"({e!r}); retrying")
        rec[y0:y1] = out[out.shape[0] - (y1 - y0):]
        if checkpoint_path:
            tmp = checkpoint_path + ".tmp.npz"
            np.savez_compressed(tmp, rec=rec, next_band=band + 1, shape=(h, w),
                                band_rows=band_rows)
            os.replace(tmp, checkpoint_path)
        if verbose:
            print(f"band {band + 1}/{n_bands} done")

    return image_from_record(torch.from_numpy(rec).to(o.device), scene, cfg)


def image_from_record(record: torch.Tensor, scene: Scene, cfg: RenderConfig) -> torch.Tensor:
    """The (H, W, 3) frame from its interleaved (H, W, 8) sky-free record:
    the sky finalize (the interleaved sky kernel in procedural mode), then
    the post chain."""
    rgb = finalize_image(record, sky_texture_for(scene, cfg), cfg.show_sky, cfg.texture_mode)
    return _post(rgb.permute(2, 0, 1).contiguous(), cfg).permute(1, 2, 0)
