"""The frame: the adaptive ladder, the sky and the post chain.

The ladder traces its coarsest level densely; each finer level copies a
coarse pixel, interpolates an escape direction between four aligned
escapes, or re-traces the pixel.  Only the re-traced pixels are marched,
compacted into one batch.  Then one sky pass for the whole frame and the
post chain: bloom, mix, ACES, FXAA.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Union

import torch

from .config import Config
from .post import aces_tonemap, bloom_chain_chw, fxaa_pass_chw, mix_pass
from .scene import Scene
from .shade import sky_rows
from .tracer import REC_ALPHA, REC_DIR, camera_rays, trace_record_rows


def _dirs_aligned_ch(a, b, cos_thresh: float):
    """angle(a, b) < acos(cos_thresh) for (3, ...) direction planes, as a
    dot-product compare."""
    dot = a[0] * b[0] + a[1] * b[1] + a[2] * b[2]
    n2 = (a[0] * a[0] + a[1] * a[1] + a[2] * a[2]) * (
        b[0] * b[0] + b[1] * b[1] + b[2] * b[2]
    )
    return dot > cos_thresh * torch.sqrt(torch.clamp(n2, min=1e-24))


def refine_masks(prev_rows: torch.Tensor, cfg: Config, width: int, height: int):
    """The ladder's per-fine-pixel decision.

    Returns ``(needs, known)``: the (H, W) re-trace mask and the (8, H, W)
    record of every pixel that is not re-traced (a coarse copy, or an
    interpolated escape).  The interpolate decision depends only on the 4
    coarse neighbours, so it is computed on the coarse grid and upsampled."""
    m = cfg.ladder_multiplier
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


def dense_rows(scene: Scene, cfg: Config, width: int, height: int,
               opts: Dict) -> torch.Tensor:
    """Every pixel of a (width, height) grid traced: (8, height, width)."""
    o, d = camera_rays(scene.camera, width, height)
    rows = trace_record_rows(o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg, opts)
    return rows.reshape(8, height, width)


def ladder_rows(scene: Scene, cfg: Config, opts: Dict) -> torch.Tensor:
    """The ladder's record at its last level's resolution, (8, H, W)."""
    lad = cfg.ladder_for_output()
    rows = dense_rows(scene, cfg, *lad.ladder_resolution(0), opts)
    for lvl in range(1, lad.ladder_levels):
        width, height = lad.ladder_resolution(lvl)
        needs, known = refine_masks(rows, cfg, width, height)
        idx = needs.reshape(-1).nonzero().squeeze(1)
        o, d = camera_rays(scene.camera, width, height)
        traced = trace_record_rows(o.reshape(-1, 3).index_select(0, idx),
                                   d.reshape(-1, 3).index_select(0, idx), scene, cfg, opts)
        rows = known.reshape(8, -1).index_copy(1, idx, traced).reshape(8, height, width)
    return rows


def crop(rows: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The (8, height, width) center crop of the ladder's record."""
    lw, lh = cfg.ladder_for_output().ladder_resolution(cfg.ladder_levels - 1)
    x0 = (lw - cfg.width) // 2
    y0 = (lh - cfg.height) // 2
    return rows[:, y0:y0 + cfg.height, x0:x0 + cfg.width]


def post(chw: torch.Tensor, cfg: Config) -> torch.Tensor:
    """The post chain on a (3, H, W) image."""
    if cfg.bloom:
        chw = mix_pass(chw, bloom_chain_chw(chw, cfg.bloom_levels, cfg.bloom_up_radius_uv),
                       cfg.bloom_mix_ratio)
    if cfg.tonemap:
        chw = aces_tonemap(chw, channel_major=True)
    if cfg.fxaa:
        chw = fxaa_pass_chw(chw, cfg.fxaa_edge_threshold_min, cfg.fxaa_edge_threshold_max,
                            cfg.fxaa_iterations, cfg.fxaa_subpixel_quality)
    return chw


def banded_rows(scenes: Sequence[Scene], cfg: Config, opts: Dict) -> torch.Tensor:
    """The dense (8, height, width) record traced in ``len(scenes)`` bands
    of ceil(height / bands) rows, band b under ``scenes[b]``, as the ranks
    of a sharded fit trace theirs."""
    width, height = cfg.width, cfg.height
    band = -(-height // len(scenes))
    parts = []
    for b, scene in enumerate(scenes):
        r0, r1 = min(b * band, height), min((b + 1) * band, height)
        if r1 > r0:
            o, d = camera_rays(scene.camera, width, height)
            parts.append(trace_record_rows(o[r0:r1].reshape(-1, 3), d[r0:r1].reshape(-1, 3),
                                           scene, cfg, opts).reshape(8, r1 - r0, width))
    return torch.cat(parts, dim=1)


def render(scene: Union[Scene, Sequence[Scene]], cfg: Config,
           opts: Optional[Dict] = None) -> torch.Tensor:
    """The (height, width, 3) float32 frame of ``scene``; ``opts`` as
    :func:`.tracer.trace_record_rows` takes them.  A sequence of scenes is
    a dense frame's bands of rows (:func:`banded_rows`)."""
    opts = {} if opts is None else opts
    if not isinstance(scene, Scene):
        if cfg.use_ladder:
            raise ValueError("a frame traced in bands of rows is dense")
        rows = banded_rows(scene, cfg, opts)
    elif cfg.use_ladder:
        rows = crop(ladder_rows(scene, cfg, opts), cfg)
    else:
        rows = dense_rows(scene, cfg, cfg.width, cfg.height, opts)
    h, w = rows.shape[1], rows.shape[2]
    chw = sky_rows(rows.reshape(8, h * w), cfg.show_sky).reshape(3, h, w)
    return post(chw, cfg).permute(1, 2, 0)
