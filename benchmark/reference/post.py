"""The post chain on a channel-major (3, H, W) image: bloom pyramid, mix,
ACES tonemap, FXAA 3.11 (quality).

Bloom passes are separable multi-tap bilinear filters written as dense
resample matrices applied with ``torch.einsum``; FXAA's edge walk is a
fixed schedule of shifted planes.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

# ACES input/output matrices, row-major.
_ACES_M1 = (
    (0.59719, 0.35458, 0.04823),
    (0.07600, 0.90834, 0.01566),
    (0.02840, 0.13383, 0.83777),
)
_ACES_M2 = (
    (1.60475, -0.53108, -0.07367),
    (-0.10208, 1.10813, -0.00605),
    (-0.00327, -0.07276, 1.07602),
)


def aces_tonemap(rgb: torch.Tensor, channel_major: bool = False) -> torch.Tensor:
    """ACES-fitted tonemap, the 3x3 transforms
    unrolled to plane-wise multiply-adds.  ``channel_major``: (3, H, W)
    in and out instead of (..., 3)."""
    ch = rgb.unbind(0 if channel_major else -1)
    v = [m[0] * ch[0] + m[1] * ch[1] + m[2] * ch[2] for m in _ACES_M1]
    cur = [
        (vi * (vi + 0.0245786) - 0.000090537)
        / (vi * (0.983729 * vi + 0.4329510) + 0.238081)
        for vi in v
    ]
    out = [
        torch.clamp(m[0] * cur[0] + m[1] * cur[1] + m[2] * cur[2], 0.0, 1.0)
        for m in _ACES_M2
    ]
    return torch.stack(out, dim=0 if channel_major else -1)


@functools.lru_cache(maxsize=256)
def _resample_matrix(src: int, out: int, taps: tuple) -> np.ndarray:
    """(out, src) matrix M with M @ v = multi-tap bilinear resample of v.

    Output sample i reads source coordinate
    ``x = (i + 0.5) * src / out - 0.5 + off`` for every (off, w) in taps
    (off in source texels), bilinearly with clamp-to-edge."""
    m = np.zeros((out, src), np.float32)
    for i in range(out):
        base = (i + 0.5) * src / out - 0.5
        for off, w in taps:
            x = base + off
            x0 = int(np.floor(x))
            f = x - x0
            m[i, min(max(x0, 0), src - 1)] += w * (1.0 - f)
            m[i, min(max(x0 + 1, 0), src - 1)] += w * f
    return m


@functools.lru_cache(maxsize=256)
def _resample_tensor(src: int, out: int, taps: tuple,
                     device: torch.device) -> torch.Tensor:
    return torch.tensor(_resample_matrix(src, out, taps), device=device)


def _separable_pass(chw: torch.Tensor, taps_y: tuple, taps_x: tuple, out_wh):
    """A separable multi-tap bilinear filter as two matrix products."""
    out_w, out_h = out_wh
    src_h, src_w = chw.shape[1], chw.shape[2]
    my = _resample_tensor(src_h, out_h, taps_y, chw.device)
    mx = _resample_tensor(src_w, out_w, taps_x, chw.device)
    tmp = torch.einsum("ph,chw->cpw", my, chw)
    return torch.einsum("qw,cpw->cpq", mx, tmp)


def bloom_downsample(img: torch.Tensor, out_wh: Tuple[int, int]):
    """13-tap downsample: taps at {-2,0,+2}^2 with
    weights 0.5 [1/4,1/2,1/4]^2 plus taps at {-1,+1}^2 with 0.5 [1/2,1/2]^2."""
    group_a = ((-2.0, 0.25), (0.0, 0.5), (2.0, 0.25))
    group_b = ((-1.0, 0.5), (1.0, 0.5))
    half_a = _separable_pass(img, group_a, group_a, out_wh)
    half_b = _separable_pass(img, group_b, group_b, out_wh)
    return 0.5 * half_a + 0.5 * half_b


def bloom_upsample(img: torch.Tensor, out_wh: Tuple[int, int],
                   radius_uv: float = 0.005):
    """9-tap tent upsample at a fixed uv radius."""
    src_h, src_w = img.shape[1], img.shape[2]
    taps_x = ((-radius_uv * src_w, 0.25), (0.0, 0.5), (radius_uv * src_w, 0.25))
    taps_y = ((-radius_uv * src_h, 0.25), (0.0, 0.5), (radius_uv * src_h, 0.25))
    return _separable_pass(img, taps_y, taps_x, out_wh)


def bloom_chain_chw(chw: torch.Tensor, levels: int, up_radius_uv: float) -> torch.Tensor:
    """``levels``-down / ``levels``-up pyramid: res /= 2 ``levels`` times,
    then *= 2 as often, truncating at each pass."""
    h, w = chw.shape[1], chw.shape[2]
    # Cap the depth so no level degenerates below 1x1 (tiny frames).
    levels = max(0, min(levels, min(w, h).bit_length() - 1))
    fres = (float(w), float(h))
    cur = chw
    for _ in range(levels):
        fres = (fres[0] / 2.0, fres[1] / 2.0)
        cur = bloom_downsample(cur, (max(int(fres[0]), 1), max(int(fres[1]), 1)))
    for _ in range(levels):
        fres = (fres[0] * 2.0, fres[1] * 2.0)
        cur = bloom_upsample(
            cur, (max(int(fres[0]), 1), max(int(fres[1]), 1)), up_radius_uv
        )
    return cur


def mix_pass(scene_img: torch.Tensor, bloom_img: torch.Tensor, mix_ratio: float):
    """final = ratio * scene + (1 - ratio) * bloom."""
    return mix_ratio * scene_img + (1.0 - mix_ratio) * bloom_img


# ---------------------------------------------------------------------------
# FXAA 3.11 (quality)
# ---------------------------------------------------------------------------

_QUALITY = [1.0, 1.0, 1.0, 1.0, 1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0]


def _quality(i: int) -> float:
    return _QUALITY[i] if i < len(_QUALITY) else 8.0


def _shift(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Clamp-to-edge neighbour fetch of an (H, W) plane: out[y, x] =
    a[clamp(y + dy), clamp(x + dx)], shifts clamped to the plane's extent."""
    dy = max(min(dy, a.shape[0] - 1), 1 - a.shape[0])
    dx = max(min(dx, a.shape[1] - 1), 1 - a.shape[1])
    if dy > 0:
        a = torch.cat([a[dy:], a[-1:].expand(dy, -1)], dim=0)
    elif dy < 0:
        a = torch.cat([a[:1].expand(-dy, -1), a[:dy]], dim=0)
    if dx > 0:
        a = torch.cat([a[:, dx:], a[:, -1:].expand(-1, dx)], dim=1)
    elif dx < 0:
        a = torch.cat([a[:, :1].expand(-1, -dx), a[:, :dx]], dim=1)
    return a


def fxaa_pass_chw(chw: torch.Tensor, edge_threshold_min: float, edge_threshold_max: float,
                  iterations: int, subpixel_quality: float) -> torch.Tensor:
    """FXAA 3.11 quality on a (3, H, W) image.  The walk samples sit half a
    texel off-axis, so each is the mean of two adjacent texels ("pair
    images"), and every pixel still walking at step i sits at the same
    distance D_i, so each sample is a fixed shift of a pair image; only
    whether a pixel samples is data-dependent.  "Up" means +row."""
    rp, gp, bp = chw[0], chw[1], chw[2]
    hgt, wdt = rp.shape[0], rp.shape[1]
    inv_w, inv_h = 1.0 / wdt, 1.0 / hgt
    # + 1e-12 under the sqrt keeps luma's slope finite at exact black.
    luma_img = torch.sqrt(
        torch.clamp(0.299 * rp + 0.587 * gp + 0.114 * bp, min=0.0) + 1e-12
    )

    l_c = luma_img
    l_down = _shift(luma_img, -1, 0)
    l_up = _shift(luma_img, +1, 0)
    l_left = _shift(luma_img, 0, -1)
    l_right = _shift(luma_img, 0, +1)

    l_min = torch.minimum(l_c, torch.minimum(torch.minimum(l_down, l_up),
                                             torch.minimum(l_left, l_right)))
    l_max = torch.maximum(l_c, torch.maximum(torch.maximum(l_down, l_up),
                                             torch.maximum(l_left, l_right)))
    l_range = l_max - l_min
    no_edge = l_range < torch.clamp(l_max * edge_threshold_max,
                                    min=edge_threshold_min)

    l_dl = _shift(luma_img, -1, -1)
    l_ur = _shift(luma_img, +1, +1)
    l_ul = _shift(luma_img, +1, -1)
    l_dr = _shift(luma_img, -1, +1)

    l_du = l_down + l_up
    l_lr = l_left + l_right
    l_lc = l_dl + l_ul
    l_dc = l_dl + l_dr
    l_rc = l_dr + l_ur
    l_uc = l_ur + l_ul

    edge_h = (
        torch.abs(-2.0 * l_left + l_lc)
        + torch.abs(-2.0 * l_c + l_du) * 2.0
        + torch.abs(-2.0 * l_right + l_rc)
    )
    edge_v = (
        torch.abs(-2.0 * l_up + l_uc)
        + torch.abs(-2.0 * l_c + l_lr) * 2.0
        + torch.abs(-2.0 * l_down + l_dc)
    )
    is_horizontal = edge_h >= edge_v

    luma1 = torch.where(is_horizontal, l_down, l_left)
    luma2 = torch.where(is_horizontal, l_up, l_right)
    grad1 = luma1 - l_c
    grad2 = luma2 - l_c
    is1 = torch.abs(grad1) >= torch.abs(grad2)
    grad_scaled = 0.25 * torch.maximum(torch.abs(grad1), torch.abs(grad2))
    l_avg = torch.where(is1, 0.5 * (luma1 + l_c), 0.5 * (luma2 + l_c))

    pair_v = 0.5 * (luma_img + _shift(luma_img, +1, 0))  # rows y, y+1
    pair_h = 0.5 * (luma_img + _shift(luma_img, 0, +1))  # cols x, x+1
    # The pair at (perp-1, perp) vs (perp, perp+1) per step sign.
    pv = torch.where(is1, _shift(pair_v, -1, 0), pair_v)
    ph = torch.where(is1, _shift(pair_h, 0, -1), pair_h)

    # Every fractional distance of the schedule ends in .5, and a shift
    # commutes with an elementwise blend, so one pre-blended half-texel
    # plane per (orientation, sign) serves every fractional sample.
    half = {
        (+1): (0.5 * (pv + _shift(pv, 0, +1)), 0.5 * (ph + _shift(ph, +1, 0))),
        (-1): (0.5 * (pv + _shift(pv, 0, -1)), 0.5 * (ph + _shift(ph, -1, 0))),
    }

    def sample_at(dist: float, sign: int):
        """Pair-image value at signed walk distance ``dist`` (texels)."""
        lo = int(np.floor(dist))
        f = dist - lo
        off = sign * lo
        if f == 0.0:
            h0 = _shift(pv, 0, off)
            v0 = _shift(ph, off, 0)
        elif f == 0.5:
            hp, vp = half[sign]
            h0 = _shift(hp, 0, off)
            v0 = _shift(vp, off, 0)
        else:  # pragma: no cover - the schedule only produces .0/.5
            h0 = _shift(pv, 0, off) * (1.0 - f) + _shift(pv, 0, off + sign) * f
            v0 = _shift(ph, off, 0) * (1.0 - f) + _shift(ph, off + sign, 0) * f
        return torch.where(is_horizontal, h0, v0)

    # Static distance schedule (prefix sums of the QUALITY table).
    dists = [1.0, 2.0]
    for i in range(2, max(iterations, 2)):
        dists.append(dists[-1] + _quality(i))

    le1 = sample_at(dists[0], -1) - l_avg
    le2 = sample_at(dists[0], +1) - l_avg
    reached1 = torch.abs(le1) >= grad_scaled
    reached2 = torch.abs(le2) >= grad_scaled
    p1 = torch.where(reached1, dists[0], dists[1])
    p2 = torch.where(reached2, dists[0], dists[1])

    for i in range(2, iterations):
        both = reached1 & reached2
        le1 = torch.where(reached1, le1, sample_at(dists[i - 1], -1) - l_avg)
        le2 = torch.where(reached2, le2, sample_at(dists[i - 1], +1) - l_avg)
        new_r1 = torch.abs(le1) >= grad_scaled
        new_r2 = torch.abs(le2) >= grad_scaled
        p1 = torch.where(~both & ~new_r1, dists[i], p1)
        p2 = torch.where(~both & ~new_r2, dists[i], p2)
        reached1 = reached1 | new_r1
        reached2 = reached2 | new_r2

    # Distances along the walk axis, back in uv units.
    unit = torch.where(is_horizontal, inv_w, inv_h)
    dist1 = p1 * unit
    dist2 = p2 * unit
    is_dir1 = dist1 < dist2
    dist_final = torch.minimum(dist1, dist2)
    edge_thickness = dist1 + dist2
    center_smaller = l_c < l_avg
    good1 = (le1 < 0.0) != center_smaller
    good2 = (le2 < 0.0) != center_smaller
    good = torch.where(is_dir1, good1, good2)
    pixel_offset = -dist_final / torch.where(
        edge_thickness == 0.0, 1e-12, edge_thickness) + 0.5
    final_offset = torch.where(good, pixel_offset, 0.0)

    l_full_avg = (1.0 / 12.0) * (2.0 * (l_du + l_lr) + l_lc + l_rc)
    sub1 = torch.clamp(
        torch.abs(l_full_avg - l_c)
        / torch.clamp(l_range, min=edge_threshold_min),
        0.0, 1.0,
    )
    sub2 = (-2.0 * sub1 + 3.0) * sub1 * sub1
    sub_final = sub2 * sub2 * subpixel_quality
    # The blend weight is a filter decision, not radiance: gradients flow
    # through the resampled colors only.
    t = torch.maximum(final_offset, sub_final).detach()

    # Final resample: a sub-texel lerp along the perpendicular axis.
    def resample(chan):
        nb_h = torch.where(is1, _shift(chan, -1, 0), _shift(chan, +1, 0))
        nb_v = torch.where(is1, _shift(chan, 0, -1), _shift(chan, 0, +1))
        neighbor = torch.where(is_horizontal, nb_h, nb_v)
        out = chan * (1.0 - t) + neighbor * t
        return torch.where(no_edge, chan, out)

    return torch.stack([resample(c) for c in (rp, gp, bp)])
