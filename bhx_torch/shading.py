"""Shading helpers on the main path (counterpart of parts of ``bhx/shading.py``):
the equirect sky mapping, the ACES tonemap and the bilinear ``disk_gain``
sample."""

from __future__ import annotations

import torch

PI = 3.1415926  # matches the reference constant (ray.wgsl:131)


def sample_gain(grid: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Clamp-addressed bilinear sample of a small (Gh, Gw, C) grid at uv,
    texel centers at (i + 0.5) / size.  Returns C tensors shaped like u.

    Same math as ``bhx.shading.sample_grid_mxu``: its hat-basis weights are
    zero outside the 2x2 footprint, which this fetches directly."""
    gh, gw, channels = grid.shape
    x = torch.clamp(u * gw - 0.5, 0.0, gw - 1.0)
    y = torch.clamp(v * gh - 0.5, 0.0, gh - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).unsqueeze(-1)
    fy = (y - y0).unsqueeze(-1)
    ix0 = x0.long()
    iy0 = y0.long()
    ix1 = torch.clamp(ix0 + 1, max=gw - 1)
    iy1 = torch.clamp(iy0 + 1, max=gh - 1)
    # index_select on the flat grid: its backward is an atomic index_add_
    # into the few texels, where advanced indexing's sorts millions of
    # duplicate indices on CUDA.
    texels = grid.reshape(gh * gw, -1)

    def fetch(iy, ix):
        return texels.index_select(0, (iy * gw + ix).reshape(-1)).reshape(u.shape + (channels,))

    top = fetch(iy0, ix0) * (1.0 - fx) + fetch(iy0, ix1) * fx
    bot = fetch(iy1, ix0) * (1.0 - fx) + fetch(iy1, ix1) * fx
    return (top * (1.0 - fy) + bot * fy).unbind(-1)


def sky_uv(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor):
    """Escape direction -> equirect uv (reference sky.wgsl:20-22): the
    direction's xzy goes into a z-up spherical mapping,
    uv = ((phi + 2.6 pi) / 2 pi mod 1, (pi - theta) / pi mod 1).
    ``mod`` is a floor mod (torch.remainder), as jnp.mod is."""
    theta = torch.atan2(torch.sqrt(dx * dx + dz * dz), dy)
    phi = torch.atan2(dz, dx)
    u = torch.remainder((phi + 2.6 * PI) / (2.0 * PI), 1.0)
    v = torch.remainder((PI - theta) / PI, 1.0)
    return u, v


# ACES input/output matrices (reference hdr.wgsl:1-16), row-major.
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
    """ACES-fitted tonemap (reference hdr.wgsl:1-16), the 3x3 transforms
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
