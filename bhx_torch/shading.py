"""Shading (counterpart of ``bhx/shading.py``): the equirect sky mapping,
the ACES tonemap, the bilinear ``disk_gain`` sample, and the array-texture
shading of ``texture_mode="array"`` -- the bilinear texture sample, the
sky lookup and the disk shade of a crossing, differentiable with respect
to the textures' content.

``bhx``'s quad-packed ``sample_bilinear_fast`` exists because the TPU has
no gathers; here every sample is a plain gather (``index_select``) with
:func:`sample_bilinear`'s values."""

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


def smoothstep(e0, e1, x):
    t = torch.clamp((x - e0) / (e1 - e0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def rsqrt_eps(x: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """1 / sqrt(x + eps) (``bhx.shading.jax_rsqrt``)."""
    return torch.reciprocal(torch.sqrt(x + eps))


def sample_bilinear(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                    wrap: bool = False) -> torch.Tensor:
    """Bilinear texture sample: tex (H, W, C), u and v (...) in [0, 1];
    returns (..., C).  Texel centers at (i + 0.5) / size, repeat
    (``wrap``) or clamp-to-edge addressing (reference texture.rs:55-63)."""
    h, w, channels = tex.shape
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).unsqueeze(-1)
    fy = (y - y0).unsqueeze(-1)

    def idx(i, n):
        i = i.long()
        return torch.remainder(i, n) if wrap else torch.clamp(i, 0, n - 1)

    x0i, x1i = idx(x0, w), idx(x0 + 1, w)
    y0i, y1i = idx(y0, h), idx(y0 + 1, h)
    # index_select on the flat texture: its backward is an atomic
    # index_add_ into the texels, where advanced indexing's sorts the
    # indices on CUDA.
    texels = tex.reshape(h * w, channels)

    def fetch(iy, ix):
        return texels.index_select(0, (iy * w + ix).reshape(-1)).reshape(u.shape + (channels,))

    top = fetch(y0i, x0i) * (1 - fx) + fetch(y0i, x1i) * fx
    bot = fetch(y1i, x0i) * (1 - fx) + fetch(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def sample_sky(sky_tex: torch.Tensor, direction: torch.Tensor,
               texture_mode: str = "array") -> torch.Tensor:
    """Sky radiance (..., 3) of escape directions (..., 3).  "array": the
    bilinear sample of the stored radiance^(1/4) texture, then ^4
    (reference sky.wgsl:23-26); "procedural": the star grid + nebula
    evaluated arithmetically (``sky_tex`` unused)."""
    u, v = sky_uv(*direction.unbind(-1))
    if texture_mode == "procedural":
        from bhx_torch.procedural import sky_radiance_channels

        return torch.stack(sky_radiance_channels(u, v), dim=-1)
    return sample_bilinear(sky_tex, u, v, wrap=True)[..., :3] ** 4


def disk_shade(hit_point, ray_dir, camera_distance, black_hole, rotation_matrix,
               disk_texture, temp_lut, time, show_texture: bool = True,
               show_redshift: bool = True):
    """Color (..., 3) and opacity (...) of accretion-disk crossings in array
    texture mode (``bhx.shading.disk_shade``; reference hit_black_hole's
    disk branch, ray.wgsl:612-662):

      density  = (1 - |p| / outer) * smoothstep(inner, inner + 1, d) / sqrt(d)
      od       = (30 * density)^1.3,  opacity = clamp(0.2 * od)
      texture  : the disk texture at polar uv spun by time * rotation_speed
      redshift : Doppler x gravitational shift indexing the blackbody LUT.

    hit_point, ray_dir: (..., 3); camera_distance (...): the distance of
    each ray's origin from the hole (ray.wgsl:511)."""
    bh = black_hole
    rel = hit_point - bh.position
    dist = torch.linalg.vector_norm(rel, dim=-1)

    # Reference quirk kept: density's first factor uses |hit_point|
    # (absolute position, ray.wgsl:619), the rest the hole-relative radius.
    density = 1.0 - torch.linalg.vector_norm(hit_point, dim=-1) / bh.disk_outer
    density = density * smoothstep(bh.disk_inner, bh.disk_inner + 1.0, dist)
    density = density * rsqrt_eps(dist)
    density = torch.clamp(density, min=0.0)
    optical_depth = (30.0 * density) ** 1.3
    opacity = torch.clamp(optical_depth * 0.2, 0.0, 1.0)
    color = optical_depth.unsqueeze(-1).expand(hit_point.shape[:-1] + (3,))

    if show_texture:
        r_norm = (dist - bh.disk_inner) / (bh.disk_outer - bh.disk_inner)
        rotated = (rel / bh.disk_outer) @ rotation_matrix.t()
        # Degenerate-center guard: atan2's gradient at (0, 0) is 0/0, and
        # invalid slots sit there; the select keeps the forward value.
        rot_x, rot_z = rotated[..., 0], rotated[..., 2]
        degen = rot_x * rot_x + rot_z * rot_z < 1e-24
        angle = -torch.atan2(rot_z, torch.where(degen, 1.0, rot_x))
        spun = angle + time * bh.rotation_speed
        u = (torch.sin(spun) * r_norm + 1.0) * 0.5
        v = (torch.cos(spun) * r_norm + 1.0) * 0.5
        texel = sample_bilinear(disk_texture, u, v, wrap=False)
        opacity = opacity * torch.clamp(0.7 + texel[..., 3] * 0.5, 0.0, 1.0)
        color = color * texel[..., :3] * texel[..., 3:4]

    if show_redshift:
        # Fixed emitter temperature 15000 K in the LUT's [1e4, 1e5] K
        # vertical range (ray.wgsl:644-647).
        temp_min, temp_max, temp = 10000.0, 100000.0, 15000.0
        y = 1.0 - (temp - temp_min) / (temp_max - temp_min)
        rhat = rel * rsqrt_eps((rel * rel).sum(-1)).unsqueeze(-1)
        # shift_vec = 0.6 * cross(rhat, (0, -1, 0)) = 0.6 * (rhat_z, 0, -rhat_x)
        velocity = ray_dir[..., 0] * (0.6 * rhat[..., 2]) + ray_dir[..., 2] * (-0.6 * rhat[..., 0])
        doppler = torch.sqrt(torch.clamp((1.0 - velocity) / (1.0 + velocity), min=0.0))
        rs = 2.0 * bh.mass
        grav = torch.sqrt(torch.clamp(
            (1.0 - rs / torch.maximum(dist, rs + 1e-3))
            / (1.0 - rs / torch.maximum(camera_distance, rs + 1e-3)),
            min=0.0,
        ))
        shift = torch.clamp(grav * doppler, 0.0, 1.0) ** 2
        tint = sample_bilinear(temp_lut, shift, torch.full_like(shift, y))
        color = color * tint[..., :3]

    return color, opacity
