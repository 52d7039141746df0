"""The deferred disk shade + front-to-back composite of the K recorded
crossings, and the sky on record rows.

Each valid crossing is shaded -- optical depth, the spiral Perlin texel
times the bilinear ``disk_gain`` sample, the blackbody tint of the Doppler
x gravitational shift -- and composited front to back into rows r, g, b,
transmission.  The sky adds the procedural star sky of the escape
direction, weighted by the residual transmission where it exceeds 0.001.
"""

from __future__ import annotations

import torch

from .march import CROSS_FIELDS, MAX_CROSSINGS
from .procedural import blackbody_tint_channels, disk_texel_m, sky_radiance_channels

PI = 3.1415926

# Scalar parameter vector of the shade pass.
_SP = dict(
    bh_x=0, bh_y=1, bh_z=2, mass=3, disk_inner=4, disk_outer=5,
    r00=6, r01=7, r02=8, r10=9, r11=10, r12=11, r20=12, r21=13, r22=14,
    spun=15,  # time * rotation_speed
)
NUM_SHADE_PARAMS = len(_SP)

def pack_shade_params(black_hole, rot_mat: torch.Tensor, time) -> torch.Tensor:
    """The (NUM_SHADE_PARAMS,) float32 vector, on the scene's device."""
    bh = black_hole
    return torch.cat([
        bh.position, torch.stack([bh.mass, bh.disk_inner, bh.disk_outer]),
        rot_mat.reshape(9), (time * bh.rotation_speed).reshape(1),
    ]).to(torch.float32)


def sample_gain(grid: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Clamp-addressed bilinear sample of a small (Gh, Gw, C) grid at uv,
    texel centers at (i + 0.5) / size.  Returns C tensors shaped like u."""
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
    texels = grid.reshape(gh * gw, -1)

    def fetch(iy, ix):
        return texels.index_select(0, (iy * gw + ix).reshape(-1)).reshape(u.shape + (channels,))

    top = fetch(iy0, ix0) * (1.0 - fx) + fetch(iy0, ix1) * fx
    bot = fetch(iy1, ix0) * (1.0 - fx) + fetch(iy1, ix1) * fx
    return (top * (1.0 - fy) + bot * fy).unbind(-1)


def sky_uv(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor):
    """Escape direction -> equirect uv: the
    direction's xzy goes into a z-up spherical mapping,
    uv = ((phi + 2.6 pi) / 2 pi mod 1, (pi - theta) / pi mod 1).
    ``mod`` is a floor mod (torch.remainder)."""
    theta = torch.atan2(torch.sqrt(dx * dx + dz * dz), dy)
    phi = torch.atan2(dz, dx)
    u = torch.remainder((phi + 2.6 * PI) / (2.0 * PI), 1.0)
    v = torch.remainder((PI - theta) / PI, 1.0)
    return u, v


def _slot_ingredients(hx, hy, hz, dx, dz, cam_dist, p, show_texture,
                      show_redshift):
    """(od, m, tint r, g, b, u, v) of one slot's geometry rows."""
    rx = hx - p["bh_x"]
    ry = hy - p["bh_y"]
    rz = hz - p["bh_z"]
    dist2 = rx * rx + ry * ry + rz * rz
    inv_dist = torch.rsqrt(dist2 + 1e-20)
    dist = dist2 * inv_dist

    # Reference quirk kept: the first density factor uses |hit_point|
    # (absolute position), the rest the hole-relative radius.
    abs2 = hx * hx + hy * hy + hz * hz
    abs_dist = abs2 * torch.rsqrt(abs2 + 1e-20)
    density = 1.0 - abs_dist / p["disk_outer"]
    tt = torch.clamp(dist - p["disk_inner"], 0.0, 1.0)
    density = density * (tt * tt * (3.0 - 2.0 * tt))
    density = torch.clamp(density * torch.sqrt(inv_dist), min=0.0)
    x = 30.0 * density
    od = torch.where(
        x > 0.0, torch.exp(1.3 * torch.log(torch.clamp(x, min=1e-20))), 0.0
    )

    zeros = torch.zeros_like(od)
    u = v = m = zeros
    if show_texture:
        r_norm = (dist - p["disk_inner"]) / (p["disk_outer"] - p["disk_inner"])
        inv_outer = 1.0 / p["disk_outer"]
        sx = rx * inv_outer
        sy = ry * inv_outer
        sz = rz * inv_outer
        rot_x = p["r00"] * sx + p["r01"] * sy + p["r02"] * sz
        rot_z = p["r20"] * sx + p["r21"] * sy + p["r22"] * sz
        # Invalid slots sit at zero geometry: atan2(0, 0) -> atan2(0, 1),
        # the same forward value with a finite gradient.
        degen = rot_x * rot_x + rot_z * rot_z < 1e-24
        angle = -torch.atan2(rot_z, torch.where(degen, 1.0, rot_x))
        spun = angle + p["spun"]
        u = (torch.sin(spun) * r_norm + 1.0) * 0.5
        v = (torch.cos(spun) * r_norm + 1.0) * 0.5
        m = disk_texel_m(u, v)

    tr = tg = tb = torch.ones_like(od)
    if show_redshift:
        rhx = rx * inv_dist
        rhz = rz * inv_dist
        # shift_vec = 0.6 * cross(rhat, (0,-1,0)) = 0.6 * (rhz, 0, -rhx)
        velocity = 0.6 * (dx * rhz - dz * rhx)
        doppler = torch.sqrt(
            torch.clamp((1.0 - velocity) / (1.0 + velocity), min=0.0)
        )
        rs = 2.0 * p["mass"]
        grav = torch.sqrt(torch.clamp(
            (1.0 - rs / torch.maximum(dist, rs + 1e-3))
            / (1.0 - rs / torch.maximum(cam_dist, rs + 1e-3)),
            min=0.0,
        ))
        shift = torch.clamp(grav * doppler, 0.0, 1.0)
        tr, tg, tb = blackbody_tint_channels(shift * shift)
    return od, m, tr, tg, tb, u, v


def composite_rows(slots, cam_dist, params, gain, show_texture: bool,
                   show_redshift: bool) -> torch.Tensor:
    """The (4, N) rows r, g, b, transmission of the (K*7, N) ``slots``."""
    p = {name: params[i] for name, i in _SP.items()}
    n = cam_dist.shape[0]
    trans = cam_dist.new_ones((n,))
    acc = [cam_dist.new_zeros((n,)) for _ in range(3)]
    for k in range(MAX_CROSSINGS):
        hx, hy, hz, dx, _, dz, valid = slots[k * CROSS_FIELDS:(k + 1) * CROSS_FIELDS]
        od, m, tr, tg, tb, u, v = _slot_ingredients(
            hx, hy, hz, dx, dz, cam_dist, p, show_texture, show_redshift
        )
        opacity = torch.clamp(od * 0.2, 0.0, 1.0)
        rgb = [od, od, od]
        if show_texture:
            # The direct 2x2 fetch; its backward scatter-adds into ``gain``.
            gain_rgba = sample_gain(gain, u, v)
            tex_a = m * gain_rgba[3]
            rgb = [rgb[c] * m * gain_rgba[c] * tex_a for c in range(3)]
            opacity = opacity * torch.clamp(0.7 + tex_a * 0.5, 0.0, 1.0)
        if show_redshift:
            rgb = [rgb[0] * tr, rgb[1] * tg, rgb[2] * tb]
        op = torch.where(valid > 0.5, opacity, 0.0)
        w = trans * op
        for c in range(3):
            acc[c] = acc[c] + w * torch.clamp(rgb[c], 0.0, 1.0)
        trans = trans * (1.0 - op)
    return torch.stack(acc + [trans])


def sky_rows(rows, show_sky: bool) -> torch.Tensor:
    """8 record rows (cr cg cb alpha amount dx dy dz) -> (3, N)."""
    cr, cg, cb, _, amount, dx, dy, dz = rows
    if not show_sky:
        return torch.stack([cr, cg, cb])
    w = torch.where(amount > 0.001, amount, 0.0)
    sr, sg, sb = sky_radiance_channels(*sky_uv(dx, dy, dz))
    return torch.stack([cr + w * sr, cg + w * sg, cb + w * sb])


