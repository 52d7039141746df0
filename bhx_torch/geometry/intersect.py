"""Analytic ray intersections on tensors (counterpart of
``bhx/geometry/intersect.py``).

Misses are encoded as ``t = MISS_T``, never as branches; every function
broadcasts over leading ray dims, with (..., 3) vectors.  The triangle test
is written component by component, cross products and determinants spelled
out in a fixed order, so that the mesh kernel (``csrc/mesh.cu``) repeats it
operation for operation.
"""

from __future__ import annotations

import functools

import torch

# Sentinel distance for "no intersection"; the reference's t_min and t_max
# (ray.wgsl:492-493).
MISS_T = 1e8
T_MIN = 1e-8
T_MAX = 1e5


def _sphere_roots(origin, direction, center, radius):
    oc = origin - center
    a = (direction * direction).sum(-1)
    b = 2.0 * (oc * direction).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = b * b - 4.0 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return (-b - sq) / (2.0 * a), (-b + sq) / (2.0 * a), disc


def hit_sphere(origin, direction, center, radius, t_min=T_MIN, t_max=T_MAX):
    """(t, hit): the nearest root in (t_min, t_max), t = MISS_T on a miss
    (reference hit_sphere, ray.wgsl:725-766)."""
    t1, t2, disc = _sphere_roots(origin, direction, center, radius)
    valid1 = (disc > 0.0) & (t1 > t_min) & (t1 < t_max)
    valid2 = (disc > 0.0) & (t2 > t_min) & (t2 < t_max)
    t = torch.where(valid1, t1, torch.where(valid2, t2, MISS_T))
    hit = valid1 | valid2
    return torch.where(hit, t, MISS_T), hit


def hit_sphere_both(origin, direction, center, radius):
    """Both raw roots and whether they are real: (t_near, t_far, real)."""
    t1, t2, disc = _sphere_roots(origin, direction, center, radius)
    return t1, t2, disc > 0.0


def hit_annulus(origin, direction, center, normal, inner_radius, outer_radius,
                t_min=T_MIN, t_max=T_MAX):
    """Flat annulus through ``center`` with ``normal``, hits with radial
    distance in [inner, outer] (reference hit_torus2d, ray.wgsl:668-701).
    Returns (t, hit, hit_point, facing normal): the normal is flipped to
    -normal where the ray meets the plane against it."""
    denom = (normal * direction).sum(-1)
    delta = center - origin
    tiny = torch.where(denom.abs() < 1e-12, torch.sign(denom) * 1e-12 + 1e-20, denom)
    t = (delta * normal).sum(-1) / tiny
    point = origin + direction * t[..., None]
    r = torch.linalg.norm(point - center, dim=-1)
    hit = (t > t_min) & (t < t_max) & (r >= inner_radius) & (r <= outer_radius)
    facing = torch.where(denom[..., None] < 0.0, -normal, normal)
    return torch.where(hit, t, MISS_T), hit, point, facing


def hit_aabb(origin, inv_direction, box_min, box_max):
    """Slab-method entry distance into an axis-aligned box; MISS_T when the
    ray misses it or the box lies wholly behind the origin (reference
    hit_aabb, ray.wgsl:703-723).  ``inv_direction`` is 1/direction."""
    t1 = (box_min - origin) * inv_direction
    t2 = (box_max - origin) * inv_direction
    t_near = torch.minimum(t1, t2).amax(-1)
    t_far = torch.maximum(t1, t2).amin(-1)
    miss = (t_near > t_far) | (t_far < 0.0)
    return torch.where(miss, MISS_T, t_near)


@functools.lru_cache(maxsize=None)
def diffuse_light(device: torch.device) -> torch.Tensor:
    """The mesh light normalize(0.2, 0.2, -1) (ray.wgsl:384-386) on
    ``device``, normalised by torch's ops there once: the plain merge and
    the mesh kernel read the same bits.  Shared: never write to it."""
    light = torch.tensor((0.2, 0.2, -1.0), dtype=torch.float32, device=device)
    return light / torch.linalg.norm(light)


def det3(ax, ay, az, bx, by, bz, cx, cy, cz):
    """a . (b x c), summed x + y + z."""
    return (ax * (by * cz - bz * cy) + ay * (bz * cx - bx * cz)) + az * (bx * cy - by * cx)


def hit_triangles(origin, direction, p1, p2, p3, n1, n2, n3, t_min=T_MIN, t_max=T_MAX):
    """Ray against triangle (p1, p2, p3) with vertex normals n1..n3, all
    (..., 3) and broadcast against each other.  Returns (t, hit, color,
    geometric normal), t = MISS_T on a miss.

    The reference's Cramer form (hit_triangle, ray.wgsl:768-847): the
    geometric normal is flipped toward the ray, color = -n_smooth * 0.5 +
    0.5 from the interpolated vertex normal, and a near-parallel or
    degenerate triangle (|normal . dir| or |det| under 1e-5) is a miss."""
    ox, oy, oz = origin.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    ax, ay, az = p1.unbind(-1)
    bx, by, bz = p2.unbind(-1)
    cx, cy, cz = p3.unbind(-1)

    # Geometric normal: (p2 - p1) x (p3 - p1), normalized.
    abx, aby, abz = bx - ax, by - ay, bz - az
    acx, acy, acz = cx - ax, cy - ay, cz - az
    gx = aby * acz - abz * acy
    gy = abz * acx - abx * acz
    gz = abx * acy - aby * acx
    inv = 1.0 / (torch.sqrt((gx * gx + gy * gy) + gz * gz) + 1e-20)
    gx, gy, gz = gx * inv, gy * inv, gz * inv
    ray_dot = (dx * gx + dy * gy) + dz * gz
    flip = ray_dot > 0.0
    gx, gy, gz = (torch.where(flip, -gx, gx), torch.where(flip, -gy, gy),
                  torch.where(flip, -gz, gz))

    # p1 - p2, p1 - p3, p1 - origin.
    mbx, mby, mbz = ax - bx, ay - by, az - bz
    mcx, mcy, mcz = ax - cx, ay - cy, az - cz
    mox, moy, moz = ax - ox, ay - oy, az - oz
    denom = det3(dx, dy, dz, mbx, mby, mbz, mcx, mcy, mcz)
    safe = torch.where(denom.abs() < 1e-12, 1e-12, denom)
    u = det3(dx, dy, dz, mox, moy, moz, mcx, mcy, mcz) / safe
    v = det3(dx, dy, dz, mbx, mby, mbz, mox, moy, moz) / safe
    t = det3(mox, moy, moz, mbx, mby, mbz, mcx, mcy, mcz) / safe

    hit = ((ray_dot.abs() >= 1e-5) & (denom.abs() >= 1e-5) & (u >= 0.0) & (u <= 1.0)
           & (v >= 0.0) & (u + v <= 1.0) & (t > t_min) & (t < t_max))

    w = (1.0 - u) - v
    n1x, n1y, n1z = n1.unbind(-1)
    n2x, n2y, n2z = n2.unbind(-1)
    n3x, n3y, n3z = n3.unbind(-1)
    color = torch.stack([
        -((w * n1x + u * n2x) + v * n3x) * 0.5 + 0.5,
        -((w * n1y + u * n2y) + v * n3y) * 0.5 + 0.5,
        -((w * n1z + u * n2z) + v * n3z) * 0.5 + 0.5,
    ], dim=-1)
    return torch.where(hit, t, MISS_T), hit, color, torch.stack([gx, gy, gz], dim=-1)
