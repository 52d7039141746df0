"""Fused deferred disk shade + composite, and the per-slot shading
ingredients: plain torch versions and the CUDA kernel's wrappers.

Counterpart of ``bhx/kernels/shade_pallas.py``: ``_slot_ingredients``
(:83-160), the fused ``_composite_kernel`` (:407-469) and its jnp mirror
``_composite_jnp`` (:520-528), and the ingredients kernel ``_shade_kernel``
(:163-198) with its jnp mirror ``_ingredients_jnp`` (:263-279).  For each
ray, each valid recorded disk crossing (the march's K=4 slot rows) is
shaded -- optical depth, spiral Perlin texel times the bilinear
``disk_gain`` sample, blackbody tint of the Doppler x gravitational shift
-- and composited front to back: a (4, N) tensor of rows r, g, b,
transmission.  The ingredients variant returns, for every slot, its 7
rows od, m, tint r, g, b, u, v: a (K*7, N) tensor.
"""

from __future__ import annotations

import functools

import torch
from torch.autograd.function import once_differentiable

from bhx_torch.kernels import build
from bhx_torch.kernels.march import CROSS_FIELDS, MAX_CROSSINGS
from bhx_torch.procedural import blackbody_tint_channels, disk_texel_m, _tint_coeffs
from bhx_torch.profiling import REPLAY_COMPOSITE, REPLAY_INGREDIENTS, span
from bhx_torch.shading import sample_gain

# Scalar parameter vector of the shade pass.
_SP = dict(
    bh_x=0, bh_y=1, bh_z=2, mass=3, disk_inner=4, disk_outer=5,
    r00=6, r01=7, r02=8, r10=9, r11=10, r12=11, r20=12, r21=13, r22=14,
    spun=15,  # time * rotation_speed
)
NUM_SHADE_PARAMS = len(_SP)
SLOT_ROWS = MAX_CROSSINGS * CROSS_FIELDS
ING_FIELDS = 7  # od, m, tint_r, tint_g, tint_b, u, v

launches = {"composite": 0, "ingredients": 0}
# Backward replays, by the same names.
replays = dict.fromkeys(launches, 0)


def pack_shade_params(black_hole, rot_mat: torch.Tensor, time) -> torch.Tensor:
    """The (NUM_SHADE_PARAMS,) float32 vector, on the scene's device."""
    bh = black_hole
    return torch.cat([
        bh.position, torch.stack([bh.mass, bh.disk_inner, bh.disk_outer]),
        rot_mat.reshape(9), (time * bh.rotation_speed).reshape(1),
    ]).to(torch.float32)


@functools.lru_cache(maxsize=None)
def tint_table(device: torch.device) -> torch.Tensor:
    """The 3 x 11 tint polynomial coefficients (15000 K) on ``device``."""
    return torch.tensor(_tint_coeffs(15000.0).reshape(-1), device=device)


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
    # (absolute position, ray.wgsl:619), the rest the hole-relative radius.
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


def composite_torch(slots, cam_dist: torch.Tensor, params: torch.Tensor,
                    gain: torch.Tensor, *, show_texture: bool = True,
                    show_redshift: bool = True) -> torch.Tensor:
    """Plain torch shade + composite; ``slots`` is SLOT_ROWS (N,) rows."""
    return _composite_rows(slots, cam_dist, params, gain, show_texture, show_redshift)


def _composite_rows(slots, cam_dist, params, gain, show_texture: bool,
                    show_redshift: bool) -> torch.Tensor:
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


def _replay(counter: str, fn, inputs, grad_out, *args):
    """The cotangents of ``inputs`` for the cotangent ``grad_out`` of
    ``fn(*inputs, *args)``, by autograd through that plain math (the
    reference's recompute-adjoint backward rules, shade_pallas.py:300-305,
    551-563)."""
    replays[counter] += 1
    inputs = [t.detach().requires_grad_() for t in inputs]
    with torch.enable_grad():
        grads = torch.autograd.grad(fn(*inputs, *args), inputs, grad_out,
                                    allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for t, g in zip(inputs, grads))


def composite_replay(slots, cam_dist, params, gain, grad_out, *, show_texture: bool = True,
                     show_redshift: bool = True):
    """The composite's vector-Jacobian product: the cotangents of
    ``(slots, cam_dist, params, gain)`` for the cotangent ``grad_out`` of
    its (4, N) output, by replaying the plain shade + composite."""
    with span(REPLAY_COMPOSITE):
        return _replay("composite", _composite_rows, (slots, cam_dist, params, gain),
                       grad_out, show_texture, show_redshift)


def _composite_forward(slots, cam_dist, params, gain, show_texture: bool,
                       show_redshift: bool) -> torch.Tensor:
    if slots.device.type == "cpu":
        return composite_torch(slots, cam_dist, params, gain,
                               show_texture=show_texture,
                               show_redshift=show_redshift)
    n = slots.shape[1]
    build.check_rows(slots, SLOT_ROWS, "slots")
    build.check_vector(cam_dist, n, slots.device, "cam_dist")
    build.check_vector(params, NUM_SHADE_PARAMS, slots.device, "params")
    if gain.dim() != 3 or gain.shape[2] != 4 or not gain.is_contiguous():
        raise ValueError(
            f"gain: expected a contiguous (Gh, Gw, 4) tensor, got {tuple(gain.shape)}"
        )
    build.check_vector(gain.view(-1), gain.numel(), slots.device, "gain")
    out = torch.empty((4, n), dtype=torch.float32, device=slots.device)
    if n:
        build.launch(
            "bhx_composite", slots, cam_dist, params, gain,
            int(gain.shape[0]), int(gain.shape[1]), tint_table(slots.device),
            out, n, int(show_texture), int(show_redshift),
        )
        launches["composite"] += 1
    return out


class _Composite(torch.autograd.Function):
    """The composite with :func:`composite_replay` as its backward
    (``shade_pallas.shade_composite``)."""

    @staticmethod
    def forward(ctx, slots, cam_dist, params, gain, show_texture, show_redshift):
        ctx.flags = (show_texture, show_redshift)
        ctx.save_for_backward(slots, cam_dist, params, gain)
        return _composite_forward(slots, cam_dist, params, gain, show_texture,
                                  show_redshift)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        show_texture, show_redshift = ctx.flags
        grads = composite_replay(*ctx.saved_tensors, grad_out, show_texture=show_texture,
                                 show_redshift=show_redshift)
        return (*grads, None, None)


def composite(slots: torch.Tensor, cam_dist: torch.Tensor, params: torch.Tensor,
              gain: torch.Tensor, *, show_texture: bool = True,
              show_redshift: bool = True) -> torch.Tensor:
    """Shade + composite: the plain version for CPU tensors, the CUDA kernel
    (``csrc/shade.cu``) for CUDA tensors.  ``slots`` is (SLOT_ROWS, N).
    Differentiable in every tensor argument: the backward is
    :func:`composite_replay`, on either device."""
    return _Composite.apply(slots, cam_dist, params, gain, show_texture, show_redshift)


def ingredients_torch(slots, cam_dist: torch.Tensor, params: torch.Tensor, *,
                      show_texture: bool = True,
                      show_redshift: bool = True) -> torch.Tensor:
    """Plain torch shading ingredients of every slot, valid or not:
    (MAX_CROSSINGS * ING_FIELDS, N) rows, 7 per slot."""
    return _ingredient_rows(slots, cam_dist, params, show_texture, show_redshift)


def _ingredient_rows(slots, cam_dist, params, show_texture: bool,
                     show_redshift: bool) -> torch.Tensor:
    p = {name: params[i] for name, i in _SP.items()}
    rows = []
    for k in range(MAX_CROSSINGS):
        hx, hy, hz, dx, _, dz, _ = slots[k * CROSS_FIELDS:(k + 1) * CROSS_FIELDS]
        ing = _slot_ingredients(hx, hy, hz, dx, dz, cam_dist, p, show_texture,
                                show_redshift)
        rows.extend(ing)
    return torch.stack(rows)


def ingredients_replay(slots, cam_dist, params, grad_out, *, show_texture: bool = True,
                       show_redshift: bool = True):
    """The ingredients' vector-Jacobian product: the cotangents of
    ``(slots, cam_dist, params)`` for the cotangent ``grad_out`` of the
    (K*7, N) output, by replaying the plain ingredients."""
    with span(REPLAY_INGREDIENTS):
        return _replay("ingredients", _ingredient_rows, (slots, cam_dist, params),
                       grad_out, show_texture, show_redshift)


def _ingredients_forward(slots, cam_dist, params, show_texture: bool,
                         show_redshift: bool) -> torch.Tensor:
    if slots.device.type == "cpu":
        return ingredients_torch(slots, cam_dist, params, show_texture=show_texture,
                                 show_redshift=show_redshift)
    n = slots.shape[1]
    build.check_rows(slots, SLOT_ROWS, "slots")
    build.check_vector(cam_dist, n, slots.device, "cam_dist")
    build.check_vector(params, NUM_SHADE_PARAMS, slots.device, "params")
    out = torch.empty((MAX_CROSSINGS * ING_FIELDS, n), dtype=torch.float32,
                      device=slots.device)
    if n:
        build.launch(
            "bhx_ingredients", slots, cam_dist, params, tint_table(slots.device),
            out, n, int(show_texture), int(show_redshift),
        )
        launches["ingredients"] += 1
    return out


class _Ingredients(torch.autograd.Function):
    """The ingredients with :func:`ingredients_replay` as its backward
    (``shade_pallas.shade_ingredients``)."""

    @staticmethod
    def forward(ctx, slots, cam_dist, params, show_texture, show_redshift):
        ctx.flags = (show_texture, show_redshift)
        ctx.save_for_backward(slots, cam_dist, params)
        return _ingredients_forward(slots, cam_dist, params, show_texture, show_redshift)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_out):
        show_texture, show_redshift = ctx.flags
        grads = ingredients_replay(*ctx.saved_tensors, grad_out,
                                   show_texture=show_texture, show_redshift=show_redshift)
        return (*grads, None, None)


def ingredients(slots: torch.Tensor, cam_dist: torch.Tensor, params: torch.Tensor,
                *, show_texture: bool = True,
                show_redshift: bool = True) -> torch.Tensor:
    """Per-slot shading ingredients: the plain version for CPU tensors, the
    CUDA kernel (``csrc/shade.cu``, its ingredients variant) for CUDA
    tensors.  ``slots`` is (SLOT_ROWS, N); the result (K*7, N).
    Differentiable: the backward is :func:`ingredients_replay`."""
    return _Ingredients.apply(slots, cam_dist, params, show_texture, show_redshift)
