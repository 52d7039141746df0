"""The geodesic march: plain torch version and the CUDA kernel's wrapper.

Counterpart of ``bhx/kernels/march_pallas.py`` (kernel) and
``bhx/kernels/march_grad.py:march_jnp`` (its step-exact mirror), for the
Euler integrator under the pseudo-Newtonian force with the disk branch
(``bhx/kernels/march_substep.py:78-340``).

Contract (same as ``march_jnp``): ``rays`` is IN_FIELDS (N,) float32 rows
-- px py pz dx dy dz h active amount steps_done -- as a (10, N) tensor;
``params`` is the (NUM_PARAMS,) vector of :func:`pack_params`.  The
result is a (OUT_FIXED + K*CROSS_FIELDS, N)
tensor: the 13 rows of ``_OUT_FIXED`` then K=4 slots of 7 rows
(hx hy hz dx dy dz valid) recording the first K disk crossings in order.
Lanes that enter inactive come back unchanged: pos, dir, h and amount
equal their inputs; steps, horizon, exited, count and slots are 0.
"""

from __future__ import annotations

import torch

from bhx_torch.kernels import build
from bhx_torch.scene import const

IN_FIELDS = 10  # px, py, pz, dx, dy, dz, h, active, amount, steps_done

# Scalar parameter vector layout.
_P = dict(
    bh_x=0, bh_y=1, bh_z=2, mass=3, horizon_r=4, rel_r=5,
    disk_nx=6, disk_ny=7, disk_nz=8, disk_inner=9, disk_outer=10,
    step_size=11, cutoff=12, rtol=13, safety=14, min_f=15, max_f=16,
    h_min=17, h_max=18,
    # Per-ray total step budget: a lane deactivates exactly when
    # steps_done + steps_this_call reaches it.
    budget=19,
    spin=20,
)
NUM_PARAMS = len(_P)

# Output rows.  ``count`` is the true number of disk crossings (not capped
# at K): the difference to the recorded slots measures dropped crossings.
_OUT_FIXED = dict(
    px=0, py=1, pz=2, dx=3, dy=4, dz=5,
    steps=6, closest=7, horizon=8, exited=9, h=10, amount=11, count=12,
)
OUT_FIXED = len(_OUT_FIXED)
CROSS_FIELDS = 7  # hx, hy, hz, dx, dy, dz, valid
MAX_CROSSINGS = 4
OUT_FIELDS = OUT_FIXED + CROSS_FIELDS * MAX_CROSSINGS

launches = 0


# The RK45 controller's slots (rtol, safety, min_f, max_f, h_min, h_max)
# hold bhx.RenderConfig's defaults; the Euler march never reads them, and
# they become configurable with RK45 (ROADMAP A10).
_RK45_SLOTS = (1e-3, 0.9, 0.2, 1.5, 1e-3, 1.0)


def pack_params(black_hole, disk_normal, cfg) -> torch.Tensor:
    """The (NUM_PARAMS,) float32 parameter vector, on the scene's device."""
    cfg_vals = const(
        (cfg.step_size, cfg.opacity_cutoff) + _RK45_SLOTS
        + (float(cfg.max_iterations),),
        black_hole.mass.device,
    )
    bh = black_hole
    return torch.cat([
        bh.position, torch.stack([bh.mass, bh.horizon_radius, bh.relativity_radius]),
        disk_normal, torch.stack([bh.disk_inner, bh.disk_outer]),
        cfg_vals, bh.spin.reshape(1),
    ]).to(torch.float32)


def _substep(s, p, slots, tex_opacity_min: float, show_disk: bool):
    """One Euler substep on the state dict ``s`` (in place); records a
    crossing into ``slots`` ((K*7, N), in place).  Same operations as
    ``march_substep`` with the integrator fixed to Euler."""
    bx, by, bz = p["bh_x"], p["bh_y"], p["bh_z"]
    px, py, pz = s["px"], s["py"], s["pz"]
    dx, dy, dz = s["dx"], s["dy"], s["dz"]
    act = s["act"]

    rx, ry, rz = px - bx, py - by, pz - bz
    cxv = ry * dz - rz * dy
    cyv = rz * dx - rx * dz
    czv = rx * dy - ry * dx
    h2 = cxv * cxv + cyv * cyv + czv * czv

    # Pseudo-Newtonian bending force -1.5 h^2 r / |r|^5 (ray.wgsl:401-403),
    # r^-5 as rsqrt^5; dir += f h; normalize; pos += dir h.
    r2 = rx * rx + ry * ry + rz * rz
    ir = torch.rsqrt(r2 + 1e-12)
    ir2 = ir * ir
    a_s = (-3.0) * p["mass"] * h2 * (ir2 * ir2 * ir)
    h_used = s["h"]
    vx = dx + a_s * rx * h_used
    vy = dy + a_s * ry * h_used
    vz = dz + a_s * rz * h_used
    inv = torch.rsqrt(vx * vx + vy * vy + vz * vz + 1e-20)
    ndx, ndy, ndz = vx * inv, vy * inv, vz * inv
    npx = px + ndx * h_used
    npy = py + ndy * h_used
    npz = pz + ndz * h_used

    # Horizon sphere against [pos, pos + ndir * h] (ray.wgsl:539-541).
    half_b = rx * ndx + ry * ndy + rz * ndz
    c_q = r2 - p["horizon_r2"]
    disc4 = half_b * half_b - c_q
    sq = torch.sqrt(torch.clamp(disc4, min=0.0))
    t1 = -half_b - sq
    t2 = -half_b + sq
    v1 = (disc4 > 0.0) & (t1 > 1e-8) & (t1 < h_used)
    v2 = (disc4 > 0.0) & (t2 > 1e-8) & (t2 < h_used)
    t_h = torch.where(v1, t1, torch.where(v2, t2, 1e9))
    hit_h = v1 | v2

    if show_disk:
        # Disk annulus plane hit (reference hit_torus2d, ray.wgsl:668-701).
        nx, ny, nz = p["disk_nx"], p["disk_ny"], p["disk_nz"]
        denom = nx * ndx + ny * ndy + nz * ndz
        denom = torch.where(torch.abs(denom) < 1e-12, 1e-12, denom)
        t_d = ((bx - px) * nx + (by - py) * ny + (bz - pz) * nz) / denom
        hx = px + ndx * t_d
        hy = py + ndy * t_d
        hz = pz + ndz * t_d
        ex, ey, ez = hx - bx, hy - by, hz - bz
        rr2 = ex * ex + ey * ey + ez * ez
        hit_d = ((t_d > 1e-8) & (t_d < h_used)
                 & (rr2 >= p["d_in2"]) & (rr2 <= p["d_out2"]))
        horizon_first = hit_h & (t_h <= t_d)
        crossing = act & hit_d & ~horizon_first
    else:
        horizon_first = hit_h
        crossing = None
    hit_horizon = act & horizon_first

    if show_disk:
        # Early-exit transmission bound: pow-free minorant
        # x^1.3 >= min(x, x^2) of the optical depth (30*dens)^1.3.
        irr = torch.rsqrt(rr2 + 1e-20)
        rr = rr2 * irr
        dens = 1.0 - rr * p["inv_d_out"]
        tt = torch.clamp(rr - p["disk_inner"], 0.0, 1.0)
        dens = dens * (tt * tt * (3.0 - 2.0 * tt))
        dens = torch.clamp(dens * torch.sqrt(irr), min=0.0)
        x = 30.0 * dens
        od_lb = torch.where(x < 1.0, x * x, x)
        op_lb = torch.clamp(od_lb * 0.2, 0.0, 1.0) * tex_opacity_min

        count = s["count"]
        for k in range(MAX_CROSSINGS):
            put = crossing & (count == float(k))
            base = k * CROSS_FIELDS
            for f, val in enumerate((hx, hy, hz, ndx, ndy, ndz)):
                slots[base + f] = torch.where(put, val, slots[base + f])
            slots[base + 6] = torch.where(put, 1.0, slots[base + 6])
        s["count"] = count + crossing.to(torch.float32)
        s["amount_ub"] = s["amount_ub"] * torch.where(crossing, 1.0 - op_lb, 1.0)

    # Advance the active lanes (for Euler, ``act`` is the reference's
    # ``applied`` mask); inactive lanes keep their state.
    s["px"] = torch.where(act, npx, px)
    s["py"] = torch.where(act, npy, py)
    s["pz"] = torch.where(act, npz, pz)
    s["dx"] = torch.where(act, ndx, dx)
    s["dy"] = torch.where(act, ndy, dy)
    s["dz"] = torch.where(act, ndz, dz)
    ox, oy, oz = s["px"] - bx, s["py"] - by, s["pz"] - bz
    dist2 = ox * ox + oy * oy + oz * oz
    s["closest2"] = torch.where(act, torch.minimum(s["closest2"], dist2),
                                s["closest2"])
    exited_now = act & (dist2 > p["rel_r2"])
    absorbed = hit_horizon | (act & (s["amount_ub"] < p["cutoff"]))
    s["horizon"] = torch.where(hit_horizon, 1.0, s["horizon"])
    s["exited"] = torch.where(exited_now, 1.0, s["exited"])
    s["steps"] = s["steps"] + act.to(torch.float32)
    s["act"] = act & (s["steps0"] + s["steps"] < p["budget"]) \
        & ~(exited_now | absorbed)


def march_torch(rays: torch.Tensor, params: torch.Tensor, *, max_iterations: int,
                tex_opacity_min: float = 0.7,
                show_disk: bool = True) -> torch.Tensor:
    """Plain torch march (see the module docstring for the contract).

    Runs substeps until no lane is active or ``max_iterations`` passes; a
    pass over inactive lanes is an identity, so stopping early is exact.
    The all-done test runs every 32 passes (a host sync on CUDA)."""
    if rays.shape[0] != IN_FIELDS:
        raise ValueError(f"expected {IN_FIELDS} ray rows, got {rays.shape[0]}")
    n = rays.shape[1]
    sc = {k: params[i] for k, i in _P.items()}
    sc.update(
        horizon_r2=sc["horizon_r"] * sc["horizon_r"],
        rel_r2=sc["rel_r"] * sc["rel_r"],
        d_in2=sc["disk_inner"] * sc["disk_inner"],
        d_out2=sc["disk_outer"] * sc["disk_outer"],
        inv_d_out=1.0 / sc["disk_outer"],
    )
    px, py, pz, dx, dy, dz, h, act0, amount0, steps0 = rays.unbind(0)
    zeros = torch.zeros_like(px)
    ox, oy, oz = px - sc["bh_x"], py - sc["bh_y"], pz - sc["bh_z"]
    s = dict(
        px=px, py=py, pz=pz, dx=dx, dy=dy, dz=dz, h=h,
        act=(steps0 < sc["budget"]) & (act0 > 0.5),
        steps=zeros, steps0=steps0,
        closest2=ox * ox + oy * oy + oz * oz,
        count=zeros, amount_ub=amount0, horizon=zeros, exited=zeros,
    )
    slots = rays.new_zeros((MAX_CROSSINGS * CROSS_FIELDS, n))
    for it in range(max_iterations):
        if it % 32 == 0 and not bool(s["act"].any()):
            break
        _substep(s, sc, slots, tex_opacity_min, show_disk)

    out = rays.new_empty((OUT_FIELDS, n))
    for name in ("px", "py", "pz", "dx", "dy", "dz", "steps", "horizon",
                 "exited", "h", "count"):
        out[_OUT_FIXED[name]] = s[name]
    out[_OUT_FIXED["closest"]] = torch.sqrt(s["closest2"])
    out[_OUT_FIXED["amount"]] = s["amount_ub"]
    out[OUT_FIXED:] = slots
    return out


def march(rays: torch.Tensor, params: torch.Tensor, *, max_iterations: int,
          tex_opacity_min: float = 0.7, show_disk: bool = True) -> torch.Tensor:
    """Run the march: the plain version for CPU tensors, the CUDA kernel
    (``csrc/march.cu``) for CUDA tensors.  ``rays`` is a (10, N) tensor."""
    if rays.device.type == "cpu":
        return march_torch(rays, params, max_iterations=max_iterations,
                           tex_opacity_min=tex_opacity_min, show_disk=show_disk)
    build.check_rows(rays, IN_FIELDS, "rays")
    build.check_vector(params, NUM_PARAMS, rays.device, "params")
    n = rays.shape[1]
    out = torch.empty((OUT_FIELDS, n), dtype=torch.float32, device=rays.device)
    if n:
        global launches
        build.launch(
            "bhx_march", rays, params, out, n, int(max_iterations),
            float(tex_opacity_min), int(show_disk),
        )
        launches += 1
    return out
