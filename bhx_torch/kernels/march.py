"""The geodesic march: plain torch version and the CUDA kernel's wrapper.

Counterpart of ``bhx/kernels/march_pallas.py`` (kernel) and
``bhx/kernels/march_grad.py:march_jnp`` (its step-exact mirror), for all
three branches of ``bhx/kernels/march_substep.py:78-340``: Euler and
Cash-Karp RK45 under the pseudo-Newtonian force, and the exact-Kerr
Hamiltonian RK4, each with the disk branch.

Contract (same as ``march_jnp``): ``rays`` is an (in_fields(geodesics), N)
float32 tensor of rows px py pz dx dy dz h active amount steps_done, then
qx qy qz (the conjugate momentum) under Kerr; ``params`` is the
(NUM_PARAMS,) vector of :func:`pack_params`.  The result is an
(out_fields(geodesics), N) tensor: the 13 rows of ``_OUT_FIXED``, then K=4
slots of 7 rows (hx hy hz dx dy dz valid) recording the first K disk
crossings in order, then under Kerr the final momentum qx qy qz.
Lanes that enter inactive come back unchanged: pos, dir, h, amount (and
momentum) equal their inputs; steps, horizon, exited, count and slots
are 0.

The backward pass (:func:`march_backward`) is :func:`march_replay`, the
plain substeps replayed under autograd, except for CUDA tensors under the
Euler branch, which take the hand-written adjoint kernel
(:func:`euler_adjoint`, ``csrc/march.cu``).  Launches, backward passes and
adjoint calls are counted in ``entries``, under the branch's kernel name.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from bhx_torch import kerr
from bhx_torch.integrate import (
    A21, A31, A32, A41, A42, A43, A51, A52, A53, A54, A61, A62, A63, A64, A65,
    B1, B3, B4, B6, E1, E3, E4, E5, E6,
)
from bhx_torch.kernels import build, entries
from bhx_torch.profiling import REPLAY_MARCH, count_march_backward, span
from bhx_torch.scene import const

IN_FIELDS = 10  # px, py, pz, dx, dy, dz, h, active, amount, steps_done
MOMENTUM_FIELDS = 3  # qx, qy, qz (geodesics="kerr")

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
SLOT_ROWS = CROSS_FIELDS * MAX_CROSSINGS

# The kernel's branches (its template instantiations), and the name each
# one's launches and backward passes are counted under.
_EULER, _RK45, _KERR = range(3)
KERNEL_NAMES = ("march", "march_rk45", "march_kerr")
entries.declare(KERNEL_NAMES, entries.LAUNCH, entries.REPLAY)
entries.declare(KERNEL_NAMES[:1], entries.ADJOINT)

# Substeps between the all-done tests, and in each checkpointed segment of
# the backward replay (the reference's 32-step leaf, march_grad.py:68-70).
SEGMENT_STEPS = 32
# Live rays in each chunk of the backward replay (the counterpart of
# ``pallas_bwd_chunks``, bhx/config.py:233-236).  A replayed substep keeps
# ~100 (N,) float32 tensors for the backward, ~0.8 GB at the 2,073,358
# rays of a 1918x1081 frame, so the frame in one chunk peaks at ~17 GB on
# the card (32-step segment pulled back, plus the segment checkpoints)
# and takes half the time of two chunks, which peak at ~10 GB.
REPLAY_CHUNK_RAYS = 1 << 21
# The Euler adjoint kernel's scratch for each live lane: a checkpoint of
# CHECKPOINT_FIELDS floats every SEGMENT_STEPS substeps and ADJOINT_STATE
# floats of cotangent; and each substep's ADJOINT_TERMS per-lane terms of
# mass and the disk normal, in rows of a multiple of TERMS_ALIGN floats, so
# that each row starts where a fresh tensor does (torch's reduction reads
# an unaligned head apart, in another order).
CHECKPOINT_FIELDS = 8
ADJOINT_STATE = 12
ADJOINT_TERMS = 7
TERMS_ALIGN = 128


def in_fields(geodesics: str = "pseudo") -> int:
    return IN_FIELDS + (MOMENTUM_FIELDS if geodesics == "kerr" else 0)


def out_fields(geodesics: str = "pseudo") -> int:
    return OUT_FIXED + SLOT_ROWS + (MOMENTUM_FIELDS if geodesics == "kerr" else 0)


def _mode(integrator: str, geodesics: str) -> int:
    """The kernel's branch; Kerr runs its own RK4 whatever the integrator
    (as in the reference)."""
    if geodesics == "kerr":
        return _KERR
    if geodesics == "pseudo" and integrator in ("euler", "rk45"):
        return _EULER if integrator == "euler" else _RK45
    raise ValueError(f"no march for integrator={integrator!r}, geodesics={geodesics!r}")


def pack_params(black_hole, disk_normal, cfg) -> torch.Tensor:
    """The (NUM_PARAMS,) float32 parameter vector, on the scene's device."""
    cfg_vals = const(
        (cfg.step_size, cfg.opacity_cutoff, cfg.rk_rtol, cfg.rk_safety,
         cfg.rk_min_factor, cfg.rk_max_factor, cfg.rk_h_min, cfg.rk_h_max,
         float(cfg.max_iterations)),
        black_hole.mass.device,
    )
    bh = black_hole
    return torch.cat([
        bh.position, torch.stack([bh.mass, bh.horizon_radius, bh.relativity_radius]),
        disk_normal, torch.stack([bh.disk_inner, bh.disk_outer]),
        cfg_vals, bh.spin.reshape(1),
    ]).to(torch.float32)


def _norm3(x, y, z):
    inv = torch.rsqrt(x * x + y * y + z * z + 1e-20)
    return x * inv, y * inv, z * inv


def _accel_fn(p, h2):
    """The pseudo-Newtonian bending force -1.5 h^2 r / |r|^5 at a position
    (ray.wgsl:401-403), r^-5 as rsqrt^5."""
    def accel(qx, qy, qz):
        arx, ary, arz = qx - p["bh_x"], qy - p["bh_y"], qz - p["bh_z"]
        r2 = arx * arx + ary * ary + arz * arz
        ir = torch.rsqrt(r2 + 1e-12)
        ir2 = ir * ir
        a_s = (-3.0) * p["mass"] * h2 * (ir2 * ir2 * ir)
        return a_s * arx, a_s * ary, a_s * arz
    return accel


def _rk45_proposal(s, p, h2):
    """One Cash-Karp proposal (``march_substep.py:195-240``): the new
    direction, the position along the old direction, the controller's next
    step and the accept mask."""
    px, py, pz = s["px"], s["py"], s["pz"]
    dx, dy, dz = s["dx"], s["dy"], s["dz"]
    h = s["h"]
    accel = _accel_fn(p, h2)

    def stage(cx, cy, cz):
        return accel(px + cx * h, py + cy * h, pz + cz * h)

    k1 = accel(px, py, pz)
    k2 = stage(*(A21 * k1[c] for c in range(3)))
    k3 = stage(*(A31 * k1[c] + A32 * k2[c] for c in range(3)))
    k4 = stage(*(A41 * k1[c] + A42 * k2[c] + A43 * k3[c] for c in range(3)))
    k5 = stage(*(A51 * k1[c] + A52 * k2[c] + A53 * k3[c] + A54 * k4[c]
                 for c in range(3)))
    k6 = stage(*(A61 * k1[c] + A62 * k2[c] + A63 * k3[c] + A64 * k4[c]
                 + A65 * k5[c] for c in range(3)))
    inc = [B1 * k1[c] + B3 * k3[c] + B4 * k4[c] + B6 * k6[c] for c in range(3)]
    e = [h * (E1 * k1[c] + E3 * k3[c] + E4 * k4[c] + E5 * k5[c] + E6 * k6[c])
         for c in range(3)]
    err = torch.maximum(torch.abs(e[0]), torch.maximum(torch.abs(e[1]),
                                                       torch.abs(e[2])))
    ratio = err / p["rtol"]
    accept = ratio <= 1.0
    # Controller without pow: ratio^-0.25 = rsqrt(rsqrt(ratio)).
    sr4 = p["safety"] * torch.rsqrt(torch.rsqrt(ratio + 1e-12))
    grow = torch.minimum(torch.clamp(sr4, min=1.0), p["max_f"])
    shrink = torch.clamp(torch.maximum(sr4, p["min_f"]), max=1.0)
    h_next = torch.minimum(
        torch.maximum(h * torch.where(accept, grow, shrink), p["h_min"]), p["h_max"])
    nd = _norm3(dx + h * inc[0], dy + h * inc[1], dz + h * inc[2])
    # The position advances along the old direction (reference parity).
    npos = (px + dx * h, py + dy * h, pz + dz * h)
    return nd, npos, h_next, accept


def _kerr_proposal(s, p):
    """One Hamiltonian RK4 step (``march_substep.py:126-182``): the chord
    direction, the new position and momentum, the chord length, and the
    capture test r_new <= r+."""
    mass = p["mass"]
    spin = p["spin"]
    a = spin * mass
    rx, ry, rz = s["px"] - p["bh_x"], s["py"] - p["bh_y"], s["pz"] - p["bh_z"]
    qx, qy, qz = s["qx"], s["qy"], s["qz"]
    x0 = (rx, ry, rz, qx, qy, qz)

    k1, r0 = kerr.rhs_rows(*x0, mass, a)
    # Field-strength-scaled step clip(h (r/3M)^1.5, 2e-3, 1), pow-free.
    t = r0 * (1.0 / (3.0 * mass))
    hk = torch.clamp(p["step_size"] * t * torch.sqrt(t), 2e-3, 1.0)
    half = 0.5 * hk
    k2, _ = kerr.rhs_rows(*(x0[c] + half * k1[c] for c in range(6)), mass, a)
    k3, _ = kerr.rhs_rows(*(x0[c] + half * k2[c] for c in range(6)), mass, a)
    k4, _ = kerr.rhs_rows(*(x0[c] + hk * k3[c] for c in range(6)), mass, a)
    sixth = hk * (1.0 / 6.0)
    nx = [x0[c] + sixth * (k1[c] + 2 * k2[c] + 2 * k3[c] + k4[c]) for c in range(6)]
    sgx, sgy, sgz = nx[0] - rx, nx[1] - ry, nx[2] - rz
    seg_len = torch.sqrt(sgx * sgx + sgy * sgy + sgz * sgz + 1e-24)
    inv_seg = 1.0 / seg_len
    nd = (sgx * inv_seg, sgy * inv_seg, sgz * inv_seg)
    npos = (nx[0] + p["bh_x"], nx[1] + p["bh_y"], nx[2] + p["bh_z"])
    r_plus = kerr.horizon_radius(mass, spin)
    r_new = kerr.scalars_rows(nx[0], nx[1], nx[2], mass, a)[0]
    return nd, npos, nx[3:], seg_len, r_new <= r_plus


def _substep(s, p, slots, tex_opacity_min: float, show_disk: bool, mode: int):
    """One substep: rebinds the entries of the state dict ``s`` and of
    ``slots`` (a list of K*7 (N,) rows) to new tensors, writing into no
    tensor, so a checkpointed replay recomputes it from its inputs.  Same
    operations as ``march_substep`` under the branch ``mode`` (_EULER,
    _RK45, _KERR)."""
    bx, by, bz = p["bh_x"], p["bh_y"], p["bh_z"]
    px, py, pz = s["px"], s["py"], s["pz"]
    dx, dy, dz = s["dx"], s["dy"], s["dz"]
    act = s["act"]

    rx, ry, rz = px - bx, py - by, pz - bz
    if mode == _KERR:
        (ndx, ndy, ndz), (npx, npy, npz), nq, h_used, captured = _kerr_proposal(s, p)
        captured = act & captured
        applied = act
        h_next = s["h"]
        # Capture is a terminal hit at t = 0 along the chord.
        hit_h = captured
        t_h = torch.where(captured, 0.0, 1e9)
    else:
        cxv = ry * dz - rz * dy
        cyv = rz * dx - rx * dz
        czv = rx * dy - ry * dx
        h2 = cxv * cxv + cyv * cyv + czv * czv
        r2 = rx * rx + ry * ry + rz * rz
        h_used = s["h"]
        if mode == _EULER:
            # Euler: dir += f h; normalize; pos += dir h (ray.wgsl:467-480),
            # with the force inlined as in the kernel.
            ir = torch.rsqrt(r2 + 1e-12)
            ir2 = ir * ir
            a_s = (-3.0) * p["mass"] * h2 * (ir2 * ir2 * ir)
            vx = dx + a_s * rx * h_used
            vy = dy + a_s * ry * h_used
            vz = dz + a_s * rz * h_used
            inv = torch.rsqrt(vx * vx + vy * vy + vz * vz + 1e-20)
            ndx, ndy, ndz = vx * inv, vy * inv, vz * inv
            npx = px + ndx * h_used
            npy = py + ndy * h_used
            npz = pz + ndz * h_used
            # For Euler, ``act`` is the reference's ``applied`` mask.
            applied = act
            h_next = h_used
        else:
            (ndx, ndy, ndz), (npx, npy, npz), h_next, accept = _rk45_proposal(s, p, h2)
            # A rejected lane keeps its state and retries with h_next.
            applied = act & accept

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
        # As the reference has it: a Kerr capture whose disk plane lies
        # behind the chord (t_d < 0) is not a horizon hit (ROADMAP C).
        horizon_first = hit_h & (t_h <= t_d)
        crossing = applied & hit_d & ~horizon_first
    else:
        horizon_first = hit_h
        crossing = None
    hit_horizon = applied & horizon_first

    if show_disk:
        # Early-exit transmission bound: pow-free minorant
        # x^1.3 >= min(x, x^2) of the optical depth (30*dens)^1.3.  A
        # heuristic mask input, so its inputs are detached, where the
        # reference's replay stops their gradient (march_substep.py:288-293).
        rr2_ng = rr2.detach()
        irr = torch.rsqrt(rr2_ng + 1e-20)
        rr = rr2_ng * irr
        dens = 1.0 - rr * p["inv_d_out"].detach()
        tt = torch.clamp(rr - p["disk_inner"].detach(), 0.0, 1.0)
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

    # Advance the applied lanes; the others keep their state.
    s["px"] = torch.where(applied, npx, px)
    s["py"] = torch.where(applied, npy, py)
    s["pz"] = torch.where(applied, npz, pz)
    s["dx"] = torch.where(applied, ndx, dx)
    s["dy"] = torch.where(applied, ndy, dy)
    s["dz"] = torch.where(applied, ndz, dz)
    if mode == _KERR:
        for name, val in zip(("qx", "qy", "qz"), nq):
            s[name] = torch.where(applied, val, s[name])
    ox, oy, oz = s["px"] - bx, s["py"] - by, s["pz"] - bz
    dist2 = ox * ox + oy * oy + oz * oz
    s["closest2"] = torch.where(applied, torch.minimum(s["closest2"], dist2),
                                s["closest2"])
    exited_now = applied & (dist2 > p["rel_r2"])
    absorbed = hit_horizon | (act & (s["amount_ub"] < p["cutoff"]))
    s["horizon"] = torch.where(hit_horizon, 1.0, s["horizon"])
    s["exited"] = torch.where(exited_now, 1.0, s["exited"])
    # Every active pass counts toward the budget, rejected ones included.
    s["steps"] = s["steps"] + act.to(torch.float32)
    if mode == _RK45:
        s["h"] = torch.where(act, h_next, s["h"])
    s["act"] = act & (s["steps0"] + s["steps"] < p["budget"]) \
        & ~(exited_now | absorbed)


def _scalars(params: torch.Tensor) -> dict:
    """The scalar dict a substep reads: every ``_P`` entry of ``params``
    and the squares and reciprocal derived from them."""
    sc = {k: params[i] for k, i in _P.items()}
    sc.update(
        horizon_r2=sc["horizon_r"] * sc["horizon_r"],
        rel_r2=sc["rel_r"] * sc["rel_r"],
        d_in2=sc["disk_inner"] * sc["disk_inner"],
        d_out2=sc["disk_outer"] * sc["disk_outer"],
        inv_d_out=1.0 / sc["disk_outer"],
    )
    return sc


def _segment(s, slots, sc, steps: int, args):
    """``steps`` substeps on copies of the state dict and the slot list."""
    s, slots = dict(s), list(slots)
    for _ in range(steps):
        _substep(s, sc, slots, *args)
    return s, slots


def _checkpointed_segment(s, slots, sc, steps: int, args):
    """:func:`_segment` under ``torch.utils.checkpoint``: autograd keeps
    only the segment's inputs and recomputes its substeps in the backward
    pass (the reference's rematerialized leaves, march_grad.py:138-178)."""
    keys = tuple(s)

    def run(*vals):
        st, sl = _segment(dict(zip(keys, vals)), vals[len(keys):], sc, steps, args)
        return (*(st[k] for k in keys), *sl)

    vals = checkpoint(run, *(s[k] for k in keys), *slots, use_reentrant=False,
                      preserve_rng_state=False)
    return dict(zip(keys, vals)), list(vals[len(keys):])


def _run(rays: torch.Tensor, params: torch.Tensor, max_iterations: int,
         tex_opacity_min: float, show_disk: bool, mode: int,
         checkpointed: bool = False) -> torch.Tensor:
    """The plain march of ``rays``: segments of SEGMENT_STEPS substeps
    until no lane is active or ``max_iterations`` passes.  A pass over
    inactive lanes is an identity, so stopping early is exact; the
    all-done test is a host sync on CUDA."""
    fin = IN_FIELDS + (MOMENTUM_FIELDS if mode == _KERR else 0)
    if rays.shape[0] != fin:
        raise ValueError(f"expected {fin} ray rows, got {rays.shape[0]}")
    sc = _scalars(params)
    px, py, pz, dx, dy, dz, h, act0, amount0, steps0 = rays[:IN_FIELDS].unbind(0)
    zeros = torch.zeros_like(px)
    ox, oy, oz = px - sc["bh_x"], py - sc["bh_y"], pz - sc["bh_z"]
    s = dict(
        px=px, py=py, pz=pz, dx=dx, dy=dy, dz=dz, h=h,
        act=(steps0 < sc["budget"]) & (act0 > 0.5),
        steps=zeros, steps0=steps0,
        closest2=ox * ox + oy * oy + oz * oz,
        count=zeros, amount_ub=amount0, horizon=zeros, exited=zeros,
    )
    if mode == _KERR:
        s.update(zip(("qx", "qy", "qz"), rays[IN_FIELDS:].unbind(0)))
    slots = [zeros] * SLOT_ROWS
    args = (tex_opacity_min, show_disk, mode)
    segment = _checkpointed_segment if checkpointed else _segment
    for start in range(0, max_iterations, SEGMENT_STEPS):
        if not bool(s["act"].any()):
            break
        s, slots = segment(s, slots, sc, min(SEGMENT_STEPS, max_iterations - start), args)

    rows = [None] * OUT_FIXED
    for name in ("px", "py", "pz", "dx", "dy", "dz", "steps", "horizon",
                 "exited", "h", "count"):
        rows[_OUT_FIXED[name]] = s[name]
    rows[_OUT_FIXED["closest"]] = torch.sqrt(s["closest2"])
    rows[_OUT_FIXED["amount"]] = s["amount_ub"]
    rows += slots
    if mode == _KERR:
        rows += [s["qx"], s["qy"], s["qz"]]
    return torch.stack(rows)


def march_torch(rays: torch.Tensor, params: torch.Tensor, *, max_iterations: int,
                tex_opacity_min: float = 0.7, show_disk: bool = True,
                integrator: str = "euler", geodesics: str = "pseudo") -> torch.Tensor:
    """Plain torch march (see the module docstring for the contract)."""
    return _run(rays, params, max_iterations, tex_opacity_min, show_disk,
                _mode(integrator, geodesics))


def march_replay(rays: torch.Tensor, params: torch.Tensor, grad_out: torch.Tensor, *,
                 max_iterations: int, tex_opacity_min: float = 0.7,
                 show_disk: bool = True, integrator: str = "euler",
                 geodesics: str = "pseudo"):
    """The march's vector-Jacobian product: ``(grad_rays, grad_params)``
    for the cotangent ``grad_out`` of its (out_fields, N) output, from the
    inputs alone (the counterpart of ``march_grad._march_bwd``).

    Replays the plain substeps under autograd and pulls ``grad_out`` back
    through them, with memory bounded two ways: lanes that enter live are
    replayed in chunks of at most REPLAY_CHUNK_RAYS (parameter cotangents
    summed over chunks), each in checkpointed segments of SEGMENT_STEPS
    substeps.  Lanes that enter inactive take no substep, so they are
    replayed apart, with none.  The kernel loops each lane until it is
    done, and an inactive pass is an identity, so the replayed trajectory
    is the kernel's with no step-count rounding."""
    mode = _mode(integrator, geodesics)
    with span(REPLAY_MARCH):
        entries.count(entries.REPLAY, KERNEL_NAMES[mode])
        count_march_backward(adjoint=False)
        rays, params = rays.detach(), params.detach().requires_grad_()
        live = (rays[7] > 0.5) & (rays[9] < params[_P["budget"]])  # active, steps_done
        grad_rays = torch.zeros_like(rays)
        grad_params = torch.zeros_like(params)
        batches = [((~live).nonzero()[:, 0], 0)]
        batches += [(idx, max_iterations)
                    for idx in live.nonzero()[:, 0].split(REPLAY_CHUNK_RAYS)]
        for idx, steps in batches:
            if not len(idx):
                continue
            r = rays[:, idx].requires_grad_()
            with torch.enable_grad():
                out = _run(r, params, steps, tex_opacity_min, show_disk, mode,
                           checkpointed=True)
                gr, gp = torch.autograd.grad(out, (r, params), grad_out[:, idx],
                                             allow_unused=True)
            if gr is not None:
                grad_rays[:, idx] = gr
            if gp is not None:
                grad_params += gp
        return grad_rays, grad_params


def euler_adjoint(rays: torch.Tensor, params: torch.Tensor, grad_out: torch.Tensor, *,
                  max_iterations: int, tex_opacity_min: float = 0.7,
                  show_disk: bool = True):
    """:func:`march_replay` of the Euler branch for CUDA tensors, by the
    adjoint kernel (``csrc/march.cu``, ``euler_adjoint_kernel``): equal to
    the replay bit for bit in every ray row and in the mass and disk-normal
    cotangents (the black hole's position to rounding), and the same bits
    from call to call.  The live lanes go in the replay's chunks; in each,
    one launch marches them and keeps their checkpoints, then one launch a
    segment, from the last, pulls the cotangent back, and each substep's
    per-lane mass and normal terms are summed by torch's reduction and
    added in autograd's order.  ``grad_out`` is the (out_fields(), N)
    cotangent."""
    with span(REPLAY_MARCH):
        entries.count(entries.REPLAY, KERNEL_NAMES[_EULER])
        count_march_backward(adjoint=True)
        build.check_rows(rays, IN_FIELDS, "rays")
        build.check_vector(params, NUM_PARAMS, rays.device, "params")
        n = rays.shape[1]
        grad_out = grad_out.contiguous()
        build.check_rows(grad_out, out_fields(), "grad_out")
        if grad_out.shape[1] != n:
            raise ValueError(f"grad_out: expected {n} lanes, got {grad_out.shape[1]}")
        if n >= 2 ** 31:
            raise ValueError(f"rays: at most 2^31 - 1 lanes, got {n}")
        grad_rays = torch.empty_like(rays)
        grad_params = torch.zeros_like(params)
        if not n:
            return grad_rays, grad_params
        dev, f32 = rays.device, torch.float32
        its = int(max_iterations)
        kw = (its, float(tex_opacity_min), int(show_disk))
        # The black hole's position terms of each lane.
        partials = torch.empty((3, n), dtype=f32, device=dev)
        build.launch("bhx_euler_adjoint_dead", rays, params, grad_out, grad_rays, partials,
                     n, its)
        live = (rays[7] > 0.5) & (rays[9] < params[_P["budget"]]) & (its > 0)
        for lanes in live.nonzero()[:, 0].to(torch.int32).split(REPLAY_CHUNK_RAYS):
            m = len(lanes)
            if not m:
                continue
            segments = -(-its // SEGMENT_STEPS)
            checkpoints = torch.empty((segments * CHECKPOINT_FIELDS * m,), dtype=f32, device=dev)
            steps = torch.empty((m,), dtype=torch.int32, device=dev)
            adj = torch.empty((ADJOINT_STATE, m), dtype=f32, device=dev)
            build.launch("bhx_euler_adjoint_checkpoint", rays, params, grad_out, lanes, m,
                         checkpoints, steps, adj, n, *kw)
            # The substeps to pull back (a host sync, as nonzero is).
            total = int(steps.max())
            stride = -(-m // TERMS_ALIGN) * TERMS_ALIGN
            terms = torch.empty((SEGMENT_STEPS, ADJOINT_TERMS, stride), dtype=f32, device=dev)
            sums = torch.empty((total, ADJOINT_TERMS), dtype=f32, device=dev)
            for seg in reversed(range(-(-total // SEGMENT_STEPS))):
                build.launch("bhx_euler_adjoint_segment", rays, params, grad_out, lanes, m,
                             checkpoints, steps, adj, terms, stride, seg, n, *kw)
                first = seg * SEGMENT_STEPS
                for j in range(min(SEGMENT_STEPS, total - first)):
                    for u in range(ADJOINT_TERMS):
                        # As autograd reduces a broadcast scalar's cotangent.
                        torch.sum(terms[j, u, :m], (0,), keepdim=True,
                                  out=sums[first + j, u:u + 1])
            build.launch("bhx_euler_adjoint_finish", rays, params, lanes, m, adj, grad_rays,
                         partials, n)
            chunk = torch.zeros_like(params)
            build.launch("bhx_euler_adjoint_accumulate", sums, total, int(show_disk), chunk)
            grad_params += chunk
        build.launch("bhx_euler_adjoint_sum", partials, grad_params, n)
        entries.count(entries.ADJOINT, KERNEL_NAMES[_EULER])
        return grad_rays, grad_params


def march_backward(rays: torch.Tensor, params: torch.Tensor, grad_out: torch.Tensor, *,
                   max_iterations: int, tex_opacity_min: float = 0.7,
                   show_disk: bool = True, integrator: str = "euler",
                   geodesics: str = "pseudo"):
    """The march's vector-Jacobian product: :func:`euler_adjoint` for CUDA
    tensors under the Euler branch, :func:`march_replay` for CPU tensors
    and for the RK45 and Kerr branches."""
    if rays.device.type == "cuda" and _mode(integrator, geodesics) == _EULER:
        return euler_adjoint(rays, params, grad_out, max_iterations=max_iterations,
                             tex_opacity_min=tex_opacity_min, show_disk=show_disk)
    return march_replay(rays, params, grad_out, max_iterations=max_iterations,
                        tex_opacity_min=tex_opacity_min, show_disk=show_disk,
                        integrator=integrator, geodesics=geodesics)


def _march_cuda(rays: torch.Tensor, params: torch.Tensor, *, max_iterations: int,
                tex_opacity_min: float, show_disk: bool, integrator: str,
                geodesics: str) -> torch.Tensor:
    """The CUDA kernel's launch."""
    mode = _mode(integrator, geodesics)
    build.check_rows(rays, in_fields(geodesics), "rays")
    build.check_vector(params, NUM_PARAMS, rays.device, "params")
    n = rays.shape[1]
    if n >= 2 ** 31:
        raise ValueError(f"rays: at most 2^31 - 1 lanes, got {n}")
    out = torch.empty((out_fields(geodesics), n), dtype=torch.float32,
                      device=rays.device)
    if n:
        # The kernel's scratch, allocated on every call: the queue of live
        # lanes and its three counters, zeroed (the kernel allocates
        # nothing).
        queue = torch.empty((n,), dtype=torch.int32, device=rays.device)
        counters = torch.zeros((3,), dtype=torch.int32, device=rays.device)
        build.launch(
            "bhx_march", rays, params, out, queue, counters, n, int(max_iterations),
            float(tex_opacity_min), int(show_disk), mode,
        )
        entries.count(entries.LAUNCH, KERNEL_NAMES[mode])
    return out


# The march with :func:`march_backward` as its backward
# (``march_grad.march_pallas_diff``).
_MARCH = entries.Entry(march_torch, _march_cuda, march_backward)


def march(rays: torch.Tensor, params: torch.Tensor, *, max_iterations: int,
          tex_opacity_min: float = 0.7, show_disk: bool = True,
          integrator: str = "euler", geodesics: str = "pseudo") -> torch.Tensor:
    """Run the march: the plain version for CPU tensors, the CUDA kernel
    (``csrc/march.cu``, the instantiation of ``integrator`` and
    ``geodesics``) for CUDA tensors.  ``rays`` is (in_fields(geodesics), N).
    Differentiable in ``rays`` and ``params``: the backward is
    :func:`march_backward`."""
    return _MARCH(rays, params, max_iterations=max_iterations,
                  tex_opacity_min=tex_opacity_min, show_disk=show_disk,
                  integrator=integrator, geodesics=geodesics)
