"""The plain geodesic march: Euler and Cash-Karp RK45 steps under the
pseudo-Newtonian force, or the exact-Kerr Hamiltonian RK4 step
(:mod:`.kerr`), with the disk branch.

``rays`` is a (10, N) float32 tensor of rows px py pz dx dy dz h active
amount steps_done, then under Kerr the momentum qx qy qz (13 rows);
``params`` the (NUM_PARAMS,) vector of :func:`pack_params`.  The result is
(OUT_FIXED + SLOT_ROWS, N): the 13 rows of ``_OUT_FIXED``, then K=4 slots
of 7 rows (hx hy hz dx dy dz valid) recording the first K disk crossings
in order, then under Kerr the final momentum qx qy qz (44 rows).  Lanes
that enter inactive come back unchanged, with zero counters and slots.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from . import kerr

# The Cash-Karp tableau.
A21 = 1.0 / 5.0
A31, A32 = 3.0 / 40.0, 9.0 / 40.0
A41, A42, A43 = 3.0 / 10.0, -9.0 / 10.0, 6.0 / 5.0
A51, A52, A53, A54 = -11.0 / 54.0, 5.0 / 2.0, -70.0 / 27.0, 35.0 / 27.0
A61, A62, A63, A64, A65 = (
    1631.0 / 55296.0,
    175.0 / 512.0,
    575.0 / 13824.0,
    44275.0 / 110592.0,
    253.0 / 4096.0,
)
# 5th-order solution weights.
B1, B2, B3, B4, B5, B6 = (
    37.0 / 378.0,
    0.0,
    250.0 / 621.0,
    125.0 / 594.0,
    0.0,
    512.0 / 1771.0,
)
# Embedded 4th-order weights.
BH1, BH2, BH3, BH4, BH5, BH6 = (
    2825.0 / 27648.0,
    0.0,
    18575.0 / 48384.0,
    13525.0 / 55296.0,
    277.0 / 14336.0,
    1.0 / 4.0,
)
# Error weights (b - b_hat).
E1, E2, E3, E4, E5, E6 = (
    B1 - BH1,
    B2 - BH2,
    B3 - BH3,
    B4 - BH4,
    B5 - BH5,
    B6 - BH6,
)

IN_FIELDS = 10  # px, py, pz, dx, dy, dz, h, active, amount, steps_done
MOMENTUM_FIELDS = 3  # qx, qy, qz (Kerr)
MOMENTUM = ("qx", "qy", "qz")

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

_EULER, _RK45, _KERR = 0, 1, 2
# Substeps between the all-done tests, and in each checkpointed segment.
SEGMENT_STEPS = 32


def mode_of(integrator: str, geodesics: str = "pseudo") -> int:
    """The march's branch: Kerr runs its own RK4 whatever the integrator."""
    if geodesics == "kerr":
        return _KERR
    if geodesics != "pseudo" or integrator not in ("euler", "rk45"):
        raise ValueError(f"no march for integrator={integrator!r}, geodesics={geodesics!r}")
    return _EULER if integrator == "euler" else _RK45


def pack_params(black_hole, disk_normal, cfg) -> torch.Tensor:
    """The (NUM_PARAMS,) float32 parameter vector, on the scene's device."""
    bh = black_hole
    cfg_vals = torch.tensor(
        (cfg.step_size, cfg.opacity_cutoff, cfg.rk_rtol, cfg.rk_safety,
         cfg.rk_min_factor, cfg.rk_max_factor, cfg.rk_h_min, cfg.rk_h_max,
         float(cfg.max_iterations)), dtype=torch.float32, device=bh.mass.device)
    return torch.cat([
        bh.position, torch.stack([bh.mass, bh.horizon_radius, bh.relativity_radius]),
        disk_normal, torch.stack([bh.disk_inner, bh.disk_outer]),
        cfg_vals, bh.spin.reshape(1),
    ]).to(torch.float32)


def _norm3(x, y, z):
    inv = torch.rsqrt(x * x + y * y + z * z + 1e-20)
    return x * inv, y * inv, z * inv


def _accel_fn(p, h2):
    """The pseudo-Newtonian bending force -3 M h^2 r / |r|^5 at a position,
    r^-5 as rsqrt^5."""
    def accel(qx, qy, qz):
        arx, ary, arz = qx - p["bh_x"], qy - p["bh_y"], qz - p["bh_z"]
        r2 = arx * arx + ary * ary + arz * arz
        ir = torch.rsqrt(r2 + 1e-12)
        ir2 = ir * ir
        a_s = (-3.0) * p["mass"] * h2 * (ir2 * ir2 * ir)
        return a_s * arx, a_s * ary, a_s * arz
    return accel


def _rk45_proposal(s, p, h2):
    """One Cash-Karp proposal: the new
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
    # The position advances along the old direction.
    npos = (px + dx * h, py + dy * h, pz + dz * h)
    return nd, npos, h_next, accept


def _substep(s, p, slots, tex_opacity_min: float, show_disk: bool, mode: int):
    """One substep: rebinds the entries of the state dict ``s`` and of
    ``slots`` (a list of K*7 (N,) rows) to new tensors, writing into no
    tensor, so a checkpointed replay recomputes it from its inputs.  Same
    operations under the branch ``mode`` (_EULER, _RK45 or _KERR)."""
    bx, by, bz = p["bh_x"], p["bh_y"], p["bh_z"]
    px, py, pz = s["px"], s["py"], s["pz"]
    dx, dy, dz = s["dx"], s["dy"], s["dz"]
    act = s["act"]

    rx, ry, rz = px - bx, py - by, pz - bz
    if mode == _KERR:
        (ndx, ndy, ndz), (npx, npy, npz), nq, h_used, captured = kerr.proposal(s, p)
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
            # Euler: dir += f h; normalize; pos += dir h,
            # with the force inlined.
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
            applied = act
            h_next = h_used
        else:
            (ndx, ndy, ndz), (npx, npy, npz), h_next, accept = _rk45_proposal(s, p, h2)
            # A rejected lane keeps its state and retries with h_next.
            applied = act & accept

        # Horizon sphere against [pos, pos + ndir * h].
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
        # Disk annulus plane hit.
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
        # A Kerr capture whose disk plane lies behind the chord (t_d < 0)
        # is no horizon hit: the lane marches on inside the horizon.
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
        # gradient is stopped.
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
        for name, val in zip(MOMENTUM, nq):
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


# The state rows that the lower-precision control rounds (and the
# momentum, under Kerr).
_ROUNDED = ("px", "py", "pz", "dx", "dy", "dz", "h", "closest2", "amount_ub")


def _segment(s, slots, sc, steps: int, args, state_dtype=None):
    """``steps`` substeps on copies of the state dict and the slot list;
    with ``state_dtype``, the ray's state and its recorded crossings are
    rounded to that type after each substep (the lower-precision control;
    counters and flags are left whole)."""
    s, slots = dict(s), list(slots)
    for _ in range(steps):
        _substep(s, sc, slots, *args)
        if state_dtype is not None:
            for k in _ROUNDED + MOMENTUM:
                if k in s:
                    s[k] = s[k].to(state_dtype).to(torch.float32)
            slots = [v.to(state_dtype).to(torch.float32) for v in slots]
    return s, slots


def _checkpointed_segment(s, slots, sc, steps: int, args, state_dtype=None):
    """:func:`_segment` under ``torch.utils.checkpoint``: autograd keeps
    only the segment's inputs and recomputes its substeps in the backward
    pass."""
    keys = tuple(s)

    def run(*vals):
        st, sl = _segment(dict(zip(keys, vals)), vals[len(keys):], sc, steps, args,
                          state_dtype)
        return (*(st[k] for k in keys), *sl)

    vals = checkpoint(run, *(s[k] for k in keys), *slots, use_reentrant=False,
                      preserve_rng_state=False)
    return dict(zip(keys, vals)), list(vals[len(keys):])


def _graphed(s, slots, sc, max_iterations: int, args, state_dtype):
    """The segments of :func:`run` on the card with no gradient: one
    segment of SEGMENT_STEPS substeps captured as a CUDA graph that
    advances the state in place, replayed until no lane is active, and the
    last shorter segment run as it is.  The graph launches the very
    kernels of the uncaptured segment, in the same order, so the result is
    the same to the bit; it saves the host's launch cost, which bounds the
    plain march at a frame's small ray counts."""
    state = {k: v.clone() for k, v in s.items()}
    rows = [v.clone() for v in slots]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, out_rows = _segment(state, rows, sc, SEGMENT_STEPS, args, state_dtype)
        for k, v in out.items():
            state[k].copy_(v)
        for a, b in zip(rows, out_rows):
            a.copy_(b)
    done = 0
    while done + SEGMENT_STEPS <= max_iterations and bool(state["act"].any()):
        graph.replay()
        done += SEGMENT_STEPS
    if done < max_iterations and bool(state["act"].any()):
        return _segment(state, rows, sc, max_iterations - done, args, state_dtype)
    return state, rows


def run(rays: torch.Tensor, params: torch.Tensor, max_iterations: int,
        tex_opacity_min: float, show_disk: bool, mode: int,
        checkpointed: bool = False, state_dtype=None, graphed: bool = True) -> torch.Tensor:
    """The plain march of ``rays``: segments of SEGMENT_STEPS substeps
    until no lane is active or ``max_iterations`` passes.  A pass over
    inactive lanes is an identity, so stopping early is exact; the
    all-done test is a host sync on CUDA.  On the card with no gradient
    the segments replay a CUDA graph (:func:`_graphed`) unless
    ``graphed`` is false."""
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
        s.update(zip(MOMENTUM, rays[IN_FIELDS:].unbind(0)))
    slots = [zeros] * SLOT_ROWS
    args = (tex_opacity_min, show_disk, mode)
    if graphed and not checkpointed and not torch.is_grad_enabled() \
            and px.device.type == "cuda":
        s, slots = _graphed(s, slots, sc, max_iterations, args, state_dtype)
    else:
        segment = _checkpointed_segment if checkpointed else _segment
        for start in range(0, max_iterations, SEGMENT_STEPS):
            if not bool(s["act"].any()):
                break
            s, slots = segment(s, slots, sc, min(SEGMENT_STEPS, max_iterations - start),
                               args, state_dtype)

    rows = [None] * OUT_FIXED
    for name in ("px", "py", "pz", "dx", "dy", "dz", "steps", "horizon",
                 "exited", "h", "count"):
        rows[_OUT_FIXED[name]] = s[name]
    rows[_OUT_FIXED["closest"]] = torch.sqrt(s["closest2"])
    rows[_OUT_FIXED["amount"]] = s["amount_ub"]
    rows += slots
    if mode == _KERR:
        rows += [s[k] for k in MOMENTUM]
    return torch.stack(rows)


