"""The tracer: straight and march phases over a flat ray batch.

A trace runs ``straight -> [march -> straight] x 2``, then one last
straight phase.  A straight phase tests rays outside the relativity sphere
against it; a march phase marches the rays inside.  The march records up
to K=4 disk crossings per ray, and one batched shade + composite runs at
the end.  The result is the sky-free record: 8 rows ``cr cg cb alpha
amount dx dy dz``.

State is a dict of (N,) rows; ``status`` is 0 = needs a straight phase,
1 = marching, 2 = escaped, 3 = absorbed.  Under exact Kerr geodesics a ray
that enters the relativity sphere takes the null momentum along its
direction there, and each march carries the momentum in and out.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import kerr, march
from .config import Config
from .march import CROSS_FIELDS, MAX_CROSSINGS, OUT_FIXED, SLOT_ROWS, _OUT_FIXED
from .scene import Camera, Scene
from .shade import composite_rows, pack_shade_params

ROUNDS = 2
T_MIN = 1e-8
MISS_T = 1e8

# Record channels (rows): 0-2 color, 3 alpha, 4 amount, 5-7 escape direction.
REC_ALPHA = 3
REC_DIR = slice(5, 8)

# On the CPU, torch runs a binary transcendental op (atan2, pow) on the
# last N mod 32 elements of a batch with scalar libm, an ulp apart from its
# vector math.  A CPU trace pads its batch to a multiple of
# CPU_BATCH_ALIGN rays, so a ray's record does not depend on the batch it
# is traced in.
CPU_BATCH_ALIGN = 64
o_steps = _OUT_FIXED["steps"]


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def camera_rays(camera: Camera, width: int, height: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions, (H, W, 3) each: NDC scale
    2 / (min(W, H) - 1) about the image center, camera basis from world-up
    (0, -1, 0)."""
    dev = camera.position.device
    inc = 2.0 / (min(width, height) - 1)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) - (width - 1) / 2.0) * inc
    ys = (torch.arange(height, dtype=torch.float32, device=dev) - (height - 1) / 2.0) * inc
    py, px = torch.meshgrid(ys, xs, indexing="ij")

    fwd = camera.forward / _norm(camera.forward)
    world_up = torch.tensor((0.0, -1.0, 0.0), dtype=torch.float32, device=dev)
    right = torch.linalg.cross(fwd, world_up)
    right = right / _norm(right)
    up = torch.linalg.cross(fwd, right)
    up = up / _norm(up)
    fov_factor = 1.0 / torch.tan(camera.fov / 2.0)

    d = px[..., None] * right + py[..., None] * up + fov_factor * fwd
    d = d / _norm(d, keepdim=True)
    return camera.position.expand(d.shape), d


def _init_state(origins: torch.Tensor, directions: torch.Tensor) -> Dict:
    """Rows state of a fresh batch."""
    n = origins.shape[0]
    o = origins.to(torch.float32)
    d = directions.to(torch.float32)
    zeros = o.new_zeros((n,))
    false = torch.zeros((n,), dtype=torch.bool, device=o.device)
    izeros = torch.zeros((n,), dtype=torch.int32, device=o.device)
    return dict(
        px=o[:, 0], py=o[:, 1], pz=o[:, 2],
        dx=d[:, 0], dy=d[:, 1], dz=d[:, 2],
        ox=d[:, 0], oy=d[:, 1], oz=d[:, 2],  # original directions (feather)
        hit=false, status=izeros, march_steps=izeros, entered=false,
        h=zeros, closest=zeros,
        # Conjugate momentum of the Kerr march (zeros under the pseudo force).
        qx=zeros, qy=zeros, qz=zeros,
        # K crossing slots of CROSS_FIELDS rows each, in crossing order.
        slots=o.new_zeros((MAX_CROSSINGS * CROSS_FIELDS, n)),
        count=zeros,
        horizon=false,
        # True (uncapped) crossing count; its excess over ``count``
        # measures the crossings the K slots dropped.
        true_count=zeros,
        # Running transmission upper bound of the march's early exit.
        amount_ub=o.new_ones((n,)),
    )


def _merge_slots(slots_a, count_a, slots_b, count_b):
    """Append slot list b after a's entries: merged[i] <- b[i - count_a]."""
    cf = CROSS_FIELDS
    merged = list(slots_a.unbind(0))
    for i in range(MAX_CROSSINGS):
        keep = (count_a > float(i)) | (slots_a[i * cf + 6] > 0.5)
        sels = [count_a == float(i - j) for j in range(i + 1)]
        for f in range(cf):
            take = torch.zeros_like(slots_b[f])
            for j in range(i + 1):
                take = torch.where(sels[j], slots_b[j * cf + f], take)
            merged[i * cf + f] = torch.where(keep, merged[i * cf + f], take)
    return (torch.stack(merged),
            torch.clamp(count_a + count_b, 0.0, float(MAX_CROSSINGS)))


def _straight_phase(state: Dict, scene: Scene, cfg: Config) -> Dict:
    """Straight-ray test of status-0 rays against the relativity sphere: a
    hit advances the ray to the boundary and starts its march, a miss
    escapes.  A ray already inside the sphere enters."""
    bh = scene.black_hole
    mask = state["status"] == 0
    px, py, pz = state["px"], state["py"], state["pz"]
    dx, dy, dz = state["dx"], state["dy"], state["dz"]

    ocx = px - bh.position[0]
    ocy = py - bh.position[1]
    ocz = pz - bh.position[2]
    r_sphere = bh.relativity_radius
    a_q = dx * dx + dy * dy + dz * dz
    b_q = 2.0 * (ocx * dx + ocy * dy + ocz * dz)
    oc2 = ocx * ocx + ocy * ocy + ocz * ocz
    c_q = oc2 - r_sphere * r_sphere
    disc = b_q * b_q - 4.0 * a_q * c_q
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = (-b_q - sq) / (2.0 * a_q)
    t2 = (-b_q + sq) / (2.0 * a_q)
    real = disc > 0.0
    # Nearest root in (T_MIN, MISS_T).
    v1 = real & (t1 > T_MIN) & (t1 < MISS_T)
    v2 = real & (t2 > T_MIN) & (t2 < MISS_T)
    sphere_t = torch.where(v1, t1, torch.where(v2, t2, MISS_T))
    inside = oc2 < r_sphere * r_sphere

    state = dict(state)
    enters = mask & (inside | v1 | v2)
    escapes = mask & ~enters
    status = state["status"]
    adv_t = torch.where(enters & ~inside, sphere_t, 0.0)
    npx = px + dx * adv_t
    npy = py + dy * adv_t
    npz = pz + dz * adv_t
    nrx = npx - bh.position[0]
    nry = npy - bh.position[1]
    nrz = npz - bh.position[2]

    state.update(
        px=npx, py=npy, pz=npz,
        status=torch.where(enters, 1, torch.where(escapes, 2, status)).to(torch.int32),
        entered=state["entered"] | enters,
        h=torch.where(enters, cfg.step_size, state["h"]),
        closest=torch.where(enters, torch.sqrt(nrx * nrx + nry * nry + nrz * nrz),
                            state["closest"]),
    )
    if cfg.geodesics == "kerr":
        # The null momentum along the current direction at the sphere
        # boundary.
        q = kerr.null_momentum(torch.stack([nrx, nry, nrz], dim=-1),
                               torch.stack([dx, dy, dz], dim=-1), bh.mass, bh.spin)
        for c, name in enumerate(march.MOMENTUM):
            state[name] = torch.where(enters, q[:, c], state[name])
    return state


def _march_inputs(state: Dict, cfg: Config) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rays (10, N), or (13, N) with the momentum under Kerr, marching
    mask) for the march."""
    was = state["status"] == 1
    rows = [
        state["px"], state["py"], state["pz"],
        state["dx"], state["dy"], state["dz"],
        state["h"], was.to(torch.float32), state["amount_ub"],
        torch.zeros_like(state["px"]),  # steps already taken (one round)
    ]
    if cfg.geodesics == "kerr":
        rows += [state[name] for name in march.MOMENTUM]
    return torch.stack(rows), was


def _march_phase(state: Dict, black_hole, params: torch.Tensor,
                 cfg: Config, first_phase: bool, opts: Dict) -> Dict:
    """March the status-1 rays and fold the result into the state."""
    bh = black_hole
    rays, was = _march_inputs(state, cfg)
    out = march.run(rays, params, cfg.max_iterations,
                    0.7 if (cfg.show_disk_texture and cfg.show_disk) else 1.0,
                    cfg.show_disk, march.mode_of(cfg.integrator, cfg.geodesics),
                    checkpointed=opts.get("checkpointed", False),
                    state_dtype=opts.get("state_dtype"), graphed=opts.get("graphed", True))
    if opts.get("work") is not None:
        opts["work"].append((was.sum(), out[o_steps].sum(dtype=torch.float64)))
    o = _OUT_FIXED
    # Inactive lanes came back unchanged with zero counters and slots.
    w_closest = torch.minimum(
        torch.where(was, state["closest"], 1e9), out[o["closest"]]
    )
    w_dx, w_dy, w_dz = out[o["dx"]], out[o["dy"]], out[o["dz"]]
    horizon_b = out[o["horizon"]] > 0.5
    exited_b = out[o["exited"]] > 0.5

    hit = state["hit"]
    slots, count = state["slots"], state["count"]
    if cfg.show_disk:
        w_slots = out[OUT_FIXED:OUT_FIXED + SLOT_ROWS]
        w_count = sum(w_slots[k * CROSS_FIELDS + 6] for k in range(MAX_CROSSINGS))
        if first_phase:
            slots, count = w_slots, w_count
        else:
            slots, count = _merge_slots(slots, count, w_slots, w_count)
        hit = hit | (count > 0.5)
    hit = hit | horizon_b
    amount_ub = torch.where(horizon_b, 0.0, out[o["amount"]])

    # Feather the exit direction toward the original one.
    fw = bh.relativity_radius * bh.feather
    fs = bh.relativity_radius - fw
    lin = torch.clamp((w_closest - fs) / torch.clamp(fw, min=1e-6), 0.0, 1.0)
    mix_amount = lin * lin
    ndx = torch.where(exited_b, w_dx + (state["ox"] - w_dx) * mix_amount, w_dx)
    ndy = torch.where(exited_b, w_dy + (state["oy"] - w_dy) * mix_amount, w_dy)
    ndz = torch.where(exited_b, w_dz + (state["oz"] - w_dz) * mix_amount, w_dz)

    absorbed = was & (horizon_b | (amount_ub < cfg.opacity_cutoff))
    # Budget-capped rays (photon-sphere orbiters) escape with their current
    # direction.
    over_budget = was & ~exited_b & ~absorbed
    status = state["status"]
    status = torch.where(exited_b & ~absorbed, 0, status)
    status = torch.where(absorbed, 3, status)
    status = torch.where(over_budget, 2, status).to(torch.int32)

    state = dict(state)
    state.update(
        px=out[o["px"]], py=out[o["py"]], pz=out[o["pz"]],
        dx=ndx, dy=ndy, dz=ndz,
        h=out[o["h"]],
        hit=hit, slots=slots, count=count,
        horizon=state["horizon"] | horizon_b,
        amount_ub=amount_ub,
        closest=torch.where(was, w_closest, state["closest"]),
        march_steps=state["march_steps"] + out[o["steps"]].to(torch.int32),
        status=status,
        true_count=state["true_count"] + out[o["count"]],
    )
    if cfg.geodesics == "kerr":
        # The final momentum after the slot rows.
        state.update(zip(march.MOMENTUM, out[OUT_FIXED + SLOT_ROWS:].unbind(0)))
    return state


def _trace_phases(state: Dict, scene: Scene, cfg: Config, rounds: int,
                  opts: Dict) -> Dict:
    bh = scene.black_hole
    _, disk_normal = bh.disk_frame()
    params = march.pack_params(bh, disk_normal, cfg)
    for r in range(rounds):
        state = _straight_phase(state, scene, cfg)
        state = _march_phase(state, bh, params, cfg, (r == 0), opts)
    return state


def _shade_deferred(state: Dict, scene: Scene, cfg: Config,
                    cam_dist: torch.Tensor):
    """One batched shade + composite of the recorded crossings; a ray
    captured by the horizon keeps no sky transmission.  Returns the (4, N)
    rows r, g, b, amount."""
    bh = scene.black_hole
    n = cam_dist.shape[0]
    if cfg.show_disk:
        rot_mat, _ = bh.disk_frame()
        rgbt = composite_rows(
            state["slots"], cam_dist, pack_shade_params(bh, rot_mat, scene.time),
            scene.disk_gain, cfg.show_disk_texture, cfg.show_redshift)
    else:
        rgbt = torch.cat([cam_dist.new_zeros((3, n)), cam_dist.new_ones((1, n))])
    return torch.cat([rgbt[:3], torch.where(state["horizon"], 0.0, rgbt[3:])])


def trace_record_rows(origins: torch.Tensor, directions: torch.Tensor, scene: Scene,
                      cfg: Config, opts: Dict, rounds: int = ROUNDS) -> torch.Tensor:
    """Trace a flat (N, 3) batch of rays to the sky-free record, an (8, N)
    tensor of rows ``cr cg cb alpha amount dx dy dz``.  ``opts``:
    ``checkpointed`` (march segments under checkpoint, for a backward
    pass), ``state_dtype`` (the lower-precision control), ``graphed``
    (False: no CUDA graph), ``work`` (a list that gets (live rays,
    lane-substeps) of every march)."""
    n = origins.shape[0]
    pad = -n % CPU_BATCH_ALIGN if origins.device.type == "cpu" else 0
    if pad:  # dead lanes, cut off below
        origins = torch.cat([origins, origins[-1:].expand(pad, 3)])
        directions = torch.cat([directions, directions[-1:].expand(pad, 3)])
    bh = scene.black_hole
    state = _init_state(origins, directions)
    if pad:
        live = torch.arange(n + pad) < n
        state["status"] = torch.where(live, state["status"], 2).to(torch.int32)
    cam_dist = _norm(origins - bh.position)

    state = _trace_phases(state, scene, cfg, rounds, opts)
    # Rays that want a straight phase after the last march get one more;
    # any that would re-enter again are treated as escapes.
    state = _straight_phase(state, scene, cfg)
    status = torch.where(state["status"] == 1, 2, state["status"])
    state["status"] = status.to(torch.int32)

    shaded = _shade_deferred(state, scene, cfg, cam_dist)
    # Classification: final-color pixels composited something or marched
    # at most few_iters_threshold steps; the other escapes carry
    # (direction, alpha 0).
    total_iters = state["march_steps"] + state["entered"].to(torch.int32)
    alpha = state["hit"] | (total_iters <= cfg.few_iters_threshold)
    return torch.cat([
        shaded[:3], alpha.to(torch.float32).unsqueeze(0), shaded[3:],
        torch.stack([state["dx"], state["dy"], state["dz"]]),
    ])[:, :n]


