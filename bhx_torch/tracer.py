"""The ray tracer: straight and march phases over a flat ray batch
(counterpart of the kernel path of ``bhx/tracer.py``).

A trace runs ``straight -> [march -> straight] x 2``, then one last
straight phase.  A straight phase tests rays outside the relativity
sphere against it and against the scene's meshes: the nearer wins, a mesh
hit absorbs the ray, and a sphere hit advances the ray to the boundary; a
march phase runs the geodesic march kernel on the rays inside.  Nothing
is shaded during the trace: the march records up to K=4 disk crossings
per ray, a straight phase at most one opaque mesh hit, and one batched
shade + composite runs at the end (the deferred record of
``march_mode="pallas"``), the mesh hit weighted by the transmission of
every crossing before it.  In procedural texture mode the composite is a
kernel; in array mode it is plain torch, :func:`shading.disk_shade` on
the valid slots and a cumulative product, as ``bhx`` composites it in jnp.
The result is the sky-free record: 8 rows ``cr cg cb alpha amount dx dy
dz``.  The public API (:func:`trace_rays`, :func:`trace_image`, their
record variants, :func:`finalize_sky`, :func:`finalize_image`) takes and
gives the interleaved (..., 8) record of ``bhx.tracer``.

Re-entry rounds run as masked launches whatever their live count: a phase
with no live ray changes nothing, so no host sync is needed to skip it.

State is a dict of (N,) rows; ``status`` is 0 = needs a straight phase,
1 = marching, 2 = escaped, 3 = absorbed.  Under exact Kerr geodesics the
rows qx qy qz carry each ray's conjugate momentum: a straight phase sets
it for the rays that enter the sphere, and each march phase resumes from
it and writes it back.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from bhx_torch import graphs, kerr
from bhx_torch.config import Integrator, RenderConfig
from bhx_torch.geometry.intersect import MISS_T, T_MIN
from bhx_torch.geometry.traverse import intersect_meshes
from bhx_torch.kernels.march import (
    CROSS_FIELDS, MAX_CROSSINGS, OUT_FIXED, SLOT_ROWS, _OUT_FIXED, march, pack_params,
)
from bhx_torch.kernels.shade import composite, pack_shade_params
from bhx_torch.kernels.sky import sky_finalize, sky_rows
from bhx_torch.profiling import (
    KERNEL_COMPOSITE, KERNEL_MARCH, KERNEL_MESH, KERNEL_SKY, SKY, TRACE, TRACE_KERR_MOMENTUM,
    TRACE_MARCH, TRACE_MERGE, TRACE_SHADE, TRACE_STRAIGHT, count_call, count_lanes, span,
)
from bhx_torch.scene import Camera, Scene, const, texture
from bhx_torch.shading import disk_shade, sample_sky

DEFAULT_ROUNDS = 2

# Record channels (rows): 0-2 color, 3 alpha, 4 amount, 5-7 escape direction.
REC_ALPHA = 3
REC_AMOUNT = 4
REC_DIR = slice(5, 8)

# On the CPU, torch runs a binary transcendental op (atan2, pow) on the last
# N mod 32 elements of a batch (N mod 16 under AVX2) with scalar libm, an ulp
# apart from its vector math.  A CPU trace pads its batch to a multiple of
# CPU_BATCH_ALIGN rays, so a ray's record does not depend on the batch it is
# traced in (a band, a ladder level, a rank's share).  The array composite
# shades a compacted batch of valid slots, which this does not cover.
CPU_BATCH_ALIGN = 64


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1, keepdim=keepdim))


def camera_rays(camera: Camera, width: int, height: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pixel ray origins and directions, (H, W, 3) each (reference
    create_ray, ray.wgsl:269-285): NDC scale 2 / (min(W, H) - 1) about the
    image center, camera basis from world-up (0, -1, 0)."""
    dev = camera.position.device
    inc = 2.0 / (min(width, height) - 1)
    xs = (torch.arange(width, dtype=torch.float32, device=dev) - (width - 1) / 2.0) * inc
    ys = (torch.arange(height, dtype=torch.float32, device=dev) - (height - 1) / 2.0) * inc
    py, px = torch.meshgrid(ys, xs, indexing="ij")

    fwd = camera.forward / _norm(camera.forward)
    right = torch.linalg.cross(fwd, const((0.0, -1.0, 0.0), dev))
    right = right / _norm(right)
    up = torch.linalg.cross(fwd, right)
    up = up / _norm(up)
    fov_factor = 1.0 / torch.tan(camera.fov / 2.0)

    d = px[..., None] * right + py[..., None] * up + fov_factor * fwd
    d = d / _norm(d, keepdim=True)
    return camera.position.expand(d.shape), d


def _init_state(origins: torch.Tensor, directions: torch.Tensor) -> Dict:
    """Rows state of a fresh batch (``bhx.tracer._init_state`` with
    ``deferred=True``)."""
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
        # The opaque mesh hit of a straight phase: its clipped color.
        mcr=zeros, mcg=zeros, mcb=zeros,
        mesh_hit=false,
        horizon=false,
        # True (uncapped) crossing count; its excess over ``count``
        # measures the crossings the K slots dropped.
        true_count=zeros,
        # Running transmission upper bound of the march's early exit.
        amount_ub=o.new_ones((n,)),
    )


def _merge_slots(slots_a, count_a, slots_b, count_b):
    """Append slot list b after a's entries: merged[i] <- b[i - count_a].
    A span a slot, so that none holds more operations than a trace's
    breakdown looks back over for the range around an idle gap."""
    cf = CROSS_FIELDS
    merged = list(slots_a.unbind(0))
    for i in range(MAX_CROSSINGS):
        with span(TRACE_MERGE):
            keep = (count_a > float(i)) | (slots_a[i * cf + 6] > 0.5)
            sels = [count_a == float(i - j) for j in range(i + 1)]
            for f in range(cf):
                take = torch.zeros_like(slots_b[f])
                for j in range(i + 1):
                    take = torch.where(sels[j], slots_b[j * cf + f], take)
                merged[i * cf + f] = torch.where(keep, merged[i * cf + f], take)
    return (torch.stack(merged),
            torch.clamp(count_a + count_b, 0.0, float(MAX_CROSSINGS)))


def _straight_phase(state: Dict, scene: Scene, cfg: RenderConfig) -> Dict:
    """Straight-ray test of status-0 rays (reference outside branch,
    ray.wgsl:554-569; ``bhx/tracer.py:199-320``): the nearer of a mesh hit
    and the relativity sphere's entry wins.  A mesh hit records its color
    and absorbs the ray (meshes are opaque); a sphere hit advances the ray
    to the boundary and starts its march; neither escapes.  A ray already
    inside the sphere enters whatever the meshes."""
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
    # Nearest root in (T_MIN, MISS_T) — reference hit_sphere semantics.
    v1 = real & (t1 > T_MIN) & (t1 < MISS_T)
    v2 = real & (t2 > T_MIN) & (t2 < MISS_T)
    sphere_t = torch.where(v1, t1, torch.where(v2, t2, MISS_T))
    inside = oc2 < r_sphere * r_sphere

    state = dict(state)
    if cfg.render_meshes and scene.meshes:
        # Mesh hits carry no gradient (bhx wraps them in stop_gradient).
        with torch.no_grad(), span(KERNEL_MESH):
            mesh = intersect_meshes((px, py, pz), (dx, dy, dz), scene.meshes, active=mask)
        mesh_hit = mesh["hit"]
        enters = mask & (inside | ((v1 | v2) & (sphere_t < mesh["t"])))
        mesh_wins = mask & ~enters & mesh_hit
        escapes = mask & ~enters & ~mesh_hit
        # Recorded for the composite, which weights it by the transmission
        # through the crossings before it (ray.wgsl:571-576, opacity 1).
        mc = torch.clamp(mesh["color"], 0.0, 1.0)
        for c, name in enumerate(("mcr", "mcg", "mcb")):
            state[name] = torch.where(mesh_wins, mc[:, c], state[name])
        state["mesh_hit"] = state["mesh_hit"] | mesh_wins
        state["hit"] = state["hit"] | mesh_wins
        status = torch.where(mesh_wins, 3, state["status"])
    else:
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
        # boundary (bhx/tracer.py:307-317).
        with span(TRACE_KERR_MOMENTUM):
            q = kerr.null_momentum(torch.stack([nrx, nry, nrz], dim=-1),
                                   torch.stack([dx, dy, dz], dim=-1), bh.mass, bh.spin)
            for c, name in enumerate(("qx", "qy", "qz")):
                state[name] = torch.where(enters, q[:, c], state[name])
    return state


def _march_inputs(state: Dict, cfg: RenderConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rays (10, N), or (13, N) with the momentum under Kerr, marching
    mask) for the march kernel."""
    was = state["status"] == 1
    rows = [
        state["px"], state["py"], state["pz"],
        state["dx"], state["dy"], state["dz"],
        state["h"], was.to(torch.float32), state["amount_ub"],
        torch.zeros_like(state["px"]),  # steps already taken (one round)
    ]
    if cfg.geodesics == "kerr":
        rows += [state["qx"], state["qy"], state["qz"]]
    return torch.stack(rows), was


def march_kwargs(cfg: RenderConfig) -> Dict:
    """The march kernel's keyword arguments under ``cfg``."""
    return dict(
        max_iterations=cfg.max_iterations,
        tex_opacity_min=0.7 if (cfg.show_disk_texture and cfg.show_disk) else 1.0,
        show_disk=cfg.show_disk,
        integrator="rk45" if cfg.integrator == Integrator.RK45 else "euler",
        geodesics=cfg.geodesics,
    )


def _march_phase(state: Dict, black_hole, params: torch.Tensor,
                 cfg: RenderConfig, first_phase: bool) -> Dict:
    """March the status-1 rays in one kernel launch and fold the result
    into the state (``bhx.tracer._march_phase_pallas`` with one round)."""
    bh = black_hole
    rays, was = _march_inputs(state, cfg)
    with span(KERNEL_MARCH):
        out = march(rays, params, **march_kwargs(cfg))
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

    # Feather the exit direction toward the original one (ray.wgsl:543-553).
    fw = bh.relativity_radius * bh.feather
    fs = bh.relativity_radius - fw
    lin = torch.clamp((w_closest - fs) / torch.clamp(fw, min=1e-6), 0.0, 1.0)
    mix_amount = lin * lin
    ndx = torch.where(exited_b, w_dx + (state["ox"] - w_dx) * mix_amount, w_dx)
    ndy = torch.where(exited_b, w_dy + (state["oy"] - w_dy) * mix_amount, w_dy)
    ndz = torch.where(exited_b, w_dz + (state["oz"] - w_dz) * mix_amount, w_dz)

    absorbed = was & (horizon_b | (amount_ub < cfg.opacity_cutoff))
    # Budget-capped rays (photon-sphere orbiters) escape with their current
    # direction, like the reference's loop falling through (ray.wgsl:595).
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
        # The final momentum after the slot rows (bhx/tracer.py:492-494).
        qrows = out[OUT_FIXED + SLOT_ROWS:]
        state.update(qx=qrows[0], qy=qrows[1], qz=qrows[2])
    return state


def _trace_phases(state: Dict, scene: Scene, cfg: RenderConfig,
                  rounds: int) -> Dict:
    bh = scene.black_hole
    _, disk_normal = bh.disk_frame()
    params = pack_params(bh, disk_normal, cfg)
    for r in range(rounds):
        with span(TRACE_STRAIGHT):
            state = _straight_phase(state, scene, cfg)
        with span(TRACE_MARCH):
            state = _march_phase(state, bh, params, cfg, first_phase=(r == 0))
    return state


def _array_composite(slots: torch.Tensor, cam_dist: torch.Tensor, scene: Scene,
                     cfg: RenderConfig) -> torch.Tensor:
    """The array-mode shade + front-to-back composite of the K crossing
    slots (``bhx/tracer.py:984-1011``): each valid slot shaded by
    :func:`disk_shade` on the scene's disk texture and LUT, its color
    clipped, then composited by a cumulative product of transmissions.
    Only the valid slots are shaded; the others carry opacity 0, as the
    reference's mask gives them, so values and gradients are the
    reference's.  At 1918x1081 this beats shading all K x N slots and
    masking, as ``bhx`` does, despite its one host sync: 42-47 against
    62-65 ms a frame, 21-22 against 162 ms a texture-gradient step
    (one H100; ``march_study --study array``, PERF.md).  Returns the (4, N) rows r,
    g, b, transmission."""
    bh = scene.black_hole
    cf, k_slots, n = CROSS_FIELDS, MAX_CROSSINGS, cam_dist.shape[0]
    rot_mat, _ = bh.disk_frame()
    valid = slots.reshape(k_slots, cf, n)[:, 6] > 0.5
    sel = valid.reshape(-1).nonzero().squeeze(1)  # k * n + ray
    k = torch.div(sel, n, rounding_mode="floor")
    base = k * (cf * n) + (sel - k * n)  # row k * cf of the ray's column
    flat = slots.reshape(-1)
    fields = [flat.index_select(0, base + f * n) for f in range(6)]
    rgb, op = disk_shade(
        torch.stack(fields[:3], -1), torch.stack(fields[3:6], -1),
        cam_dist.index_select(0, sel - k * n), bh, rot_mat,
        texture(scene, "disk_texture"), texture(scene, "temp_lut"), scene.time,
        show_texture=cfg.show_disk_texture, show_redshift=cfg.show_redshift,
    )
    op_kn = cam_dist.new_zeros((k_slots * n,)).index_copy(0, sel, op)
    rgb_kn = cam_dist.new_zeros((k_slots * n, 3)).index_copy(
        0, sel, torch.clamp(rgb, 0.0, 1.0))
    op_kn, rgb_kn = op_kn.reshape(k_slots, n), rgb_kn.reshape(k_slots, n, 3)
    trans = torch.cumprod(1.0 - op_kn, dim=0)
    trans_before = torch.cat([cam_dist.new_ones((1, n)), trans[:-1]])
    color = ((trans_before * op_kn).unsqueeze(-1) * rgb_kn).sum(0)
    return torch.cat([color.t(), trans[-1:]])


def _shade_deferred(state: Dict, scene: Scene, cfg: RenderConfig,
                    cam_dist: torch.Tensor):
    """One batched shade + composite of the recorded crossings, then the
    opaque mesh hit weighted by the transmission through them all
    (``bhx/tracer.py:1012-1019``); a ray that hit a mesh or was captured by
    the horizon keeps no sky transmission.  Returns the (4, N) rows r, g,
    b, amount."""
    bh = scene.black_hole
    n = cam_dist.shape[0]
    if cfg.show_disk and cfg.texture_mode == "array":
        with span(KERNEL_COMPOSITE):
            rgbt = _array_composite(state["slots"], cam_dist, scene, cfg)
    elif cfg.show_disk:
        rot_mat, _ = bh.disk_frame()
        shade_params = pack_shade_params(bh, rot_mat, scene.time)
        with span(KERNEL_COMPOSITE):
            rgbt = composite(state["slots"], cam_dist, shade_params, scene.disk_gain,
                             show_texture=cfg.show_disk_texture,
                             show_redshift=cfg.show_redshift)
    else:
        rgbt = torch.cat([cam_dist.new_zeros((3, n)), cam_dist.new_ones((1, n))])
    trans_total = rgbt[3]
    mesh_hit = state["mesh_hit"]
    rgb = [torch.where(mesh_hit, rgbt[c] + trans_total * state[m], rgbt[c])
           for c, m in enumerate(("mcr", "mcg", "mcb"))]
    return torch.stack(rgb + [torch.where(mesh_hit | state["horizon"], 0.0, trans_total)])


def trace_rays_record_rows(origins: torch.Tensor, directions: torch.Tensor,
                           scene: Scene, cfg: RenderConfig,
                           rounds: int = DEFAULT_ROUNDS,
                           active: torch.Tensor = None) -> torch.Tensor:
    """Trace a flat (N, 3) batch of rays to the sky-free record, an (8, N)
    tensor of rows ``cr cg cb alpha amount dx dy dz``.

    ``active`` (optional bool (N,)): rays with False are dead lanes that
    produce an escape record; the march kernel skips them.  On the card,
    a shape traced before runs as a CUDA graph of the eager trace
    (``bhx_torch.graphs``).  Recorded as the span ``profiling.TRACE``, its
    lanes and whether it replayed a graph counted while a profiler
    records."""
    with span(TRACE):
        count_lanes(origins.shape[0], active)
        rows, replayed = graphs.GRAPHS.trace(_trace_record_rows, origins, directions,
                                             scene, cfg, rounds, active)
        count_call(replayed)
        return rows


def _trace_record_rows(origins: torch.Tensor, directions: torch.Tensor, scene: Scene,
                       cfg: RenderConfig, rounds: int,
                       active: torch.Tensor = None) -> torch.Tensor:
    """The eager trace of :func:`trace_rays_record_rows`, and the body of its
    CUDA graphs."""
    n = origins.shape[0]
    pad = -n % CPU_BATCH_ALIGN if origins.device.type == "cpu" else 0
    if pad:  # dead lanes, cut off below
        origins = torch.cat([origins, origins[-1:].expand(pad, 3)])
        directions = torch.cat([directions, directions[-1:].expand(pad, 3)])
        live = torch.ones(n, dtype=torch.bool) if active is None else active
        active = torch.cat([live, torch.zeros(pad, dtype=torch.bool)])
    bh = scene.black_hole
    state = _init_state(origins, directions)
    if active is not None:
        state["status"] = torch.where(active, state["status"], 2).to(torch.int32)
    cam_dist = _norm(origins - bh.position)

    state = _trace_phases(state, scene, cfg, rounds)
    # Rays that want a straight phase after the last march get one more;
    # any that would re-enter again are treated as escapes.
    with span(TRACE_STRAIGHT):
        state = _straight_phase(state, scene, cfg)
    status = torch.where(state["status"] == 1, 2, state["status"])
    state["status"] = status.to(torch.int32)

    with span(TRACE_SHADE):
        shaded = _shade_deferred(state, scene, cfg, cam_dist)
        # Classification (reference ray.wgsl:583-595): final-color pixels
        # composited something or marched at most few_iters_threshold
        # steps; the other escapes carry (direction, alpha 0).
        total_iters = state["march_steps"] + state["entered"].to(torch.int32)
        alpha = state["hit"] | (total_iters <= cfg.few_iters_threshold)
        return torch.cat([
            shaded[:3], alpha.to(torch.float32).unsqueeze(0), shaded[3:],
            torch.stack([state["dx"], state["dy"], state["dz"]]),
        ])[:, :n]


def march_batch(scene: Scene, cfg: RenderConfig, width: int, height: int,
                active: torch.Tensor = None, march_round: int = 0):
    """(rays (10 or 13, N), params, cam_dist (N,)) of march launch
    ``march_round`` (0 or 1) of a (width, height) trace: the camera rays
    after the first straight phase, and for round 1 after the first march
    and the second straight phase, with ``active`` (optional flat bool
    mask) as in
    :func:`trace_rays_record_rows`.  Holds the kernel to its plain version
    on inputs a frame gives it."""
    if not 0 <= march_round < DEFAULT_ROUNDS:
        raise ValueError(f"march_round must be in [0, {DEFAULT_ROUNDS}), got {march_round}")
    bh = scene.black_hole
    o, d = camera_rays(scene.camera, width, height)
    o, d = o.reshape(-1, 3), d.reshape(-1, 3)
    state = _init_state(o, d)
    if active is not None:
        state["status"] = torch.where(active, state["status"], 2).to(torch.int32)
    _, normal = bh.disk_frame()
    params = pack_params(bh, normal, cfg)
    state = _straight_phase(state, scene, cfg)
    for r in range(march_round):
        state = _march_phase(state, bh, params, cfg, first_phase=(r == 0))
        state = _straight_phase(state, scene, cfg)
    rays, _ = _march_inputs(state, cfg)
    return rays, params, _norm(o - bh.position)


def crossing_overflow_stats(scene: Scene, cfg: RenderConfig, width: int,
                            height: int) -> Dict[str, torch.Tensor]:
    """K-slot crossing-overflow diagnostic of a dense (width, height)
    trace: the fraction of rays that dropped at least one disk crossing,
    the dropped total and the largest true crossing count."""
    o, d = camera_rays(scene.camera, width, height)
    state = _trace_phases(_init_state(o.reshape(-1, 3), d.reshape(-1, 3)),
                          scene, cfg, DEFAULT_ROUNDS)
    dropped = torch.clamp(state["true_count"] - state["count"], min=0.0)
    return dict(
        overflow_frac=(dropped > 0.0).to(torch.float32).mean(),
        dropped_total=dropped.sum(),
        max_count=state["true_count"].max(),
    )


def trace_rays_record(origins: torch.Tensor, directions: torch.Tensor, scene: Scene,
                      cfg: RenderConfig, rounds: int = DEFAULT_ROUNDS,
                      active: torch.Tensor = None) -> torch.Tensor:
    """Trace a flat batch of rays to the sky-free record: (N, 3) -> (N, 8),
    channels [color(3), alpha, amount, dir(3)] (the interleaved form of
    :func:`trace_rays_record_rows`)."""
    return trace_rays_record_rows(origins, directions, scene, cfg, rounds, active).t().contiguous()


def sky_texture_for(scene: Scene, cfg: RenderConfig):
    """The sky texture ``cfg`` reads: the scene's in array mode, none in
    procedural mode."""
    return texture(scene, "sky_texture") if cfg.texture_mode == "array" else None


def finalize_image(record: torch.Tensor, sky_tex, show_sky: bool = True,
                   texture_mode: str = "array") -> torch.Tensor:
    """Final rgb from a record, (..., 8) -> (..., 3): ``color + amount *
    sky(dir)`` where amount > 0.001, exact for hits and escapes alike
    (escapes carry color 0, amount 1).  Procedural mode runs the sky
    finalize kernel (``kernels.sky.sky_finalize``: its plain version on the
    CPU); array mode samples ``sky_tex``."""
    if texture_mode == "procedural":
        with span(SKY), span(KERNEL_SKY):
            return sky_finalize(record.contiguous(), show_sky)
    return finalize_image_rows(record.movedim(-1, 0), sky_tex, show_sky,
                               texture_mode).movedim(0, -1)


def finalize_sky(record: torch.Tensor, sky_tex, show_sky: bool = True,
                 texture_mode: str = "array") -> torch.Tensor:
    """The public alpha-encoded output of a record, (..., 8) -> (..., 4):
    final pixels get the sky composited into their residual transmission
    (reference ray.wgsl:587-592), escapes return (direction, alpha 0) for
    the sky pass or the ladder's interpolation."""
    escape = (record[..., REC_ALPHA] == 0.0).unsqueeze(-1)
    rgb = torch.where(escape, record[..., REC_DIR],
                      finalize_image(record, sky_tex, show_sky, texture_mode))
    return torch.cat([rgb, record[..., REC_ALPHA:REC_ALPHA + 1]], dim=-1)


def finalize_image_rows(rows: torch.Tensor, sky_tex, show_sky: bool = True,
                        texture_mode: str = "array") -> torch.Tensor:
    """Final rgb rows from record rows, (8, ...) -> (3, ...): the row-major
    form of :func:`finalize_image`.  Procedural mode runs the sky kernel on
    record rows (``kernels.sky.sky_rows``); array mode samples ``sky_tex``."""
    with span(SKY):
        if texture_mode == "procedural":
            flat = rows.reshape(8, -1).contiguous()
            with span(KERNEL_SKY):
                out = sky_rows(flat, show_sky)
            return out.reshape((3,) + rows.shape[1:])
        if not show_sky:
            return rows[0:3]
        amount = rows[REC_AMOUNT]
        with span(KERNEL_SKY):
            sky = sample_sky(sky_tex, rows[REC_DIR].movedim(0, -1), "array").movedim(-1, 0)
            w = torch.where(amount > 0.001, amount, 0.0)
            return rows[0:3] + w * sky


def trace_rays(origins: torch.Tensor, directions: torch.Tensor, scene: Scene,
               cfg: RenderConfig, rounds: int = DEFAULT_ROUNDS,
               active: torch.Tensor = None) -> torch.Tensor:
    """Trace a flat batch of rays: origins and directions (N, 3) -> (N, 4),
    rgb and the reference's alpha encoding: alpha 1 where the color is
    final (the sky composited into the residual transmission), alpha 0 with
    rgb = the escape direction for clean escapes."""
    rec = trace_rays_record(origins, directions, scene, cfg, rounds, active)
    return finalize_sky(rec, sky_texture_for(scene, cfg), cfg.show_sky, cfg.texture_mode)


def trace_image(scene: Scene, cfg: RenderConfig, width: int, height: int,
                rounds: int = DEFAULT_ROUNDS) -> torch.Tensor:
    """Trace every pixel of a (height, width) image densely: (height, width, 4)."""
    o, d = camera_rays(scene.camera, width, height)
    out = trace_rays(o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg, rounds)
    return out.reshape(height, width, 4)


def trace_image_record(scene: Scene, cfg: RenderConfig, width: int, height: int,
                       rounds: int = DEFAULT_ROUNDS) -> torch.Tensor:
    """The dense sky-free record image: (height, width, 8)."""
    o, d = camera_rays(scene.camera, width, height)
    out = trace_rays_record(o.reshape(-1, 3), d.reshape(-1, 3), scene, cfg, rounds)
    return out.reshape(height, width, 8)
