"""Each CUDA kernel held against its plain torch version on the card, on
inputs the default frame gives it.  Used by ``chip_smoke.py`` and by the
card-only tests (``tests/test_torch_gpu.py``).

Tolerances:

* march (every branch), composite and ingredients: bit-identical,
  ``max_abs_err == 0.0`` (each kernel repeats its plain version's
  operations in their order, ``--fmad=false``);
* sky on rows and on an interleaved record: 99.5% quantile of |err| <
  2e-3 and max < 0.2 (a star splat's edge moves with the last bit of the
  escape direction);
* the mesh kernel M1, one launch for all meshes with the merge inside, or
  one mesh without it, BVH and brute force: bit-identical,
  ``max_abs_err == 0.0`` in t, hit, color and normal (it repeats the plain
  traversal's triangle and box tests and the merge operation for
  operation);
* the Euler adjoint kernel against ``march_replay`` on the card
  (:func:`compare_march_adjoint`): bit-identical in every ray row and in
  the mass and disk-normal cotangents, the black hole's position within
  ADJOINT_BH_REL of the larger of its |want| and a thousandth of the
  largest (summed in another order), and two calls equal bit for bit;
* the render's gradient on the card against the CPU's
  (:func:`compare_gradients`): every parameter within 1e-3 of its
  largest entry; so d/d(yaw, pitch) of a render through
  ``Camera.rotated`` (:func:`compare_pose_gradients`).

Each ``compare_*`` returns a dict with ``ok``, the error figures, and the
kernel's and the plain version's milliseconds per call (CUDA events; the
kernel averaged over ``reps`` calls after a warm-up call, the plain
version timed once).

:func:`march_work` and :func:`serial_floor` measure a march launch
against the card: its bound (:func:`bound`: the largest of its float
operations at the unfused float32 rate, its special-function operations
at theirs and its bytes at the memory rate), the SIMT efficiency of one
thread per lane in pixel order, and its serial floor.
:func:`composite_work` counts the composite's work from its slots alone:
the valid slots, the rays that have one, and the SIMT efficiency of
shading them one thread per ray against packed per block.
:func:`meshes_work` counts an M1 launch's node visits and triangle tests
per ray, mesh by mesh, from the plain lockstep run, and
:func:`mesh_bound` bounds the launch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from bhx_torch.bench import fd_stable, pose_fd_stable, rotated
from bhx_torch.config import RenderConfig
from bhx_torch.geometry import traverse
from bhx_torch.kernels import march as march_mod
from bhx_torch.kernels import mesh as mesh_mod
from bhx_torch.kernels import shade as shade_mod
from bhx_torch.kernels import sky as sky_mod
from bhx_torch.parallel import apply_params, scene_params
from bhx_torch.pipeline import final_level_retrace_mask, render
from bhx_torch.scene import TEXTURE_FIELDS, Mesh, Scene, with_textures
from bhx_torch.tracer import camera_rays, march_batch, march_kwargs

SKY_Q995 = 2e-3
SKY_MAX = 0.2
GRAD_REL = 1e-3
# Pixels whose card and CPU forward values part by more than this are left
# out of the gradient comparison (the CPU tests' tolerance against bhx).
GRAD_FWD_ATOL = 1e-5
# The Euler adjoint's gate on the black hole's position, which it sums in
# another order than autograd (PERF.md section 6, its limits table).
ADJOINT_BH_REL = 1e-3


def _timed(fn: Callable, reps: int = 1) -> Tuple[torch.Tensor, float]:
    """(last result, ms per call) of ``reps`` calls, timed with CUDA events;
    with ``reps > 1`` after one untimed call (the first timed call of a
    kernel on the card reads up to 3x slower than the rest) and behind a
    ~5 ms spin of the card, during which the host queues the calls: a
    kernel shorter than its host launch path (~30-50 µs) would otherwise
    time the host."""
    if reps > 1:
        fn()
    torch.cuda.synchronize()
    if reps > 1:
        torch.cuda._sleep(10_000_000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def last_level_batch(scene: Scene, cfg: RenderConfig, march_round: int = 0):
    """:func:`march_batch` of the ladder's final level, whose active
    set is that level's re-trace mask: ``march_round`` 0 is the largest
    march launch of a frame, 1 the re-entry launch after it."""
    lad = cfg.ladder_for_output()
    w, h = lad.resolution(lad.levels - 1)
    return march_batch(scene, cfg, w, h, active=final_level_retrace_mask(scene, cfg),
                       march_round=march_round)


def shade_params(scene: Scene) -> torch.Tensor:
    rot, _ = scene.black_hole.disk_frame()
    return shade_mod.pack_shade_params(scene.black_hole, rot, scene.time)


def compare_march(rays, params, cfg: RenderConfig, reps: int = 1) -> Dict:
    """The march kernel against its plain version (bit-identical), with the
    launch's work and bound (:func:`march_work`)."""
    kw = march_kwargs(cfg)
    got, ms = _timed(lambda: march_mod.march(rays, params, **kw), reps)
    want, plain_ms = _timed(lambda: march_mod.march_torch(rays, params, **kw))
    max_err = _max_abs_err(got, want)
    finite = bool(torch.isfinite(got).all())
    kernel = march_mod.KERNEL_NAMES[march_mod._mode(kw["integrator"], kw["geodesics"])]
    return dict(march_work(rays, params, want, kernel),
                diff_frac=float((got != want).any(0).float().mean()) if got.numel() else 0.0,
                max_abs_err=max_err, ms=ms, plain_ms=plain_ms,
                ok=finite and max_err == 0.0, out=got)


# Float operations of one march substep (adds, subtracts, multiplies,
# divisions, square roots, reciprocal square roots, min, max, abs; no
# compare or select), counted by hand from csrc/march.cu's substep with the
# disk branch on and a crossing's extra work (its slot record and the
# transmission bound) left out: Euler 22 (relative position, angular
# momentum, r^2) + 32 (step) + 12 (horizon) + 29 (disk plane) + 11 (advance,
# closest, budget); RK45 22 + 303 (six forces at 18, stage sums 105, the
# 4th/5th-order sums and error 51, controller 17, direction and position
# 22) + 12 + 29 + 11; Kerr 3 + 4 x 190 (a right-hand side: Kerr-Schild
# scalars 34, null-vector product 7, dx 6, three dH/dx at 47 and 2
# arguments) + 119 (step size 7, stage sums 79, chord 17, capture radius
# 16) + 29 + 11.  Of them, how many run on the special-function unit
# (rsqrt, sqrt, division): Euler 4, RK45 12, Kerr 4 x 36 + 6.
SUBSTEP_OPS = {"march": 106, "march_rk45": 377, "march_kerr": 922}
SUBSTEP_MUFU = {"march": 4, "march_rk45": 12, "march_kerr": 150}
# NVIDIA H100 SXM (data sheet, 700 W).  Its 67 TFLOP/s of float32 outside
# the tensor cores counts a fused multiply-add as two operations; the
# kernels are built with --fmad=false, so each add and multiply takes an
# issue slot alone, at half that rate: 128 a clock on each of 132 SMs at
# the 1980 MHz boost clock.  The special-function unit gives 16 results a
# clock an SM; HBM3 moves 3.35 TB/s.
PEAK_F32_OPS = 132 * 128 * 1.98e9
PEAK_MUFU_PER_S = 132 * 16 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12


def bound(ops: float, nbytes: float, mufu: float = 0.0) -> Dict:
    """The least time the card could take: the largest of ``ops`` unfused
    float32 operations at PEAK_F32_OPS, ``mufu`` of them (those on the
    special-function unit) at PEAK_MUFU_PER_S, and ``nbytes`` at the
    memory rate.  ``bound_by`` is "operations" or "bytes";
    ``bound_ceiling`` names the ceiling: "float32", "special-function" or
    "bytes"."""
    ceilings = {"float32": ops / PEAK_F32_OPS * 1e3,
                "special-function": mufu / PEAK_MUFU_PER_S * 1e3,
                "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    ceiling = max(ceilings, key=ceilings.get)
    return dict(bound_ms=ceilings[ceiling],
                bound_by="bytes" if ceiling == "bytes" else "operations",
                bound_ceiling=ceiling, ops_ms=ceilings["float32"],
                mufu_ms=ceilings["special-function"], bytes_ms=ceilings["bytes"])


def march_work(rays, params, out, kernel: str) -> Dict:
    """The work of one march launch, from its inputs and its output: the
    live lanes, the sum and the largest of the ``steps`` row (the
    lane-substeps the work needs), the SIMT efficiency of one thread per
    lane in pixel order (sum of steps over 32 x the sum over consecutive
    32-lane warps of the warp's largest), and the bound (:func:`bound`):
    sum(steps) x SUBSTEP_OPS[kernel] operations, SUBSTEP_MUFU[kernel] of
    each substep's on the special-function unit, and (in rows + out rows)
    x 4 x N bytes."""
    n = rays.shape[1]
    live = (rays[7] > 0.5) & (rays[9] < params[march_mod._P["budget"]])
    steps = out[march_mod._OUT_FIXED["steps"]].double()
    total = float(steps.sum())
    warp_max = torch.nn.functional.pad(steps, (0, (-n) % 32)).reshape(-1, 32).amax(1)
    issued = 32.0 * float(warp_max.sum())
    r = dict(n=n, live=int(live.sum()), steps_sum=total,
             steps_max=float(steps.max()) if n else 0.0,
             simt_eff=total / issued if issued else None,
             **bound(total * SUBSTEP_OPS[kernel], (rays.shape[0] + out.shape[0]) * 4.0 * n,
                     total * SUBSTEP_MUFU[kernel]))
    return r


def serial_floor(rays, params, out, march_fn: Callable, reps: int = 10) -> Dict:
    """The serial floor of a launch: the lane with the most steps marched
    alone, in a batch of one, by ``march_fn(rays, params)`` (CUDA events,
    ``reps`` calls after a warm-up): its steps x one substep's latency,
    plus one launch's fixed cost.  No assignment of rays to threads beats
    it."""
    steps = out[march_mod._OUT_FIXED["steps"]]
    if not steps.numel() or float(steps.max()) == 0.0:
        return dict(serial_floor_ms=0.0, floor_steps=0.0, substep_ns=None)
    j = int(steps.argmax())
    _, ms = _timed(lambda: march_fn(rays[:, j:j + 1].contiguous(), params), reps)
    return dict(serial_floor_ms=ms, floor_steps=float(steps[j]),
                substep_ns=ms * 1e6 / float(steps[j]))


# Float operations of one live lane-substep of the Euler adjoint
# (csrc/march.cu, euler_adjoint_kernel), counted as SUBSTEP_OPS: the
# substep twice (the march that lays the checkpoints and the segment's
# re-march that records it), 2 x 106, and its pullback, 202 (the substep's
# values again, 62; closest2 and the advance, 30; the normalisation, 24;
# the force and its rsqrt, 47; the angular momentum, 33; the relative
# position, 6); a crossing's slot pullback left out.  Of them on the
# special-function unit: 2 x 4 + 2.
ADJOINT_SUBSTEP_OPS = 2 * 106 + 202
ADJOINT_SUBSTEP_MUFU = 2 * 4 + 2


def compare_march_adjoint(rays, params, grad_out, cfg: RenderConfig, reps: int = 1,
                          drop_slots: bool = False) -> Dict:
    """The Euler adjoint kernel against ``march_replay`` on the same
    inputs, with its work (the live lanes' substeps, from the forward
    kernel's ``steps`` row), its bound (:func:`bound`: ADJOINT_SUBSTEP_OPS
    a lane-substep; the 10 + 41 rows in and 10 out) and the gate's numbers:
    ``max_abs_err`` and ``diff_frac`` (lanes not bit-equal) of the ray
    rows, ``param_err`` of the mass and disk normal, ``bh_rel_err`` of the
    black hole's position.  ``drop_slots`` is the fault control: the kernel
    gets the cotangent with its slot rows zeroed, the replay the whole one."""
    kw = march_kwargs(cfg)
    if march_mod._mode(kw["integrator"], kw["geodesics"]) != march_mod._EULER:
        raise ValueError("the adjoint kernel is the Euler branch's")
    akw = {k: kw[k] for k in ("max_iterations", "tex_opacity_min", "show_disk")}
    g = grad_out.clone()
    if drop_slots:
        g[march_mod.OUT_FIXED:march_mod.OUT_FIXED + march_mod.SLOT_ROWS] = 0.0
    (got_r, got_p), ms = _timed(lambda: march_mod.euler_adjoint(rays, params, g, **akw), reps)
    again_r, again_p = march_mod.euler_adjoint(rays, params, g, **akw)
    (want_r, want_p), plain_ms = _timed(
        lambda: march_mod.march_replay(rays, params, grad_out, **kw))
    n = rays.shape[1]
    exact = [march_mod._P[k] for k in ("mass", "disk_nx", "disk_ny", "disk_nz")]
    bh = [march_mod._P[k] for k in ("bh_x", "bh_y", "bh_z")]
    want_bh = want_p[bh].double()
    floor = max(float(want_bh.abs().max()) * 1e-3, 1e-30)
    bh_err = ((got_p[bh].double() - want_bh).abs() / want_bh.abs().clamp_min(floor)).nan_to_num(
        nan=float("inf"))
    out = march_mod.march(rays, params, **kw)
    rows = march_mod._OUT_FIXED
    live = (rays[7] > 0.5) & (rays[9] < params[march_mod._P["budget"]])
    total = float(out[rows["steps"]].double().sum())
    r = dict(n=n, live=int(live.sum()), steps_sum=total,
             over_k=int((out[rows["count"]] > march_mod.MAX_CROSSINGS).sum()),
             horizon_hits=int(out[rows["horizon"]].sum()),
             **bound(total * ADJOINT_SUBSTEP_OPS, (2 * march_mod.IN_FIELDS + grad_out.shape[0])
                     * 4.0 * n, total * ADJOINT_SUBSTEP_MUFU),
             max_abs_err=_max_abs_err(got_r, want_r),
             diff_frac=float((got_r != want_r).any(0).double().mean()) if n else 0.0,
             param_err=float((got_p[exact] - want_p[exact]).abs().max()),
             bh_rel_err=float(bh_err.max()),
             bit_equal=bool(torch.equal(again_r, got_r) and torch.equal(again_p, got_p)),
             ms=ms, plain_ms=plain_ms)
    r["ok"] = (r["max_abs_err"] == 0.0 and r["param_err"] == 0.0
               and r["bh_rel_err"] <= ADJOINT_BH_REL and r["bit_equal"])
    return r


# Operations of the shade and sky kernels (csrc/shade.cu, csrc/sky.cu,
# procedural.cuh), counted by hand as the march's are, with integer hash
# operations counted like float ones and libdevice's atan2f, sinf, cosf,
# expf and logf at ~25 each: a slot's optical depth ~61, its texture ~767
# (a spiral-warped texel of four Perlin octaves at ~140, two atan2 and
# sin/cos pairs), its redshift ~98 (the tint polynomial of three
# channels), the composite of a valid slot ~109 more (the 2x2 gain fetch,
# the blend); a sky pixel ~1200 (two atan2, two Perlin octaves of nebula,
# nine star cells of four hashes and a sine each).
SLOT_OD_OPS, SLOT_TEXTURE_OPS, SLOT_REDSHIFT_OPS, COMPOSITE_OPS = 61, 767, 98, 109
SKY_PIXEL_OPS = 1200


def _slot_ops(cfg: RenderConfig) -> int:
    return (SLOT_OD_OPS + SLOT_TEXTURE_OPS * bool(cfg.show_disk_texture)
            + SLOT_REDSHIFT_OPS * bool(cfg.show_redshift))


def _valid_slots(slots) -> torch.Tensor:
    """(K, N) bool: slot k of ray i recorded a crossing."""
    return torch.stack([slots[k * march_mod.CROSS_FIELDS + 6] > 0.5
                        for k in range(march_mod.MAX_CROSSINGS)])


# Rays a block of the composite kernel (csrc/shade.cu, kBlockRays).
COMPOSITE_BLOCK_RAYS = 256


def composite_work(slots) -> Dict:
    """The composite's work on these (SLOT_ROWS, N) slots, from them alone:
    ``n`` rays, ``v`` valid slots (``v_by_k`` by slot), ``r`` rays with a
    valid slot; ``simt_eff``, the SIMT efficiency of shading them one
    thread per ray in pixel order (v over 32 x the sum over consecutive
    32-ray warps and slots k of "some ray of the warp has slot k valid"),
    and ``packed_eff``, that of the same slots packed per block of
    COMPOSITE_BLOCK_RAYS rays (v over 32 x the sum over blocks of
    ceil(v_block / 32)); both None without a valid slot."""
    n = slots.shape[1]
    valid = _valid_slots(slots).to(torch.int64)
    k = valid.shape[0]

    def tiles(width: int) -> torch.Tensor:
        pad = (-n) % width
        return torch.nn.functional.pad(valid, (0, pad)).reshape(k, (n + pad) // width, width)

    v = int(valid.sum())
    warp_slots = int(tiles(32).amax(2).sum())
    block_warps = int(((tiles(COMPOSITE_BLOCK_RAYS).sum((0, 2)) + 31) // 32).sum())
    return dict(n=n, v=v, v_by_k=valid.sum(1).tolist(), r=int(valid.amax(0).sum()),
                simt_eff=v / (32.0 * warp_slots) if v else None,
                packed_eff=v / (32.0 * block_warps) if v else None)


def composite_bound(slots, cfg: RenderConfig) -> Dict:
    """The composite's bound on these slots: 4 (8n + 5v + r) bytes and
    v (slot ops + COMPOSITE_OPS) operations (:func:`composite_work`'s n,
    v, r).  It must read every slot's valid row of every ray, because the
    function masks each slot on its own valid row (``_composite_kernel``
    tests each slot k alone, ``bhx/kernels/shade_pallas.py:431-435``;
    ``composite_torch`` selects on it per k), and write 4 rows; for each
    valid slot it reads the five shaded rows (hit point, dx, dz) and
    shades it; once a ray with a valid slot, it reads the camera
    distance."""
    w = composite_work(slots)
    return bound(float(w["v"]) * (_slot_ops(cfg) + COMPOSITE_OPS),
                 4.0 * (8 * w["n"] + 5 * w["v"] + w["r"]))


def ingredients_bound(slots, cfg: RenderConfig) -> Dict:
    """The ingredients variant shades every slot, valid or not: 5 rows in
    a slot and the camera distance read, 28 rows written."""
    n = slots.shape[1]
    return bound(float(n) * march_mod.MAX_CROSSINGS * _slot_ops(cfg),
                 4.0 * n * (march_mod.MAX_CROSSINGS * 5 + 1 + march_mod.SLOT_ROWS))


def sky_bound(record, cfg: RenderConfig) -> Dict:
    """The sky pass's bound on this record, (8, ...) rows or (..., 8): every
    pixel's color and amount read and its color written; a pixel that sees
    the sky (amount > 0.001) also reads its direction and costs
    SKY_PIXEL_OPS."""
    amount = record[4] if record.shape[0] == 8 else record[..., 4]
    n = amount.numel()
    sky = float((amount > 0.001).sum()) if cfg.show_sky else 0.0
    return bound(sky * SKY_PIXEL_OPS, 4.0 * (7 * n + 3 * sky))


def compare_ingredients(slots, cam_dist, params, cfg: RenderConfig,
                        reps: int = 1) -> Dict:
    kw = dict(show_texture=cfg.show_disk_texture, show_redshift=cfg.show_redshift)
    got, ms = _timed(lambda: shade_mod.ingredients(slots, cam_dist, params, **kw), reps)
    want, plain_ms = _timed(lambda: shade_mod.ingredients_torch(slots, cam_dist, params,
                                                                **kw))
    err = _max_abs_err(got, want)
    finite = bool(torch.isfinite(got).all())
    return dict(n=slots.shape[1], max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **ingredients_bound(slots, cfg), ok=finite and err == 0.0)


def compare_composite(slots, cam_dist, params, gain, cfg: RenderConfig,
                      reps: int = 1) -> Dict:
    kw = dict(show_texture=cfg.show_disk_texture, show_redshift=cfg.show_redshift)
    got, ms = _timed(lambda: shade_mod.composite(slots, cam_dist, params, gain, **kw),
                     reps)
    want, plain_ms = _timed(
        lambda: shade_mod.composite_torch(slots, cam_dist, params, gain, **kw))
    err = _max_abs_err(got, want)
    finite = bool(torch.isfinite(got).all())
    return dict(composite_work(slots), max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **composite_bound(slots, cfg), ok=finite and err == 0.0)


def _compare_sky(kernel: Callable, plain: Callable, rec, cfg: RenderConfig,
                 reps: int) -> Dict:
    got, ms = _timed(lambda: kernel(rec, cfg.show_sky), reps)
    want, plain_ms = _timed(lambda: plain(rec, cfg.show_sky))
    err = (got - want).abs().reshape(-1)
    q995 = float(torch.quantile(err, 0.995))
    finite = bool(torch.isfinite(got).all())
    return dict(n=want.numel() // 3, q995_abs_err=q995, max_abs_err=float(err.max()),
                ms=ms, plain_ms=plain_ms, **sky_bound(rec, cfg),
                ok=finite and q995 < SKY_Q995 and float(err.max()) < SKY_MAX)


def compare_sky(rows, cfg: RenderConfig, reps: int = 1) -> Dict:
    """The sky kernel on (8, N) record rows."""
    return _compare_sky(sky_mod.sky_rows, sky_mod.sky_rows_torch, rows, cfg, reps)


def compare_sky_finalize(record, cfg: RenderConfig, reps: int = 1) -> Dict:
    """The sky kernel on an interleaved (..., 8) record."""
    return _compare_sky(sky_mod.sky_finalize, sky_mod.sky_finalize_torch, record,
                        cfg, reps)


def compare_gradients(scene: Scene, cfg: RenderConfig, seed: int = 7) -> Dict:
    """The gradient of ``sum(w * render(scene, cfg))`` with respect to every
    ``parallel.scene_params`` entry and, in procedural texture mode,
    ``disk_gain``, in array texture mode the three textures (the default
    bakes where the scene has none), each of which must get one: on the
    card (the kernels' forward, their replayed backward) against the plain
    path on the CPU.  ``scene`` lies on the card.

    ``w`` is ``default_rng(seed)`` uniform, zero where the two programs'
    pointwise derivatives may part by more than rounding: pixels that are
    not FD-stable along every fitted entry (``bench.fd_stable``: rays near
    the photon sphere, moving visibility edges), and pixels whose forward
    values differ by more than GRAD_FWD_ATOL (there the disk texture's
    finest octave, whose slope sums terms of order 100 that cancel, shows
    the two devices' float32 rounding).  ``ok``: every entry finite on the
    card, and each parameter whose largest entry exceeds 1e-6 of the
    largest of all within GRAD_REL of it."""
    names = [k for k in scene_params(scene) if k != "spin" or cfg.geodesics == "kerr"]
    # disk_gain is read by the procedural shade only, the textures by the
    # array shade only: every leaf must get a gradient.
    extra = ("disk_gain",)
    if cfg.texture_mode == "array":
        scene = with_textures(scene)
        extra = TEXTURE_FIELDS
    cpu_scene = scene.to("cpu")
    with torch.no_grad():
        fwd_err = (render(scene, cfg).cpu() - render(cpu_scene, cfg)).abs().numpy()
    keep = fd_stable(scene, cfg, names) & (fwd_err <= GRAD_FWD_ATOL).all(-1, keepdims=True)
    weights = np.random.default_rng(seed).random((cfg.height, cfg.width, 3)) * keep

    def grads(s: Scene) -> Dict[str, torch.Tensor]:
        leaves = {k: v.detach().clone().requires_grad_() for k, v in scene_params(s).items()}
        leaves.update({k: getattr(s, k).detach().clone().requires_grad_() for k in extra})
        s = dataclasses.replace(apply_params(s, leaves), **{k: leaves[k] for k in extra})
        img = render(s, cfg)
        loss = (img * torch.as_tensor(weights, dtype=img.dtype, device=img.device)).sum()
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return {k: g.cpu() for k, g in zip(leaves, grads)}

    on_card, on_cpu = grads(scene), grads(cpu_scene)
    largest = max(float(g.abs().max()) for g in on_cpu.values())
    rel = {k: float((on_card[k] - g).abs().max() / g.abs().max())
           for k, g in on_cpu.items() if float(g.abs().max()) > 1e-6 * largest}
    finite = all(bool(torch.isfinite(g).all()) for g in on_card.values())
    worst = max(rel, key=rel.get)
    return dict(kept_frac=float(keep.mean()), max_rel_err=rel[worst], worst=worst,
                rel_err=rel, ok=finite and rel[worst] < GRAD_REL)


def compare_pose_gradients(scene: Scene, cfg: RenderConfig, yaw: float, pitch: float,
                           seed: int = 7) -> Dict:
    """d/d(yaw, pitch) of ``sum(w * render(scene', cfg))``, where ``scene'``
    has ``scene.camera.rotated(yaw, pitch)``: on the card (the kernels'
    forward, their replayed backward) against the plain path on the CPU.
    ``scene`` lies on the card.  ``w`` is ``default_rng(seed)`` uniform,
    zero off the pixels that are FD-stable along yaw and along pitch
    (``bench.pose_fd_stable``) and where the two forwards part by more than
    GRAD_FWD_ATOL, as in :func:`compare_gradients`.  ``ok``: the card's
    gradient finite and within GRAD_REL of the CPU's larger entry."""
    angles = torch.tensor([yaw, pitch], dtype=torch.float32, device=scene.time.device)
    # Each device's angles, a leaf, and its image, the graph kept for the
    # backward once the weights are known.
    runs = []
    for s in (scene, scene.to("cpu")):
        a = angles.to(s.time.device, copy=True).requires_grad_()
        runs.append((a, render(rotated(s, a), cfg)))
    (_, on_card), (_, on_cpu) = runs
    fwd_err = (on_card.detach().cpu() - on_cpu.detach()).abs().numpy()
    keep = (pose_fd_stable(scene, cfg, angles)
            & (fwd_err <= GRAD_FWD_ATOL).all(-1, keepdims=True))
    weights = np.random.default_rng(seed).random((cfg.height, cfg.width, 3)) * keep
    card_g, cpu_g = (
        torch.autograd.grad((img * torch.as_tensor(weights, dtype=img.dtype,
                                                   device=img.device)).sum(), a)[0].cpu()
        for a, img in runs)
    rel = float((card_g - cpu_g).abs().max() / cpu_g.abs().max())
    return dict(kept_frac=float(keep.mean()), grad_card=card_g.tolist(),
                grad_cpu=cpu_g.tolist(), rel_err=rel,
                ok=bool(torch.isfinite(card_g).all()) and rel < GRAD_REL)


def last_level_rays(scene: Scene, cfg: RenderConfig):
    """(origins (N, 3), directions (N, 3), active (N,)) of the ladder's
    final level's first straight phase: its camera rays, with its re-trace
    mask as the active set.  The largest mesh launch of a frame."""
    lad = cfg.ladder_for_output()
    o, d = camera_rays(scene.camera, *lad.resolution(lad.levels - 1))
    return (o.reshape(-1, 3).contiguous(), d.reshape(-1, 3).contiguous(),
            final_level_retrace_mask(scene, cfg))


# Float operations of M1 (csrc/mesh.cu), counted by hand as the march's
# are: a live ray's guarded inverse direction 6 (3 abs, 3 divisions), once a
# ray when a BVH mesh is tested; the root box of each BVH mesh 28 (6 adds
# of the position, 6 subtracts, 6 multiplies, 6 min and max, 4 to reduce
# them); an inner node's visit two boxes and a min and a max, 58; a
# triangle's setup, once for each triangle the launch reads (its edges 6,
# cross product 9, length and inverse 8, the scale 3, a - b and a - c 6):
# 32, with a square root and a division.  A triangle test's ray-dependent
# part, 70 in all, is counted as far as the test gets, for it leaves at the
# first condition of a hit that fails (traverse.EXIT_KEYS): the
# determinant and its abs, 15, on every test; a - o and u's determinant,
# 17, past |det|; v's determinant, 14, past u's sign; t's, 14, past v's;
# the ray's dot with the normal 5, its abs, 3 divisions and u + v, 10 with
# 3 divisions, past t's sign.  Comparisons are not counted.  Divisions and
# square roots also count on the special-function unit.  Left out: the
# winning hit's color, normal and diffuse factor (~35 a hit), and the
# offset of the vertices by the mesh position (9 adds a triangle read).
MESH_INV_OPS, MESH_INV_MUFU = 6, 3
MESH_ROOT_OPS = 28
MESH_INNER_OPS = 58
MESH_TRI_SETUP_OPS, MESH_TRI_SETUP_MUFU = 32, 2
# Per test: on every test, then past each early exit in turn.
MESH_TEST_EXIT_OPS = (15, 17, 14, 14, 10)
MESH_TRI_TEST_OPS = sum(MESH_TEST_EXIT_OPS)
MESH_TRI_TEST_MUFU = 3


def _row_bytes(a: torch.Tensor) -> int:
    return a.element_size() * (a.shape[1] if a.dim() > 1 else 1)


def _mesh_bytes_read(mesh: Mesh, work: Dict) -> int:
    """Bytes of ``mesh`` that the run needs, each read once: the mesh's
    position; in brute force every triangle; through the BVH the count and
    child index of the visited nodes, the boxes of the root and of the
    visited inner nodes' children, the lookup entries tested and their
    triangles; and the distinct vertices and normals of those triangles."""
    if not int(work["live"].sum()):
        return 0
    total = _row_bytes(mesh.position[None])
    if mesh.num_triangles <= mesh_mod.BRUTE_FORCE_THRESHOLD:
        tris = torch.arange(mesh.num_triangles, device=mesh.tri_points.device)
    else:
        visited, entries = work["nodes_read"], work["lookup_read"]
        left = mesh.node_left[visited & (mesh.node_count == 0)].long()
        boxes = torch.zeros_like(visited)
        boxes[0] = True
        boxes[left] = True
        boxes[left + 1] = True
        tris = mesh.lookup[entries].long().unique()
        total += (int(visited.sum()) * (_row_bytes(mesh.node_left) + _row_bytes(mesh.node_count))
                  + int(boxes.sum()) * (_row_bytes(mesh.node_min) + _row_bytes(mesh.node_max))
                  + int(entries.sum()) * _row_bytes(mesh.lookup))
    points = mesh.tri_points[tris].unique().numel()
    normals = mesh.tri_normals[tris].unique().numel()
    return (total + tris.numel() * (_row_bytes(mesh.tri_points) + _row_bytes(mesh.tri_normals))
            + points * _row_bytes(mesh.points) + normals * _row_bytes(mesh.normals))


def _simt_eff(per_lane: torch.Tensor):
    """SIMT efficiency of one thread per lane in 32-lane warps, in order:
    the work over 32 x the sum of each warp's most."""
    n = per_lane.numel()
    warp_max = torch.nn.functional.pad(per_lane, (0, (-n) % 32)).reshape(-1, 32).amax(1)
    issued = 32.0 * float(warp_max.sum())
    return float(per_lane.sum()) / issued if issued else None


def _mesh_work(origins, dirs, mesh: Mesh, active=None) -> Tuple[Dict, torch.Tensor]:
    """M1's work on these rays against one mesh, counted from the plain
    lockstep run (``traverse.intersect_mesh_torch``), and each lane's
    steps (its node visits through a BVH, its triangle tests in brute
    force).  The dict: ``live`` lanes, inner-node and leaf visits and
    triangle tests, their sums, means over the live lanes and largest;
    ``mesh_bytes``, the bytes of the mesh the run reads
    (:func:`_mesh_bytes_read`); the tests that pass each early exit
    (``traverse.EXIT_KEYS``); ``tris_read``, the triangles it tests at
    least once; ``simt_eff``, the SIMT efficiency of one thread per ray in
    pixel order (steps over 32 x the sum over consecutive 32-lane warps of
    the warp's most steps)."""
    work = {}
    traverse.intersect_mesh_torch(origins, dirs, mesh, active, work=work)
    n, live = origins.shape[0], int(work["live"].sum())
    brute = mesh.num_triangles <= mesh_mod.BRUTE_FORCE_THRESHOLD
    per_lane = work["tri_tests"] if brute else work["inner_visits"] + work["leaf_visits"]
    tris_read = ((mesh.num_triangles if live else 0) if brute
                 else int(work["lookup_read"].sum()))
    r = dict(n=n, live=live, masked=active is not None, brute=brute,
             triangles=mesh.num_triangles, mesh_bytes=_mesh_bytes_read(mesh, work),
             tris_read=tris_read, simt_eff=_simt_eff(per_lane),
             **{k: int(work[k].sum()) for k in traverse.EXIT_KEYS})
    for k in ("inner_visits", "leaf_visits", "tri_tests"):
        total = int(work[k].sum())
        r[k] = total
        r[k + "_mean"] = total / live if live else 0.0
        r[k + "_max"] = int(work[k].max()) if n else 0
    return r, per_lane


def meshes_work(origins, dirs, meshes, active=None) -> Dict:
    """The work of one launch of M1 for ``meshes``: each visible mesh's
    (:func:`_mesh_work`; hidden ones are skipped) under ``meshes``, their
    sums, ``bvh_meshes``, and the SIMT efficiency of each lane's steps over
    all the meshes (node visits through a BVH, triangle tests in brute
    force) one thread per lane in pixel order (``simt_eff``) and with the
    live lanes packed 32 to a warp in pixel order (``packed_simt_eff``,
    what the queue gives before any refill)."""
    n = origins.shape[0]
    live = (torch.ones(n, dtype=torch.bool, device=origins.device) if active is None
            else active)
    per_mesh, steps = [], torch.zeros(n, dtype=torch.int64, device=origins.device)
    for mesh in meshes:
        if bool(mesh.visible):
            w, per_lane = _mesh_work(origins, dirs, mesh, active)
            per_mesh.append(w)
            steps += per_lane
    r = dict(n=n, live=int(live.sum()), masked=active is not None, meshes=per_mesh,
             bvh_meshes=sum(not w["brute"] for w in per_mesh),
             simt_eff=_simt_eff(steps), packed_simt_eff=_simt_eff(steps[live]))
    for k in ("inner_visits", "leaf_visits", "tri_tests", "tris_read", "mesh_bytes",
              *traverse.EXIT_KEYS):
        r[k] = sum(w[k] for w in per_mesh)
    return r


def mesh_bound(work: Dict) -> Dict:
    """One M1 launch's bound from :func:`meshes_work`'s counts: its float
    operations (the live rays' inverse direction and each BVH mesh's root
    box, the inner visits', each triangle read's setup once and every
    test's ray-dependent part as far as the test gets) and its bytes: the
    live rays' two float32 triples read once, the (N,) active mask, the
    (8, N) merged hits written once, and the meshes' ``mesh_bytes``."""
    n, live = work["n"], work["live"]
    inverse = live if work["bvh_meshes"] else 0
    reached = (work["tri_tests"], *(work[k] for k in traverse.EXIT_KEYS))
    ops = (inverse * MESH_INV_OPS + live * work["bvh_meshes"] * MESH_ROOT_OPS
           + work["inner_visits"] * MESH_INNER_OPS + work["tris_read"] * MESH_TRI_SETUP_OPS
           + sum(c * k for c, k in zip(reached, MESH_TEST_EXIT_OPS)))
    mufu = (inverse * MESH_INV_MUFU + work["tris_read"] * MESH_TRI_SETUP_MUFU
            + work[traverse.EXIT_KEYS[-1]] * MESH_TRI_TEST_MUFU)
    nbytes = (24.0 * live + (1.0 * n if work["masked"] else 0.0)
              + 4.0 * mesh_mod.OUT_ROWS * n + work["mesh_bytes"])
    return bound(float(ops), nbytes, float(mufu))


def _mesh_errors(got: Dict, want: Dict) -> Dict:
    errs = {k: _max_abs_err(got[k].float(), want[k].float()) for k in want}
    finite = all(bool(torch.isfinite(v).all()) for v in got.values())
    return dict(err=errs, max_abs_err=max(errs.values()), hits=int(got["hit"].sum()),
                ok=finite and max(errs.values()) == 0.0)


def compare_mesh(origins, dirs, mesh: Mesh, active=None, reps: int = 1) -> Dict:
    """M1 on one visible mesh without the merge (``intersect_mesh``)
    against the plain traversal on the card (bit-identical in t, hit, color
    and normal), with the launch's work and bound (:func:`meshes_work`,
    :func:`mesh_bound`)."""
    got, ms = _timed(lambda: mesh_mod.intersect_mesh_cuda(origins, dirs, mesh, active), reps)
    want, plain_ms = _timed(lambda: traverse.intersect_mesh_torch(origins, dirs, mesh, active))
    work = meshes_work(origins, dirs, [mesh], active)
    return dict(work, **mesh_bound(work), **_mesh_errors(got, want), ms=ms,
                plain_ms=plain_ms)


def compare_meshes(origins, dirs, meshes, active=None, reps: int = 1) -> Dict:
    """M1's one launch for all ``meshes``, with the merge inside, against
    the plain traversals and merge (``traverse.intersect_meshes_torch``) on
    the card: bit-identical in t, hit, color and normal, with the launch's
    work (:func:`meshes_work`) and bound (:func:`mesh_bound`).  The rays go
    in as the columns of ``origins`` and ``dirs``, as rows of stride 3."""
    rows = origins.unbind(1), dirs.unbind(1)
    got, ms = _timed(lambda: mesh_mod.intersect_meshes_cuda(*rows, meshes, active), reps)
    want, plain_ms = _timed(
        lambda: traverse.intersect_meshes_torch(origins, dirs, meshes, active))
    work = meshes_work(origins, dirs, meshes, active)
    return dict(work, **mesh_bound(work), **_mesh_errors(got, want), ms=ms,
                plain_ms=plain_ms)
