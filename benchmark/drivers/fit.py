"""The fit: inverse rendering, Adam step after step on the scene's
parameters toward a target frame, through the program's train step; each
step ends by reading its loss on the host.

The target is the reference's frame of the configured scene with its
mass drawn from the seed; the program never renders it, and its seconds
are left out of ``setup_s``.  Set-up builds the program's parameters and
optimizer and takes the first step, which warms up; the window goes on
with the same objects.  ``step_s`` is the window's wall time over the
steps it completed.

``correct`` holds two things against the reference, once the window has
closed.  The first three steps (the set-up's and the window's first two)
from the same start: each step's loss, the norm of the first gradient as
the optimizer got it (its first moment after one step over 1 - beta1),
and the norm of each parameter's change after the three, as the fourth
step found them.  And one later step of the window, drawn from the seed:
the reference takes one Adam step from the program's state before it
(parameters and moments), and its loss, gradient (worked out from the
program's moments before and after) and change are compared alike.  The
norms are taken by the worst leaf, as the gap between the two sides'
norms over the reference's norm of that leaf or of the median leaf,
whichever is larger.  Leaves whose reference gradient is under
``leaf_floor`` of the median leaf's (no path to the image, such as the
spin under the pseudo-Newtonian force) are left out.

A cell on more than one chip runs the same fit over that many ranks, one
a card, through the program's sharded step (``parallel.train_step`` over
a ``TileMesh``): each rank traces its band of the frame's rows, the bands
are gathered, every rank computes the whole frame's loss, and the
gradients are summed over the ranks.  This process is rank 0: its clock,
its traced step and its state are the run's.  The other ranks are child
processes (:mod:`.ranks`, :func:`rank_main`) that get the target's bits
from rank 0, take their first step with it, and then one step each time
rank 0 tells them that the window goes on, so that every rank takes the
same steps.  ``setup_s`` holds their start-up.  The reference takes its
gradient as the same sum over bands of rows (:mod:`..reference.fit`).
Once the window has closed the other ranks send back their parameters,
and ``rank_gap``, the largest absolute difference between any rank's
parameters and rank 0's, is compared with its limit, 0: every rank
applies the same summed gradient, so the parameters stay equal to the
bit.
"""

from __future__ import annotations

import random
import statistics
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import port
from benchmark.drivers import ranks as ranks_mod
from benchmark.drivers.common import Outcome, check, log, peak_bytes, reference_side, sync
from benchmark.reference import fit as ref_fit
from benchmark.reference import frame as ref_frame
from benchmark.reference.scene import with_params

# The first steps that the reference follows from the start.
FIRST_STEPS = 3


def reference_params(numbers: Dict, keys, device) -> Dict[str, torch.Tensor]:
    """The fitted parameters' starting values, from the configuration."""
    out = {}
    for k in keys:
        group, field = ("camera", k[4:]) if k.startswith("cam_") else ("black_hole", k)
        out[k] = torch.tensor(numbers[group][field], dtype=torch.float32, device=device)
    return out


def leaf_gaps(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor], keep) -> float:
    """The worst leaf's gap of norms over the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    norms = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keep}
    median = statistics.median(norms.values())
    return max(abs(float(torch.linalg.vector_norm(got[k].double().to(want[k].device)))
                   - norms[k]) / max(norms[k], median) for k in keep)


def make_target(rscene, rcfg, traffic: Dict, seed: int, device) -> torch.Tensor:
    """The reference's frame of the scene at the mass the seed draws."""
    mass = float(np.random.default_rng(seed).uniform(*traffic["target_mass"]))
    with torch.no_grad():
        return ref_frame.render(with_params(rscene, dict(
            mass=torch.tensor(mass, dtype=torch.float32, device=device))), rcfg)


def gaps(got: Dict, ref: Dict, leaf_floor: float) -> Dict[str, float]:
    """The compared numbers of some steps of a fit: ``got`` and ``ref``
    each hold ``losses``, ``grad`` (by leaf) and ``change`` (by leaf)."""
    g_norms = {k: float(torch.linalg.vector_norm(v.double())) for k, v in ref["grad"].items()}
    g_median = statistics.median(g_norms.values())
    keep = [k for k in ref["grad"] if g_norms[k] >= leaf_floor * g_median]
    return dict(
        loss_gap=max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"])),
        grad_gap=leaf_gaps(got["grad"], ref["grad"], keep),
        change_gap=leaf_gaps(got["change"], ref["change"], keep))


def snapshot(params: Dict[str, torch.Tensor], optimizer) -> Dict:
    """A copy of the fit's state: the parameters and each leaf's moments."""
    with torch.no_grad():
        return dict(params={k: p.detach().clone() for k, p in params.items()},
                    moments={k: ref_fit.moments_of(optimizer, p) for k, p in params.items()})


def step_taken(before: Dict, after: Dict, beta1: float) -> Dict[str, Dict]:
    """The gradient that the optimizer got in the step between two
    snapshots (from its first moments, in float64) and each leaf's change."""
    grad = {k: (after["moments"][k][0].double() - beta1 * before["moments"][k][0].double())
            / (1.0 - beta1) for k in before["params"]}
    change = {k: after["params"][k] - before["params"][k] for k in before["params"]}
    return dict(grad=grad, change=change)


def program(render: Dict, numbers: Dict, keys, lr: float, device):
    """The program's (settings, scene, fitted parameters, optimizer)."""
    from bhx_torch import parallel

    cfg = port.render_config(render)
    scene = port.scene(numbers, device)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in parallel.scene_params(scene).items()}
    if sorted(params) != sorted(keys):
        raise RuntimeError(f"the program fits {sorted(params)}, the traffic names {keys}")
    return cfg, scene, params, parallel.make_optimizer(params, lr)


def rank_main(rank: int, world: int, port_: int, device: str, conn, job: Dict) -> None:
    """Rank ``rank`` of a fit over ``world`` ranks (a child process): the
    target from rank 0, the first step, then one step for each True that
    rank 0 sends, each ending in its loss read on the host; at the False,
    its parameters and its peaks (set-up, window) go back to rank 0."""
    import torch.distributed as dist
    from bhx_torch import parallel

    dev = ranks_mod.rank_device(device, rank)
    mesh = ranks_mod.join(port_, world, rank, dev)
    target = torch.empty(job["target_shape"], dtype=torch.float32, device=dev)
    dist.broadcast(target, src=0, group=mesh.group)
    cfg, scene, params, optimizer = program(job["render"], job["numbers"], job["keys"],
                                            job["lr"], dev)

    def step() -> float:
        return float(parallel.train_step(params, optimizer, scene, target, cfg, mesh))

    step()
    sync(dev)
    setup_peak = peak_bytes(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    while conn.recv():
        step()
    conn.send(dict(params={k: p.detach().cpu().numpy() for k, p in params.items()},
                   setup_peak=setup_peak, window_peak=peak_bytes(dev)))


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float,
        overrides: Dict = None, capture=None) -> Outcome:
    traffic = cell.traffic
    render = {**cell.config["render"], **traffic["render"], **(overrides or {})}
    ranks = None
    if cell.chips > 1:
        # The other ranks start up while this one does.
        job = dict(render=render, numbers=cell.config["scene"], keys=traffic["params"],
                   lr=traffic["lr"], target_shape=(render["height"], render["width"], 3))
        ranks = ranks_mod.Ranks(cell.chips, rank_main, device, job)
    try:
        return _run(cell, seed, seconds, trace, device, t0, render, capture, ranks)
    except Exception as e:
        reason = None if ranks is None else ranks.reason()
        if reason is not None:
            raise RuntimeError(f"a rank failed: {reason}") from e
        raise
    finally:
        if ranks is not None:
            ranks.close()
            ranks_mod.leave()


def _run(cell, seed: int, seconds: float, trace: bool, device, t0: float, render: Dict,
         capture, ranks) -> Outcome:
    import torch.distributed as dist
    from bhx_torch import parallel

    traffic = cell.traffic
    numbers = cell.config["scene"]
    mesh = None
    if ranks is not None:
        device = ranks_mod.rank_device(device, 0)
        mesh = ranks_mod.join(ranks.port, cell.chips, 0, device)
    rcfg, rscene = reference_side(render, numbers, device)
    keys = traffic["params"]
    # The device is up before the target's seconds are taken, so that they
    # hold the reference's own work alone.
    torch.zeros(1, device=device).add_(1.0)
    sync(device)
    a = time.perf_counter()
    target = make_target(rscene, rcfg, traffic, seed, device)
    sync(device)
    target_s = time.perf_counter() - a
    if mesh is not None:
        # The frame is a view of its channel-major planes; a collective
        # sends memory in order, so the rows go out laid out as they read.
        target = target.contiguous()
        dist.broadcast(target, src=0, group=mesh.group)

    cfg, scene, params, optimizer = program(render, numbers, keys, traffic["lr"], device)
    beta1 = optimizer.param_groups[0]["betas"][0]
    # One rank steps as a user of one card does; more go through the mesh.
    sharded = () if mesh is None else (mesh,)

    def step() -> float:
        return float(parallel.train_step(params, optimizer, scene, target, cfg, *sharded))

    losses = [step()]
    # An optimizer that got no gradient holds no first moment.
    first_grad = {k: m / (1.0 - beta1)
                  for k, (m, _, _) in snapshot(params, optimizer)["moments"].items()}
    sync(device)
    setup_peak = peak_bytes(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    start = time.perf_counter()
    setup_s = start - t0 - target_s
    log(f"set-up {setup_s:.1f} s, besides the reference's target {target_s:.1f} s")
    if ranks is not None:
        ranks.window(seconds)
    # The state before each of the window's steps, for the step checked
    # later.  A traced run profiles the window's second step, so that the
    # window has unprofiled steps to set against it.
    states: List[Dict] = []
    count, now, stretch_s = 0, start, 0.0
    while True:
        states.append(snapshot(params, optimizer))
        if ranks is not None:
            ranks.tell(True)
        if trace and count == 1:
            a = time.perf_counter()
            with capture.stretch(1, dict(kind="fit")):
                losses.append(step())
            now = time.perf_counter()
            stretch_s = now - a
        else:
            losses.append(step())
            now = time.perf_counter()
        count += 1
        if now - start >= seconds and count >= FIRST_STEPS:
            break
    states.append(snapshot(params, optimizer))
    window_peak = peak_bytes(device)
    rank_gap = None
    if ranks is not None:
        a = time.perf_counter()
        others = ranks.stop(False)
        log(f"{count} steps in {now - start:.3f} s; the other ranks' replies and exit "
            f"{time.perf_counter() - a:.1f} s")
        rank_gap = max(float(np.max(np.abs(o["params"][k] - params[k].detach().cpu().numpy())))
                       for o in others for k in keys)
        setup_peak = max([setup_peak] + [o["setup_peak"] for o in others])
        window_peak = max([window_peak] + [o["window_peak"] for o in others])
    if trace:
        capture.info["window_peak_bytes"] = window_peak
        capture.info["unit_s"] = (now - start - stretch_s) / (count - 1)
    del params, optimizer, scene
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    # The reference, once the window has closed: the first steps from the
    # same start, then one later step of the window from the program's
    # state before it.  Window step i is the fit's step i + 2.
    start_params = reference_params(numbers, keys, device)
    ref_start = time.perf_counter()
    ref = ref_fit.fit_steps(start_params, rscene, target, rcfg, FIRST_STEPS, traffic["lr"],
                            bands=cell.chips)
    later = random.Random(seed).randrange(FIRST_STEPS - 1, count)
    before = states[later]
    ref_later = ref_fit.step_from(before["params"], before["moments"], rscene, target, rcfg,
                                  traffic["lr"], bands=cell.chips)
    change = {k: states[FIRST_STEPS - 1]["params"][k] - start_params[k] for k in keys}
    first = gaps(dict(losses=losses[:FIRST_STEPS], grad=first_grad, change=change),
                 dict(ref, grad=ref["first_grad"]), traffic["leaf_floor"])
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    log(f"each leaf's change after {FIRST_STEPS} steps, program / reference, and first "
        "gradient's norm: " + ", ".join(
            f"{k} {norm(change[k]):.6g} / {norm(ref['change'][k]):.6g} "
            f"{norm(ref['first_grad'][k]):.3g}" for k in keys))
    window = gaps(dict(losses=[losses[later + 1]],
                       **step_taken(before, states[later + 1], beta1)),
                  dict(ref_later, losses=[ref_later["loss"]]), traffic["leaf_floor"])
    log(f"set-up {setup_s:.1f} s; {count} steps in {now - start:.3f} s; the reference's "
        f"{FIRST_STEPS} steps and step {later + 2} {time.perf_counter() - ref_start:.1f} s")
    values = dict(first)
    values.update({f"{m}.window": v for m, v in window.items()})
    parts = [list(first), [f"{m}.window" for m in window]]
    if rank_gap is not None:
        values["rank_gap"] = rank_gap
        parts.append(["rank_gap"])
    values = {k: (v if np.isfinite(v) else float("inf")) for k, v in values.items()}
    # Every number is compared: a cell's limits name each, and no other.
    if set(values) != set(cell.limits):
        raise RuntimeError(f"a fit on {cell.chips} chip(s) compares {sorted(values)}; "
                           f"the limits of {cell.name} name {sorted(cell.limits)}")
    checks = {}
    for m, v in values.items():
        checks.update(check(m, v, cell.limits[m]))
    failed = sum(any(values[m] > cell.limits[m] for m in part) for part in parts)
    return Outcome(metrics=dict(setup_s=setup_s, step_s=(now - start) / count),
                   attempted=count + 1, failed=failed, checks=checks,
                   memory_peak_bytes=max(setup_peak, window_peak))
