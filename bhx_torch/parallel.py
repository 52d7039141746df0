"""Distribution on ``torch.distributed``, and inverse rendering
(counterpart of ``bhx/parallel.py``).

* **Tile sharding.**  Rays are independent, so the frame's pixel rows are
  cut into one contiguous band per rank (the height padded to a multiple
  of the world size by repeating the last row).  Each rank traces its band
  through ``tracer.trace_rays_record_rows`` (the kernels on the card, their
  plain versions on the CPU) and the bands are ``all_gather``-ed and
  cropped: :func:`trace_image_sharded`, :func:`render_sharded`.  The trace
  is dense whatever ``cfg.use_ladder`` says, as in bhx.  bhx's two routes
  (GSPMD for its jnp modes, ``shard_map`` for its Pallas ones) are this
  one route.
* **Inverse rendering.**  :func:`train_step` / :func:`fit_scene` fit the
  scene parameters by Adam on the L2 image loss.  Over more than one rank
  each rank traces its own band under autograd (the march replay of the
  backward is ~98% of a step), gathers the other bands detached, and runs
  the sky, the post chain and the whole loss on the whole frame, as
  ``render`` does; after ``backward`` the parameter gradients are summed
  over the ranks (one ``all_reduce``).  No parameter reaches the post
  chain, so the bands' gradients sum to the frame's.  Bloom and FXAA read
  neighbours, so no rank computes a band-local loss.
* **Bring-up.**  :func:`tile_mesh` is this rank's view of a process group;
  :func:`init_distributed` joins one (torchrun's environment or explicit
  arguments); :func:`spawn` runs a function on n local ranks in processes
  of their own and returns their results; :func:`bench_scaling` times the
  sharded trace on the first 1, 2, 4, ... ranks.

Collectives go through NCCL on the card and gloo on the CPU.  NCCL takes
one rank a card, so ranks that share a card use gloo, and their CUDA
tensors are staged through the host for each collective.

The parameters are a plain dict of tensors under the keys of
``bhx.parallel.scene_params``, so a dict made by one package can be applied
by the other (as numpy arrays).
"""

from __future__ import annotations

import dataclasses
import datetime
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from bhx_torch import tracer
from bhx_torch.config import RenderConfig
from bhx_torch.pipeline import image_from_record, image_from_rows, render
from bhx_torch.scene import Scene, _device, scene_from_state

# Seconds a collective, a rendezvous or a spawned world may take before it
# fails instead of hanging.
DEFAULT_TIMEOUT_S = 120.0


# ---------------------------------------------------------------------------
# Bring-up
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TileMesh:
    """This rank's view of the ranks that share a frame: the process group
    (None without one: a world of one), this rank in it, its size, and the
    device this rank works on."""

    group: Any
    rank: int
    size: int
    device: torch.device


def _rank_device(device) -> torch.device:
    """``device``, with a CUDA device without an index (or None) made this
    rank's card, ``cuda:{LOCAL_RANK % device_count}``."""
    device = _device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def tile_mesh(group=None, device=None) -> TileMesh:
    """The ranks of ``group`` (the default group when one is initialised),
    or a world of one when no process group is, as bhx's ``tile_mesh``
    over one device.  The device is this rank's card unless ``device``
    names another; the CPU is used only when asked for."""
    device = _rank_device(device)
    if dist.is_available() and dist.is_initialized():
        group = group or dist.group.WORLD
        return TileMesh(group, dist.get_rank(group), dist.get_world_size(group), device)
    if group is not None:
        raise ValueError("tile_mesh: a group needs an initialised process group")
    return TileMesh(None, 0, 1, device)


def default_backend(device, local_ranks: Optional[int] = None) -> str:
    """NCCL for ranks on cards of their own, gloo on the CPU and for ranks
    that share a card (NCCL refuses two ranks on one device).
    ``local_ranks`` is the number of ranks on this host (torchrun's
    ``LOCAL_WORLD_SIZE`` when None, else 1); ranks on other hosts have
    cards of their own."""
    device = torch.device(device)
    if local_ranks is None:
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, backend: Optional[str] = None,
                     timeout: datetime.timedelta = datetime.timedelta(seconds=DEFAULT_TIMEOUT_S),
                     ) -> None:
    """Join the process group at ``coordinator`` (``host:port``; torchrun's
    ``MASTER_ADDR``/``MASTER_PORT`` when not given, with its ``WORLD_SIZE``
    and ``RANK`` for the counts not given).  A no-op without a coordinator
    (a single process) and once a group is initialised.  The backend is
    :func:`default_backend`'s for the card when one is present and for the
    CPU otherwise, unless named.  A
    rendezvous that does not complete within ``timeout`` (a missing peer, a
    coordinator out of reach) raises ``RuntimeError`` naming the
    coordinator and this process."""
    if dist.is_initialized():
        return
    if coordinator is None and "MASTER_ADDR" in os.environ and "MASTER_PORT" in os.environ:
        coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if coordinator is None:
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if backend is None:
        backend = default_backend("cuda" if torch.cuda.is_available() else "cpu")
    try:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id, timeout=timeout)
    except Exception as e:
        raise RuntimeError(
            f"torch.distributed.init_process_group failed (coordinator={coordinator!r}, "
            f"num_processes={num_processes!r}, process_id={process_id!r}, "
            f"backend={backend!r}) — check that the coordinator process is reachable and"
            " that every process uses the same num_processes/coordinator"
        ) from e


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _to_host(value):
    """``value`` with every tensor in it (through dicts, lists and tuples)
    a numpy array, so that it pickles by value."""
    if torch.is_tensor(value):
        return value.detach().cpu().numpy()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


# Torch threads a spawned rank: ranks share the host's cores (and the
# test runner's workers), so each takes few.
RANK_THREADS = 2


def _rank_main(fn, rank: int, world: int, port: int, backend: str, device: str,
               timeout: float, args: tuple, results) -> None:
    """One rank of :func:`spawn`: join the group, run ``fn(mesh, *args)``,
    and put ``(rank, ok, result or traceback)`` on ``results``."""
    torch.set_num_threads(RANK_THREADS)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        init_distributed(f"localhost:{port}", world, rank, backend,
                         timeout=datetime.timedelta(seconds=timeout))
        try:
            results.put((rank, True, _to_host(fn(tile_mesh(device=dev), *args))))
        finally:
            dist.destroy_process_group()
    except Exception:
        results.put((rank, False, traceback.format_exc()))


def spawn(fn: Callable, nprocs: int, backend: Optional[str] = None, device=None,
          timeout: float = DEFAULT_TIMEOUT_S, args: tuple = ()) -> List:
    """Run ``fn(mesh, *args)`` on ``nprocs`` local ranks, each a process of
    its own (the ``spawn`` start method: CUDA cannot live in a forked
    child) joined into one group at a free localhost port, and return each
    rank's result in rank order, its tensors as numpy arrays.

    ``fn`` and ``args`` are pickled, so ``fn`` is a module-level function
    of a module that the ranks import (``bhx_torch``'s rank programs
    below).  Each rank works on ``device``: rank r on card ``r %
    device_count`` for "cuda" or None (raising when there is no card), the
    CPU only when asked for.  Each takes RANK_THREADS torch threads and
    joins through ``backend`` (:func:`default_backend` when None).  A rank
    that raises, dies, or a world that is not done within ``timeout``
    seconds kills every rank and raises."""
    device = _device(device)
    backend = backend or default_backend(device, nprocs)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, port, backend, str(device), timeout, args,
                               results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    out: Dict[int, Any] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < nprocs:
            try:
                rank, ok, value = results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    try:  # its result may have reached the pipe as it exited
                        rank, ok, value = results.get(timeout=1.0)
                    except queue.Empty:
                        raise RuntimeError(
                            f"spawn: rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} without a result") from None
                elif time.monotonic() > deadline:
                    raise TimeoutError(f"spawn: {nprocs} ranks not done in {timeout} s "
                                       f"(done: {sorted(out)})")
                else:
                    continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{value}")
            out[rank] = value
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 10.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
        results.close()
    return [out[r] for r in range(nprocs)]


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------

def _comm_device(mesh: TileMesh) -> torch.device:
    """Where this group's collectives take their tensors: the card for
    NCCL, the host for gloo."""
    return mesh.device if dist.get_backend(mesh.group) == "nccl" else torch.device("cpu")


def _all_gather(t: torch.Tensor, mesh: TileMesh) -> List[torch.Tensor]:
    """Every rank's ``t`` (detached; one shape on every rank), by rank, on
    ``t``'s device."""
    x = t.detach().to(_comm_device(mesh)).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return [p.to(t.device) for p in parts]


def _all_reduce(t: torch.Tensor, mesh: TileMesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """The reduction of ``t`` over the ranks, a new tensor on ``t``'s device."""
    x = t.detach().to(_comm_device(mesh), copy=True)
    dist.all_reduce(x, op=op, group=mesh.group)
    return x.to(t.device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# Tile-sharded trace and render
# ---------------------------------------------------------------------------

def _pad_rows(h: int, n: int) -> int:
    return -(-h // n) * n


def _check_device(scene: Scene, mesh: TileMesh) -> None:
    if scene.time.device != mesh.device:
        raise ValueError(f"the scene is on {scene.time.device}, this rank works on "
                         f"{mesh.device}")


def _sharded_rows(scene: Scene, cfg: RenderConfig, mesh: TileMesh, width: int,
                  height: int) -> torch.Tensor:
    """The dense (8, height, width) sky-free record rows, each rank tracing
    its band of rows: under autograd this rank's band carries the graph,
    the other ranks' bands are detached copies."""
    _check_device(scene, mesh)
    o, d = tracer.camera_rays(scene.camera, width, height)
    band = _pad_rows(height, mesh.size) // mesh.size
    # Rows past the frame repeat its last row.
    rows = torch.arange(mesh.rank * band, (mesh.rank + 1) * band, device=o.device)
    rows = torch.clamp(rows, max=height - 1)
    mine = tracer.trace_rays_record_rows(o[rows].reshape(-1, 3), d[rows].reshape(-1, 3),
                                         scene, cfg)
    if mesh.group is None:
        parts = [mine]
    else:
        parts = _all_gather(mine, mesh)
        parts[mesh.rank] = mine
    return torch.cat(parts, dim=1).reshape(8, -1, width)[:, :height]


def trace_image_sharded(scene: Scene, cfg: RenderConfig, mesh: TileMesh, width: int,
                        height: int) -> torch.Tensor:
    """The dense (height, width, 8) sky-free record (``tracer``'s record
    layout) on every rank of ``mesh``, each rank tracing one band of rows;
    dense whatever ``cfg.use_ladder`` says.  The scene lies on this rank's
    device."""
    return _sharded_rows(scene, cfg, mesh, width, height).permute(1, 2, 0).contiguous()


def render_sharded(scene: Scene, cfg: RenderConfig, mesh: Optional[TileMesh] = None
                   ) -> torch.Tensor:
    """The (height, width, 3) frame on every rank, its trace tile-sharded
    over ``mesh`` (a world of one on the scene's device by default): the
    sky finalize on the gathered record (the interleaved sky kernel in
    procedural mode), then the post chain on every rank (a fraction of a
    frame's cost).  With ``use_ladder=False`` it is ``render``'s frame."""
    mesh = mesh or tile_mesh(device=scene.time.device)
    return image_from_record(trace_image_sharded(scene, cfg, mesh, cfg.width, cfg.height),
                             scene, cfg)


def bench_scaling(scene: Scene, cfg: RenderConfig, device_counts: Optional[Sequence[int]] = None,
                  repeats: int = 3, width: Optional[int] = None, height: Optional[int] = None,
                  mesh: Optional[TileMesh] = None) -> List[Dict]:
    """Rays/s of :func:`trace_image_sharded` on the first 1, 2, 4, ...
    ranks of ``mesh`` (all the counts up to its size by default), in bhx's
    rows: ``devices``, ``seconds`` (the best of ``repeats``, each the
    slowest rank's), ``rays_per_s``, ``mrays_per_s``, ``efficiency`` (rate
    against n times the one-rank rate), ``overhead_efficiency`` (rate
    against the one-rank rate), ``platform`` and ``device_kind``.  Every
    rank of ``mesh`` calls it; a count runs on a subgroup of the first n
    ranks.  Ranks that share a card or a host's cores measure the overhead
    of the sharded program, not hardware scaling."""
    mesh = mesh or tile_mesh(device=scene.time.device)
    counts = list(device_counts or [n for n in (1, 2, 4, 8, 16, 32) if n <= mesh.size])
    if not all(1 <= n <= mesh.size for n in counts):
        raise ValueError(f"device_counts {counts} must lie in [1, {mesh.size}]")
    w, h = width or cfg.width, height or cfg.height
    ranks = dist.get_process_group_ranks(mesh.group) if mesh.group is not None else [0]
    cuda = mesh.device.type == "cuda"
    rows, base_rate = [], None
    for n in counts:
        sub = mesh
        if n < mesh.size:
            group = dist.new_group(ranks[:n])  # every rank of mesh makes it
            sub = TileMesh(group, mesh.rank, n, mesh.device) if mesh.rank < n else None
        times = torch.zeros(repeats, dtype=torch.float64)
        if sub is not None:
            for _ in range(2):  # the kernel build and a warm-up
                trace_image_sharded(scene, cfg, sub, w, h)
            for i in range(repeats):
                _sync(mesh.device)
                if sub.group is not None:  # every member starts together
                    _all_reduce(torch.zeros(1), sub)
                t0 = time.perf_counter()
                trace_image_sharded(scene, cfg, sub, w, h)
                _sync(mesh.device)
                times[i] = time.perf_counter() - t0
        if mesh.group is not None:
            times = _all_reduce(times, mesh, dist.ReduceOp.MAX)
        best = float(times.min())
        rate = w * h / best
        base_rate = base_rate or rate
        rows.append(dict(
            devices=n, seconds=best, rays_per_s=rate, mrays_per_s=rate / 1e6,
            efficiency=rate / (base_rate * n), overhead_efficiency=rate / base_rate,
            platform="gpu" if cuda else "cpu",
            device_kind=torch.cuda.get_device_name(mesh.device) if cuda else "cpu"))
    return rows


# ---------------------------------------------------------------------------
# Inverse rendering (the training workload)
# ---------------------------------------------------------------------------

# The differentiable parameter subset: black-hole fields, then camera
# fields under a ``cam_`` prefix.  ``spin`` reaches the image only under
# geodesics="kerr"; elsewhere its gradient is zero and Adam leaves it.
PARAM_FIELDS = (
    "mass", "spin", "disk_rotation", "disk_inner", "disk_outer", "feather",
)
CAMERA_FIELDS = ("position", "fov")


def scene_params(scene: Scene) -> Dict[str, torch.Tensor]:
    """The fitted fields of ``scene``, by ``bhx.parallel.scene_params``'s
    keys (the scene's own tensors, not copies)."""
    p = {f: getattr(scene.black_hole, f) for f in PARAM_FIELDS}
    p.update({f"cam_{f}": getattr(scene.camera, f) for f in CAMERA_FIELDS})
    return p


def apply_params(scene: Scene, params: Mapping) -> Scene:
    """``scene`` with the fitted fields taken from ``params``: tensors are
    used as they are (so gradients reach them), anything else, such as the
    numpy arrays of a ``bhx.parallel.scene_params`` dict, becomes a float32
    tensor on the scene's device."""
    dev = scene.black_hole.mass.device

    def leaf(v):
        return v if torch.is_tensor(v) else torch.as_tensor(v, dtype=torch.float32,
                                                            device=dev)

    bh = dataclasses.replace(
        scene.black_hole, **{f: leaf(params[f]) for f in PARAM_FIELDS})
    cam = dataclasses.replace(
        scene.camera, **{f: leaf(params[f"cam_{f}"]) for f in CAMERA_FIELDS})
    return dataclasses.replace(scene, black_hole=bh, camera=cam)


def make_optimizer(params: Dict[str, torch.Tensor], lr: float = 1e-2) -> torch.optim.Adam:
    """Adam over the parameter tensors, with ``optax.adam``'s defaults
    (betas 0.9 / 0.999, eps 1e-8)."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _sharded(mesh: Optional[TileMesh]) -> bool:
    return mesh is not None and mesh.size > 1


def loss_fn(params: Dict[str, torch.Tensor], scene: Scene, target: torch.Tensor,
            cfg: RenderConfig, mesh: Optional[TileMesh] = None) -> torch.Tensor:
    """The mean squared difference between the frame under ``params`` and
    ``target`` ((height, width, 3)).  Over more than one rank the frame's
    trace is tile-sharded, this rank's band under autograd (dense)."""
    scene = apply_params(scene, params)
    if _sharded(mesh):
        img = image_from_rows(_sharded_rows(scene, cfg, mesh, cfg.width, cfg.height),
                              scene, cfg)
    else:
        img = render(scene, cfg)
    return torch.mean((img - target) ** 2)


def train_step(params: Dict[str, torch.Tensor], optimizer: torch.optim.Optimizer,
               scene: Scene, target: torch.Tensor, cfg: RenderConfig,
               mesh: Optional[TileMesh] = None) -> torch.Tensor:
    """One inverse-rendering step: L2 image loss, its gradients (left in
    each parameter's ``.grad``), one optimizer update in place.  Returns the
    loss before the update.  Over more than one rank of ``mesh`` every
    rank computes the same loss, the gradients are summed over the ranks
    before the update, and the parameters stay equal on every rank; the
    trace is dense there, and ``cfg.use_ladder`` raises ``ValueError``."""
    if _sharded(mesh) and cfg.use_ladder:
        raise ValueError("the sharded train step traces densely: set use_ladder=False "
                         "(the ladder is not sharded)")
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, scene, target, cfg, mesh)
    loss.backward()
    if _sharded(mesh):
        # Every rank runs one graph, so the same parameters have gradients.
        have = [p for p in params.values() if p.grad is not None]
        summed = _all_reduce(torch.cat([p.grad.reshape(-1) for p in have]), mesh)
        for p, g in zip(have, summed.split([p.numel() for p in have])):
            p.grad.copy_(g.view_as(p.grad))
    optimizer.step()
    return loss.detach()


def fit_scene(scene: Scene, target: torch.Tensor, cfg: RenderConfig, steps: int = 100,
              lr: float = 1e-2, mesh: Optional[TileMesh] = None, verbose: bool = False,
              callback: Optional[Callable[[int, float], None]] = None,
              ) -> Tuple[Dict[str, torch.Tensor], List[float]]:
    """Fit the scene's parameters to ``target`` by ``steps`` Adam steps,
    tile-sharded over ``mesh`` (the default group when one is initialised,
    else one device; as bhx's ``tile_mesh()`` takes every device).
    ``callback(step, loss)``, if given, runs after every step; ``verbose``
    prints every tenth loss on rank 0.  Returns the fitted parameters
    (detached) and the loss of every step."""
    mesh = mesh or tile_mesh(device=scene.time.device)
    params = {k: v.detach().clone().requires_grad_() for k, v in scene_params(scene).items()}
    optimizer = make_optimizer(params, lr)
    target = target.to(scene.time.device)
    losses = []
    for i in range(steps):
        losses.append(float(train_step(params, optimizer, scene, target, cfg, mesh)))
        if verbose and mesh.rank == 0 and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
        if callback is not None:
            callback(i, losses[-1])
    return {k: v.detach() for k, v in params.items()}, losses


# ---------------------------------------------------------------------------
# Rank programs for spawn (the tests and chip_smoke.py run them)
# ---------------------------------------------------------------------------

def run_jobs(mesh: TileMesh, jobs: Sequence[Tuple[Callable, tuple]]) -> List:
    """Run ``fn(mesh, *args)`` for each ``(fn, args)`` of ``jobs`` in order,
    in one world; their results."""
    return [fn(mesh, *args) for fn, args in jobs]


class _Clock:
    """Elapsed ms of the work between :meth:`start` and :meth:`ms`: CUDA
    events on the card, the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"

    def start(self) -> None:
        if self.cuda:
            self.t0 = torch.cuda.Event(enable_timing=True)
            self.t0.record()
        else:
            self.t0 = time.perf_counter()

    def ms(self) -> float:
        if not self.cuda:
            return (time.perf_counter() - self.t0) * 1e3
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return self.t0.elapsed_time(end)


def frame_job(mesh: TileMesh, state: Mapping, cfg: RenderConfig) -> Dict:
    """The sharded record and frame of the scene ``state`` on this rank:
    on the card ``render_sharded`` once to build the kernels and warm up,
    then timed (``ms``) with the kernel launches of that frame alone
    (``launches``), then ``record`` from ``trace_image_sharded``; with
    this rank's device and its card's name."""
    from bhx_torch.kernels import launch_counts, reset_launch_counts

    scene = scene_from_state(state, mesh.device)
    clock = _Clock(mesh.device)
    with torch.no_grad():
        if mesh.device.type == "cuda":
            render_sharded(scene, cfg, mesh)
            _sync(mesh.device)
        reset_launch_counts()
        clock.start()
        image = render_sharded(scene, cfg, mesh)
        ms = clock.ms()
        launches = launch_counts()
        record = trace_image_sharded(scene, cfg, mesh, cfg.width, cfg.height)
    return dict(rank=mesh.rank, world=mesh.size, device=str(mesh.device),
                device_name=(torch.cuda.get_device_name(mesh.device)
                             if mesh.device.type == "cuda" else "cpu"),
                ms=ms, launches=launches, image=image, record=record)


def fit_job(mesh: TileMesh, state: Mapping, target: np.ndarray, cfg: RenderConfig,
            steps: int, lr: float) -> Dict:
    """``steps`` sharded train steps from the scene ``state`` toward
    ``target`` on this rank: each step's loss, summed gradients, parameters
    after its update, ms (``_Clock``) and, on the card, peak memory."""
    from bhx_torch.kernels import launch_counts, reset_launch_counts

    scene = scene_from_state(state, mesh.device)
    params = {k: v.detach().clone().requires_grad_() for k, v in scene_params(scene).items()}
    optimizer = make_optimizer(params, lr)
    target = torch.as_tensor(target, device=mesh.device)
    clock = _Clock(mesh.device)
    out = dict(rank=mesh.rank, losses=[], grads=[], params=[], ms=[], peak_mem_gb=[],
               launches=[])
    for _ in range(steps):
        if mesh.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(mesh.device)
        reset_launch_counts()
        clock.start()
        loss = train_step(params, optimizer, scene, target, cfg, mesh)
        out["ms"].append(clock.ms())
        out["launches"].append(launch_counts())
        out["losses"].append(float(loss))
        out["grads"].append({k: v.grad.clone() for k, v in params.items()
                             if v.grad is not None})
        out["params"].append({k: v.detach().clone() for k, v in params.items()})
        if mesh.device.type == "cuda":
            out["peak_mem_gb"].append(torch.cuda.max_memory_allocated(mesh.device) / 1e9)
    return out


def bench_job(mesh: TileMesh, state: Mapping, cfg: RenderConfig,
              device_counts: Optional[Sequence[int]], repeats: int) -> List[Dict]:
    """:func:`bench_scaling` of the scene ``state`` on this rank."""
    return bench_scaling(scene_from_state(state, mesh.device), cfg, device_counts, repeats,
                         mesh=mesh)
