"""Command line: ``python -m bhx_torch render | bench | assets | fit``
(counterpart of ``bhx/cli.py``, with its flags).

``bhx``'s ``--march-mode`` has no counterpart: the port always runs the
kernel path.  ``--device`` names the device; it defaults to the CUDA card
(the CPU runs the kernels' plain versions).  Under torchrun with more than
one process, ``render --sharded`` tile-shards the frame's trace over the
processes (``bhx_torch.parallel.render_sharded``) and ``fit`` shards every
step (``fit_scene`` over the default group); each process works on its own
card (``LOCAL_RANK``), or on the CPU with ``--device cpu``; rank 0 writes
and prints:

    torchrun --nproc-per-node 2 -m bhx_torch render --sharded -o frame.png
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _build_config(args):
    from bhx_torch.config import BloomConfig, FxaaConfig, Integrator, LadderConfig, RenderConfig

    return RenderConfig(
        width=args.width,
        height=args.height,
        integrator=Integrator.RK45 if args.integrator == "rk45" else Integrator.EULER,
        step_size=args.step_size,
        max_iterations=args.max_iterations,
        angle_division_threshold=args.division_threshold,
        show_disk=not args.no_disk,
        show_disk_texture=not args.no_disk_texture,
        show_redshift=not args.no_redshift,
        show_sky=not args.no_sky,
        render_meshes=not args.no_meshes,
        use_ladder=not args.no_ladder,
        ladder=LadderConfig.for_resolution(args.width, args.height, args.ladder_levels),
        bloom=BloomConfig(enabled=not args.no_bloom, mix_ratio=args.mix_ratio),
        fxaa=FxaaConfig(enabled=not args.no_fxaa),
        tonemap=not args.no_tonemap,
        geodesics=args.geodesics,
    )


def _build_scene(args, device=None):
    import torch

    from bhx_torch.geometry.obj import make_mesh
    from bhx_torch.scene import Scene, _device

    dev = _device(args.device if device is None else device)

    def f32(x) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=dev)

    meshes = tuple(make_mesh(p, position=(0.0, 0.0, 0.0), name=f"obj{i}", device=dev)
                   for i, p in enumerate(args.obj))
    scene = Scene.default(dev, meshes=meshes)
    bh = dataclasses.replace(
        scene.black_hole,
        mass=f32(args.mass),
        spin=f32(args.spin),
        disk_inner=f32(args.disk_inner),
        disk_outer=f32(args.disk_outer),
        disk_rotation=f32(args.disk_rotation),
        rotation_speed=f32(args.rotation_speed),
        relativity_radius=f32(args.relativity_radius),
        feather=f32(args.feather),
    )
    cam = dataclasses.replace(scene.camera, position=f32(args.camera), fov=f32(args.fov))
    if args.look_at is not None:
        cam = cam.look_at(args.look_at)
    return dataclasses.replace(scene, camera=cam, black_hole=bh, time=f32(args.time))


def _add_scene_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device (the CPU runs the kernels' plain versions)")
    p.add_argument("--width", type=int, default=1918)
    p.add_argument("--height", type=int, default=1081)
    p.add_argument("--mass", type=float, default=0.5)
    p.add_argument("--spin", type=float, default=0.0,
                   help="dimensionless a/M (geodesics=kerr only)")
    p.add_argument("--geodesics", choices=["pseudo", "kerr"], default="pseudo",
                   help="pseudo-Newtonian bending (reference) or exact Kerr")
    p.add_argument("--disk-inner", type=float, default=2.0)
    p.add_argument("--disk-outer", type=float, default=10.0)
    p.add_argument("--disk-rotation", type=float, nargs=3,
                   default=[0.15, 0.0, 0.25], help="disk Euler angles")
    p.add_argument("--rotation-speed", type=float, default=1.0)
    p.add_argument("--relativity-radius", type=float, default=20.0)
    p.add_argument("--feather", type=float, default=0.3)
    p.add_argument("--camera", type=float, nargs=3, default=[0.0, 0.0, -19.0])
    p.add_argument("--look-at", type=float, nargs=3, default=None)
    p.add_argument("--fov", type=float, default=1.0)
    p.add_argument("--time", type=float, default=0.0)
    p.add_argument("--obj", action="append", default=[], help="OBJ mesh path")
    # Euler is the reference's shipped default (ray_pipeline.rs:4-14).
    p.add_argument("--integrator", choices=["euler", "rk45"], default="euler")
    p.add_argument("--step-size", type=float, default=0.15)
    p.add_argument("--max-iterations", type=int, default=2000)
    p.add_argument("--division-threshold", type=float, default=0.02)
    p.add_argument("--ladder-levels", type=int, default=4)
    p.add_argument("--mix-ratio", type=float, default=0.7)
    for flag in (
        "no-disk", "no-disk-texture", "no-redshift", "no-sky", "no-meshes",
        "no-ladder", "no-bloom", "no-fxaa", "no-tonemap",
    ):
        p.add_argument(f"--{flag}", action="store_true")


def _join_world(args):
    """Under torchrun with more than one process: join the process group
    and return this rank's ``TileMesh`` (its card, or the CPU with
    ``--device cpu``); None in a single process."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return None
    import torch

    from bhx_torch.parallel import default_backend, init_distributed, tile_mesh

    device = torch.device(args.device)
    init_distributed(backend=default_backend(device))
    mesh = tile_mesh(device=None if device.type == "cuda" else device)
    if mesh.device.type == "cuda":
        torch.cuda.set_device(mesh.device)
    return mesh


def _leave_world(mesh) -> None:
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()


def cmd_render(args) -> int:
    from bhx_torch.io import save_png
    from bhx_torch.parallel import render_sharded
    from bhx_torch.pipeline import render

    mesh = _join_world(args) if args.sharded else None
    try:
        scene = _build_scene(args, mesh.device if mesh else None)
        cfg = _build_config(args)
        t0 = time.perf_counter()
        if mesh is not None:
            img = render_sharded(scene, cfg, mesh).cpu()
        else:
            img = render(scene, cfg).cpu()  # waits for the card
        dt = time.perf_counter() - t0
    finally:
        _leave_world(mesh)
    if mesh is not None and mesh.rank != 0:
        return 0
    save_png(args.output, img)
    rays = cfg.width * cfg.height
    ranks = f" on {mesh.size} ranks" if mesh is not None else ""
    print(f"rendered {cfg.width}x{cfg.height}{ranks} in {dt:.2f}s "
          f"({rays / dt / 1e6:.2f} Mrays/s incl. the kernel build) -> {args.output}")
    return 0


def cmd_bench(args) -> int:
    from bhx_torch.bench import run_bench

    result = run_bench(width=args.width, height=args.height, iters=args.iters,
                       dense=args.dense, geodesics=args.geodesics, spin=args.spin)
    result.pop("image")
    print(json.dumps(result))
    return 0


def cmd_assets(args) -> int:
    from bhx_torch import assets
    from bhx_torch.io import save_png

    if args.regenerate:
        assets.clear_cache()
    disk = assets.disk_texture()
    sky = assets.sky_texture()
    lut = assets.blackbody_lut()
    if args.dump:
        save_png("disk_texture.png", disk)
        save_png("sky_texture.png", sky)
        save_png("blackbody_lut.png", lut)
        print("wrote disk_texture.png sky_texture.png blackbody_lut.png")
    print(f"disk {disk.shape} sky {sky.shape} lut {lut.shape}")
    return 0


def cmd_fit(args) -> int:
    import torch

    from bhx_torch.config import BloomConfig, FxaaConfig
    from bhx_torch.io import load_image
    from bhx_torch.parallel import fit_scene

    mesh = _join_world(args)
    try:
        scene = _build_scene(args, mesh.device if mesh else None)
        cfg = dataclasses.replace(
            _build_config(args), use_ladder=False,
            fxaa=FxaaConfig(enabled=False), bloom=BloomConfig(enabled=False),
            max_iterations=min(args.max_iterations, 400),
        )
        target = torch.from_numpy(load_image(args.target)[..., :3])
        params, losses = fit_scene(scene, target, cfg, steps=args.steps, lr=args.lr,
                                   mesh=mesh, verbose=True)
    finally:
        _leave_world(mesh)
    if mesh is not None and mesh.rank != 0:
        return 0
    print("final loss:", losses[-1])
    for k, v in params.items():
        print(f"  {k} = {v.cpu().numpy()}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bhx_torch",
        description="differentiable black-hole renderer on PyTorch and CUDA",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a frame to PNG")
    _add_scene_flags(pr)
    pr.add_argument("-o", "--output", default="render.png")
    pr.add_argument("--sharded", action="store_true",
                    help="under torchrun: tile-shard the trace over the processes")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="throughput of the frame on the CUDA card")
    pb.add_argument("--width", type=int, default=1918)
    pb.add_argument("--height", type=int, default=1081)
    pb.add_argument("--iters", type=int, default=5)
    pb.add_argument("--dense", action="store_true", help="disable the ladder")
    pb.add_argument("--geodesics", choices=["pseudo", "kerr"], default="pseudo")
    pb.add_argument("--spin", type=float, default=0.0)
    pb.set_defaults(fn=cmd_bench)

    pa = sub.add_parser("assets", help="bake / dump the array textures")
    pa.add_argument("--regenerate", action="store_true")
    pa.add_argument("--dump", action="store_true")
    pa.set_defaults(fn=cmd_assets)

    pf = sub.add_parser("fit", help="inverse rendering: fit the scene to an image")
    _add_scene_flags(pf)
    pf.add_argument("--target", required=True)
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=1e-2)
    pf.set_defaults(fn=cmd_fit)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
