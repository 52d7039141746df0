"""Scaling of the tile-sharded trace and train step across ranks
(counterpart of ``scripts/bench_scaling.py``), on ``--ranks`` ranks
spawned on this host (rank r on card r % count; NCCL when every rank has a
card of its own, else gloo; ``--device cpu``: gloo ranks on the CPU):

* each rank's sharded record of the default scene at ``--width`` x
  ``--height`` (dense) against the dense record traced by this process,
  and the rank's sharded frame (``render_sharded``) in ms;
* ``bench_scaling``'s rows for 1, 2, 4, ... ranks up to ``--ranks``;
* ``--fit-steps`` sharded train steps of ``bhx fit``'s render at that size
  (no ladder, bloom or FXAA, 400 march iterations, without the star sky)
  toward the render at mass 0.6: losses, s/step and peak memory per rank.

Ranks that share a card or a host's cores measure the sharded program's
overhead, not hardware scaling.

    python -m bhx_torch.scaling --out scaling.json

Prints one JSON object (and writes it to ``--out``), on the card with its
name and power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys


def main(argv=None) -> int:
    import numpy as np
    import torch

    from bhx_torch import parallel
    from bhx_torch.config import BloomConfig, FxaaConfig, RenderConfig
    from bhx_torch.parallel import apply_params, scene_params
    from bhx_torch.pipeline import render
    from bhx_torch.scene import Scene, scene_to_state
    from bhx_torch.tracer import trace_image_record

    ap = argparse.ArgumentParser(prog="python -m bhx_torch.scaling")
    ap.add_argument("--ranks", type=int, default=None,
                    help="default: one a card (2 on the CPU)")
    ap.add_argument("--width", type=int, default=1918)
    ap.add_argument("--height", type=int, default=1081)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--fit-steps", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        raise SystemExit("python -m bhx_torch.scaling measures on CUDA cards; none is available")
    ranks = args.ranks or (torch.cuda.device_count() if cuda else 2)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines() if cuda else None
    scene = Scene.default(torch.device("cuda", 0) if cuda else "cpu")
    trace_cfg = RenderConfig(width=args.width, height=args.height, use_ladder=False)
    fit_cfg = RenderConfig(width=args.width, height=args.height, use_ladder=False,
                           max_iterations=400, bloom=BloomConfig(enabled=False),
                           fxaa=FxaaConfig(enabled=False), tonemap=True, show_sky=False)
    with torch.no_grad():
        dense = trace_image_record(scene, trace_cfg, args.width, args.height).cpu().numpy()
        target = render(apply_params(scene, dict(scene_params(scene), mass=0.6)), fit_cfg)
    target = target.cpu().numpy()
    state = scene_to_state(scene)
    del scene
    if cuda:
        torch.cuda.empty_cache()
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= ranks]
    jobs = [(parallel.frame_job, (state, trace_cfg)),
            (parallel.bench_job, (state, trace_cfg, counts, args.repeats)),
            (parallel.fit_job, (state, target, fit_cfg, args.fit_steps, 1e-2))]
    backend = parallel.default_backend(args.device, ranks)
    by_rank = parallel.spawn(parallel.run_jobs, ranks, backend=backend, device=args.device,
                             timeout=args.timeout, args=(jobs,))
    frames = [r[0] for r in by_rank]
    fits = [r[2] for r in by_rank]
    out = dict(
        card=card, cards=torch.cuda.device_count(), ranks=ranks, backend=backend,
        resolution=[args.width, args.height],
        frame={f["rank"]: dict(device=f["device"], ms=f["ms"], launches=f["launches"],
                               record_max_abs_err=float(np.abs(f["record"] - dense).max()))
               for f in frames},
        bench_scaling=by_rank[0][1],
        fit=dict(steps=args.fit_steps,
                 losses=fits[0]["losses"],
                 s_per_step={f["rank"]: [ms / 1e3 for ms in f["ms"]] for f in fits},
                 peak_mem_gb={f["rank"]: f["peak_mem_gb"] for f in fits},
                 equal_across_ranks=all(f["losses"] == fits[0]["losses"] for f in fits)))
    text = json.dumps(out)
    print(text)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
