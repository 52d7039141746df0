"""The control runs of the benchmark's correctness check, at a cell's own
size, on the card (or on the CPU at a small size, for the tests):

    python3 benchmark/control.py --workload euler.orbit --seeds 11,12,13 \\
        --out build/control.json

Each control is the reference put in the program's place and compared
with the reference exactly as a run compares the program:

* an orbit cell: the reference's frames with the bloom's matrix products
  in TF32 (the nearest precision below the configuration's float32 with
  TF32 off), and, as a second reading, with the march state rounded to
  bfloat16 after every substep; the frames are those that a window of
  ``--window-frames`` frames could sample, drawn from the seed;
* the fit: the reference's first steps, and one step from the
  reference's state after them (as a run checks a later step of its
  window), with the march state rounded to bfloat16 (the fit has no
  matrix product for TF32 to change), and with the fault "half of the
  batch left out, the mean taken over the rest" (the loss over the
  frame's top half).

Prints one JSON object a seed and control, and writes them all to
``--out``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if __name__ == "__main__":
    sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark import spec  # noqa: E402
from benchmark.drivers import fit, orbit  # noqa: E402
from benchmark.drivers.common import reference_side  # noqa: E402
from benchmark.reference import fit as ref_fit  # noqa: E402
from benchmark.reference import frame as ref_frame  # noqa: E402
from benchmark.reference.scene import posed  # noqa: E402


@contextlib.contextmanager
def tf32():
    """Float32 matrix products in TF32 inside the block."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def orbit_controls(cell, seed: int, device, window_frames: int, overrides=None):
    traffic = cell.traffic
    render = dict(cell.config["render"], **(overrides or {}))
    rcfg, rscene = reference_side(render, cell.config["scene"], device)
    w = traffic["warmup_frames"]
    table = orbit.poses(traffic, seed, w + window_frames)
    frames = random.Random(seed).sample(range(window_frames), traffic["check_frames"])
    out = []
    for name, ctx, opts in (("tf32", tf32, {}),
                            ("bf16_state", contextlib.nullcontext,
                             dict(state_dtype=torch.bfloat16))):
        worst = dict(bad_frac=0.0, mean_abs_err=0.0)
        t = time.perf_counter()
        for k in frames:
            s = posed(rscene, *(torch.tensor(float(v), device=device) for v in table[w + k]))
            with torch.no_grad():
                want = ref_frame.render(s, rcfg)
                with ctx():
                    got = ref_frame.render(s, rcfg, dict(opts))
            err = orbit.frame_errors(got, want, traffic["bad_pixel_atol"])
            worst = {m: max(worst[m], err[m]) for m in err}
        out.append(dict(control=name, seed=seed, frames=frames, **worst,
                        seconds=time.perf_counter() - t))
    return out


def fit_controls(cell, seed: int, device, overrides=None):
    traffic = cell.traffic
    render = {**cell.config["render"], **traffic["render"], **(overrides or {})}
    rcfg, rscene = reference_side(render, cell.config["scene"], device)
    target = fit.make_target(rscene, rcfg, traffic, seed, device)
    start = fit.reference_params(cell.config["scene"], traffic["params"], device)
    n, lr, floor = fit.FIRST_STEPS, traffic["lr"], traffic["leaf_floor"]
    t = time.perf_counter()
    ref = ref_fit.fit_steps(start, rscene, target, rcfg, n, lr)
    # The later step of the window, from the reference's state after the
    # first steps: the reference's own step against the control's.
    state = ref["state"]
    ref_later = ref_fit.step_from(state["params"], state["moments"], rscene, target, rcfg, lr)
    ref_s = time.perf_counter() - t
    out = []
    for name, kw in (("bf16_state", dict(opts=dict(state_dtype=torch.bfloat16))),
                     ("half_batch", dict(rows=slice(0, render["height"] // 2)))):
        t = time.perf_counter()
        got = ref_fit.fit_steps(start, rscene, target, rcfg, n, lr, **kw)
        got_later = ref_fit.step_from(state["params"], state["moments"], rscene, target,
                                      rcfg, lr, **kw)
        first = fit.gaps(dict(got, grad=got["first_grad"]), dict(ref, grad=ref["first_grad"]),
                         floor)
        later = fit.gaps(dict(got_later, losses=[got_later["loss"]]),
                         dict(ref_later, losses=[ref_later["loss"]]), floor)
        out.append(dict(control=name, seed=seed, reference_s=ref_s,
                        seconds=time.perf_counter() - t, **first,
                        **{f"{m}.window": v for m, v in later.items()}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--window-frames", type=int, default=600)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available():
        print("control: needs the CUDA card", file=sys.stderr)
        return 2
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.traffic["kind"] == "orbit":
            got = orbit_controls(cell, seed, "cuda", args.window_frames)
        else:
            got = fit_controls(cell, seed, "cuda")
        for r in got:
            print(json.dumps(dict(workload=args.workload, **r)), flush=True)
        rows += got
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
