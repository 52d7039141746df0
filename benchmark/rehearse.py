"""A run of one cell on the CPU at a small size, with the look for a card
skipped: the rest of a run as ``run.py`` makes it (the same drivers, the
same reference and comparison), for tests and for trying a change here.

    python -m benchmark.rehearse --workload euler.orbit --seed 1 --seconds 1 \\
        --width 48 --height 27 --max-iterations 150

Prints the result object, then the forbidden top-level module names that
the process holds (none, where nothing loaded JAX), as two JSON lines.
No number it prints is a device number.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import harness


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.rehearse")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--width", type=int, default=48)
    p.add_argument("--height", type=int, default=27)
    p.add_argument("--max-iterations", type=int, default=150)
    args = p.parse_args(argv)
    result = harness.run_cell(
        args.workload, args.seed, args.seconds, False, device="cpu",
        overrides=dict(width=args.width, height=args.height,
                       max_iterations=args.max_iterations))
    print(json.dumps(result))
    print(json.dumps(harness.loaded_forbidden()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
