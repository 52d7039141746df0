"""One run of one cell: the driver of the cell's traffic kind on the
program, the per-layer readers on the traced stretch, the check that no
JAX module was loaded, and the result line.

A result line is one JSON object, the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, ``built_kernels`` (whether this run built a
kernel library, whose compilation its ``setup_s`` then holds), and last
``checks``: each number compared with its limit, which also close
standard error.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from typing import Dict, List, Optional

import torch

from benchmark import spec, tracing

# Top-level module names that the run's process must not hold: JAX and the
# JAX package that the program was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "bhx")


def loaded_forbidden(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``),
    each module name cut at its first dot and compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def built_libraries(root) -> List[str]:
    """The shared libraries that builds left under the checkout's
    ``build/`` (the program's kernel library among them)."""
    return sorted(str(p) for p in (root / "build").rglob("*.so"))


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: Optional[float] = None, overrides: Optional[Dict] = None,
             root=spec.ROOT) -> Dict:
    """Run cell ``name`` once and return its result object.  ``overrides``
    change the configuration's render settings (a rehearsal on the CPU at
    a small size); the driver's ``device`` is the card unless named."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.load(name, root)
    driver = importlib.import_module(f"benchmark.drivers.{cell.traffic['kind']}")
    capture = tracing.Capture() if trace else None
    before = built_libraries(root)
    out = driver.run(cell, seed, seconds, trace, device, t0, overrides, capture)
    # A run that built a library paid for its compilation in set-up.
    built = bool(set(built_libraries(root)) - set(before))
    correct = out.failed == 0 and all(c["value"] <= c["limit"] for c in out.checks.values())
    result = dict(correct=bool(correct), attempted=int(out.attempted), failed=int(out.failed))
    on_card = torch.device(device).type == "cuda"
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=cell.chips, memory_peak_bytes=int(out.memory_peak_bytes))
    if trace:
        t = capture.trace
        metrics = {}
        for m in cell.per_layer:
            value = tracing.reader(m, root / "benchmark" / "metrics")(t)
            if value is not None:
                metrics[m] = dict(value=float(value), unit=cell.units[m])
        dev.update(tracing.device_fields(t))
        result.update(metrics=metrics, device=dev, breakdown=tracing.breakdown(t))
    else:
        result.update(metrics={m: dict(value=float(out.metrics[m]), unit=cell.units[m])
                               for m in cell.end_to_end},
                      device=dev)
    result["built_kernels"] = built
    result["checks"] = out.checks
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    parser = argparse.ArgumentParser(prog="benchmark/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cell = spec.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s), found {have}",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = loaded_forbidden()
    if found:
        print(f"benchmark: the run loaded {found}; nothing it runs may import JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    if result["built_kernels"]:
        print("benchmark: this run built the kernel library; its setup_s holds the build",
              file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
