"""What the drivers share: the reference's settings and scene of a
configuration, and the record a run hands back to the harness."""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict

import torch

from benchmark.reference.config import Config
from benchmark.reference.scene import scene_from_numbers


@dataclasses.dataclass
class Outcome:
    """A run's numbers: its end-to-end metrics by name, the requests it
    attempted and those that failed, each compared number with its limit,
    and the device's peak before the reference ran."""

    metrics: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, Dict[str, float]]
    memory_peak_bytes: int


def reference_side(render: Dict, numbers: Dict, device):
    """(settings, scene) of the reference."""
    return Config.from_render(render), scene_from_numbers(numbers, device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if torch.device(device).type == "cuda" else 0


def check(name: str, value: float, limit: float) -> Dict[str, float]:
    return {name: {"value": float(value), "limit": float(limit)}}


def log(msg: str) -> None:
    """A line of the run's progress, on standard error."""
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
