"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout; a configuration's file (its ``file`` there); a traffic mix,
``workloads/<traffic>.json``; a cell's limits, ``limits/<cell>.json``."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[str]
    per_layer: List[str]
    units: Dict[str, str]


def _reports(metric: Dict, cell: str, reported: List[str]) -> bool:
    """Whether a metric entry belongs to ``cell``: its ``workloads`` list
    names the cell, or it has none and the cell reports what it moves (an
    end-to-end metric with no list belongs to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``'s ``BENCHMARK.json``, with its data."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; "
                         f"there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    here = root / HERE.name
    traffic = json.loads((here / "workloads" / f"{w['traffic']}.json").read_text())
    limits = json.loads((here / "limits" / f"{name}.json").read_text())
    e2e = [m["name"] for m in bench["end_to_end"] if _reports(m, name, [])]
    per_layer = [m["name"] for m in bench["per_layer"] if _reports(m, name, e2e)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic,
                limits={k: float(v["limit"]) for k, v in limits.items()},
                end_to_end=e2e, per_layer=per_layer,
                units={m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]})
