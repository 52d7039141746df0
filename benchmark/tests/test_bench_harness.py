"""The harness as a whole: it loads no JAX; it finds a cell's data, a
traffic mix and a metric's reader by name, with no other file edited;
the names and units of BENCHMARK.json keep to their alphabet; without a
card, or without the program beside it, it exits non-zero with no
result."""

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import harness, spec, tracing

ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_forbidden_names_are_compared_whole():
    assert harness.loaded_forbidden(["bhx_torch", "bhx_torch.kernels", "jaxtyping"]) == []
    assert harness.loaded_forbidden(["bhx.scene", "jax", "numpy"]) == ["bhx", "jax"]


def test_rehearsal_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.rehearse", "--workload", "euler.orbit",
         "--seed", str(2**31 + 3), "--seconds", "0.5", "--width", "32", "--height", "18",
         "--max-iterations", "100"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    result, forbidden = (json.loads(line) for line in out.stdout.strip().splitlines()[-2:])
    assert forbidden == []
    assert result["correct"] is True
    assert list(result)[-1] == "checks"


def test_names_and_units():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["config"] for w in bench["workloads"]] + [w["traffic"] for w in bench["workloads"]]
    names += [k for c in bench["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    units = [m["unit"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    for m in bench["per_layer"]:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in bench["workloads"]:
        assert (ROOT / "benchmark" / "workloads" / f"{w['traffic']}.json").exists()
        assert (ROOT / "benchmark" / "limits" / f"{w['name']}.json").exists()


def _copy(tmp_path: Path) -> Path:
    """BENCHMARK.json and the benchmark's folder, with the program beside
    them as a link."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def test_new_cell_metric_and_traffic_are_found_by_name(tmp_path):
    root = _copy(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    config = json.loads((root / "benchmark/configs/bhusie_euler_1080p.json").read_text())
    config["name"] = "tiny_euler"
    config["render"].update(width=40, height=22, max_iterations=90)
    (root / "benchmark/configs/tiny_euler.json").write_text(json.dumps(config))
    traffic = json.loads((root / "benchmark/workloads/orbit.json").read_text())
    traffic["yaw_rate"] = 0.5
    (root / "benchmark/workloads/fast_orbit.json").write_text(json.dumps(traffic))
    shutil.copy(root / "benchmark/limits/euler.orbit.json",
                root / "benchmark/limits/tiny.fast_orbit.json")
    (root / "benchmark/metrics/frames_traced.py").write_text(
        "def read(trace):\n    return float(trace.units)\n")
    bench["configs"].append(dict(name="tiny_euler", source="https://example.org/tiny",
                                 file="benchmark/configs/tiny_euler.json", reduced=["width"],
                                 why="a throwaway"))
    bench["workloads"].append(dict(name="tiny.fast_orbit", config="tiny_euler",
                                   traffic="fast_orbit", chips=1, why="a throwaway"))
    bench["per_layer"].append(dict(name="frames_traced", unit="frames", better="higher",
                                   source="device_trace", layer="device (H100)",
                                   moves="frame_p95_ms", workloads=["tiny.fast_orbit"]))
    for m in bench["end_to_end"]:
        if "workloads" in m and "euler.orbit" in m["workloads"]:
            m["workloads"].append("tiny.fast_orbit")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load("tiny.fast_orbit", root)
    assert cell.config["render"]["width"] == 40 and cell.traffic["yaw_rate"] == 0.5
    assert "frames_traced" in cell.per_layer and "frame_p95_ms" in cell.end_to_end
    result = harness.run_cell("tiny.fast_orbit", 9, 0.2, False, device="cpu", root=root)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"frame_p95_ms", "setup_s"}
    read = tracing.reader("frames_traced", root / "benchmark" / "metrics")
    assert read(tracing.Trace(device=[], host=[], lo=0, hi=1, units=3, info={})) == 3.0


def _run(root: Path, cwd: Path):
    return subprocess.run(
        [sys.executable, str(root / "benchmark" / "run.py"), "--workload", "euler.orbit",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=_env(), capture_output=True, text=True, timeout=300)


def test_no_card_no_result(card_absent):
    out = _run(ROOT, ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    root = _copy(tmp_path)
    out = _run(root, root)
    assert out.returncode != 0 and out.stdout.strip() == ""

