"""Shared fixtures of the benchmark's tests.  Whether there is a CUDA card
is decided inside fixtures, never while a module is imported."""

import json
import shutil

import pytest

TINY = dict(width=48, height=27, max_iterations=150)


def scratch_root(path, configs=(), workloads=(), files=None):
    """A checkout's data under ``path``: this benchmark's ``BENCHMARK.json``
    with ``configs`` and ``workloads`` entries added, its configuration,
    traffic and limit files, and ``files`` (relative path: JSON object)
    written beside them.  ``harness.run_cell(..., root=path)`` runs its
    cells with the benchmark's own code."""
    from benchmark import spec

    bench = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    bench["configs"] += list(configs)
    bench["workloads"] += list(workloads)
    (path / "BENCHMARK.json").write_text(json.dumps(bench))
    for sub in ("configs", "workloads", "limits"):
        shutil.copytree(spec.HERE / sub, path / "benchmark" / sub)
    for rel, obj in (files or {}).items():
        (path / rel).write_text(json.dumps(obj))
    return path


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.fixture
def card_absent():
    """Skips the test where a CUDA card is present."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
