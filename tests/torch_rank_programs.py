"""Rank programs for ``bhx_torch.parallel.spawn`` in the tests: a rank that
fails, one that dies, one that hangs, and one that lists what its process
imported.  This module imports no jax and no bhx, so the ranks that load
it stay free of both."""

from __future__ import annotations

import os
import sys
import time


def foreign_modules(mesh):
    """The modules of jax or bhx this rank's process has imported."""
    return sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "bhx"))


def rank_one_raises(mesh):
    if mesh.rank == 1:
        raise ValueError("rank one failed on purpose")
    return mesh.rank


def rank_one_dies(mesh):
    if mesh.rank == 1:
        os._exit(3)
    return mesh.rank


def rank_one_hangs(mesh):
    if mesh.rank == 1:
        time.sleep(3600)
    return mesh.rank
