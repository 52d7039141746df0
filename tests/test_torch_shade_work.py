"""The composite's work and bound (``bhx_torch.checks.composite_work`` and
``composite_bound``) against a direct numpy count on hand-made slots:
valid patterns that are not a prefix, runs of crossing rays, and sizes
that are not a multiple of a warp or a block, one ray and none."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bhx_torch import checks
from bhx_torch.config import RenderConfig
from bhx_torch.kernels import shade
from bhx_torch.kernels.march import CROSS_FIELDS, MAX_CROSSINGS, SLOT_ROWS


def _slots(n: int, seed: int, pattern: str) -> np.ndarray:
    """(SLOT_ROWS, n) slots with random geometry and valid rows by
    ``pattern``: "random" (each slot alone, slot 0 often invalid behind a
    valid later slot), "runs" (crossing rays in runs, as a frame has
    them), "later_only" (slot 0 never valid)."""
    rng = np.random.default_rng(seed)
    slots = rng.uniform(-9, 9, (SLOT_ROWS, n)).astype(np.float32)
    if pattern == "runs":
        ray = np.zeros(n, bool)
        for start in rng.integers(0, max(n, 1), 6):
            ray[start:start + rng.integers(1, 120)] = True
        valid = np.stack([ray & (rng.uniform(size=n) < p) for p in (1.0, 0.3, 0.1, 0.02)])
    else:
        valid = rng.uniform(size=(MAX_CROSSINGS, n)) < np.array([[0.3], [0.4], [0.2], [0.1]])
        if pattern == "later_only":
            valid[0] = False
    # Valid rows as the march writes them (0 or 1), and a few values at the
    # threshold itself, which are not valid.
    slots[CROSS_FIELDS - 1::CROSS_FIELDS] = valid.astype(np.float32)
    slots[CROSS_FIELDS - 1::CROSS_FIELDS][~valid & (rng.uniform(size=valid.shape) < 0.05)] = 0.5
    return slots


def _direct(slots: np.ndarray, block: int = 256) -> dict:
    """The work counted ray by ray, warp by warp and block by block (of
    the composite kernel's 256 rays)."""
    valid = slots[CROSS_FIELDS - 1::CROSS_FIELDS] > 0.5
    n = valid.shape[1]
    v = int(valid.sum())
    warp_slots = sum(bool(valid[k, w:w + 32].any())
                     for k in range(MAX_CROSSINGS) for w in range(0, n, 32))
    block_warps = sum(-(-int(valid[:, b:b + block].sum()) // 32) for b in range(0, n, block))
    return dict(n=n, v=v, v_by_k=[int(x) for x in valid.sum(1)],
                r=int(valid.any(0).sum()),
                simt_eff=v / (32.0 * warp_slots) if v else None,
                packed_eff=v / (32.0 * block_warps) if v else None)


@pytest.mark.parametrize("pattern", ["random", "runs", "later_only"])
@pytest.mark.parametrize("n", [0, 1, 31, 255, 257, 1000])
def test_composite_work_matches_direct_count(n, pattern):
    slots = _slots(n, seed=n + len(pattern), pattern=pattern)
    got = checks.composite_work(torch.from_numpy(slots))
    want = _direct(slots)
    assert {k: got[k] for k in ("n", "v", "v_by_k", "r")} == {
        k: want[k] for k in ("n", "v", "v_by_k", "r")}
    for key in ("simt_eff", "packed_eff"):
        if want[key] is None:
            assert got[key] is None
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-12)
            assert 0.0 < got[key] <= 1.0
    if want["v"]:
        # Packing per block never issues more warps than a thread per ray.
        assert got["packed_eff"] >= got["simt_eff"]


def test_composite_work_packs_a_block_of_one_slot_each():
    """One valid slot in every fourth warp: one thread per ray issues a
    whole warp for each, packing per block of 256 rays one warp a block."""
    slots = np.zeros((SLOT_ROWS, 1024), np.float32)
    slots[CROSS_FIELDS - 1, ::128] = 1.0
    got = checks.composite_work(torch.from_numpy(slots))
    assert (got["v"], got["r"]) == (8, 8)
    assert got["simt_eff"] == pytest.approx(1 / 32)
    assert got["packed_eff"] == pytest.approx(2 / 32)


@pytest.mark.parametrize("show_texture", [True, False])
@pytest.mark.parametrize("show_redshift", [True, False])
def test_shade_of_no_ray(show_texture, show_redshift):
    """The plain composite and ingredients, and their wrappers, on a batch
    of no ray: empty rows, no launch (the gain fetch once reshaped an empty
    batch to (0, -1), which torch refuses)."""
    slots, cam = torch.zeros((SLOT_ROWS, 0)), torch.zeros((0,))
    params, gain = torch.zeros((shade.NUM_SHADE_PARAMS,)), torch.ones((16, 16, 4))
    flags = dict(show_texture=show_texture, show_redshift=show_redshift)
    before = dict(shade.launches)
    assert tuple(shade.composite(slots, cam, params, gain, **flags).shape) == (4, 0)
    assert tuple(shade.ingredients(slots, cam, params, **flags).shape) == (SLOT_ROWS, 0)
    assert shade.launches == before


@pytest.mark.parametrize("show_texture", [True, False])
@pytest.mark.parametrize("show_redshift", [True, False])
def test_composite_bound_is_the_closed_form(show_texture, show_redshift):
    """4 (8n + 5v + r) bytes: every slot's valid row of every ray read and
    4 rows written, five geometry rows a valid slot, the camera distance
    once a ray with a valid slot, also when slot 0 is invalid and a later
    one valid; v (slot ops + COMPOSITE_OPS) operations."""
    slots = _slots(777, seed=3, pattern="later_only")
    w = _direct(slots)
    assert w["v_by_k"][0] == 0 and w["r"] > 0
    cfg = RenderConfig(show_disk_texture=show_texture, show_redshift=show_redshift)
    got = checks.composite_bound(torch.from_numpy(slots), cfg)
    nbytes = 4.0 * (8 * w["n"] + 5 * w["v"] + w["r"])
    ops = w["v"] * (checks.SLOT_OD_OPS + checks.SLOT_TEXTURE_OPS * show_texture
                    + checks.SLOT_REDSHIFT_OPS * show_redshift + checks.COMPOSITE_OPS)
    assert got["bytes_ms"] == pytest.approx(nbytes / checks.PEAK_BYTES_PER_S * 1e3, rel=1e-12)
    assert got["ops_ms"] == pytest.approx(ops / checks.PEAK_F32_OPS * 1e3, rel=1e-12)
    assert got["bound_ms"] == max(got["bytes_ms"], got["ops_ms"])
    assert got["bound_by"] == ("bytes" if got["bytes_ms"] >= got["ops_ms"] else "operations")
