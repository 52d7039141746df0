"""The least time the card could take for a march: the program's bound
arithmetic (``bhx_torch.checks.bound`` and ``march_work``), with its
operation tables and ceilings, frozen here so that a later change to the
program cannot move it.

A march launch needs ``steps`` lane-substeps, each SUBSTEP_OPS float
operations of which SUBSTEP_MUFU run on the special-function unit (rsqrt,
sqrt, division), counted by hand from the substep of its branch with the
disk branch on: Euler 22 (relative position, angular momentum, r^2) + 32
(step) + 12 (horizon) + 29 (disk plane) + 11 (advance, closest, budget) =
106, 4 on the special-function unit; RK45 22 + 303 (six forces at 18,
stage sums 105, the 4th/5th-order sums and error 51, controller 17,
direction and position 22) + 12 + 29 + 11 = 377, 12; Kerr 3 (relative
position) + 4 x 190 (a right-hand side: Kerr-Schild scalars 34,
null-vector product 7, dx 6, three dH/dx at 47 and 2 arguments) + 119
(step size 7, stage sums 79, chord 17, capture radius 16) + 29 + 11 = 922,
4 x 36 + 6 = 150.  Its bytes: each live ray's state read once (10 float32
rows, 13 with Kerr's momentum) and its record written once (13 fixed rows
and 4 slots of 7, and Kerr's momentum: 41 or 44 rows).
"""

from __future__ import annotations

from typing import Dict

# By the march's branch: the integrator under the pseudo-Newtonian force,
# or "kerr".
SUBSTEP_OPS = {"euler": 106, "rk45": 377, "kerr": 3 + 4 * 190 + 119 + 29 + 11}
SUBSTEP_MUFU = {"euler": 4, "rk45": 12, "kerr": 4 * 36 + 6}
RAY_BYTES = {"euler": (10 + 13 + 4 * 7) * 4, "rk45": (10 + 13 + 4 * 7) * 4,
             "kerr": (13 + 13 + 4 * 7 + 3) * 4}

# NVIDIA H100 SXM (data sheet, 700 W).  Its 67 TFLOP/s of float32 outside
# the tensor cores counts a fused multiply-add as two operations; the
# kernels are built with --fmad=false, so each add and multiply takes an
# issue slot alone, at half that rate: 128 a clock on each of 132 SMs at
# the 1980 MHz boost clock (33.45 T/s).  The special-function unit gives
# 16 results a clock an SM; HBM3 moves 3.35 TB/s.
PEAK_F32_OPS = 132 * 128 * 1.98e9
PEAK_MUFU_PER_S = 132 * 16 * 1.98e9
PEAK_BYTES_PER_S = 3.35e12


def bound(ops: float, nbytes: float, mufu: float = 0.0) -> Dict:
    """The largest of ``ops`` float32 operations at PEAK_F32_OPS, ``mufu``
    of them at PEAK_MUFU_PER_S and ``nbytes`` at PEAK_BYTES_PER_S, in ms,
    with the ceiling that sets it."""
    ceilings = {"float32": ops / PEAK_F32_OPS * 1e3,
                "special-function": mufu / PEAK_MUFU_PER_S * 1e3,
                "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    ceiling = max(ceilings, key=ceilings.get)
    return dict(bound_ms=ceilings[ceiling], bound_ceiling=ceiling)


def march_branch(render) -> str:
    """The march's branch of a configuration's ``render`` group: "kerr"
    under exact Kerr geodesics, else the integrator."""
    return "kerr" if render.get("geodesics", "pseudo") == "kerr" else render["integrator"]


def march_bound_ms(branch: str, live: float, steps: float) -> float:
    """The bound of one march launch of the branch ``branch`` (see
    :func:`march_branch`) over ``live`` rays that take ``steps``
    lane-substeps in all."""
    return bound(steps * SUBSTEP_OPS[branch], live * RAY_BYTES[branch],
                 steps * SUBSTEP_MUFU[branch])["bound_ms"]
