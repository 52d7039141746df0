"""Sky finalize: plain torch version and the CUDA kernel's wrapper.

Counterpart of ``bhx/kernels/shade_pallas.py``: ``_sky_rows_kernel``
(:595-619) and its jnp mirror ``_sky_rows_jnp`` (:653-659).  The 8 record
rows (cr cg cb alpha amount dx dy dz) become 3 rgb rows: the procedural
sky radiance of the escape direction, weighted by the residual
transmission ``amount`` where ``amount > 0.001``, added to the color.
"""

from __future__ import annotations

import torch

from bhx_torch.kernels import build
from bhx_torch.kernels.shade import tint_table
from bhx_torch.procedural import sky_radiance_channels
from bhx_torch.shading import sky_uv

RECORD_ROWS = 8

launches = 0


def sky_rows_torch(rows, show_sky: bool = True) -> torch.Tensor:
    """Plain torch sky finalize: 8 record rows -> (3, N)."""
    cr, cg, cb, _, amount, dx, dy, dz = rows
    if not show_sky:
        return torch.stack([cr, cg, cb])
    w = torch.where(amount > 0.001, amount, 0.0)
    sr, sg, sb = sky_radiance_channels(*sky_uv(dx, dy, dz))
    return torch.stack([cr + w * sr, cg + w * sg, cb + w * sb])


def sky_rows(rows: torch.Tensor, show_sky: bool = True) -> torch.Tensor:
    """Sky finalize: the plain version for CPU tensors, the CUDA kernel
    (``csrc/sky.cu``) for CUDA tensors.  ``rows`` is (8, N)."""
    if rows.device.type == "cpu":
        return sky_rows_torch(rows, show_sky)
    build.check_rows(rows, RECORD_ROWS, "rows")
    n = rows.shape[1]
    out = torch.empty((3, n), dtype=torch.float32, device=rows.device)
    if n:
        global launches
        build.launch("bhx_sky", rows, tint_table(rows.device), out, n,
                     int(show_sky))
        launches += 1
    return out
