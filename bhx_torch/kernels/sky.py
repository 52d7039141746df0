"""Sky finalize: plain torch versions and the CUDA kernel's wrappers.

Counterpart of ``bhx/kernels/shade_pallas.py``: ``_sky_rows_kernel``
(:595-619) and its jnp mirror ``_sky_rows_jnp`` (:653-659), and
``_sky_kernel`` (:686-707) with its jnp mirror ``_sky_finalize_jnp``
(:740-750).  The 8 record rows (cr cg cb alpha amount dx dy dz) become 3
rgb rows: the procedural sky radiance of the escape direction, weighted
by the residual transmission ``amount`` where ``amount > 0.001``, added
to the color.  ``sky_finalize`` does the same on an interleaved
(..., 8) record, giving (..., 3).
"""

from __future__ import annotations

import torch

from bhx_torch.kernels import build, entries
from bhx_torch.kernels.shade import tint_table
from bhx_torch.procedural import sky_radiance_channels
from bhx_torch.profiling import REPLAY_SKY, REPLAY_SKY_FINALIZE, span
from bhx_torch.shading import sky_uv

RECORD_ROWS = 8

entries.declare(("sky", "sky_finalize"), entries.LAUNCH, entries.REPLAY)


def sky_rows_torch(rows, show_sky: bool = True) -> torch.Tensor:
    """Plain torch sky finalize: 8 record rows -> (3, N)."""
    return _sky_rows(rows, show_sky)


def _sky_rows(rows, show_sky: bool) -> torch.Tensor:
    cr, cg, cb, _, amount, dx, dy, dz = rows
    if not show_sky:
        return torch.stack([cr, cg, cb])
    w = torch.where(amount > 0.001, amount, 0.0)
    sr, sg, sb = sky_radiance_channels(*sky_uv(dx, dy, dz))
    return torch.stack([cr + w * sr, cg + w * sg, cb + w * sb])


def sky_rows_replay(rows, grad_out, show_sky: bool = True) -> torch.Tensor:
    """The sky's vector-Jacobian product: the cotangent of the (8, N)
    ``rows`` for the cotangent ``grad_out`` of its (3, N) output."""
    with span(REPLAY_SKY):
        return entries.replay("sky", _sky_rows, (rows,), grad_out, show_sky=show_sky)[0]


def _sky_rows_cuda(rows: torch.Tensor, *, show_sky: bool) -> torch.Tensor:
    build.check_rows(rows, RECORD_ROWS, "rows")
    n = rows.shape[1]
    out = torch.empty((3, n), dtype=torch.float32, device=rows.device)
    if n:
        build.launch("bhx_sky", rows, tint_table(rows.device), out, n,
                     int(show_sky))
        entries.count(entries.LAUNCH, "sky")
    return out


# The sky on record rows with :func:`sky_rows_replay` as its backward
# (``shade_pallas.sky_finalize_rows``).
_SKY_ROWS = entries.Entry(sky_rows_torch, _sky_rows_cuda, sky_rows_replay)


def sky_rows(rows: torch.Tensor, show_sky: bool = True) -> torch.Tensor:
    """Sky finalize: the plain version for CPU tensors, the CUDA kernel
    (``csrc/sky.cu``) for CUDA tensors.  ``rows`` is (8, N).
    Differentiable: the backward is :func:`sky_rows_replay`."""
    return _SKY_ROWS(rows, show_sky=show_sky)


def sky_finalize_torch(record: torch.Tensor, show_sky: bool = True) -> torch.Tensor:
    """Plain torch sky finalize of an interleaved record: (..., 8) -> (..., 3)."""
    return _sky_interleaved(record, show_sky)


def _sky_interleaved(record: torch.Tensor, show_sky: bool) -> torch.Tensor:
    rows = record.reshape(-1, RECORD_ROWS).t().contiguous()
    rgb = _sky_rows(rows, show_sky).t()
    return rgb.reshape(record.shape[:-1] + (3,))


def sky_finalize_replay(record, grad_out, show_sky: bool = True) -> torch.Tensor:
    """The interleaved sky's vector-Jacobian product: the cotangent of the
    (..., 8) ``record`` for the cotangent ``grad_out`` of its (..., 3)
    output."""
    with span(REPLAY_SKY_FINALIZE):
        return entries.replay("sky_finalize", _sky_interleaved, (record,), grad_out,
                              show_sky=show_sky)[0]


def _sky_finalize_cuda(record: torch.Tensor, *, show_sky: bool) -> torch.Tensor:
    if (record.dtype != torch.float32 or record.dim() < 1
            or record.shape[-1] != RECORD_ROWS or not record.is_contiguous()):
        raise ValueError(
            f"record: expected a contiguous float32 (..., {RECORD_ROWS}) tensor, "
            f"got {record.dtype} {tuple(record.shape)}"
        )
    n = record.numel() // RECORD_ROWS
    out = torch.empty(record.shape[:-1] + (3,), dtype=torch.float32,
                      device=record.device)
    if n:
        build.launch("bhx_sky_finalize", record, tint_table(record.device), out, n,
                     int(show_sky))
        entries.count(entries.LAUNCH, "sky_finalize")
    return out


# The interleaved sky with :func:`sky_finalize_replay` as its backward
# (``shade_pallas.sky_finalize``).
_SKY_FINALIZE = entries.Entry(sky_finalize_torch, _sky_finalize_cuda, sky_finalize_replay)


def sky_finalize(record: torch.Tensor, show_sky: bool = True) -> torch.Tensor:
    """Sky finalize of an interleaved (..., 8) record: the plain version for
    CPU tensors, the CUDA kernel (``csrc/sky.cu``, its interleaved variant)
    for CUDA tensors.  Differentiable: the backward is
    :func:`sky_finalize_replay`."""
    return _SKY_FINALIZE(record, show_sky=show_sky)
