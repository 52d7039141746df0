"""Hand-written CUDA kernels and their plain torch versions: the geodesic
march (Euler, RK45 and Kerr instantiations) and the Euler march's adjoint,
the disk shade + composite and its ingredients variant, the sky finalize
on record rows and on an interleaved record, and the mesh intersection
(whose plain version is ``bhx_torch.geometry.traverse``).

Every entry but the mesh's is an ``entries.Entry``: the plain version for
CPU tensors, the kernel for CUDA tensors, and a backward that replays the
plain version under autograd (the march's on the card under Euler runs
its adjoint kernel instead).  The counts live in ``entries`` alone, by
kernel name: :func:`launch_counts` (every launch, the mesh kernel's too),
:func:`replay_counts` (backward passes), :func:`adjoint_counts` (calls of
the Euler adjoint), :func:`add_launch_counts` (a CUDA graph's replay) and
:func:`reset_launch_counts`, which zeroes them all."""

from __future__ import annotations

# The kernel modules declare their names to the counts as they are imported.
from bhx_torch.kernels import march, shade, sky, mesh  # noqa: F401
from bhx_torch.kernels.entries import (  # noqa: F401
    add_launch_counts, adjoint_counts, launch_counts, replay_counts, reset_launch_counts,
)
