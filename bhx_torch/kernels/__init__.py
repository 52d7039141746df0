"""Hand-written CUDA kernels and their plain torch versions: the geodesic
march (Euler, RK45 and Kerr instantiations), the disk shade + composite
and its ingredients variant, the sky finalize on record rows and on an
interleaved record, and the mesh intersection (whose plain version is
``bhx_torch.geometry.traverse``).  Each wrapper counts its launches, by
kernel name, in its module's ``launches`` dict; :func:`launch_counts`
reads them all.  Each wrapper but the mesh's is a
``torch.autograd.Function`` whose backward replays the plain version under
autograd (the march's on the card under Euler runs its adjoint kernel
instead, whose launches ``march.adjoints`` counts); those backward passes
are counted in the modules' ``replays`` dicts, by the same names
(:func:`replay_counts`).  :func:`reset_launch_counts` zeroes them all."""

from __future__ import annotations

from typing import Dict

from bhx_torch.kernels import march, mesh, shade, sky

_MODULES = (march, shade, sky, mesh)


def launch_counts() -> Dict[str, int]:
    """Kernel launches by kernel name since the last reset."""
    return {name: c for m in _MODULES for name, c in m.launches.items()}


def add_launch_counts(counts: Dict[str, int]) -> None:
    """Add ``counts`` (kernel name -> launches) to the launch counts: the
    launches of a CUDA graph's replay, which no wrapper call counts."""
    for m in _MODULES:
        for name in m.launches.keys() & counts.keys():
            m.launches[name] += counts[name]


def replay_counts() -> Dict[str, int]:
    """Backward replays by kernel name since the last reset."""
    return {name: c for m in _MODULES for name, c in m.replays.items()}


def reset_launch_counts() -> None:
    """Zero the launch, replay and adjoint counts."""
    for m in _MODULES:
        for counts in (m.launches, m.replays, getattr(m, "adjoints", {})):
            for name in counts:
                counts[name] = 0
