"""Hand-written CUDA kernels and their plain torch versions: the geodesic
march (Euler, RK45 and Kerr instantiations), the disk shade + composite
and its ingredients variant, the sky finalize on record rows and on an
interleaved record, and the mesh intersection (whose plain version is
``bhx_torch.geometry.traverse``).  Each wrapper counts its launches, by
kernel name, in its module's ``launches`` dict; :func:`launch_counts`
reads them all.  Each wrapper but the mesh's is a
``torch.autograd.Function`` whose backward replays the plain version under
autograd; those replays are counted in the modules' ``replays`` dicts, by
the same names (:func:`replay_counts`).  :func:`reset_launch_counts`
zeroes both."""

from __future__ import annotations

from typing import Dict

from bhx_torch.kernels import march, mesh, shade, sky

_MODULES = (march, shade, sky, mesh)


def launch_counts() -> Dict[str, int]:
    """Kernel launches by kernel name since the last reset."""
    return {name: c for m in _MODULES for name, c in m.launches.items()}


def replay_counts() -> Dict[str, int]:
    """Backward replays by kernel name since the last reset."""
    return {name: c for m in _MODULES for name, c in m.replays.items()}


def reset_launch_counts() -> None:
    """Zero the launch and the replay counts."""
    for m in _MODULES:
        for counts in (m.launches, m.replays):
            for name in counts:
                counts[name] = 0
