"""Hand-written CUDA kernels of the main path and their plain torch
versions: the geodesic march, the disk shade + composite and the sky
finalize.  Each wrapper counts its launches in a module-level integer
``launches``; :func:`launch_counts` reads them, :func:`reset_launch_counts`
zeroes them."""

from __future__ import annotations

from typing import Dict

from bhx_torch.kernels import march, shade, sky

_MODULES = {"march": march, "composite": shade, "sky": sky}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: m.launches for name, m in _MODULES.items()}


def reset_launch_counts() -> None:
    for m in _MODULES.values():
        m.launches = 0
