"""The mesh kernel M1's wrapper (``csrc/mesh.cu``).

Its plain version is ``bhx_torch.geometry.traverse.intersect_mesh_torch``:
the reference's lockstep BVH traversal and chunked brute force
(``bhx/geometry/traverse.py:98-234``, jnp; no Pallas kernel).  One launch
tests a batch of rays against one mesh, by brute force up to
BRUTE_FORCE_THRESHOLD triangles and through the BVH above it.  There is no
backward: the tracer detaches mesh hits.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from bhx_torch.kernels import build
from bhx_torch.scene import MESH_INDEX_FIELDS

BRUTE_FORCE_THRESHOLD = 512
# Output rows of the kernel: t, hit, color rgb, normal xyz.
OUT_ROWS = 8

launches = {"mesh": 0}
# No backward, so nothing replays.
replays: Dict[str, int] = {}

_FLOAT_FIELDS = ("points", "normals", "node_min", "node_max", "position")


def _check(origin, direction, mesh, active) -> None:
    dev = origin.device
    for name, t in (("origin", origin), ("direction", direction)):
        if (t.device.type != "cuda" or t.dtype != torch.float32 or t.dim() != 2
                or t.shape[1] != 3 or not t.is_contiguous()):
            raise ValueError(f"{name}: expected a contiguous float32 (N, 3) CUDA tensor, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if direction.shape != origin.shape or direction.device != dev:
        raise ValueError("origin and direction must match in shape and device")
    if active is not None and (active.dtype != torch.bool or tuple(active.shape)
                               != (origin.shape[0],) or active.device != dev
                               or not active.is_contiguous()):
        raise ValueError(f"active: expected a contiguous bool ({origin.shape[0]},) "
                         f"tensor on {dev}")
    for names, dtype in ((_FLOAT_FIELDS, torch.float32), (MESH_INDEX_FIELDS, torch.int32)):
        for name in names:
            t = getattr(mesh, name)
            if t.device != dev or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"mesh.{name}: expected a contiguous {dtype} tensor on "
                                 f"{dev}, got {t.dtype} on {t.device}")


def intersect_mesh_cuda(origin: torch.Tensor, direction: torch.Tensor, mesh,
                        active: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Nearest hit of each ray against ``mesh`` by the kernel, in one
    launch on the current stream.  ``origin``/``direction`` (N, 3) float32
    and ``active`` (optional (N,) bool) on the card; returns t (N,), hit
    (N,), color (N, 3), normal (N, 3), as the plain version."""
    _check(origin, direction, mesh, active)
    n = origin.shape[0]
    out = torch.empty((OUT_ROWS, n), dtype=torch.float32, device=origin.device)
    if n:
        build.launch("bhx_mesh", origin, direction, active, mesh.points, mesh.normals,
                     mesh.tri_points, mesh.tri_normals, mesh.node_min, mesh.node_max,
                     mesh.node_left, mesh.node_count, mesh.lookup, mesh.position, out, n,
                     mesh.num_triangles, int(mesh.num_triangles <= BRUTE_FORCE_THRESHOLD))
        launches["mesh"] += 1
    return dict(t=out[0], hit=out[1] > 0.5, color=out[2:5].t(), normal=out[5:8].t())
