"""The mesh kernel M1's wrapper (``csrc/mesh.cu``).

Its plain version is ``bhx_torch.geometry.traverse.intersect_meshes_torch``
(``intersect_mesh_torch`` for one mesh): the reference's lockstep BVH
traversal and chunked brute force (``bhx/geometry/traverse.py:98-234``, jnp;
no Pallas kernel) and its nearest-hit merge (``:58-86``).  One launch tests
a batch of rays against up to MAX_MESHES meshes, each by brute force up to
BRUTE_FORCE_THRESHOLD triangles and through its BVH above it, and merges
their hits in place; a scene with more meshes takes further launches, each
carrying the merged hit of the ones before it.  A BVH mesh is walked in a
packed layout (:func:`pack`), built by torch on the mesh's device at the
mesh's first launch and cached beside it.  There is no backward: the
tracer detaches mesh hits.
"""

from __future__ import annotations

import ctypes
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from bhx_torch.geometry.intersect import MISS_T, diffuse_light
from bhx_torch.kernels import build
from bhx_torch.scene import MESH_INDEX_FIELDS

BRUTE_FORCE_THRESHOLD = 512
# Meshes a launch takes, and brute-force triangles a launch stages in shared
# memory (csrc/mesh.cu kMaxMeshes, kStageMax).
MAX_MESHES = 8
STAGE_MAX = 1024
# Output rows of the kernel: t, hit, color rgb, normal xyz.
OUT_ROWS = 8
# Launch flags (csrc/mesh.cu): merge (visible read, the diffuse factor on
# the last launch), last.
_MERGE, _LAST = 1, 2

launches = {"mesh": 0}
# No backward, so nothing replays.
replays: Dict[str, int] = {}

_FLOAT_FIELDS = ("points", "normals", "node_min", "node_max", "position")
_RAY_ROWS = ("px", "py", "pz", "dx", "dy", "dz")


def pack(mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's layout of ``mesh``'s BVH, by plain torch on the mesh's
    device (no host sync): (nodes, (B + 1, 8) int32: a zero record, then
    node i's record min xyz, left, max xyz, count, floats as their bits, so
    that node i's children, records left + 1 and left + 2, are one aligned
    64-byte read; triangles, (T, 12) int32 in leaf order: row k holds
    triangle lookup[k]'s three vertices in local coordinates, as bits, its
    index, and two zeros)."""
    bits = lambda t: t.view(torch.int32)  # noqa: E731
    nodes = torch.cat([bits(mesh.node_min), mesh.node_left[:, None],
                       bits(mesh.node_max), mesh.node_count[:, None]], dim=1)
    nodes = torch.cat([nodes.new_zeros((1, 8)), nodes])
    verts = bits(mesh.points)[mesh.tri_points[mesh.lookup.long()].long()].reshape(-1, 9)
    tris = torch.cat([verts, mesh.lookup[:, None], verts.new_zeros((verts.shape[0], 2))],
                     dim=1)
    return nodes.contiguous(), tris.contiguous()


# id(mesh.lookup) -> (weak references to the packing's sources and their
# versions, the packing); an entry goes when its lookup tensor does.
_packed: Dict[int, tuple] = {}
_PACK_SOURCES = ("node_min", "node_max", "node_left", "node_count", "lookup", "points",
                 "tri_points")


def packed(mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`pack` of ``mesh``, made once and kept while its source tensors
    are the same objects, unmodified in place (their version counters): a
    mesh moved or replaced field by field keeps its packing as long as the
    BVH's tensors stay, and no lookup needs the host to wait."""
    sources = [getattr(mesh, f) for f in _PACK_SOURCES]
    key = id(mesh.lookup)
    entry = _packed.get(key)
    if entry is not None and all(ref() is t and version == t._version
                                 for (ref, version), t in zip(entry[0], sources)):
        return entry[1]
    value = pack(mesh)
    if entry is None:
        weakref.finalize(mesh.lookup, _packed.pop, key, None)
    _packed[key] = ([(weakref.ref(t), t._version) for t in sources], value)
    return value


def launch_groups(meshes: Sequence) -> List[List]:
    """``meshes`` in order, cut into launches of at most MAX_MESHES meshes
    and STAGE_MAX brute-force triangles each."""
    groups: List[List] = []
    staged = 0
    for mesh in meshes:
        brute = mesh.num_triangles if mesh.num_triangles <= BRUTE_FORCE_THRESHOLD else 0
        if not groups or len(groups[-1]) == MAX_MESHES or staged + brute > STAGE_MAX:
            groups.append([])
            staged = 0
        groups[-1].append(mesh)
        staged += brute
    return groups


def _descriptor(mesh) -> List[int]:
    """A mesh's kMeshFields int64 of the kernel's ``meshes`` argument."""
    brute = mesh.num_triangles <= BRUTE_FORCE_THRESHOLD
    nodes, tris = (0, 0) if brute else (t.data_ptr() for t in packed(mesh))
    return [nodes, tris, *(getattr(mesh, f).data_ptr() for f in (
        "points", "normals", "tri_points", "tri_normals", "position", "visible")),
        mesh.num_triangles, int(brute)]


def _check(rows, meshes, active) -> None:
    n, dev = rows[0].shape[0], rows[0].device
    for name, t in zip(_RAY_ROWS, rows):
        if (t.device.type != "cuda" or t.device != dev or t.dtype != torch.float32
                or t.dim() != 1 or t.shape[0] != n):
            raise ValueError(f"{name}: expected a float32 ({n},) row on the card's {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if active is not None and (active.dtype != torch.bool or tuple(active.shape) != (n,)
                               or active.device != dev or not active.is_contiguous()):
        raise ValueError(f"active: expected a contiguous bool ({n},) tensor on {dev}")
    for mesh in meshes:
        for names, dtype in ((_FLOAT_FIELDS, torch.float32), (MESH_INDEX_FIELDS, torch.int32)):
            for name in names:
                t = getattr(mesh, name)
                if t.device != dev or t.dtype != dtype or not t.is_contiguous():
                    raise ValueError(f"mesh.{name}: expected a contiguous {dtype} tensor "
                                     f"on {dev}, got {t.dtype} on {t.device}")
        if (mesh.visible.device != dev or mesh.visible.dtype != torch.bool
                or mesh.visible.dim() != 0):
            raise ValueError(f"mesh.visible: expected a () bool tensor on {dev}, got "
                             f"{mesh.visible.dtype} {tuple(mesh.visible.shape)} on "
                             f"{mesh.visible.device}")


def intersect_meshes_cuda(origin: Sequence[torch.Tensor], direction: Sequence[torch.Tensor],
                          meshes: Sequence, active: Optional[torch.Tensor] = None,
                          merge: bool = True) -> Dict[str, torch.Tensor]:
    """Nearest hit of each ray across ``meshes`` by the kernel, on the
    current stream, with no host sync.  ``origin`` and ``direction``: three
    float32 (N,) rows each, of any stride (the tracer's state rows, or the
    columns of an (N, 3) tensor); ``active`` (optional (N,) bool): inactive
    lanes return a miss.  With ``merge``, the rules of
    ``traverse.intersect_meshes``: a hidden mesh never hits, an earlier mesh
    wins a tie, the winner's color takes the diffuse factor; without it (one
    mesh), ``intersect_mesh``'s hit.  Returns t (N,), hit (N,), color (N,
    3), normal (N, 3)."""
    rows = (*origin, *direction)
    if len(rows) != len(_RAY_ROWS):
        raise ValueError("origin and direction: three rows each")
    _check(rows, meshes, active)
    n, dev = rows[0].shape[0], rows[0].device
    out = torch.empty((OUT_ROWS, n), dtype=torch.float32, device=dev)
    groups = launch_groups(meshes)
    if not n or not groups:
        out[0].fill_(MISS_T)
        out[1:].zero_()
    else:
        # The queue of active lanes and its length, made by the first launch.
        queue, counters = ((torch.empty((n,), dtype=torch.int32, device=dev),
                            torch.zeros((1,), dtype=torch.int32, device=dev))
                           if active is not None else (None, None))
        light = diffuse_light(dev) if merge else None
        ray_args = (ctypes.c_int64 * 12)(*(r.data_ptr() for r in rows),
                                         *(r.stride(0) for r in rows))
        for g, group in enumerate(groups):
            fields = [v for mesh in group for v in _descriptor(mesh)]
            flags = (_MERGE if merge else 0) | (_LAST if g == len(groups) - 1 else 0)
            build.launch("bhx_mesh", ray_args, active, queue, counters, g,
                         (ctypes.c_int64 * len(fields))(*fields), len(group), light, out, n,
                         flags)
            launches["mesh"] += 1
    return dict(t=out[0], hit=out[1] > 0.5, color=out[2:5].t(), normal=out[5:8].t())


def intersect_mesh_cuda(origin: torch.Tensor, direction: torch.Tensor, mesh,
                        active: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Nearest hit of each ray against one mesh by the kernel (one launch,
    no merge).  ``origin``/``direction`` (N, 3) float32 and ``active``
    (optional (N,) bool) on the card; returns t (N,), hit (N,), color (N,
    3), normal (N, 3), as the plain ``intersect_mesh_torch``."""
    for name, t in (("origin", origin), ("direction", direction)):
        if t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name}: expected (N, 3), got {tuple(t.shape)}")
    return intersect_meshes_cuda(origin.unbind(1), direction.unbind(1), [mesh], active,
                                 merge=False)
