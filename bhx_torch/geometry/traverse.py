"""Mesh intersection of ray batches: the plain lockstep BVH traversal and
brute force, the plain nearest-hit merge, and the dispatch to the mesh
kernel M1 (counterpart of ``bhx/geometry/traverse.py``).

Mesh tests run only along straight ray segments, outside the relativity
sphere (ray.wgsl:541 vs :556): the tracer calls :func:`intersect_meshes`
once per straight phase.  A mesh of at most BRUTE_FORCE_THRESHOLD
triangles is tested triangle by triangle; a larger one through its BVH.

The plain versions (:func:`intersect_mesh_torch`) keep the reference's
rules: brute force in chunks of 128 triangles, the first index winning a
tie; the BVH walked in lockstep, every lane one node an iteration, with a
per-lane stack of STACK_DEPTH whose pointer is clamped at its last entry,
the near child first (``d1 <= d2``), the far child pushed only if it is
nearer than the best hit, at most LEAF_TESTS triangles tested in a leaf,
and a strict ``t < best_t``.  They work on the lanes that are active and
whose ray meets the root box, gathered once; the loop asks the host each
iteration whether a lane is left.

For a CPU tensor :func:`intersect_mesh` and :func:`intersect_meshes` run
the plain versions (:func:`intersect_mesh_torch`,
:func:`intersect_meshes_torch`); for a CUDA tensor they launch M1
(``bhx_torch.kernels.mesh``), which merges the meshes' hits itself, or
raise.  Results carry no gradient: visibility is discontinuous, and the
tracer detaches them, as ``bhx`` wraps them in ``stop_gradient``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from bhx_torch.geometry.intersect import (MISS_T, det3, diffuse_light, hit_aabb,
                                          hit_triangles)
from bhx_torch.kernels import mesh as mesh_kernel
from bhx_torch.scene import Mesh

# Per-lane traversal stack depth (the reference proves 19 enough for a
# 500k-triangle midpoint BVH, ray.wgsl:293).
STACK_DEPTH = 48
BRUTE_FORCE_THRESHOLD = mesh_kernel.BRUTE_FORCE_THRESHOLD
# Triangles tested in a leaf: the reference's static unroll
# (bhx/geometry/traverse.py:148); a larger leaf's later triangles are never
# tested (ROADMAP C.4).
LEAF_TESTS = 4
_TRI_CHUNK = 128
# Per-lane counts of triangle tests that pass each early exit of M1's test,
# in its order (csrc/mesh.cu:test_triangle): |det|, then the signs of u, v
# and t; a test that passes the last computes the rest of the hit.
EXIT_KEYS = ("passed_det", "passed_u", "passed_v", "passed_t")


def _miss(n: int, like: torch.Tensor) -> Dict[str, torch.Tensor]:
    return dict(t=like.new_full((n,), MISS_T),
                hit=torch.zeros((n,), dtype=torch.bool, device=like.device),
                color=like.new_zeros((n, 3)), normal=like.new_zeros((n, 3)))


def _triangles(mesh: Mesh, world: torch.Tensor, idx: torch.Tensor):
    """World-positioned vertices and vertex normals of triangles ``idx``."""
    p = world[mesh.tri_points[idx].long()]  # (..., 3, 3)
    nrm = mesh.normals[mesh.tri_normals[idx].long()]
    return p[..., 0, :], p[..., 1, :], p[..., 2, :], nrm[..., 0, :], nrm[..., 1, :], nrm[..., 2, :]


def intersect_mesh_torch(origin: torch.Tensor, direction: torch.Tensor, mesh: Mesh,
                         active: Optional[torch.Tensor] = None,
                         work: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
    """Plain nearest hit of each ray against one mesh, on any device.

    ``origin``/``direction``: (N, 3); ``active`` (optional (N,) bool):
    inactive lanes return a miss.  Returns t (N,) (MISS_T on a miss), hit
    (N,), color (N, 3), normal (N, 3).  ``work``, a dict, receives the
    per-lane counts of the run: ``live`` (active lanes), ``inner_visits``,
    ``leaf_visits``, ``tri_tests`` and, of those tests, how many pass each
    early exit of the kernel's test (:data:`EXIT_KEYS`,
    :func:`_exits_passed`), each (N,) int64; and, through the BVH, what of
    the mesh the walk read: ``nodes_read`` (the visited nodes) and
    ``lookup_read`` (the lookup entries tested), bool masks."""
    n = origin.shape[0]
    out = _miss(n, origin)
    lanes = (torch.arange(n, device=origin.device) if active is None
             else active.nonzero().squeeze(1))
    o, d = origin[lanes], direction[lanes]
    counts = {} if work is not None else None
    if mesh.num_triangles <= BRUTE_FORCE_THRESHOLD:
        res, walked = _intersect_brute(o, d, mesh, counts), lanes
    else:
        res, sub = _intersect_bvh(o, d, mesh, counts)
        walked = lanes[sub]
    for k, v in res.items():
        out[k][walked] = v
    if work is not None:
        work["live"] = torch.zeros(n, dtype=torch.int64, device=origin.device)
        work["live"][lanes] = 1
        for k, v in counts.items():
            if k in ("nodes_read", "lookup_read"):
                work[k] = v
                continue
            work[k] = torch.zeros(n, dtype=torch.int64, device=origin.device)
            work[k][walked] = v
    return out


def _exits_passed(origin, direction, p1, p2, p3) -> torch.Tensor:
    """How far M1's triangle test gets (csrc/mesh.cu:test_triangle), as
    hit_triangles' values give it: 0 if |det| < 1e-5, 1, 2 or 3 if the
    sign of u, v or t is then surely negative (their numerator's sign
    differs from det's and the quotient does not round to zero), else 4:
    the test reaches its divisions.  Broadcast as :func:`hit_triangles`."""
    ox, oy, oz = origin.unbind(-1)
    dx, dy, dz = direction.unbind(-1)
    ax, ay, az = p1.unbind(-1)
    bx, by, bz = p2.unbind(-1)
    cx, cy, cz = p3.unbind(-1)
    mbx, mby, mbz = ax - bx, ay - by, az - bz
    mcx, mcy, mcz = ax - cx, ay - cy, az - cz
    mox, moy, moz = ax - ox, ay - oy, az - oz
    denom = det3(dx, dy, dz, mbx, mby, mbz, mcx, mcy, mcz)

    def positive(num):
        return ((num < 0.0) == (denom < 0.0)) | (num.abs() <= denom.abs() * 1e-38)

    ok = denom.abs() >= 1e-5
    passed = ok.long()
    for num in (det3(dx, dy, dz, mox, moy, moz, mcx, mcy, mcz),
                det3(dx, dy, dz, mbx, mby, mbz, mox, moy, moz),
                det3(mox, moy, moz, mbx, mby, mbz, mcx, mcy, mcz)):
        ok = ok & positive(num)
        passed = passed + ok
    return passed


def _count_exits(counts, passed: torch.Tensor, tested: torch.Tensor) -> None:
    """Adds, per lane, the ``tested`` triangle tests (a bool mask that
    broadcasts to ``passed``, (n,) or (n, C)) that pass each early exit;
    ``passed`` is :func:`_exits_passed`'s."""
    for i, k in enumerate(EXIT_KEYS):
        past = tested & (passed > i)
        counts[k] += past.sum(1) if past.dim() > 1 else past


def _intersect_brute(origin, direction, mesh: Mesh, counts) -> Dict[str, torch.Tensor]:
    """Chunks of triangles against every ray, (N, 1, 3) x (1, C, 3); in a
    chunk the first index of the least t wins, across chunks a strictly
    nearer one."""
    ntris, n = mesh.num_triangles, origin.shape[0]
    if counts is not None:
        counts.update(inner_visits=origin.new_zeros(n, dtype=torch.int64),
                      leaf_visits=origin.new_zeros(n, dtype=torch.int64),
                      tri_tests=origin.new_full((n,), ntris, dtype=torch.int64),
                      **{k: origin.new_zeros(n, dtype=torch.int64) for k in EXIT_KEYS})
    best = _miss(n, origin)
    if ntris == 0 or n == 0:
        return best
    world = mesh.points + mesh.position
    chunk = min(_TRI_CHUNK, ntris)
    o, d = origin[:, None, :], direction[:, None, :]
    rows = torch.arange(n, device=origin.device)
    bt, bc, bn = best["t"], best["color"], best["normal"]
    for start in range(0, ntris, chunk):
        # The last chunk wraps around to earlier triangles (as the
        # reference pads); a repeat never wins under the strict "<".
        idx = torch.arange(start, start + chunk, device=origin.device) % ntris
        tri = [x[None] for x in _triangles(mesh, world, idx)]
        t, hit, color, normal = hit_triangles(o, d, *tri)
        if counts is not None:
            _count_exits(counts, _exits_passed(o, d, *tri[:3]), (idx >= start)[None])
        t = torch.where(hit, t, MISS_T)
        k = torch.argmin(t, dim=1)
        tmin = t[rows, k]
        closer = tmin < bt
        bt = torch.where(closer, tmin, bt)
        bc = torch.where(closer[:, None], color[rows, k], bc)
        bn = torch.where(closer[:, None], normal[rows, k], bn)
    hit = bt < MISS_T
    return dict(t=torch.where(hit, bt, MISS_T), hit=hit, color=bc, normal=bn)


def _intersect_bvh(origin, direction, mesh: Mesh, counts):
    """The lockstep traversal of the lanes whose ray meets the root box.
    Returns (results of those lanes, their indices into ``origin``)."""
    dev = origin.device
    inv_dir = 1.0 / torch.where(direction.abs() < 1e-12, 1e-12, direction)
    lo = mesh.node_min + mesh.position
    hi = mesh.node_max + mesh.position
    world = mesh.points + mesh.position
    node_left, node_count = mesh.node_left.long(), mesh.node_count.long()
    lookup = mesh.lookup.long()
    nb, nt = lo.shape[0], lookup.shape[0]

    # Rays that miss the root box are done before the loop.
    sub = (hit_aabb(origin, inv_dir, lo[0], hi[0]) < MISS_T).nonzero().squeeze(1)
    o, d, inv_dir = origin[sub], direction[sub], inv_dir[sub]
    n = sub.shape[0]
    best_t = o.new_full((n,), MISS_T)
    color, normal = o.new_zeros((n, 3)), o.new_zeros((n, 3))
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    sp = torch.zeros(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK_DEPTH), dtype=torch.int64, device=dev)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    if counts is not None:
        inner = torch.zeros(n, dtype=torch.int64, device=dev)
        leaves = torch.zeros(n, dtype=torch.int64, device=dev)
        tests = torch.zeros(n, dtype=torch.int64, device=dev)
        nodes_read = torch.zeros(nb, dtype=torch.bool, device=dev)
        lookup_read = torch.zeros(nt, dtype=torch.bool, device=dev)
        exits = {k: torch.zeros(n, dtype=torch.int64, device=dev) for k in EXIT_KEYS}

    while n and bool(active.any()):
        count, left = node_count[node], node_left[node]
        is_leaf = count > 0

        # Inner node: order the children near first.  (A leaf's ``left``
        # indexes the lookup; its clamped child boxes go unused.)
        c1, c2 = left.clamp(max=nb - 1), (left + 1).clamp(max=nb - 1)
        d1 = hit_aabb(o, inv_dir, lo[c1], hi[c1])
        d2 = hit_aabb(o, inv_dir, lo[c2], hi[c2])
        first = d1 <= d2
        near, far = torch.where(first, c1, c2), torch.where(first, c2, c1)
        d_near, d_far = torch.minimum(d1, d2), torch.maximum(d1, d2)

        # Leaf: its first LEAF_TESTS triangles.
        for i in range(LEAF_TESTS):
            lane_ok = active & is_leaf & (i < count)
            tri = _triangles(mesh, world, lookup[(left + i).clamp(0, nt - 1)])
            t, hit, c, g = hit_triangles(o, d, *tri)
            win = lane_ok & hit & (t < best_t)
            best_t = torch.where(win, t, best_t)
            color = torch.where(win[:, None], c, color)
            normal = torch.where(win[:, None], g, normal)
            if counts is not None:
                tests += lane_ok
                _count_exits(exits, _exits_passed(o, d, *tri[:3]), lane_ok)
                lookup_read[(left + i)[lane_ok]] = True

        if counts is not None:
            nodes_read[node[active]] = True
            inner += active & ~is_leaf
            leaves += active & is_leaf

        # Next node: descend to the near child (pushing the far one if it
        # is nearer than the best hit), or pop.
        descend = ~is_leaf & (d_near < best_t)
        push = active & descend & (d_far < best_t)
        top = stack.gather(1, sp[:, None]).squeeze(1)
        stack.scatter_(1, sp[:, None], torch.where(push, far, top)[:, None])
        sp = torch.where(push, (sp + 1).clamp(max=STACK_DEPTH - 1), sp)
        must_pop = ~descend | is_leaf
        can_pop = sp > 0
        popped = stack.gather(1, (sp - 1).clamp(min=0)[:, None]).squeeze(1)
        node = torch.where(active, torch.where(must_pop, popped, near), node)
        sp = torch.where(active & must_pop & can_pop, sp - 1, sp)
        active = active & (descend | can_pop)

    if counts is not None:
        counts.update(inner_visits=inner, leaf_visits=leaves, tri_tests=tests,
                      nodes_read=nodes_read, lookup_read=lookup_read, **exits)
    hit = best_t < MISS_T
    return dict(t=torch.where(hit, best_t, MISS_T), hit=hit, color=color,
                normal=normal), sub


def intersect_mesh(origin: torch.Tensor, direction: torch.Tensor, mesh: Mesh,
                   active: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Nearest hit of each ray against one mesh: the plain version for CPU
    tensors, the mesh kernel M1 (one launch, no merge) for CUDA tensors.
    Arguments and results as :func:`intersect_mesh_torch`."""
    if origin.device.type == "cpu":
        return intersect_mesh_torch(origin, direction, mesh, active)
    return mesh_kernel.intersect_mesh_cuda(origin, direction, mesh, active)


def intersect_meshes_torch(origin: torch.Tensor, direction: torch.Tensor,
                           meshes: Sequence[Mesh], active: Optional[torch.Tensor] = None
                           ) -> Dict[str, torch.Tensor]:
    """Plain nearest hit across ``meshes`` (hit_ray's model loop,
    ray.wgsl:376-390), on any device: each mesh's own search
    (:func:`intersect_mesh_torch`), then a mesh whose ``visible`` is False
    never hits, an earlier mesh wins a tie (strict ``<``), and the winning
    hit's color takes the diffuse factor of the light normalize(0.2, 0.2,
    -1) (ray.wgsl:384-386).  Arguments and results as
    :func:`intersect_mesh_torch`."""
    best = _miss(origin.shape[0], origin)
    for mesh in meshes:
        res = intersect_mesh_torch(origin, direction, mesh, active)
        closer = res["hit"] & mesh.visible & (res["t"] < best["t"])
        best = dict(
            t=torch.where(closer, res["t"], best["t"]),
            hit=best["hit"] | closer,
            color=torch.where(closer[:, None], res["color"], best["color"]),
            normal=torch.where(closer[:, None], res["normal"], best["normal"]),
        )
    light = diffuse_light(origin.device)
    n = best["normal"]
    diffuse = (n[:, 0] * light[0] + n[:, 1] * light[1]) + n[:, 2] * light[2]
    best["color"] = torch.where(best["hit"][:, None], best["color"] * diffuse[:, None],
                                best["color"])
    return best


Rays = Sequence[torch.Tensor]


def intersect_meshes(origin: Rays, direction: Rays, meshes: Sequence[Mesh],
                     active: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Nearest hit across ``meshes``, by the rules of
    :func:`intersect_meshes_torch`: the plain version for CPU tensors, one
    launch of the mesh kernel M1 for all the meshes (a further launch for
    each MAX_MESHES more) for CUDA tensors, with no host sync.  ``origin``
    and ``direction``: each its three (N,) rows (the tracer's state rows,
    read in place on the card)."""
    if origin[0].device.type == "cpu":
        return intersect_meshes_torch(torch.stack(tuple(origin), -1),
                                      torch.stack(tuple(direction), -1), meshes, active)
    return mesh_kernel.intersect_meshes_cuda(origin, direction, meshes, active)
