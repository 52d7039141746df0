"""BVH construction into flat arrays (counterpart of ``bhx/geometry/bvh.py``).

Host-side numpy, as in the reference's Rust builder
(src/renderer/triangle.rs:143-259): a binary BVH split at the midpoint of
the node box's longest axis on triangle centroids, leaves of at most
``leaf_size`` triangles, children stored next to each other, and an index
array (``lookup``) partitioned in place.

Two builders with identical output: the numpy one here, and the C++ one
(``csrc/bhxcore.cpp`` through :mod:`bhx_torch.geometry.native`) for large
meshes.

Layout:
  node_min/node_max : (B, 3) float32 box corners
  node_left         : (B,)  int32 -- first child for inner nodes, first
                      lookup index for leaves
  node_count        : (B,)  int32 -- 0 for inner nodes, #triangles for leaves
  lookup            : (T,)  int32 -- triangle indices, leaf-contiguous
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class BvhArrays(NamedTuple):
    node_min: np.ndarray
    node_max: np.ndarray
    node_left: np.ndarray
    node_count: np.ndarray
    lookup: np.ndarray

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]

    def max_depth(self) -> int:
        """Depth of the tree (root = 1): bounds the traversal stack."""
        depth = np.zeros(self.num_nodes, dtype=np.int64)
        depth[0] = 1
        out = 1
        # Children always have larger indices than their parent.
        for i in range(self.num_nodes):
            if self.node_count[i] == 0:
                c = self.node_left[i]
                depth[c] = depth[c + 1] = depth[i] + 1
                out = max(out, int(depth[i] + 1))
        return out


def build_bvh(points: np.ndarray, tri_points: np.ndarray, leaf_size: int = 2,
              use_native: bool = True) -> BvhArrays:
    """Build a BVH over triangles ``tri_points`` (T, 3) indexing ``points``.

    Node bounds are vertex bounds, the split point is the midpoint of the
    node box's longest axis, and a degenerate partition (every centroid on
    one side) leaves the node a leaf, however many triangles it holds
    (triangle.rs:159-259).  ``use_native`` builds with the C++ builder,
    which raises if it cannot be compiled; the numpy builder is taken only
    by name (``use_native=False``)."""
    points = np.asarray(points, dtype=np.float32)
    tri_points = np.asarray(tri_points, dtype=np.int32)
    if tri_points.shape[0] == 0:
        z3 = np.zeros((1, 3), np.float32)
        return BvhArrays(z3, z3, np.zeros(1, np.int32), np.zeros(1, np.int32),
                         np.zeros(0, np.int32))
    if use_native:
        from bhx_torch.geometry import native

        return native.build_bvh(points, tri_points, leaf_size)
    return _build_bvh_numpy(points, tri_points, leaf_size)


def _build_bvh_numpy(points, tri_points, leaf_size=2) -> BvhArrays:
    ntris = tri_points.shape[0]
    tri_verts = points[tri_points]  # (T, 3, 3)
    tri_min = tri_verts.min(axis=1)
    tri_max = tri_verts.max(axis=1)
    centroids = tri_verts.mean(axis=1)

    lookup = np.arange(ntris, dtype=np.int32)
    max_nodes = 2 * ntris  # a binary tree with >= 1 triangle a leaf
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_left = np.zeros(max_nodes, np.int32)
    node_count = np.zeros(max_nodes, np.int32)

    node_left[0] = 0
    node_count[0] = ntris
    nodes_used = 1

    stack = [0]
    while stack:
        ni = stack.pop()
        start, count = node_left[ni], node_count[ni]
        idx = lookup[start:start + count]
        node_min[ni] = tri_min[idx].min(axis=0)
        node_max[ni] = tri_max[idx].max(axis=0)
        if count <= leaf_size:
            continue
        extent = node_max[ni] - node_min[ni]
        axis = int(np.argmax(extent))
        split = node_min[ni][axis] + extent[axis] * 0.5
        left_mask = centroids[idx, axis] < split
        left_count = int(left_mask.sum())
        if left_count == 0 or left_count == count:
            continue  # degenerate split: an oversized leaf
        # Stable partition, left triangles first.
        lookup[start:start + count] = np.concatenate([idx[left_mask], idx[~left_mask]])
        li, ri = nodes_used, nodes_used + 1
        nodes_used += 2
        node_left[li] = start
        node_count[li] = left_count
        node_left[ri] = start + left_count
        node_count[ri] = count - left_count
        node_left[ni] = li
        node_count[ni] = 0
        stack.append(ri)
        stack.append(li)

    return BvhArrays(
        node_min=node_min[:nodes_used].copy(),
        node_max=node_max[:nodes_used].copy(),
        node_left=node_left[:nodes_used].copy(),
        node_count=node_count[:nodes_used].copy(),
        lookup=lookup,
    )


def validate_bvh(bvh: BvhArrays, points, tri_points, atol=1e-5) -> None:
    """Assert the structural invariants: every triangle in exactly one
    leaf, parent boxes hold their children's, leaf boxes their
    triangles'."""
    seen = []
    for i in range(bvh.num_nodes):
        if bvh.node_count[i] > 0:
            seen.extend(bvh.lookup[bvh.node_left[i]:bvh.node_left[i] + bvh.node_count[i]])
        else:
            c = int(bvh.node_left[i])
            for ch in (c, c + 1):
                assert np.all(bvh.node_min[i] <= bvh.node_min[ch] + atol)
                assert np.all(bvh.node_max[i] >= bvh.node_max[ch] - atol)
    assert sorted(seen) == list(range(tri_points.shape[0]))
    verts = np.asarray(points)[np.asarray(tri_points)]
    tmin, tmax = verts.min(axis=1), verts.max(axis=1)
    for i in range(bvh.num_nodes):
        if bvh.node_count[i] > 0:
            idx = bvh.lookup[bvh.node_left[i]:bvh.node_left[i] + bvh.node_count[i]]
            assert np.all(bvh.node_min[i] <= tmin[idx] + atol)
            assert np.all(bvh.node_max[i] >= tmax[idx] - atol)
