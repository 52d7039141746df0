"""Wavefront OBJ loading with the reference's import conventions, and
:func:`make_mesh` (counterpart of ``bhx/geometry/obj.py``).

As src/renderer/model.rs:7-87: positions scaled by 0.5 with the y axis
negated (the reference's flipped-y world), faces fan-triangulated, normal
indices from the file where a face has them and flat face normals
otherwise, several objects merged into one triangle soup.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from bhx_torch.geometry.bvh import build_bvh
from bhx_torch.scene import Mesh, _device


def load_obj(path, scale: float = 0.5, flip_y: bool = True, use_native: bool = True):
    """Parse an OBJ file into (points (P, 3) f32, normals (Nn, 3) f32,
    tri_points (T, 3) i32, tri_normals (T, 3) i32).  ``use_native``
    parses with the C++ parser (which raises if it cannot be built); the
    numpy parser is taken by name (``use_native=False``)."""
    if use_native:
        from bhx_torch.geometry import native

        return _postprocess(*native.load_obj(path), scale, flip_y)

    points_l, normals_l, faces = [], [], []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                points_l.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vn "):
                parts = line.split()
                normals_l.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                refs = []
                for v in line.split()[1:]:
                    comps = v.split("/")
                    ni = int(comps[2]) if len(comps) >= 3 and comps[2] else 0
                    refs.append((int(comps[0]), ni))
                for k in range(1, len(refs) - 1):  # fan triangulation
                    faces.append((refs[0], refs[k], refs[k + 1]))

    points = np.asarray(points_l, dtype=np.float32).reshape(-1, 3)
    normals = np.asarray(normals_l, dtype=np.float32).reshape(-1, 3)
    npoints, nnormals = points.shape[0], normals.shape[0]
    tri_p = np.empty((len(faces), 3), np.int32)
    tri_n = np.empty((len(faces), 3), np.int32)
    has_n = np.empty(len(faces), bool)
    for t, face in enumerate(faces):
        for c in range(3):
            pi, ni = face[c]
            # 1-based indices; a negative one counts from the end.
            tri_p[t, c] = pi - 1 if pi > 0 else npoints + pi
            tri_n[t, c] = ni - 1 if ni > 0 else (nnormals + ni if ni < 0 else -1)
        has_n[t] = all(face[c][1] != 0 for c in range(3))
    return _postprocess(points, normals, tri_p, tri_n, has_n, scale, flip_y)


def _postprocess(points, normals, tri_p, tri_n, has_n, scale, flip_y):
    """The conventions, then a flat normal (from the converted points) for
    every face without normal indices (model.rs:54-67)."""
    points_t, normals, tri_p, tri_n = _apply_conventions(points, normals, tri_p, tri_n,
                                                         scale, flip_y)
    missing = ~has_n
    if missing.any():
        miss_idx = np.nonzero(missing)[0]
        a = points_t[tri_p[miss_idx, 0]]
        b = points_t[tri_p[miss_idx, 1]]
        c = points_t[tri_p[miss_idx, 2]]
        fn = np.cross(b - a, c - a)
        fn /= np.linalg.norm(fn, axis=-1, keepdims=True) + 1e-20
        base = normals.shape[0]
        normals = np.concatenate([normals, fn.astype(np.float32)], axis=0)
        new_idx = base + np.arange(len(miss_idx), dtype=np.int32)
        tri_n[miss_idx] = new_idx[:, None]
    if normals.shape[0] == 0:
        normals = np.zeros((1, 3), np.float32)
        tri_n = np.zeros_like(tri_p)
    return points_t, normals, tri_p, tri_n


def _apply_conventions(points, normals, tri_p, tri_n, scale, flip_y):
    points = np.asarray(points, np.float32) * scale
    if flip_y:
        points = points * np.asarray([1.0, -1.0, 1.0], np.float32)
    return points, np.asarray(normals, np.float32), tri_p, tri_n


def make_mesh(path_or_arrays, position=(0.0, 0.0, 0.0), name: str = "mesh",
              scale: float = 0.5, flip_y: bool = True, leaf_size: int = 2,
              device=None) -> Mesh:
    """Load an OBJ file (a path; ``scale`` and ``flip_y`` apply) or take
    (points, normals, tri_p, tri_n) arrays as they are, build the BVH with
    the C++ builder, and return a :class:`Mesh` on ``device``: the CUDA
    card unless another is named (raises when there is no card).

    The traversal tests at most 4 triangles of a leaf, as the reference's
    does (ROADMAP C.4): a ``leaf_size`` above 4, or a degenerate split,
    leaves triangles past the fourth of a leaf untested."""
    device = _device(device)
    if isinstance(path_or_arrays, (str, os.PathLike)):
        points, normals, tri_p, tri_n = load_obj(path_or_arrays, scale, flip_y)
    else:
        points, normals, tri_p, tri_n = path_or_arrays
        points = np.asarray(points, np.float32)
        normals = np.asarray(normals, np.float32)
        tri_p = np.asarray(tri_p, np.int32)
        tri_n = np.asarray(tri_n, np.int32)
    # The mesh kernel reads these indices unchecked.
    for name, idx, count in (("vertex", tri_p, len(points)), ("normal", tri_n, len(normals))):
        if idx.size and (idx.min() < 0 or idx.max() >= count):
            raise ValueError(f"a face's {name} index is outside [0, {count})")
    bvh = build_bvh(points, tri_p, leaf_size=leaf_size)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return Mesh(
        points=put(points), normals=put(normals),
        tri_points=put(tri_p), tri_normals=put(tri_n),
        node_min=put(bvh.node_min), node_max=put(bvh.node_max),
        node_left=put(bvh.node_left), node_count=put(bvh.node_count),
        lookup=put(bvh.lookup),
        position=put(np.asarray(position, np.float32)),
        visible=torch.ones((), dtype=torch.bool, device=device),
        name=name,
    )
