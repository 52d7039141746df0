"""Meshes for the bhx_torch mesh tests, made with numpy alone (no jax), so
that the card-only tests can use them too: the viewer's 12-triangle cube
(``bhx/viewer.py:205-227``) and a seeded bumpy torus written to an OBJ
file.  :func:`jax_mesh` (which imports bhx when called) hands a port mesh
to bhx."""

from __future__ import annotations

import numpy as np


def cube_arrays(half: float = 1.5):
    """(points, normals, tri_points, tri_normals) of the viewer's cube, in
    world units (load with scale=1.0, flip_y=False)."""
    v = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1) for z in (-1, 1)],
                 np.float32) * half
    tri = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
        [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.int32)
    a, b, c = v[tri[:, 0]], v[tri[:, 1]], v[tri[:, 2]]
    fn = np.cross(b - a, c - a)
    fn = (fn / np.linalg.norm(fn, axis=-1, keepdims=True)).astype(np.float32)
    tn = np.repeat(np.arange(len(tri), dtype=np.int32)[:, None], 3, axis=1)
    return v, fn, tri, tn


def torus_arrays(nu: int = 32, nv: int = 32, major: float = 6.0, minor: float = 2.4,
                 seed: int = 0):
    """(points, normals, tri_points) of a torus about the z axis: nu x nv
    quads, 2 nu nv triangles, its minor radius bumped by four seeded
    sinusoids of total amplitude at most 8%; per-vertex normals from
    central differences on the grid, pointing outward."""
    rng = np.random.default_rng(seed)
    amp = rng.uniform(0.005, 0.02, 4)
    mu, mv = rng.integers(1, 9, 4), rng.integers(1, 7, 4)
    phase = rng.uniform(0.0, 2.0 * np.pi, 4)
    u = np.arange(nu)[:, None] * (2.0 * np.pi / nu)
    v = np.arange(nv)[None, :] * (2.0 * np.pi / nv)
    r = minor * (1.0 + sum(a * np.sin(m * u + k * v + p)
                           for a, m, k, p in zip(amp, mu, mv, phase)))
    ring = major + r * np.cos(v)
    p = np.stack([ring * np.cos(u), ring * np.sin(u), r * np.sin(v)], axis=-1)
    du = np.roll(p, -1, axis=0) - np.roll(p, 1, axis=0)
    dv = np.roll(p, -1, axis=1) - np.roll(p, 1, axis=1)
    n = np.cross(du, dv)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    tri = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                          np.stack([a, c, d], -1).reshape(-1, 3)]).astype(np.int32)
    return (p.reshape(-1, 3).astype(np.float32), n.reshape(-1, 3).astype(np.float32),
            tri)


def write_obj(path, points, normals, tri) -> None:
    """An OBJ file of ``points`` with ``normals`` (one per point) and
    triangles as ``f a//a b//b c//c``."""
    with open(path, "w") as f:
        np.savetxt(f, points, fmt="v %.6f %.6f %.6f")
        np.savetxt(f, normals, fmt="vn %.6f %.6f %.6f")
        np.savetxt(f, np.repeat(tri + 1, 2, axis=1), fmt="f %d//%d %d//%d %d//%d")


MESH_FIELDS = ("points", "normals", "tri_points", "tri_normals", "node_min", "node_max",
               "node_left", "node_count", "lookup", "position")


def jax_mesh(mesh):
    """The bhx Mesh of the bhx_torch ``mesh``, array for array."""
    import jax.numpy as jnp
    from bhx.scene import Mesh

    return Mesh(**{f: jnp.asarray(getattr(mesh, f).cpu().numpy()) for f in MESH_FIELDS},
                visible=jnp.asarray(bool(mesh.visible)), name=mesh.name)
