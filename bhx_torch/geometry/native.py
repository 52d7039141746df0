"""ctypes binding of the C++ geometry core (``csrc/bhxcore.cpp``):
the BVH builder (reference triangle.rs:143-259) and the OBJ parser
(model.rs:7-87), counterpart of ``bhx/geometry/native.py``.

``g++`` builds the library on first use into ``build/bhx_torch/`` at the
repository root, named by a hash of the source and flags, under a file
lock (as :mod:`bhx_torch.kernels.build` builds the CUDA library).  No
``-march=native``: the library runs on whatever host drives the card.  A
failed build raises; nothing falls back to numpy behind the caller's back.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from bhx_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "bhxcore.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_F = ctypes.POINTER(ctypes.c_float)
_I = ctypes.POINTER(ctypes.c_int32)


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if the source changed) and load the geometry core."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    so = BUILD_DIR / f"libbhxcore_{h.hexdigest()[:16]}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock_bhxcore", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True, timeout=240)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.bhx_build_bvh.restype = ctypes.c_int64
    lib.bhx_build_bvh.argtypes = [_F, ctypes.c_int64, _I, ctypes.c_int64, ctypes.c_int32,
                                  _F, _F, _I, _I, _I]
    lib.bhx_obj_parse.restype = ctypes.c_int64
    lib.bhx_obj_parse.argtypes = [ctypes.c_char_p]
    lib.bhx_obj_counts.restype = None
    lib.bhx_obj_counts.argtypes = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)]
    lib.bhx_obj_fill.restype = None
    lib.bhx_obj_fill.argtypes = [ctypes.c_int64, _F, _F, _I, _I,
                                 ctypes.POINTER(ctypes.c_uint8)]
    lib.bhx_obj_free.restype = None
    lib.bhx_obj_free.argtypes = [ctypes.c_int64]
    return lib


def _ptr(a: np.ndarray, ty):
    return a.ctypes.data_as(ctypes.POINTER(ty))


def build_bvh(points: np.ndarray, tri_points: np.ndarray, leaf_size: int = 2):
    """:func:`bhx_torch.geometry.bvh.build_bvh` by the C++ builder."""
    from bhx_torch.geometry.bvh import BvhArrays

    lib = library()
    points = np.ascontiguousarray(points, np.float32)
    tris = np.ascontiguousarray(tri_points, np.int32)
    ntris = tris.shape[0]
    max_nodes = max(2 * ntris, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    node_left = np.zeros(max_nodes, np.int32)
    node_count = np.zeros(max_nodes, np.int32)
    lookup = np.empty(ntris, np.int32)
    used = int(lib.bhx_build_bvh(
        _ptr(points, ctypes.c_float), points.shape[0], _ptr(tris, ctypes.c_int32), ntris,
        leaf_size, _ptr(node_min, ctypes.c_float), _ptr(node_max, ctypes.c_float),
        _ptr(node_left, ctypes.c_int32), _ptr(node_count, ctypes.c_int32),
        _ptr(lookup, ctypes.c_int32)))
    return BvhArrays(node_min=node_min[:used].copy(), node_max=node_max[:used].copy(),
                     node_left=node_left[:used].copy(),
                     node_count=node_count[:used].copy(), lookup=lookup)


def load_obj(path) -> tuple:
    """The raw parse of an OBJ file: (points (P, 3) f32, normals (Nn, 3)
    f32, tri_p (T, 3) i32, tri_n (T, 3) i32, has_n (T,) bool), before the
    scale and flip conventions and the synthesis of missing normals, which
    :mod:`bhx_torch.geometry.obj` applies to both parsers alike.  Raises
    if the file cannot be opened."""
    lib = library()
    handle = lib.bhx_obj_parse(os.fsencode(path))
    if handle < 0:
        raise OSError(f"cannot open {path}")
    try:
        counts = (ctypes.c_int64 * 3)()
        lib.bhx_obj_counts(handle, counts)
        p, nn, t = int(counts[0]), int(counts[1]), int(counts[2])
        points = np.empty((p, 3), np.float32)
        normals = np.empty((nn, 3), np.float32)
        tri_p = np.empty((t, 3), np.int32)
        tri_n = np.empty((t, 3), np.int32)
        has_n = np.empty((t,), np.uint8)
        lib.bhx_obj_fill(handle, _ptr(points, ctypes.c_float), _ptr(normals, ctypes.c_float),
                         _ptr(tri_p, ctypes.c_int32), _ptr(tri_n, ctypes.c_int32),
                         _ptr(has_n, ctypes.c_uint8))
    finally:
        lib.bhx_obj_free(handle)
    return points, normals, tri_p, tri_n, has_n.astype(bool)
