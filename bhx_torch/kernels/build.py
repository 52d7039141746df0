"""Build, load and launch the CUDA kernels in ``bhx_torch/csrc``.

``nvcc`` compiles every ``csrc/*.cu`` into one shared library with a plain
C interface, loaded with ctypes, on first use.  The library lands in
``build/bhx_torch/`` at the repository root, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused; a file lock serialises concurrent builders.

No fast-math, and no fused multiply-add contraction (``--fmad=false``):
the kernels are held to their plain torch versions, which round after
every operation, and the disk texel amplifies a last-bit difference by
the optical depth (up to ~80).  Where a plain version calls
``torch.rsqrt`` the kernel calls ``rsqrtf``, which is what torch runs on
the card.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "bhx_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I32 = ctypes.c_int
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
# C signatures; every entry point also takes the stream last and returns
# cudaGetLastError() after its launch.
SIGNATURES = {
    # rays, params, out, queue (N int32 of scratch), counters (3 int32,
    # zero), n, max_iterations, tex_opacity_min, show_disk, mode (0 Euler,
    # 1 RK45, 2 Kerr)
    "bhx_march": (_P, _P, _P, _P, _P, _I64, _I32, _F32, _I32, _I32),
    # slots, cam_dist, params, gain, gain_h, gain_w, tint, out, n,
    # show_texture, show_redshift
    "bhx_composite": (_P, _P, _P, _P, _I32, _I32, _P, _P, _I64, _I32, _I32),
    # slots, cam_dist, params, tint, out, n, show_texture, show_redshift
    "bhx_ingredients": (_P, _P, _P, _P, _P, _I64, _I32, _I32),
    # rows, tint, out, n, show_sky
    "bhx_sky": (_P, _P, _P, _I64, _I32),
    # record (N, 8), tint, out (N, 3), n, show_sky
    "bhx_sky_finalize": (_P, _P, _P, _I64, _I32),
    # rays (12 int64: six row pointers, six strides), active (N,) bool or
    # NULL, queue (N int32 of scratch), counters (1 int32, zero), launch,
    # meshes (10 int64 a mesh), count, light (3 float32), out (8, N), n,
    # flags (1 merge, 2 last)
    "bhx_mesh": (_P, _P, _P, _P, _I32, _P, _I32, _P, _P, _I64, _I32),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (needed to build bhx_torch/csrc)")
    return path


def _tag(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(sources):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    for p in sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _sources():
    return sorted(CSRC.glob("*.cu"))


def log_path(sources=None) -> Path:
    """The nvcc output (ptxas register and spill report) of the build of
    ``sources`` (the package's by default)."""
    return BUILD_DIR / f"nvcc_{_tag(sources or _sources())}.log"


def compile_library(sources, signatures, name: str = "libbhx_torch") -> ctypes.CDLL:
    """Build ``sources`` (``.cu`` paths; ``csrc/`` on the include path)
    into one shared library under BUILD_DIR, unless a build of the same
    sources and flags is there, load it, and bind each entry point of
    ``signatures`` (name -> argument types; the stream is appended)."""
    tag = _tag(sources)
    so = BUILD_DIR / f"{name}_{tag}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            tmp = BUILD_DIR / f"{name}_{tag}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   *map(str, sorted(sources))]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            (BUILD_DIR / f"nvcc_{tag}.log").write_text(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-6000:]}"
                )
            os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for fn_name, argtypes in signatures.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes) + [_P]
        fn.restype = ctypes.c_int
    lib.bhx_error_string.argtypes = [ctypes.c_int]
    lib.bhx_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """Build (if the sources changed) and load the kernel library."""
    return compile_library(_sources(), SIGNATURES)


def launch(name: str, *args) -> None:
    """Call entry point ``name`` of the kernel library on the current
    stream; tensors go in as device pointers.  Raises if the launch reports
    a CUDA error."""
    call(library(), name, *args)


def call(lib: ctypes.CDLL, name: str, *args) -> None:
    """:func:`launch` of entry point ``name`` of ``lib``, a library from
    :func:`compile_library`."""
    dev = next(a.device for a in args if torch.is_tensor(a))
    c_args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = getattr(lib, name)(*c_args, stream)
    if rc != 0:
        msg = lib.bhx_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def check_rows(t: torch.Tensor, rows: int, name: str) -> None:
    """A contiguous float32 (rows, N) CUDA tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(
            f"{name}: expected float32 ({rows}, N), got {t.dtype} {tuple(t.shape)}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_vector(t: torch.Tensor, n: int, device, name: str) -> None:
    """A contiguous float32 (n,) tensor on ``device``."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (n,):
        raise ValueError(
            f"{name}: expected float32 ({n},) on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
