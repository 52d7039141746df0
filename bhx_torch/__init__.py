"""bhx_torch — the bhx black-hole renderer on PyTorch and CUDA.

A port of the JAX package ``bhx`` (its reference, which it never imports)
to PyTorch, with every TPU kernel of ``bhx`` rewritten by hand in CUDA C++
for Hopper (``bhx_torch/csrc``):

  bhx_torch.config     static render configuration
  bhx_torch.scene      camera / black hole / disk_gain / mesh / texture tensors
  bhx_torch.assets     the baked array textures (disk, sky, blackbody LUT)
  bhx_torch.geometry   ray-shape tests, BVH build, OBJ loading (C++ core),
                       mesh traversal
  bhx_torch.procedural hash-Perlin disk texel, blackbody tint, star sky
  bhx_torch.physics    the geodesic force, conserved h^2, capture and deflection
  bhx_torch.kerr       Kerr Hamiltonian, null momentum, hand-written dH/dx
  bhx_torch.integrate  the Cash-Karp tableau of the RK45 march, Euler and RK45 steps
  bhx_torch.shading    sky mapping, ACES, texture sampling, the array disk shade
  bhx_torch.tracer     straight + march phases, deferred disk record, the
                       public tracer API (trace_rays, finalize_*)
  bhx_torch.pipeline   adaptive ladder, sky pass, post chain, render(),
                       render_tiled()
  bhx_torch.post       bloom, mix, ACES, FXAA
  bhx_torch.kernels    march (Euler, RK45, Kerr) / composite / ingredients /
                       sky / mesh kernels and their plain versions
  bhx_torch.bench      the 1918x1081 frame timed on the card, the numerics and
                       gradient gates
  bhx_torch.parallel   torch.distributed: tile-sharded trace and render, scene
                       fitting by Adam with all-reduced gradients, spawn,
                       bench_scaling (bhx_torch.scaling: its command line)
  bhx_torch.io         PNG and scene checkpoint I/O (bhx's .npz layout)
  bhx_torch.cli        ``python -m bhx_torch render | bench | assets | fit``
  bhx_torch.viewer     the HTTP viewer
  bhx_torch.profiling  spans and lane counters on the profiler's clock, profile_trace
  bhx_torch.entry      a small forward render and a sharded dry run for a quick check

Tensors on the CPU take each kernel's plain torch version; CUDA tensors
launch the kernel, which is built with nvcc on first use.  ``render`` is
differentiable: each kernel call is a ``torch.autograd.Function`` whose
backward replays the kernel's plain version under autograd (mesh hits
carry no gradient).
"""

import torch

# MKL's vector math (torch's CPU sin, cos, sqrt, atan, exp, log, ...) sets
# itself up on its first call in a process.  When torch splits that first
# call across its thread team, the other threads' chunks can come back with
# ~12-bit results (relative error up to 3e-4; ROADMAP C.5).  So make the
# first call here, on this thread alone: one element is below torch's
# parallel grain.
torch.sqrt(torch.ones(1))

from bhx_torch.config import (
    BloomConfig, FxaaConfig, FxaaPreset, Integrator, LadderConfig, RenderConfig,
)
from bhx_torch.geometry.obj import make_mesh
from bhx_torch.pipeline import render, render_image, render_tiled
from bhx_torch.scene import BlackHole, Camera, Mesh, Scene, scene_from_state
from bhx_torch.tracer import trace_rays

__all__ = [
    "RenderConfig",
    "FxaaConfig",
    "FxaaPreset",
    "LadderConfig",
    "BloomConfig",
    "Integrator",
    "Camera",
    "BlackHole",
    "Scene",
    "Mesh",
    "make_mesh",
    "scene_from_state",
    "render",
    "render_image",
    "render_tiled",
    "trace_rays",
]
