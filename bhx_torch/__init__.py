"""bhx_torch — the bhx black-hole renderer on PyTorch and CUDA.

A port of the JAX package ``bhx`` (its reference, which it never imports)
to PyTorch, with every TPU kernel of ``bhx`` rewritten by hand in CUDA C++
for Hopper (``bhx_torch/csrc``):

  bhx_torch.config     static render configuration
  bhx_torch.scene      camera / black hole / disk_gain / mesh tensors
  bhx_torch.geometry   ray-shape tests, BVH build, OBJ loading (C++ core),
                       mesh traversal
  bhx_torch.procedural hash-Perlin disk texel, blackbody tint, star sky
  bhx_torch.kerr       Kerr Hamiltonian, null momentum, hand-written dH/dx
  bhx_torch.integrate  the Cash-Karp tableau of the RK45 march
  bhx_torch.tracer     straight + march phases, deferred disk record
  bhx_torch.pipeline   adaptive ladder, sky pass, post chain, render()
  bhx_torch.post       bloom, mix, ACES, FXAA
  bhx_torch.kernels    march (Euler, RK45, Kerr) / composite / ingredients /
                       sky / mesh kernels and their plain versions
  bhx_torch.bench      the 1918x1081 frame timed on the card, the gradient gate
  bhx_torch.parallel   scene fitting by Adam on one device

Tensors on the CPU take each kernel's plain torch version; CUDA tensors
launch the kernel, which is built with nvcc on first use.  ``render`` is
differentiable: each kernel call is a ``torch.autograd.Function`` whose
backward replays the kernel's plain version under autograd (mesh hits
carry no gradient).
"""

from bhx_torch.config import BloomConfig, FxaaConfig, Integrator, LadderConfig, RenderConfig
from bhx_torch.geometry.obj import make_mesh
from bhx_torch.pipeline import render, render_image
from bhx_torch.scene import BlackHole, Camera, Mesh, Scene, scene_from_state

__all__ = [
    "RenderConfig",
    "FxaaConfig",
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
]
