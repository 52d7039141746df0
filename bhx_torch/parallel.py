"""Inverse rendering on one device: fit scene parameters to a target image
by Adam on the L2 image loss (counterpart of the single-device part of
``bhx/parallel.py:256-336``).

The parameters are a plain dict of tensors under the keys of
``bhx.parallel.scene_params``, so a dict made by one package can be applied
by the other (as numpy arrays).  Gradients come from ``render``'s
autograd graph: each kernel call is a ``torch.autograd.Function`` whose
backward replays its plain version (``bhx_torch/kernels``).  Tile sharding
and the gradient all-reduce across devices are not ported yet (ROADMAP
A15).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import torch

from bhx_torch.config import RenderConfig
from bhx_torch.pipeline import render
from bhx_torch.scene import Scene

# The differentiable parameter subset: black-hole fields, then camera
# fields under a ``cam_`` prefix.  ``spin`` reaches the image only under
# geodesics="kerr"; elsewhere its gradient is zero and Adam leaves it.
PARAM_FIELDS = (
    "mass", "spin", "disk_rotation", "disk_inner", "disk_outer", "feather",
)
CAMERA_FIELDS = ("position", "fov")


def scene_params(scene: Scene) -> Dict[str, torch.Tensor]:
    """The fitted fields of ``scene``, by ``bhx.parallel.scene_params``'s
    keys (the scene's own tensors, not copies)."""
    p = {f: getattr(scene.black_hole, f) for f in PARAM_FIELDS}
    p.update({f"cam_{f}": getattr(scene.camera, f) for f in CAMERA_FIELDS})
    return p


def apply_params(scene: Scene, params: Mapping) -> Scene:
    """``scene`` with the fitted fields taken from ``params``: tensors are
    used as they are (so gradients reach them), anything else, such as the
    numpy arrays of a ``bhx.parallel.scene_params`` dict, becomes a float32
    tensor on the scene's device."""
    dev = scene.black_hole.mass.device

    def leaf(v):
        return v if torch.is_tensor(v) else torch.as_tensor(v, dtype=torch.float32,
                                                            device=dev)

    bh = dataclasses.replace(
        scene.black_hole, **{f: leaf(params[f]) for f in PARAM_FIELDS})
    cam = dataclasses.replace(
        scene.camera, **{f: leaf(params[f"cam_{f}"]) for f in CAMERA_FIELDS})
    return dataclasses.replace(scene, black_hole=bh, camera=cam)


def make_optimizer(params: Dict[str, torch.Tensor], lr: float = 1e-2) -> torch.optim.Adam:
    """Adam over the parameter tensors, with ``optax.adam``'s defaults
    (betas 0.9 / 0.999, eps 1e-8)."""
    return torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def loss_fn(params: Dict[str, torch.Tensor], scene: Scene, target: torch.Tensor,
            cfg: RenderConfig) -> torch.Tensor:
    """The mean squared difference between the render under ``params`` and
    ``target`` ((height, width, 3))."""
    img = render(apply_params(scene, params), cfg)
    return torch.mean((img - target) ** 2)


def train_step(params: Dict[str, torch.Tensor], optimizer: torch.optim.Optimizer,
               scene: Scene, target: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """One inverse-rendering step: L2 image loss, its gradients (left in
    each parameter's ``.grad``), one optimizer update in place.  Returns the
    loss before the update."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(params, scene, target, cfg)
    loss.backward()
    optimizer.step()
    return loss.detach()


def fit_scene(scene: Scene, target: torch.Tensor, cfg: RenderConfig, steps: int = 100,
              lr: float = 1e-2, verbose: bool = False,
              callback: Optional[Callable[[int, float], None]] = None,
              ) -> Tuple[Dict[str, torch.Tensor], List[float]]:
    """Fit the scene's parameters to ``target`` by ``steps`` Adam steps.
    ``callback(step, loss)``, if given, runs after every step.  Returns the
    fitted parameters (detached) and the loss of every step."""
    params = {k: v.detach().clone().requires_grad_() for k, v in scene_params(scene).items()}
    optimizer = make_optimizer(params, lr)
    target = target.to(scene.black_hole.mass.device)
    losses = []
    for i in range(steps):
        losses.append(float(train_step(params, optimizer, scene, target, cfg)))
        if verbose and i % 10 == 0:
            print(f"step {i}: loss {losses[-1]:.6f}")
        if callback is not None:
            callback(i, losses[-1])
    return {k: v.detach() for k, v in params.items()}, losses
