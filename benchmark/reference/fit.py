"""The fit step: the mean squared difference between the frame under the
fitted parameters and a target frame, its gradient by autograd through
the plain renderer (the march in checkpointed segments), and one Adam
update (betas 0.9 / 0.999, eps 1e-8).

A fit over ``bands`` ranks takes the gradient as the sum, in rank order,
of each band of rows' share: rank b traces its band under its own copy of
the parameters and the whole frame's loss reaches the others only through
its band.  The sum rounds otherwise than the whole frame's gradient, and
on some seeds the third step's change follows that rounding far (0.35 of
the worst leaf against the whole frame's), so a sharded fit is held to
the sum it computes."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .config import Config
from .frame import render
from .scene import Scene, with_params


def loss_of(params: Dict[str, torch.Tensor], scene: Scene, target: torch.Tensor,
            cfg: Config, opts: Dict, rows: Optional[slice] = None) -> torch.Tensor:
    """The image loss; ``rows`` keeps only those rows of the frame (a
    fault: half of the batch left out, the mean taken over the rest).  A
    list of parameters is one copy a band of rows."""
    scenes = (with_params(scene, params) if isinstance(params, dict)
              else [with_params(scene, p) for p in params])
    img = render(scenes, cfg, dict(opts, checkpointed=True))
    if rows is not None:
        img, target = img[rows], target[rows]
    return torch.mean((img - target) ** 2)


def backward(params: Dict[str, torch.Tensor], scene: Scene, target: torch.Tensor,
             cfg: Config, opts: Dict, rows: Optional[slice] = None, bands: int = 1) -> float:
    """The image loss, its gradient left in each leaf's ``.grad``: the
    whole frame's, or over ``bands`` > 1 the bands' sum in rank order."""
    if bands == 1:
        loss = loss_of(params, scene, target, cfg, opts, rows)
        loss.backward()
        return float(loss.detach())
    copies = [{k: v.detach().clone().requires_grad_() for k, v in params.items()}
              for _ in range(bands)]
    loss = loss_of(copies, scene, target, cfg, opts, rows)
    loss.backward()
    for k, p in params.items():
        for c in copies:
            g = c[k].grad
            if g is not None:
                p.grad = g if p.grad is None else p.grad + g
    return float(loss.detach())


def fit_steps(params0: Dict[str, torch.Tensor], scene: Scene, target: torch.Tensor,
              cfg: Config, steps: int, lr: float, opts: Optional[Dict] = None,
              rows: Optional[slice] = None, bands: int = 1) -> Dict:
    """``steps`` Adam steps from ``params0``.  Returns each step's loss, the
    first step's gradient of each leaf, each leaf's change after the last
    step, and the state after it as :func:`step_from` takes it: the
    parameters, each leaf's moments and count of steps taken."""
    opts = {} if opts is None else opts
    params = {k: v.detach().clone().requires_grad_() for k, v in params0.items()}
    opt = torch.optim.Adam(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    losses, first_grad = [], None
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss = backward(params, scene, target, cfg, opts, rows, bands)
        if first_grad is None:
            first_grad = {k: (torch.zeros_like(v) if v.grad is None else v.grad.detach().clone())
                          for k, v in params.items()}
        opt.step()
        losses.append(loss)
    change = {k: (v.detach() - params0[k]).clone() for k, v in params.items()}
    state = dict(params={k: v.detach().clone() for k, v in params.items()},
                 moments={k: moments_of(opt, v) for k, v in params.items()})
    return dict(losses=losses, first_grad=first_grad, change=change, state=state)


def moments_of(opt: torch.optim.Optimizer, p: torch.Tensor) -> tuple:
    """(first moment, second moment, steps taken) of Adam's state of leaf
    ``p``, copied; zeros and 0 where the leaf never had a gradient."""
    st = opt.state.get(p, {})
    if "exp_avg" not in st:
        return torch.zeros_like(p), torch.zeros_like(p), 0
    return st["exp_avg"].detach().clone(), st["exp_avg_sq"].detach().clone(), int(st["step"])


def step_from(params: Dict[str, torch.Tensor], moments: Dict[str, tuple], scene: Scene,
              target: torch.Tensor, cfg: Config, lr: float, opts: Optional[Dict] = None,
              rows: Optional[slice] = None, bands: int = 1) -> Dict:
    """One Adam step from a state taken inside a fit: the parameters and
    each leaf's (first moment, second moment, steps taken).  Returns the
    step's loss, each leaf's gradient and each leaf's change."""
    opts = {} if opts is None else opts
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    opt = torch.optim.Adam(list(leaves.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for k, p in leaves.items():
        m, v, taken = moments[k]
        opt.state[p] = dict(step=torch.tensor(float(taken)), exp_avg=m.detach().clone(),
                            exp_avg_sq=v.detach().clone())
    loss = backward(leaves, scene, target, cfg, opts, rows, bands)
    grad = {k: (torch.zeros_like(v) if v.grad is None else v.grad.detach().clone())
            for k, v in leaves.items()}
    opt.step()
    return dict(loss=loss, grad=grad,
                change={k: (v.detach() - params[k]).clone() for k, v in leaves.items()})
