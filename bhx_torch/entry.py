"""The port's entry points for a quick check: a frame renders
(counterpart of the repository root's ``__graft_entry__.entry``), and one
sharded train step and one sharded forward trace run over n ranks
(``__graft_entry__.dryrun_multichip``)."""

from __future__ import annotations

import math


def entry(device=None):
    """(fn, example_args): the forward render of the flagship pipeline at a
    small size -- 128x72, no ladder, 300 march iterations, the full post
    chain -- on the CUDA card unless ``device`` names another.  ``fn(scene)``
    returns the (72, 128, 3) image."""
    from bhx_torch.config import RenderConfig
    from bhx_torch.pipeline import render
    from bhx_torch.scene import Scene

    cfg = RenderConfig(width=128, height=72, use_ladder=False, max_iterations=300)

    def fn(scene):
        return render(scene, cfg)

    return fn, (Scene.default(device),)


def _dryrun_rank(mesh):
    """One rank of :func:`dryrun_multichip`: (loss, record sum)."""
    import torch

    from bhx_torch.config import BloomConfig, FxaaConfig, RenderConfig
    from bhx_torch.parallel import make_optimizer, scene_params, trace_image_sharded, train_step
    from bhx_torch.scene import Scene

    # 8 rows a rank: the height divides into bands evenly.
    cfg = RenderConfig(width=32, height=8 * mesh.size, use_ladder=False, max_iterations=40,
                       fxaa=FxaaConfig(enabled=False), bloom=BloomConfig(enabled=False))
    scene = Scene.default(mesh.device)
    params = {k: v.detach().clone().requires_grad_() for k, v in scene_params(scene).items()}
    optimizer = make_optimizer(params, 1e-2)
    target = torch.zeros((cfg.height, cfg.width, 3), device=mesh.device)
    loss = float(train_step(params, optimizer, scene, target, cfg, mesh))
    if not math.isfinite(loss):
        raise RuntimeError(f"non-finite loss: {loss}")
    # The parameters moved: gradients flowed and were summed.
    if float(params["mass"].detach()) == 0.5:
        raise RuntimeError("the sharded step left the mass where it was")
    with torch.no_grad():
        rec_sum = float(trace_image_sharded(scene, cfg, mesh, cfg.width, cfg.height).sum())
    if not math.isfinite(rec_sum):
        raise RuntimeError(f"non-finite sharded record: {rec_sum}")
    return loss, rec_sum


def dryrun_multichip(n_devices: int, device=None, backend=None) -> None:
    """One sharded train step (32 x 8n, 40 march iterations, no bloom or
    FXAA, toward a black target) and one sharded forward trace, on
    ``n_devices`` ranks spawned by ``bhx_torch.parallel.spawn``: rank r on
    card ``r % device_count`` unless ``device`` names the CPU, joined through
    ``backend`` (``parallel.default_backend`` when None).  Raises if a rank
    fails; prints one line."""
    from bhx_torch.parallel import spawn

    results = spawn(_dryrun_rank, n_devices, backend=backend, device=device)
    loss, rec_sum = results[0]
    print(f"dryrun_multichip({n_devices}): one sharded train step ok, loss={loss:.6f}; "
          f"kernel forward frame over the ranks ok (record sum {rec_sum:.3f})")
