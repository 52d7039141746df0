"""The port's entry point for a quick check that a frame renders
(counterpart of the repository root's ``__graft_entry__.entry``)."""

from __future__ import annotations


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
