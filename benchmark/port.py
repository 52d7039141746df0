"""The program under test, built from a configuration's numbers through
its public entries: ``bhx_torch.RenderConfig`` and its groups, and
``bhx_torch.scene_from_state``."""

from __future__ import annotations

from typing import Dict

import numpy as np


def render_config(render: Dict):
    """The program's ``RenderConfig`` of a configuration's ``render`` group."""
    import bhx_torch
    from bhx_torch.config import BloomConfig, FxaaConfig, Integrator, LadderConfig

    r = dict(render)
    return bhx_torch.RenderConfig(
        width=r["width"], height=r["height"], geodesics=r.get("geodesics", "pseudo"),
        integrator=Integrator.RK45 if r["integrator"] == "rk45" else Integrator.EULER,
        step_size=r["step_size"], max_iterations=r["max_iterations"],
        angle_division_threshold=r["angle_division_threshold"],
        rk_rtol=r["rk_rtol"], rk_safety=r["rk_safety"], rk_min_factor=r["rk_min_factor"],
        rk_max_factor=r["rk_max_factor"], rk_h_min=r["rk_h_min"], rk_h_max=r["rk_h_max"],
        show_disk=r["show_disk"], show_disk_texture=r["show_disk_texture"],
        show_redshift=r["show_redshift"], show_sky=r["show_sky"],
        texture_mode="procedural", opacity_cutoff=r["opacity_cutoff"],
        few_iters_threshold=r["few_iters_threshold"], use_ladder=r["use_ladder"],
        ladder=LadderConfig(base=tuple(r["ladder_base"]), multiplier=r["ladder_multiplier"],
                            levels=r["ladder_levels"]),
        bloom=BloomConfig(enabled=r["bloom"], levels=r["bloom_levels"],
                          up_radius_uv=r["bloom_up_radius_uv"],
                          mix_ratio=r["bloom_mix_ratio"]),
        fxaa=FxaaConfig(enabled=r["fxaa"], edge_threshold_min=r["fxaa_edge_threshold_min"],
                        edge_threshold_max=r["fxaa_edge_threshold_max"],
                        iterations=r["fxaa_iterations"],
                        subpixel_quality=r["fxaa_subpixel_quality"]),
        tonemap=r["tonemap"],
    )


def scene(numbers: Dict, device):
    """The program's ``Scene`` of a configuration's ``scene`` group."""
    import bhx_torch

    f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
    state = dict(camera={k: f32(v) for k, v in numbers["camera"].items()},
                 black_hole={k: f32(v) for k, v in numbers["black_hole"].items()},
                 time=f32(numbers["time"]),
                 disk_gain=np.full((16, 16, 4), numbers["disk_gain"], np.float32))
    return bhx_torch.scene_from_state(state, device=device)
