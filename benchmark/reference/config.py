"""The reference's static render settings, read from a configuration file
of the benchmark (``benchmark/configs/<name>.json``, its ``render`` and
``scene`` groups)."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple


@dataclasses.dataclass(frozen=True)
class Config:
    width: int
    height: int
    integrator: str  # "euler" or "rk45" (under the pseudo force)
    step_size: float
    max_iterations: int
    angle_division_threshold: float
    rk_rtol: float
    rk_safety: float
    rk_min_factor: float
    rk_max_factor: float
    rk_h_min: float
    rk_h_max: float
    show_disk: bool
    show_disk_texture: bool
    show_redshift: bool
    show_sky: bool
    opacity_cutoff: float
    few_iters_threshold: int
    use_ladder: bool
    ladder_base: Tuple[int, int]
    ladder_multiplier: int
    ladder_levels: int
    bloom: bool
    bloom_levels: int
    bloom_up_radius_uv: float
    bloom_mix_ratio: float
    fxaa: bool
    fxaa_edge_threshold_min: float
    fxaa_edge_threshold_max: float
    fxaa_iterations: int
    fxaa_subpixel_quality: float
    tonemap: bool
    # "pseudo": the pseudo-Newtonian force under ``integrator``; "kerr":
    # exact Kerr null geodesics (the Hamiltonian RK4, whatever the
    # integrator), spin from the scene's black hole.
    geodesics: str = "pseudo"

    def __post_init__(self):
        if self.geodesics not in ("pseudo", "kerr"):
            raise ValueError(f"geodesics must be 'pseudo' or 'kerr', got {self.geodesics!r}")

    @staticmethod
    def from_render(render: Mapping) -> "Config":
        """The settings of a configuration file's ``render`` group."""
        kw = dict(render)
        kw["ladder_base"] = tuple(kw["ladder_base"])
        return Config(**kw)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def ladder_resolution(self, level: int) -> Tuple[int, int]:
        """Level ``level``'s grid: next = m * cur - (m - 1) per axis."""
        w, h = self.ladder_base
        m = self.ladder_multiplier
        for _ in range(level):
            w, h = m * w - (m - 1), m * h - (m - 1)
        return w, h

    def ladder_for_output(self) -> "Config":
        """The settings whose ladder's last level covers (width, height):
        these, or a base grid picked for the output."""
        lw, lh = self.ladder_resolution(self.ladder_levels - 1)
        if (lw, lh) == (self.width, self.height):
            return self
        m = self.ladder_multiplier ** (self.ladder_levels - 1)
        base = (-(-(self.width + m - 1) // m), -(-(self.height + m - 1) // m))
        return self.replace(ladder_base=base)
