"""Static render configuration (counterpart of ``bhx/config.py``).

Plain frozen dataclasses: they select code paths and shapes.  Scene
quantities (camera pose, black-hole parameters, ``disk_gain``) live in
:mod:`bhx_torch.scene` as tensors.

The port always runs the kernel path's semantics — a deferred record of
K=4 disk-crossing slots, one march round — so the TPU tiling knobs
(sublanes, unroll, vote interval, round steps, record guard) and the
``march_mode`` switch have no counterpart here.  Modes that are not ported
yet raise ``NotImplementedError`` naming their ROADMAP item; a
``geodesics`` other than "pseudo" or "kerr" raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple


class Integrator(enum.Enum):
    """Geodesic integrator selection (reference ray.wgsl:525-531)."""

    EULER = 0
    RK45 = 1


@dataclasses.dataclass(frozen=True)
class FxaaConfig:
    """FXAA 3.11 quality settings (reference fxaa.wgsl + fxaa_pipline.rs:69-92);
    the edge thresholds default to the reference's ULTRA preset."""

    enabled: bool = True
    edge_threshold_min: float = 0.0833
    edge_threshold_max: float = 0.250
    iterations: int = 12
    subpixel_quality: float = 0.75


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Coarse-to-fine adaptive ray grid (reference src/renderer/mod.rs:170-207).

    Level ``k`` has resolution ``next = multiplier * cur - (multiplier - 1)``
    per axis, so every ``multiplier``-th fine pixel lands exactly on a
    coarse pixel.  The default is base (72, 41), multiplier 3, 4 levels ->
    1918 x 1081.
    """

    base: Tuple[int, int] = (72, 41)  # (width, height)
    multiplier: int = 3
    levels: int = 4

    def resolution(self, level: int) -> Tuple[int, int]:
        w, h = self.base
        for _ in range(level):
            w = self.multiplier * w - (self.multiplier - 1)
            h = self.multiplier * h - (self.multiplier - 1)
        return (w, h)

    @property
    def final_resolution(self) -> Tuple[int, int]:
        return self.resolution(self.levels - 1)

    @staticmethod
    def for_resolution(
        width: int, height: int, levels: int = 4, multiplier: int = 3
    ) -> "LadderConfig":
        """Pick a base grid whose final level is at least (width, height)."""
        m = multiplier ** (levels - 1)
        # Invert final = base*m - (m-1)  =>  base = ceil((final + m - 1) / m)
        bw = -(-(width + m - 1) // m)
        bh = -(-(height + m - 1) // m)
        return LadderConfig(base=(bw, bh), multiplier=multiplier, levels=levels)


@dataclasses.dataclass(frozen=True)
class BloomConfig:
    """Bloom pyramid (reference src/renderer/mod.rs:219-256, bloom_*.wgsl)."""

    enabled: bool = True
    levels: int = 5
    # Fixed 3x3 tent radius in uv units used by the upsample pass.
    up_radius_uv: float = 0.005
    # Final image = mix_ratio * scene + (1 - mix_ratio) * bloom.
    mix_ratio: float = 0.7


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs of the renderer; defaults are the reference startup
    state, which is also ``bhx.RenderConfig()``'s."""

    width: int = 1918
    height: int = 1081

    # --- geodesic march ---
    # "pseudo": the reference's pseudo-Newtonian bending force.  "kerr":
    # exact Kerr null geodesics (Hamiltonian RK4 in Kerr-Schild
    # coordinates, ``bhx_torch.kerr``), spin from the scene's black hole.
    geodesics: str = "pseudo"
    integrator: Integrator = Integrator.EULER
    step_size: float = 0.15
    max_iterations: int = 2000
    # Coarse-to-fine subdivision threshold on escape-direction divergence.
    angle_division_threshold: float = 0.02

    # RK45 error control: a per-lane Cash-Karp controller whose rejected
    # lanes retry with the shrunken step on the next pass (bhx.integrate).
    rk_rtol: float = 1e-3
    rk_safety: float = 0.9
    rk_min_factor: float = 0.2
    rk_max_factor: float = 1.5
    rk_h_min: float = 1e-3
    rk_h_max: float = 1.0

    # --- feature toggles ---
    show_disk: bool = True
    show_disk_texture: bool = True
    show_redshift: bool = True
    show_sky: bool = True
    # Test the scene's meshes in the straight phases (bhx/config.py:174).
    render_meshes: bool = True
    texture_mode: str = "procedural"

    # Early-exit opacity threshold (reference ray.wgsl:578).
    opacity_cutoff: float = 0.005
    # Rays with <= this many march steps are classified "hit" for the
    # alpha encoding (reference ray.wgsl:583 `i <= 5`).
    few_iters_threshold: int = 5

    # --- ladder / post chain ---
    use_ladder: bool = True
    ladder: LadderConfig = LadderConfig()
    bloom: BloomConfig = BloomConfig()
    fxaa: FxaaConfig = FxaaConfig()
    tonemap: bool = True

    def __post_init__(self):
        if self.geodesics not in ("pseudo", "kerr"):
            raise ValueError(
                f"geodesics must be 'pseudo' or 'kerr', got {self.geodesics!r}"
            )
        if self.texture_mode != "procedural":
            raise NotImplementedError(
                f"texture_mode={self.texture_mode!r} is not ported to "
                "bhx_torch yet (array textures: ROADMAP A13)"
            )

    def ladder_for_output(self) -> LadderConfig:
        """Ladder whose final level covers (width, height)."""
        lw, lh = self.ladder.final_resolution
        if lw == self.width and lh == self.height:
            return self.ladder
        return LadderConfig.for_resolution(
            self.width, self.height, self.ladder.levels, self.ladder.multiplier
        )

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
