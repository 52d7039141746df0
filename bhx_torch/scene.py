"""Scene state as tensor dataclasses (counterpart of ``bhx/scene.py``).

Every leaf is a float32 tensor on one device; ``to(device)`` moves a
whole scene.  The constructors (``Scene.default``, ``Camera.default``,
``BlackHole.default``, :func:`scene_from_state`) put it on the CUDA card
unless given another device, and raise when there is no card: the CPU
(the plain versions of the kernels) is asked for by name.  The array
textures of ``texture_mode="array"`` (disk, sky, blackbody LUT) are
optional fields: one left unset is the default bake, which
:func:`texture` takes from ``bhx_torch.assets.default_textures`` (baked
and uploaded once per device) when an array-mode call first reads it, so
a procedural render neither bakes nor uploads them.  A :class:`Mesh`
holds a triangle mesh with its BVH (``bhx_torch.geometry.obj.make_mesh``
builds one).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, Optional, Tuple

import numpy as np
import torch


def _device(device) -> torch.device:
    """``device``, or the CUDA card when it is None; raises when the card
    is asked for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "bhx_torch: no CUDA card is available; pass device='cpu' to run "
            "the plain versions on the CPU"
        )
    return device


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


@functools.lru_cache(maxsize=None)
def const(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 constant vector on ``device``, copied there once (a host to
    device copy synchronises the stream, so per-frame code must not make
    one).  Shared between callers: never write to it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


class _TensorData:
    """``to(device)`` for a dataclass whose fields are tensors, such
    dataclasses, or tuples of them."""

    def to(self, device):
        def move(v):
            if isinstance(v, tuple):
                return tuple(move(x) for x in v)
            return v.to(device) if isinstance(v, (torch.Tensor, _TensorData)) else v

        return dataclasses.replace(self, **{
            f.name: move(getattr(self, f.name)) for f in dataclasses.fields(self)
        })


@dataclasses.dataclass
class Camera(_TensorData):
    """Pinhole camera (reference src/scene/camera.rs); world-up (0, -1, 0)."""

    position: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    fov: torch.Tensor  # () radians

    @staticmethod
    def default(device=None) -> "Camera":
        # Reference defaults: pos (0,0,-19), forward +z, fov 1 rad.
        device = _device(device)
        return Camera(
            position=_f32([0.0, 0.0, -19.0], device),
            forward=_f32([0.0, 0.0, 1.0], device),
            fov=_f32(1.0, device),
        )


@dataclasses.dataclass
class BlackHole(_TensorData):
    """Black hole + accretion disk (reference src/scene/blackhole.rs:16-28)."""

    position: torch.Tensor  # (3,)
    mass: torch.Tensor  # ()
    spin: torch.Tensor  # () dimensionless a/M (0 = Schwarzschild)
    disk_rotation: torch.Tensor  # (3,) Euler angles
    disk_inner: torch.Tensor  # ()
    disk_outer: torch.Tensor  # ()
    rotation_speed: torch.Tensor  # () disk texture angular speed
    relativity_radius: torch.Tensor  # () geodesic-integration sphere radius
    feather: torch.Tensor  # () sphere-boundary blend amount
    horizon_radius: torch.Tensor  # () opaque-sphere draw radius

    @staticmethod
    def default(device=None) -> "BlackHole":
        device = _device(device)
        return BlackHole(
            position=_f32([0.0, 0.0, 0.0], device),
            mass=_f32(0.5, device),
            spin=_f32(0.0, device),
            disk_rotation=_f32([0.15, 0.0, 0.25], device),
            disk_inner=_f32(2.0, device),
            disk_outer=_f32(10.0, device),
            rotation_speed=_f32(1.0, device),
            relativity_radius=_f32(20.0, device),
            feather=_f32(0.3, device),
            horizon_radius=_f32(1.0, device),
        )

    def disk_frame(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rotation_matrix, disk_normal) from the Euler angles, as in
        ``bhx.scene.BlackHole.disk_frame``: rot = Rz @ Ry @ Rx, up = the
        rotated (0,-1,0), right = (0,0,1) x up, forward = right x up,
        matrix columns [right, up, forward]."""
        rx, ry, rz = self.disk_rotation.unbind()
        cx, sx = torch.cos(rx), torch.sin(rx)
        cy, sy = torch.cos(ry), torch.sin(ry)
        cz, sz = torch.cos(rz), torch.sin(rz)
        one, zero = torch.ones_like(rx), torch.zeros_like(rx)
        mat_x = torch.stack([
            torch.stack([one, zero, zero]),
            torch.stack([zero, cx, -sx]),
            torch.stack([zero, sx, cx]),
        ])
        mat_y = torch.stack([
            torch.stack([cy, zero, sy]),
            torch.stack([zero, one, zero]),
            torch.stack([-sy, zero, cy]),
        ])
        mat_z = torch.stack([
            torch.stack([cz, -sz, zero]),
            torch.stack([sz, cz, zero]),
            torch.stack([zero, zero, one]),
        ])
        rot = mat_z @ mat_y @ mat_x
        up = rot @ const((0.0, -1.0, 0.0), rx.device)
        up = up / torch.linalg.norm(up)
        right = torch.linalg.cross(const((0.0, 0.0, 1.0), rx.device), up)
        forward = torch.linalg.cross(right, up)
        return torch.stack([right, up, forward], dim=1), up


@dataclasses.dataclass
class Mesh(_TensorData):
    """A triangle mesh with a flat BVH (``bhx.scene.Mesh``).

    BVH layout (``bhx_torch.geometry.bvh``): node i has the box
    [node_min[i], node_max[i]]; if node_count[i] == 0 its children are
    node_left[i] and node_left[i] + 1, otherwise it is a leaf holding the
    triangles lookup[node_left[i] : node_left[i] + node_count[i]].  Index
    arrays are int32."""

    points: torch.Tensor  # (P, 3) float32
    normals: torch.Tensor  # (Nn, 3) float32
    tri_points: torch.Tensor  # (T, 3) int32 indices into points
    tri_normals: torch.Tensor  # (T, 3) int32 indices into normals
    node_min: torch.Tensor  # (B, 3) float32
    node_max: torch.Tensor  # (B, 3) float32
    node_left: torch.Tensor  # (B,) int32
    node_count: torch.Tensor  # (B,) int32
    lookup: torch.Tensor  # (T,) int32
    position: torch.Tensor  # (3,) world offset (reference Model.position)
    visible: torch.Tensor  # () bool
    name: str = "mesh"

    @property
    def num_triangles(self) -> int:
        return self.tri_points.shape[0]


# The int32 index arrays of a Mesh.
MESH_INDEX_FIELDS = ("tri_points", "tri_normals", "node_left", "node_count", "lookup")


# The array textures of a Scene, by field name.
TEXTURE_FIELDS = ("disk_texture", "sky_texture", "temp_lut")


@dataclasses.dataclass
class Scene(_TensorData):
    """Camera, black hole, clock, the learnable 16x16x4 ``disk_gain`` grid
    (a multiplicative RGBA gain over the disk texture's uv square; all-ones
    is the identity; procedural mode), a tuple of :class:`Mesh`, and the
    array textures of ``texture_mode="array"``, through which that mode's
    gradients reach the texture content (None: the default bake, see
    :func:`texture`)."""

    camera: Camera
    black_hole: BlackHole
    time: torch.Tensor  # () seconds, drives disk texture rotation
    disk_gain: torch.Tensor  # (16, 16, 4)
    meshes: Tuple[Mesh, ...] = ()
    disk_texture: Optional[torch.Tensor] = None  # (Th, Tw, 4) RGBA in [0, 1]
    sky_texture: Optional[torch.Tensor] = None  # (Sh, Sw, 3) equirect, radiance^(1/4)
    temp_lut: Optional[torch.Tensor] = None  # (Lh, Lw, 3) x = shift, y = temperature

    def __post_init__(self):
        self.meshes = tuple(self.meshes)

    @staticmethod
    def default(device=None, meshes: Tuple[Mesh, ...] = (), disk_texture=None,
                sky_texture=None, temp_lut=None) -> "Scene":
        """The reference's startup scene.  A texture given (an array or a
        tensor) is put on the scene's device as float32; one not given is
        the default bake (:func:`texture`)."""
        device = _device(device)

        def tex(t):
            if t is None:
                return None
            t = t if torch.is_tensor(t) else torch.from_numpy(np.asarray(t, np.float32))
            return t.to(device, torch.float32)

        return Scene(
            camera=Camera.default(device),
            black_hole=BlackHole.default(device),
            time=_f32(0.0, device),
            disk_gain=torch.ones((16, 16, 4), dtype=torch.float32, device=device),
            meshes=meshes,
            disk_texture=tex(disk_texture),
            sky_texture=tex(sky_texture),
            temp_lut=tex(temp_lut),
        )


def texture(scene: Scene, name: str) -> torch.Tensor:
    """The scene's array texture ``name`` (one of TEXTURE_FIELDS), or, when
    it is unset, the default bake on the scene's device
    (``bhx_torch.assets.default_textures``: baked and uploaded once per
    device)."""
    t = getattr(scene, name)
    if t is None:
        from bhx_torch.assets import default_textures

        t = default_textures(scene.time.device)[name]
    return t


def with_textures(scene: Scene) -> Scene:
    """``scene`` with every unset array texture set to the default bake."""
    return dataclasses.replace(scene, **{n: texture(scene, n) for n in TEXTURE_FIELDS})


def with_spin(scene: Scene, spin: float) -> Scene:
    """``scene`` with its black hole's dimensionless spin set to ``spin``."""
    bh = scene.black_hole
    return dataclasses.replace(scene, black_hole=dataclasses.replace(
        bh, spin=torch.full((), float(spin), dtype=torch.float32,
                            device=bh.spin.device)))


def scene_to_state(scene: Scene) -> dict:
    """The numpy snapshot of ``scene`` in ``bhx.scene.scene_to_state``'s
    layout, which :func:`scene_from_state` reads back (an unset texture
    stays absent; a mesh's name is a 0-d string array).  Processes pass
    scenes to each other so."""
    def fields(obj) -> dict:
        out = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            out[f.name] = np.asarray(v) if f.name == "name" else v.detach().cpu().numpy()
        return out

    state = dict(camera=fields(scene.camera), black_hole=fields(scene.black_hole),
                 time=scene.time.detach().cpu().numpy(),
                 disk_gain=scene.disk_gain.detach().cpu().numpy(),
                 meshes=tuple(fields(m) for m in scene.meshes))
    for n in TEXTURE_FIELDS:
        if getattr(scene, n) is not None:
            state[n] = getattr(scene, n).detach().cpu().numpy()
    return state


def scene_from_state(state: Mapping, device=None) -> Scene:
    """Build a :class:`Scene` from the numpy dict that
    ``bhx.scene.scene_to_state`` returns, so both packages render the same
    scene, textures included (an absent texture is the default bake).  The
    materials, which no shader reads, are ignored; a ``None`` gain becomes
    the all-ones identity grid.  Each mesh comes as a dict of its fields, its
    ``name`` a 0-d string array; index arrays stay int32.  On the CUDA
    card unless ``device`` names another."""
    device = _device(device)

    def build(cls, sub):
        return cls(**{
            f.name: _f32(sub[f.name], device) for f in dataclasses.fields(cls)
        })

    def mesh(sub):
        missing = [f.name for f in dataclasses.fields(Mesh) if f.name not in sub]
        if missing:
            raise ValueError(f"a mesh's state lacks {missing}")
        fields = {}
        for f in dataclasses.fields(Mesh):
            v = sub[f.name]
            if f.name == "name":
                fields[f.name] = str(np.asarray(v))
            elif f.name == "visible":
                fields[f.name] = torch.tensor(bool(np.asarray(v)), device=device)
            elif f.name in MESH_INDEX_FIELDS:
                fields[f.name] = torch.tensor(np.asarray(v, np.int32), device=device)
            else:
                fields[f.name] = _f32(v, device)
        return Mesh(**fields)

    gain = state.get("disk_gain")
    if gain is None:
        gain = np.ones((16, 16, 4), np.float32)
    return Scene(
        camera=build(Camera, state["camera"]),
        black_hole=build(BlackHole, state["black_hole"]),
        time=_f32(state["time"], device),
        disk_gain=_f32(gain, device),
        meshes=tuple(mesh(m) for m in state.get("meshes", ())),
        **{n: _f32(state[n], device) for n in TEXTURE_FIELDS
           if state.get(n) is not None},
    )
