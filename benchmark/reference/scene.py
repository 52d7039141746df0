"""Scene tensors: the pinhole camera and its pose, the black hole with its
disk frame, the clock and the 16x16x4 ``disk_gain`` grid."""

from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch


def _vec(values, device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


@dataclasses.dataclass
class Camera:
    """World-up (0, -1, 0)."""

    position: torch.Tensor  # (3,)
    forward: torch.Tensor  # (3,)
    fov: torch.Tensor  # () radians

    def right(self) -> torch.Tensor:
        """normalize(forward x (0, -1, 0))."""
        r = torch.linalg.cross(self.forward, _vec((0.0, -1.0, 0.0), self.position.device))
        return r / torch.linalg.vector_norm(r)

    def rotated(self, yaw: torch.Tensor, pitch: torch.Tensor) -> "Camera":
        """Yaw about world +y, then pitch about the camera's right axis,
        each by Rodrigues' formula."""

        def axis_rot(v, axis, angle):
            axis = axis / torch.linalg.vector_norm(axis)
            c, s = torch.cos(angle), torch.sin(angle)
            return (v * c + torch.linalg.cross(axis, v) * s
                    + axis * torch.dot(axis, v) * (1.0 - c))

        fwd = axis_rot(self.forward, _vec((0.0, 1.0, 0.0), self.position.device), yaw)
        fwd = axis_rot(fwd, self.right(), pitch)
        return dataclasses.replace(self, forward=fwd)


@dataclasses.dataclass
class BlackHole:
    position: torch.Tensor  # (3,)
    mass: torch.Tensor
    spin: torch.Tensor
    disk_rotation: torch.Tensor  # (3,) Euler angles
    disk_inner: torch.Tensor
    disk_outer: torch.Tensor
    rotation_speed: torch.Tensor
    relativity_radius: torch.Tensor
    feather: torch.Tensor
    horizon_radius: torch.Tensor

    def disk_frame(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(rotation matrix, disk normal): rot = Rz @ Ry @ Rx, up = rot @
        (0, -1, 0) normalised, right = (0, 0, 1) x up, forward = right x
        up; the matrix's columns are right, up, forward."""
        rx, ry, rz = self.disk_rotation.unbind()
        cx, sx = torch.cos(rx), torch.sin(rx)
        cy, sy = torch.cos(ry), torch.sin(ry)
        cz, sz = torch.cos(rz), torch.sin(rz)
        one, zero = torch.ones_like(rx), torch.zeros_like(rx)
        mat_x = torch.stack([torch.stack([one, zero, zero]),
                             torch.stack([zero, cx, -sx]),
                             torch.stack([zero, sx, cx])])
        mat_y = torch.stack([torch.stack([cy, zero, sy]),
                             torch.stack([zero, one, zero]),
                             torch.stack([-sy, zero, cy])])
        mat_z = torch.stack([torch.stack([cz, -sz, zero]),
                             torch.stack([sz, cz, zero]),
                             torch.stack([zero, zero, one])])
        rot = mat_z @ mat_y @ mat_x
        up = rot @ _vec((0.0, -1.0, 0.0), rx.device)
        up = up / torch.linalg.norm(up)
        right = torch.linalg.cross(_vec((0.0, 0.0, 1.0), rx.device), up)
        forward = torch.linalg.cross(right, up)
        return torch.stack([right, up, forward], dim=1), up


@dataclasses.dataclass
class Scene:
    camera: Camera
    black_hole: BlackHole
    time: torch.Tensor  # ()
    disk_gain: torch.Tensor  # (16, 16, 4)


def scene_from_numbers(numbers: Mapping, device) -> Scene:
    """The scene of a configuration file's ``scene`` group: ``camera`` and
    ``black_hole`` field values, ``time``, and ``disk_gain`` (a constant
    filling the 16x16x4 grid)."""
    cam = Camera(**{k: _vec(v, device) for k, v in numbers["camera"].items()})
    bh = BlackHole(**{k: _vec(v, device) for k, v in numbers["black_hole"].items()})
    gain = torch.full((16, 16, 4), float(numbers["disk_gain"]), dtype=torch.float32,
                      device=device)
    return Scene(camera=cam, black_hole=bh, time=_vec(numbers["time"], device),
                 disk_gain=gain)


def posed(scene: Scene, yaw: torch.Tensor, pitch: torch.Tensor,
          time: torch.Tensor) -> Scene:
    """``scene`` seen through its camera rotated by (yaw, pitch) at ``time``."""
    return dataclasses.replace(scene, camera=scene.camera.rotated(yaw, pitch), time=time)


def with_params(scene: Scene, params: Mapping) -> Scene:
    """``scene`` with the fitted fields taken from ``params``: the black
    hole's fields by name, the camera's under a ``cam_`` prefix."""
    bh = dataclasses.replace(scene.black_hole, **{
        k: v for k, v in params.items() if not k.startswith("cam_")})
    cam = dataclasses.replace(scene.camera, **{
        k[4:]: v for k, v in params.items() if k.startswith("cam_")})
    return dataclasses.replace(scene, black_hole=bh, camera=cam)
