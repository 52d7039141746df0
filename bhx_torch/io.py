"""Image and scene I/O (counterpart of ``bhx/io.py``): PNG save and load
through PIL, and the scene checkpoint.

A scene is saved as ``bhx.io.save_scene`` saves one -- an ``.npz`` of flat
keys (``camera.*``, ``bh.*``, the three textures, ``time``,
``disk_gain``, ``mesh<i>.*`` and ``num_meshes``), with an optional
``.json`` of the render config beside it -- so a file written by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from bhx_torch.config import RenderConfig
from bhx_torch.scene import (
    MESH_INDEX_FIELDS, TEXTURE_FIELDS, BlackHole, Camera, Mesh, Scene, _device, texture,
)


def to_uint8(img) -> np.ndarray:
    """A float image in [0, 1] (array or tensor) as uint8, rounded."""
    if torch.is_tensor(img):
        img = img.detach().cpu().numpy()
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def save_png(path: str, img) -> None:
    """Write a (H, W, 3|4) image, float in [0, 1] or uint8, as PNG."""
    from PIL import Image

    a = img.detach().cpu().numpy() if torch.is_tensor(img) else np.asarray(img)
    if a.dtype != np.uint8:
        a = to_uint8(a)
    Image.fromarray(a).save(path)


def load_image(path: str) -> np.ndarray:
    """A PNG or JPG as float32 RGB(A) in [0, 1] (reference texture.rs:10-76)."""
    from PIL import Image

    with Image.open(path) as img:
        return np.asarray(img).astype(np.float32) / 255.0


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_scene(path: str, scene: Scene, cfg: Optional[RenderConfig] = None) -> None:
    """The scene's tensors to ``path`` (.npz) in ``bhx.io``'s layout, and the
    config, if given, to the ``.json`` beside it.  An unset texture is
    written as the default bake, which ``bhx.io.load_scene`` needs."""
    flat: Dict[str, np.ndarray] = {}

    def put(prefix: str, obj) -> None:
        for f in dataclasses.fields(obj):
            if f.name != "name":
                flat[f"{prefix}{f.name}"] = _np(getattr(obj, f.name))

    put("camera.", scene.camera)
    put("bh.", scene.black_hole)
    for name in TEXTURE_FIELDS:
        flat[name] = _np(texture(scene, name))
    flat["time"] = _np(scene.time)
    flat["disk_gain"] = _np(scene.disk_gain)
    for i, mesh in enumerate(scene.meshes):
        put(f"mesh{i}.", mesh)
    flat["num_meshes"] = np.asarray(len(scene.meshes))
    np.savez_compressed(path, **flat)
    if cfg is not None:
        with open(os.path.splitext(path)[0] + ".json", "w") as fp:
            json.dump(config_to_dict(cfg), fp, indent=2, default=str)


def load_scene(path: str, device=None) -> Scene:
    """A scene saved by :func:`save_scene` or ``bhx.io.save_scene``, on the
    CUDA card unless ``device`` names another.  Mesh ``i`` is named
    ``mesh<i>``, as ``bhx`` names it; the materials are not read."""
    device = _device(device)

    def f32(a) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    with np.load(path) as z:
        def get(prefix: str, cls, **extra):
            kw = dict(extra)
            for f in dataclasses.fields(cls):
                key = f"{prefix}{f.name}"
                if key not in z:
                    continue
                if f.name in MESH_INDEX_FIELDS:
                    kw[f.name] = torch.from_numpy(z[key].astype(np.int32)).to(device)
                elif f.name == "visible":
                    kw[f.name] = torch.tensor(bool(z[key]), device=device)
                else:
                    kw[f.name] = f32(z[key])
            return cls(**kw)

        return Scene(
            camera=get("camera.", Camera),
            black_hole=get("bh.", BlackHole),
            time=f32(z["time"]),
            disk_gain=f32(z["disk_gain"]) if "disk_gain" in z
            else torch.ones((16, 16, 4), dtype=torch.float32, device=device),
            meshes=tuple(get(f"mesh{i}.", Mesh, name=f"mesh{i}")
                         for i in range(int(z["num_meshes"]))),
            **{n: f32(z[n]) for n in TEXTURE_FIELDS},
        )


def config_to_dict(cfg: RenderConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)
