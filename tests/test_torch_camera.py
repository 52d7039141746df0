"""bhx_torch's camera pose methods (``Camera.look_at``, ``right``,
``rotated``) against ``bhx.scene.Camera`` on the CPU, and a 64x36 render
through a rotated and through a looked-at camera against bhx's ``fast``
render.  Inputs are made with numpy from seeds and handed to both packages.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_camera.py -q
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bhx.pipeline import render_jit
from bhx.scene import Camera as JaxCamera
from bhx.scene import scene_to_state

import bhx_torch
from bhx_torch.scene import Camera

from tests.common import FAST_CFG, small_scene
from tests.test_torch_pipeline import _bad_frac, torch_cfg

torch.set_num_threads(2)

ATOL = 2e-6


def _cameras(position, forward, fov=1.0):
    """The same camera in both packages, from numpy."""
    pos, fwd = np.asarray(position, np.float32), np.asarray(forward, np.float32)
    jcam = JaxCamera(position=jnp.asarray(pos), forward=jnp.asarray(fwd),
                     fov=jnp.float32(fov))
    tcam = Camera(position=torch.from_numpy(pos), forward=torch.from_numpy(fwd),
                  fov=torch.tensor(fov, dtype=torch.float32))
    return jcam, tcam


def _case(seed: int):
    """A camera off the axes with an unnormalised forward (length 0.5-2), a
    target off the axes, and yaw and pitch in [-pi, pi]."""
    rng = np.random.default_rng(seed)
    fwd = rng.normal(size=3)
    fwd *= rng.uniform(0.5, 2.0) / np.linalg.norm(fwd)
    jcam, tcam = _cameras(rng.uniform(-20.0, 20.0, 3), fwd)
    target = rng.uniform(-10.0, 10.0, 3).astype(np.float32)
    yaw, pitch = (float(x) for x in rng.uniform(-np.pi, np.pi, 2).astype(np.float32))
    return jcam, tcam, target, yaw, pitch


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("seed", range(6))
def test_pose_methods_match_bhx(seed):
    jcam, tcam, target, yaw, pitch = _case(seed)
    _close(tcam.right(), jcam.right())
    _close(tcam.look_at(target).forward, jcam.look_at(target).forward)
    _close(tcam.look_at(target).right(), jcam.look_at(target).right())
    _close(tcam.rotated(yaw, pitch).forward, jcam.rotated(yaw, pitch).forward)
    _close(tcam.rotated(yaw, pitch).right(), jcam.rotated(yaw, pitch).right())
    # The methods return new cameras and leave this one as it was.
    _close(tcam.forward, jcam.forward)


def test_right_along_world_up_is_nan_in_both():
    """Reference semantics: a forward along world-up (0, -1, 0) gives
    right() = 0/0 = NaN in both packages (no guard in either), and so a
    NaN pitch axis in ``rotated``."""
    jcam, tcam = _cameras([1.0, 2.0, -19.0], [0.0, -1.0, 0.0])
    assert np.isnan(np.asarray(jcam.right())).all()
    assert torch.isnan(tcam.right()).all()
    assert np.isnan(np.asarray(jcam.rotated(0.2, 0.1).forward)).all()
    assert torch.isnan(tcam.rotated(0.2, 0.1).forward).all()


@pytest.mark.parametrize("seed", range(3))
def test_composed_poses_match_bhx(seed):
    jcam, tcam, target, yaw, pitch = _case(seed)
    _close(tcam.rotated(yaw, pitch).rotated(-0.4 * pitch, 0.3 * yaw).forward,
           jcam.rotated(yaw, pitch).rotated(-0.4 * pitch, 0.3 * yaw).forward)
    _close(tcam.look_at(target).rotated(yaw, pitch).forward,
           jcam.look_at(target).rotated(yaw, pitch).forward)


def test_argument_types_and_graph():
    """Python floats, lists, tuples, numpy arrays and tensors give the same
    pose; tensors keep their autograd graph, and d(forward)/d(yaw, pitch)
    and d(forward)/d(target) match ``jax.jacobian`` through bhx."""
    jcam, tcam, target, yaw, pitch = _case(11)
    want = tcam.rotated(yaw, pitch).forward
    for y, p in ((np.float32(yaw), np.float32(pitch)),
                 (torch.tensor(yaw), torch.tensor(pitch)),
                 (torch.tensor(yaw, dtype=torch.float64), pitch)):
        torch.testing.assert_close(tcam.rotated(y, p).forward, want, atol=0, rtol=0)
    want = tcam.look_at(target).forward
    for t in (target.tolist(), tuple(target.tolist()), target, torch.from_numpy(target)):
        torch.testing.assert_close(tcam.look_at(t).forward, want, atol=0, rtol=0)

    angles = torch.tensor([yaw, pitch], requires_grad=True)
    fwd = tcam.rotated(angles[0], angles[1]).forward
    assert fwd.grad_fn is not None
    got = torch.stack([torch.autograd.grad(fwd[i], angles, retain_graph=True)[0]
                       for i in range(3)])
    jac = jax.jacobian(lambda a: jcam.rotated(a[0], a[1]).forward)(jnp.asarray([yaw, pitch]))
    np.testing.assert_allclose(got.numpy(), np.asarray(jac), atol=1e-5, rtol=0)

    t = torch.from_numpy(target).requires_grad_()
    fwd = tcam.look_at(t).forward
    assert fwd.grad_fn is not None
    got = torch.stack([torch.autograd.grad(fwd[i], t, retain_graph=True)[0] for i in range(3)])
    jac = jax.jacobian(lambda x: jcam.look_at(x).forward)(jnp.asarray(target))
    np.testing.assert_allclose(got.numpy(), np.asarray(jac), atol=1e-5, rtol=0)


def _posed_scenes(pose: str):
    """bhx's small test scene and the port's copy of it, both with the
    camera of ``chip_smoke.py``'s phase 10: the default camera turned by
    yaw 0.35 and pitch -0.15, or a camera at (6, -2, -18) looking at the
    hole."""
    jscene = small_scene()
    tscene = bhx_torch.scene_from_state(scene_to_state(jscene), "cpu")
    jcam, tcam = jscene.camera, tscene.camera
    if pose == "rotated":
        jcam, tcam = jcam.rotated(0.35, -0.15), tcam.rotated(0.35, -0.15)
    else:
        pos = np.float32([6.0, -2.0, -18.0])
        jcam = dataclasses.replace(jcam, position=jnp.asarray(pos)).look_at((0.0, 0.0, 0.0))
        tcam = dataclasses.replace(tcam, position=torch.from_numpy(pos)).look_at((0.0, 0.0, 0.0))
    return (dataclasses.replace(jscene, camera=jcam),
            dataclasses.replace(tscene, camera=tcam), tscene)


@pytest.mark.parametrize("pose", ["rotated", "look_at"])
def test_posed_render_matches_bhx(pose):
    """A 64x36 render (dense, no post) through the posed camera against
    bhx's fast render of the same scene, at test_toggles_match_bhx's gate:
    at most 2% of the pixels over 2e-2.  The pose moves the image."""
    jscene, tscene, unposed = _posed_scenes(pose)
    cfg = torch_cfg(FAST_CFG)
    want = np.asarray(render_jit(jscene, FAST_CFG), np.float32)
    got = bhx_torch.render(tscene, cfg).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    bad = _bad_frac(got, want)
    assert bad <= 0.02, f"{bad:.2%} pixels differ by more than 2e-2"
    assert _bad_frac(got, bhx_torch.render(unposed, cfg).numpy()) > 0.2
