"""PyTorch port: camera basis and primary rays match the JAX package."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.core.camera import generate_rays as j_generate_rays
from vrenderer_pathtracer_tpu_torch.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer_tpu_torch.interop import camera_from_numpy

MOVES = [
    dict(),
    dict(origin=(5.0, -3.0, 120.0), yaw=0.2, pitch=-0.1, fov_deg=60.0),
    dict(origin=(-20.0, 10.0, 90.0), yaw=-0.7, pitch=0.5, fov_deg=90.0),
]


def _pair(move):
    j = JCamera.default()
    j = j._replace(**{k: jnp.asarray(v, jnp.float32) for k, v in move.items()})
    t = camera_from_numpy({k: np.asarray(v) for k, v in j._asdict().items()},
                          device="cpu")
    return j, t


@pytest.mark.parametrize("move", MOVES)
def test_basis_matches_jax(move):
    j, t = _pair(move)
    for a, b in zip(j.basis(), t.basis()):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)


@pytest.mark.parametrize("move", MOVES)
@pytest.mark.parametrize("size", [(16, 12), (64, 25)])
def test_generate_rays_matches_jax(move, size):
    j, t = _pair(move)
    jo, jd = j_generate_rays(j, *size)
    to, td = generate_rays(t, *size)
    assert td.shape == (size[0] * size[1], 3)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-6)


def test_default_pixel_ids_and_pitch_clamp():
    cam = Camera.default("cpu")
    np.testing.assert_array_equal(cam.origin.numpy(), [0.0, 0.0, 150.0])
    assert pixel_ids(4, 3, "cpu").tolist() == list(range(12))
    clamped = cam.replace(pitch=torch.tensor(3.0)).with_pitch_clamped()
    assert abs(float(clamped.pitch) - np.pi / 2) < 1e-6


def test_rays_differentiable_wrt_camera():
    cam = Camera.default("cpu")
    yaw = torch.tensor(0.1, requires_grad=True)
    _, d = generate_rays(cam.replace(yaw=yaw), 8, 8)
    d[:, 0].sum().backward()
    assert yaw.grad is not None and torch.isfinite(yaw.grad) and yaw.grad != 0


# Key scripts of orbit (dx, dy pixels) and dolly (amount) steps; the last
# two drive the pitch past +-pi/2, where the clamp holds it.
SCRIPTS = [
    [("orbit", 40.0, 0.0), ("orbit", 0.0, 40.0), ("forward", 6.0)],
    [("orbit", -24.0, 32.0), ("forward", -6.0), ("orbit", 1234.5, -7.0),
     ("forward", 48.0)],
    [("orbit", 0.0, 600.0), ("orbit", 0.0, 600.0), ("forward", 6.0),
     ("orbit", 3.0, -40.0)],
    [("orbit", 5.0, -2000.0), ("forward", -12.5)],
]


@pytest.mark.parametrize("script", SCRIPTS)
def test_orbit_and_move_forward_match_jax_bit_for_bit(script):
    j, t = JCamera.default(), Camera.default("cpu")
    for op, *a in script:
        j = j.orbit(*a) if op == "orbit" else j.move_forward(*a)
        t = t.orbit(*a) if op == "orbit" else t.move_forward(*a)
        for name in ("yaw", "pitch", "origin"):
            got, want = getattr(t, name).numpy(), np.asarray(getattr(j, name))
            assert got.dtype == want.dtype == np.float32
            assert got.tobytes() == want.tobytes(), (op, a, name, got, want)
    assert abs(float(t.pitch)) <= np.float32(np.pi / 2)
    assert t.DRAG_RAD_PER_PX == JCamera.DRAG_RAD_PER_PX


def test_pitch_clamps_at_half_pi():
    up = Camera.default("cpu").orbit(0.0, 1e4)
    down = Camera.default("cpu").orbit(0.0, -1e4)
    assert up.pitch.item() == np.float32(np.pi / 2)
    assert down.pitch.item() == -np.float32(np.pi / 2)
    assert up.pitch.dtype == torch.float32 and up.pitch.device == up.device
