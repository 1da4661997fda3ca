"""PyTorch port: K1's plain version against the JAX package, and the
wrapper's dispatch.

The plain version (``render_pass_reference``) is held against the Pallas
kernel in interpret mode and against the JAX integrator under the
cross-program contract of tests/test_pallas_radiance.py: fewer than 1% of
rgb elements differ by more than 1e-5 (branch flips on grazing rays), and
depth is within 1e-3.  K1 itself is tested on the card in
tests/test_torch_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vrenderer_pathtracer_tpu.config import RenderSettings as JSettings
from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.core.camera import generate_rays as j_generate_rays
from vrenderer_pathtracer_tpu.core.camera import pixel_ids as j_pixel_ids
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
from vrenderer_pathtracer_tpu.render.pallas_radiance import render_pass_pallas
from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
from vrenderer_pathtracer_tpu_torch import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera, generate_rays
from vrenderer_pathtracer_tpu_torch.interop import camera_from_numpy
from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene

CORNELL = dict(use_cornell_box=True, has_hdr=False)
# Interpret-mode Pallas compiles the unrolled spp x bounces loop, so the
# Pallas comparisons stay at 2 x 2; the integrator comparison runs 4 x 4.
PALLAS = dict(width=64, height=32, samples_per_pass=2, bounces=2, **CORNELL)
XLA = dict(width=64, height=32, samples_per_pass=4, bounces=4, **CORNELL)
MOVED = dict(origin=(5.0, -3.0, 120.0), yaw=0.2, pitch=-0.1, fov_deg=60.0)


def _assert_contract(rgb, depth, want_rgb, want_depth):
    d = np.abs(rgb.numpy() - np.asarray(want_rgb))
    assert (d > 1e-5).mean() < 0.01, f"{(d > 1e-5).mean():.4%} differ"
    assert np.abs(depth.numpy() - np.asarray(want_depth)).max() < 1e-3


def _cameras(move):
    j = JCamera.default()
    j = j._replace(**{k: jnp.asarray(v, jnp.float32) for k, v in move.items()})
    leaves = {k: np.asarray(v) for k, v in j._asdict().items()}
    return j, camera_from_numpy(leaves, device="cpu")


def _plain(cfg, frame, move=None, fc=0.1, fp=3.0):
    s = RenderSettings(**cfg)
    _, cam = _cameras(move or {})
    return k1.render_pass_reference(Scene.analytic(s, "cpu"), s, cam, frame,
                                    fc, fp)


@pytest.mark.parametrize("size", [(64, 32), (64, 25)])
@pytest.mark.parametrize("frame", [1, 3])
def test_plain_matches_pallas_interpret(size, frame):
    cfg = dict(PALLAS, width=size[0], height=size[1])
    js = JSettings(**cfg)
    want = render_pass_pallas(JScene.analytic(js), js, JCamera.default(),
                              jnp.uint32(frame), jnp.float32(0.1),
                              jnp.float32(3.0), interpret=True)
    rgb, depth = _plain(cfg, frame)
    assert rgb.shape == (size[0] * size[1], 3)
    _assert_contract(rgb, depth, *want)


@pytest.mark.parametrize("size,move", [
    ((64, 32), {}), ((64, 25), {}), ((64, 32), MOVED)])
@pytest.mark.parametrize("frame", [1, 3])
def test_plain_matches_integrator(size, move, frame):
    cfg = dict(XLA, width=size[0], height=size[1])
    js = JSettings(**cfg)
    jcam, _ = _cameras(move)
    ray_o, ray_d = j_generate_rays(jcam, *size)
    want = j_render_pass(JScene.analytic(js), js, ray_o, ray_d,
                         j_pixel_ids(*size), jnp.uint32(frame),
                         jnp.float32(0.1), jnp.float32(3.0))
    _assert_contract(*_plain(cfg, frame, move), *want)


def test_fresnel_sliders_change_plain_image():
    a, _ = _plain(PALLAS, 1)
    b, _ = _plain(PALLAS, 1, fc=0.9, fp=1.0)
    assert (a - b).abs().max() > 1e-3


def test_pack_camera_reproduces_generate_rays():
    """The kernel's [14] camera table rebuilds the primary rays."""
    s = RenderSettings(width=16, height=8, **CORNELL)
    _, cam = _cameras(MOVED)
    p = k1.pack_camera(cam, s, 0.25, 2.0).numpy()
    x = np.tile(np.arange(16, dtype=np.float32), 8)
    y = np.repeat(np.arange(8, dtype=np.float32), 16)
    u = ((0.25 + x) / 16 - 0.5)[:, None]
    v = ((0.25 + y) / 8 - 0.5)[:, None]
    d = p[3:6] + u * p[6:9] + v * p[9:12]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    _, want = generate_rays(cam, 16, 8)
    np.testing.assert_allclose(d, want.numpy(), atol=1e-6)
    np.testing.assert_allclose(p[:3], cam.origin.numpy())
    np.testing.assert_allclose(p[12:], [0.25, 2.0])


def test_pack_spheres_rows():
    scene = Scene.analytic(RenderSettings(**CORNELL), "cpu")
    t = k1.pack_spheres(scene.spheres).numpy()
    s = scene.spheres
    assert t.shape == (8, 14)
    np.testing.assert_array_equal(t[:, 0:3], s.pos.numpy())
    np.testing.assert_array_equal(t[:, 3], s.radius.numpy())
    np.testing.assert_array_equal(t[:, 7:10], s.emission.numpy())
    np.testing.assert_array_equal(t[:, 13], s.refl.numpy())


def test_supports_gating():
    s = RenderSettings(**XLA)
    scene = Scene.analytic(s, "cpu")
    assert k1.supports(scene, s)
    assert k1.supports(scene, s.replace(width=100, height=7))
    for flag in ("has_mesh", "has_hdr", "use_example_sphere", "has_brdf",
                 "has_diffuse_map"):
        assert not k1.supports(scene, s.replace(**{flag: True}))
    assert not k1.supports(scene, s.replace(use_cornell_box=False))


def test_cpu_scene_resolves_to_plain_path():
    s = RenderSettings(**XLA)
    scene = Scene.analytic(s, "cpu")
    resolved = settings_for_scene(scene, s.replace(has_hdr=True))
    assert resolved.radiance_kernel == "torch" and not resolved.has_hdr
    assert settings_for_scene(scene, s.replace(radiance_kernel="torch")) \
        .radiance_kernel == "torch"
    with pytest.raises(ValueError):
        settings_for_scene(scene, s.replace(radiance_kernel="cuda"))


def test_wrapper_takes_plain_version_for_cpu_tensors():
    s = RenderSettings(**PALLAS)
    scene, cam = Scene.analytic(s, "cpu"), Camera.default("cpu")
    before = k1.launch.count
    got = k1.render_pass_cuda(scene, s, cam, 2, 0.1, 3.0, 5)
    want = k1.render_pass_reference(scene, s, cam, 2, 0.1, 3.0, 5)
    assert k1.launch.count == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_wrapper_rejects_other_devices():
    s = RenderSettings(**PALLAS)
    scene = Scene.analytic(s, "meta")
    with pytest.raises(ValueError):
        k1.render_pass_cuda(scene, s, Camera.default("meta"), 1, 0.1, 3.0)


def test_unsupported_settings_raise():
    from vrenderer_pathtracer_tpu_torch.interop import train_params_from_numpy

    s = RenderSettings(**PALLAS)
    # Every setting is in scope now, a trainable HDRI in TrainParams too.
    z = np.zeros((9, 3), np.float32)
    p = train_params_from_numpy(
        {"color": z, "emission": z, "fresnel_coef": np.float32(0.1),
         "fresnel_pow": np.float32(3.0),
         "hdr": np.zeros((4, 8, 3), np.float32)}, device="cpu")
    assert tuple(p.hdr.shape) == (4, 8, 3) and len(p.leaves()) == 5
    # Compact bounce waves, ray sorting and attribute capture are in scope
    # (captured_attrs turns compact waves off, as in the JAX integrator).
    scene = Scene.analytic(s, "cpu")
    for flag in ("compact_waves", "sort_rays", "captured_attrs"):
        got = settings_for_scene(scene, s.replace(**{flag: True}))
        assert got.compact_waves == (flag == "compact_waves")
    # The MERL flags are in scope: K4 and the wavefront take them.
    settings_for_scene(scene, s.replace(use_example_sphere=True, use_brdf=True,
                                        brdf_importance_sampling=True))
    with pytest.raises(ValueError, match="MERL"):
        Scene(spheres=Scene.analytic(s, "cpu").spheres, brdf=torch.zeros(3, 8))


def test_launch_refuses_tables_off_the_card():
    s = RenderSettings(**PALLAS)
    scene, cam = Scene.analytic(s, "cpu"), Camera.default("cpu")
    with pytest.raises(ValueError):
        k1.launch(k1.pack_camera(cam, s, 0.1, 3.0), k1.pack_spheres(scene.spheres),
                  s, 1)
