"""The port's sharded train steps against the JAX package's (CPU).

The port's steps run on a four-rank gloo group spawned by
tests/test_torch_multihost.py (``rank_train``), the JAX side here on the
8-device CPU mesh of tests/conftest.py, both towards the same targets (the
port's one-device renders, which agree with JAX's to float32 rounding):

* ``sharded_train_step`` with the camera and the HDRI trained (2x2: the
  wavefront route with the sample-mean form) against ``jax.value_and_grad``
  on one device, at tests/test_sharding.py's tolerances; the Cornell scene
  on 4x1 (K2's route: its plain version on the CPU) and 2x2 (the
  wavefront's) against each other, tightly, and against JAX;
* ``sharded_opt_step`` with Adam against optax's Adam on JAX's loss: the
  same losses step by step;
* ``sharded_deferred_opt_step`` on an HDRI: one SGD(1.0) step's gradient
  against JAX ``sharded_deferred_opt_step``'s, and Adam descends.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tests.conftest import cpu_devices
from tests.test_torch_multihost import FC, FP, SETTINGS, hdr_scene, hdr_table, start
import vrenderer_pathtracer_tpu as jvpt
from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.core.camera import generate_rays, pixel_ids
from vrenderer_pathtracer_tpu.parallel import sharding as js
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.render import integrator
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene


def _jsettings(**kw):
    return jvpt.RenderSettings(**{**SETTINGS, **kw})


def _jscene(hdr: bool):
    if hdr:
        return JScene.analytic(_jsettings(use_cornell_box=False, has_hdr=True),
                               hdr=jnp.asarray(hdr_table()))
    return JScene.analytic(_jsettings())


@pytest.fixture(scope="module")
def port_train(tmp_path_factory):
    """The steps of rank_train, towards the true Cornell image and the true
    HDRI image at frame 1 (the port's one-device renders).  The ranks run
    while the tests' JAX side compiles; ``port_train()`` waits for them."""
    out = tmp_path_factory.mktemp("train")
    s = vpt.RenderSettings(**SETTINGS)
    cam = Camera.default("cpu")
    for name, (settings, scene) in (
            ("cornell", (s, Scene.analytic(s, "cpu"))), ("hdr", hdr_scene())):
        rgb, _ = integrator.render_camera_pass(scene, settings, cam, 1, FC, FP)
        np.save(out / f"{name}_target.npy", rgb.numpy())
    wait, done = start("train", 4, out), []

    def result():
        if not done:
            wait()
            done.append(True)
        return out

    return result


def _jloss_and_grad(hdr: bool, camera: bool):
    s = _jsettings(use_cornell_box=False, has_hdr=True) if hdr else _jsettings()
    scene = _jscene(hdr)
    cam = JCamera.default()
    target = jnp.zeros((s.n_pixels, 3), jnp.float32)

    def loss_fn(p):
        c = p.camera if p.camera is not None else cam
        rgb, _ = j_render_pass(js._apply_params(scene, p), s,
                               *generate_rays(c, s.width, s.height),
                               pixel_ids(s.width, s.height), jnp.uint32(1),
                               p.fresnel_coef, p.fresnel_pow)
        return jnp.sum((rgb - target) ** 2) / (s.n_pixels * 3)

    p0 = js.TrainParams.from_scene(scene, camera=cam if camera else None,
                                   optimize_hdr=hdr)
    if hdr:   # compiled: a few seconds where op by op takes ~20
        return jax.jit(jax.value_and_grad(loss_fn))(p0)
    # Op by op in the Cornell box, whose walls a compiled program flips on
    # a few paths (its loss 0.6% apart).
    return jax.value_and_grad(loss_fn)(p0)


def _grads(out, name, n, rank=0):
    return [np.load(out / f"{name}_grad{i}_{rank}.npy") for i in range(n)]


def test_sharded_train_step_with_camera_and_hdr_matches_jax(port_train):
    loss, g = _jloss_and_grad(hdr=True, camera=True)
    port_train = port_train()
    got = _grads(port_train, "hdr_2x2", 9)
    np.testing.assert_allclose(np.load(port_train / "hdr_2x2_loss_0.npy"),
                               float(loss), rtol=1e-3)
    assert np.abs(got[8]).sum() > 0
    np.testing.assert_allclose(got[8], np.asarray(g.hdr), rtol=2e-2, atol=2e-3)
    np.testing.assert_allclose(got[5], float(g.camera.yaw), rtol=2e-2, atol=1e-4)
    np.testing.assert_allclose(got[7], float(g.camera.fov_deg), rtol=2e-2,
                               atol=1e-4)
    for i, leaf in enumerate((g.color, g.emission)):
        np.testing.assert_allclose(got[i], np.asarray(leaf), rtol=2e-2, atol=2e-3)
    # Every rank took the same update.
    for rank in range(1, 4):
        for a, b in zip(_grads(port_train, "hdr_2x2", 9, rank), got):
            np.testing.assert_array_equal(a, b)


def test_sharded_train_step_routes_agree_and_match_jax(port_train):
    """The Cornell scene on 4x1 (K2's route) and on 2x2 (the wavefront's
    sample-mean form): one estimator, tight agreement, and JAX's gradient at
    tests/test_sharding.py's tolerance."""
    loss, g = _jloss_and_grad(hdr=False, camera=False)
    port_train = port_train()
    a = _grads(port_train, "cornell_4x1", 4)
    b = _grads(port_train, "cornell_2x2", 4)
    la, lb = (np.load(port_train / f"cornell_{m}_loss_0.npy")
              for m in ("4x1", "2x2"))
    np.testing.assert_allclose(la, lb, rtol=1e-6)
    np.testing.assert_allclose(la, float(loss), rtol=1e-3)
    for x, y, want in zip(a, b, jax.tree.leaves(g)):
        np.testing.assert_allclose(x, y, rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(x, np.asarray(want), rtol=2e-2, atol=2e-3)


def test_sharded_opt_step_adam_matches_jax(port_train):
    """Adam on the albedo over 4x1, in the open HDRI scene, against optax's
    Adam on JAX's one-device loss, step by step.  (In the Cornell box two
    programs flip a few paths on the walls: at frame 5 the loss of JAX's
    compiled pass is 4.4% apart from that of its op-by-op pass, which the
    port's matches, so no compiled JAX program is an oracle there at
    1e-3.)"""
    settings = _jsettings(use_cornell_box=False, has_hdr=True)
    scene = _jscene(True)
    target = jnp.asarray(np.load(port_train() / "hdr_target.npy"))
    rays = generate_rays(JCamera.default(), settings.width, settings.height)
    ids = pixel_ids(settings.width, settings.height)

    @jax.jit
    def loss_and_grad(color, frame):
        def loss_fn(c):
            rgb, _ = j_render_pass(
                scene._replace(spheres=scene.spheres._replace(color=c)),
                settings, *rays, ids, frame, jnp.float32(FC), jnp.float32(FP))
            return jnp.sum((rgb - target) ** 2) / (settings.n_pixels * 3)
        return jax.value_and_grad(loss_fn)(color)

    color = jnp.clip(scene.spheres.color + 0.2, 0, 1)
    opt = optax.adam(0.05)
    state = opt.init(color)
    want = []
    for i in range(6):
        loss, g = loss_and_grad(color, jnp.uint32(5 + i))
        updates, state = opt.update(g, state, color)
        color = color + updates
        want.append(float(loss))
    got = np.load(port_train() / "adam_losses_0.npy")
    assert got[-1] < got[0] * 0.7
    np.testing.assert_allclose(got, want, rtol=1e-3)


def test_sharded_deferred_opt_step_env_map_matches_jax(port_train):
    s = _jsettings(use_cornell_box=False, has_hdr=True)
    scene = _jscene(True)
    port_train = port_train()
    mesh = js.make_render_mesh(n_tiles=2, n_samples=2, devices=cpu_devices()[:4])
    target = js.shard_pixels(mesh, jnp.asarray(
        np.load(port_train / "hdr_target.npy")))
    p0 = js.DeferredParams(hdr=jnp.clip(scene.hdr + 0.3, 0, None))
    sgd = optax.sgd(1.0)
    step = js.sharded_deferred_opt_step(mesh, s, sgd, scene=scene)
    p1, _, m = step(js.replicate(mesh, p0),
                    js.replicate(mesh, jax.device_get(sgd.init(jax.device_get(p0)))),
                    js.replicate(mesh, scene), js.replicate(mesh, JCamera.default()),
                    target, jnp.uint32(5), jnp.float32(FC), jnp.float32(FP))
    np.testing.assert_allclose(np.load(port_train / "deferred_grad_0.npy"),
                               np.asarray(p0.hdr - p1.hdr), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(np.load(port_train / "deferred_sgd_losses_0.npy"),
                               [float(m["loss"])], rtol=1e-3)
    got = np.load(port_train / "deferred_adam_losses_0.npy")
    assert np.isfinite(got).all() and got[-1] < got[0] * 0.7
