"""PyTorch port: the Cornell training step against the JAX package.

The port's plain K2 version (torch autograd through the integrator,
``cornell_loss_grads_reference``) is held against ``jax.value_and_grad`` of
the JAX package's XLA loss, the oracle that tests/test_pallas_grad.py holds
the Pallas K2 against, with that file's tolerances.  Gradients of a Monte
Carlo estimate are only comparable on the same sample set, so the
comparisons run on that file's well-conditioned scene at the first frame
where the two forwards agree on every rgb element to 1e-5 (a flipped branch
shifts the sums by a whole path).  Both packages get the same numpy-made
target and the same parameters, converted with ``interop``.  The Pallas
kernel itself is not run here (interpret mode takes tens of seconds a
call); K2 on the card is tested in tests/test_torch_cuda.py.  The four
Pallas K2 runs of tests/test_pallas_grad.py are ``slow`` (the root
conftest.py's ``SLOW``), outside tier-1, and run with
``python -m pytest -m slow tests/test_pallas_grad.py``; this file's main,
odd-size, camera and SGD cases hold the port to their contract in tier-1.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_pallas_grad import _benign_scene
from vrenderer_pathtracer_tpu.config import RenderSettings as JSettings
from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.core.camera import generate_rays as j_generate_rays
from vrenderer_pathtracer_tpu.core.camera import pixel_ids as j_pixel_ids
from vrenderer_pathtracer_tpu.parallel.sharding import TrainParams as JTrainParams
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch import interop
from vrenderer_pathtracer_tpu_torch.parallel import sharding
from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
from vrenderer_pathtracer_tpu_torch.render.cuda_radiance import render_pass_reference
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

CORNELL = dict(use_cornell_box=True, has_hdr=False)
MAIN = dict(width=64, height=32, samples_per_pass=2, bounces=4, **CORNELL)
ODD = dict(MAIN, height=25, bounces=2)
CAMERA = dict(width=32, height=32, samples_per_pass=2, bounces=3, **CORNELL)
SLIDERS = [(0.1, 3.0), (0.4, 1.5)]


def _numpy(tree):
    return {k: (None if v is None else
                _numpy(v) if hasattr(v, "_asdict") else np.asarray(v))
            for k, v in tree._asdict().items()}


def _jax_value_and_grad(jscene, js, target, with_camera, jit):
    """``jax.value_and_grad`` of the XLA train loss as a function of
    (TrainParams, frame); the rendered rgb rides along as aux.  On an
    8-core CPU the first call costs about 17 s eager at any size, while
    jit's compile grows with the bounces (7 s at 2, 12 s at 3, 22 s at 4),
    so the cases below 4 bounces are jitted."""
    cam = JCamera.default()
    ids = j_pixel_ids(js.width, js.height)
    inv_n = 1.0 / (js.n_pixels * 3)

    def loss_fn(p, frame):
        ray_o, ray_d = j_generate_rays(p.camera if with_camera else cam,
                                       js.width, js.height)
        s2 = jscene._replace(spheres=jscene.spheres._replace(
            color=p.color, emission=p.emission))
        rgb, _ = j_render_pass(s2, js, ray_o, ray_d, ids, frame,
                               p.fresnel_coef, p.fresnel_pow)
        return jnp.sum((rgb - target) ** 2) * inv_n, rgb

    vg = jax.value_and_grad(loss_fn, has_aux=True)
    return jax.jit(vg) if jit else vg


class Case:
    """One size of the benign scene in both packages, with a numpy target,
    at the first frame where the JAX and port forwards agree on every rgb
    element to 1e-5."""

    def __init__(self, cfg, target_seed, with_camera=False, max_frames=24):
        self.js = JSettings(**cfg)
        self.ts = vpt.RenderSettings(**cfg)
        self.jscene = _benign_scene()
        self.scene = interop.scene_from_numpy(_numpy(self.jscene.spheres),
                                              device="cpu")
        self.camera = vpt.Camera.default("cpu")
        self.with_camera = with_camera
        rng = np.random.default_rng(target_seed)
        target = rng.uniform(0, 0.5, (self.js.n_pixels, 3)).astype(np.float32)
        self.target = torch.from_numpy(target)
        self.vg = _jax_value_and_grad(self.jscene, self.js, jnp.asarray(target),
                                      with_camera, jit=self.js.bounces < 4)
        for frame in range(1, max_frames + 1):
            self.frame = frame
            _, (_, want), _ = self.reference(0.1, 3.0)
            got, _ = render_pass_reference(self.scene, self.ts, self.camera,
                                           frame, 0.1, 3.0)
            if np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5:
                return
        raise AssertionError(f"no flip-free frame in 1..{max_frames}")

    def reference(self, fc, fp):
        """The port's TrainParams and the JAX ``((loss, rgb), grads)`` at the
        same parameters."""
        p0 = JTrainParams.from_scene(
            self.jscene, fresnel_coef=fc, fresnel_pow=fp,
            camera=JCamera.default() if self.with_camera else None)
        (loss, rgb), grads = self.vg(p0, jnp.uint32(self.frame))
        return (interop.train_params_from_numpy(_numpy(p0), device="cpu"),
                (float(loss), rgb), grads)


@pytest.fixture(scope="module")
def main_case():
    case = Case(MAIN, 0)
    case.refs = {}
    for pair in SLIDERS:
        params, (loss, _), grads = case.reference(*pair)
        case.refs[pair] = params, loss, grads
    return case


def _assert_material_grads(out, loss, g):
    tloss, dcol, dem, dfc, dfp = (x.detach().numpy() for x in out[:5])
    np.testing.assert_allclose(tloss, loss, rtol=1e-4)
    np.testing.assert_allclose(dcol, np.asarray(g.color), rtol=1e-2, atol=2e-4)
    np.testing.assert_allclose(dem, np.asarray(g.emission), rtol=1e-2, atol=2e-4)
    np.testing.assert_allclose(dfc, float(g.fresnel_coef), rtol=1e-2, atol=1e-6)
    np.testing.assert_allclose(dfp, float(g.fresnel_pow), rtol=1e-2, atol=1e-6)


def _plain(case, params, with_camera=False):
    return k2.cornell_loss_grads_reference(
        sharding.apply_params(case.scene, params), case.ts,
        params.camera or case.camera, case.target, case.frame,
        params.fresnel_coef, params.fresnel_pow, with_camera=with_camera)


@pytest.mark.parametrize("pair", SLIDERS)
def test_plain_grads_match_jax_value_and_grad(main_case, pair):
    params, loss, g = main_case.refs[pair]
    out = _plain(main_case, params)
    assert out[1].shape == (7, 3) and out[2].shape == (7, 3)
    assert float(out[3]) != 0.0 and float(out[4]) != 0.0  # a Fresnel sphere is seen
    _assert_material_grads(out, loss, g)


def test_odd_size_plain_grads_match_jax_value_and_grad():
    case = Case(ODD, 3)
    params, (loss, _), g = case.reference(0.1, 3.0)
    _assert_material_grads(_plain(case, params), loss, g)


def test_camera_grads_match_jax_value_and_grad():
    case = Case(CAMERA, 1, with_camera=True)
    params, (loss, _), g = case.reference(0.1, 3.0)
    out = _plain(case, params, with_camera=True)
    _assert_material_grads(out, loss, g)
    dcam = out[5]
    np.testing.assert_allclose(dcam.origin.numpy(), np.asarray(g.camera.origin),
                               rtol=2e-2, atol=2e-6)
    np.testing.assert_allclose(float(dcam.yaw), float(g.camera.yaw),
                               rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(float(dcam.pitch), float(g.camera.pitch),
                               rtol=2e-2, atol=1e-5)
    np.testing.assert_allclose(float(dcam.fov_deg), float(g.camera.fov_deg),
                               rtol=2e-2, atol=1e-6)
    # The camera extension leaves the material gradients as they were.
    base = _plain(case, sharding.TrainParams(*params.leaves()[:4]))
    for a, b in zip(out[:5], base):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=0.0)


def test_train_step_matches_jax_sgd(main_case):
    """One port SGD step on the CPU equals p - lr * g with g from
    jax.value_and_grad, on the same parameters."""
    params, loss, g = main_case.refs[SLIDERS[0]]
    lr = 0.05
    step = vpt.train_step(main_case.ts, lr=lr, with_metrics=True, device="cpu")
    new, metrics = step(params, main_case.scene, main_case.camera,
                        main_case.target, main_case.frame)
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-4)
    for name, tol in (("color", 2e-4), ("emission", 2e-4),
                      ("fresnel_coef", 1e-6), ("fresnel_pow", 1e-6)):
        before = getattr(params, name).numpy()
        after = getattr(new, name).numpy()
        want = before - lr * np.asarray(getattr(g, name))
        np.testing.assert_allclose((before - after) / lr,
                                   np.asarray(getattr(g, name)),
                                   rtol=1e-2, atol=tol)
        np.testing.assert_allclose(after, want, rtol=1e-5, atol=lr * tol)
    gnorm = np.sqrt(sum(float(np.sum(np.asarray(x) ** 2))
                        for x in (g.color, g.emission, g.fresnel_coef,
                                  g.fresnel_pow)))
    np.testing.assert_allclose(float(metrics["grad_global_norm"]), gnorm,
                               rtol=1e-2)
    np.testing.assert_allclose(float(metrics["update_norm"]),
                               lr * float(metrics["grad_global_norm"]), rtol=1e-6)
    assert not any(t.requires_grad for t in new.leaves())


def test_cornell_loss_backward_scales_by_grad_output(main_case):
    """CornellLoss saves the gradients and scales them by grad_output (on
    the CPU its forward takes the plain version)."""
    params, _, _ = main_case.refs[SLIDERS[0]]
    leaves = [t.clone().requires_grad_() for t in params.leaves()]
    cam = main_case.camera
    loss = k2.CornellLoss.apply(*leaves, cam.origin, cam.yaw, cam.pitch,
                                cam.fov_deg, main_case.scene, main_case.ts,
                                main_case.target, main_case.frame, 0, False)
    (3.0 * loss).backward()
    want = _plain(main_case, params)
    torch.testing.assert_close(loss.detach(), want[0])
    for leaf, g in zip(leaves, want[1:]):
        torch.testing.assert_close(leaf.grad, 3.0 * g)


def test_adam_descends_on_cpu():
    """Adam on the light's emission recovers a brighter light (the
    descent test of tests/test_pallas_grad.py, at 32x32)."""
    s = vpt.RenderSettings(width=32, height=32, samples_per_pass=2, bounces=4,
                           **CORNELL)
    scene, cam = Scene.analytic(s, "cpu"), vpt.Camera.default("cpu")
    bright = scene.spheres.emission.clone()
    bright[0] *= 1.5
    target, _ = render_pass_reference(scene.replace_spheres(emission=bright),
                                      s, cam, 1, 0.1, 3.0)
    params = vpt.TrainParams.from_scene(scene)
    params.emission.requires_grad_()
    step = vpt.opt_step(s, torch.optim.Adam([params.emission], lr=0.1),
                        device="cpu")
    losses = []
    for _ in range(12):
        params, metrics = step(params, scene, cam, target, 1)
        losses.append(float(metrics["loss"]))
        assert float(metrics["grad_global_norm"]) > 0
    assert losses[-1] < 0.5 * losses[0], losses
    assert params.color.grad is None  # only the optimiser's leaf is trained


def test_wrapper_takes_plain_version_for_cpu_tensors(main_case):
    params, _, _ = main_case.refs[SLIDERS[0]]
    scene = sharding.apply_params(main_case.scene, params)
    args = (scene, main_case.ts, main_case.camera, main_case.target,
            main_case.frame, params.fresnel_coef, params.fresnel_pow, 0, True)
    before = k2.launch.count
    got = k2.cornell_loss_grads(*args)
    want = k2.cornell_loss_grads_reference(*args)
    assert k2.launch.count == before
    for a, b in zip(got[:5], want[:5]):
        assert torch.equal(a, b)
    for f in ("origin", "yaw", "pitch", "fov_deg"):
        assert torch.equal(getattr(got[5], f), getattr(want[5], f))


def test_wrapper_and_launch_refuse_other_devices():
    s = vpt.RenderSettings(**MAIN)
    target = torch.zeros((s.n_pixels, 3))
    meta = Scene.analytic(s, "meta")
    with pytest.raises(ValueError):
        k2.cornell_loss_grads(meta, s, vpt.Camera.default("meta"),
                              target.to("meta"), 1, 0.1, 3.0)
    scene, cam = Scene.analytic(s, "cpu"), vpt.Camera.default("cpu")
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1

    with pytest.raises(ValueError):
        k2.launch(k1.pack_camera(cam, s, 0.1, 3.0), k1.pack_spheres(scene.spheres),
                  s, target, 1)


def test_supports_gating():
    s = vpt.RenderSettings(**MAIN)
    scene = Scene.analytic(s, "cpu")
    assert k2.supports(scene, s)
    assert k2.supports(scene, s.replace(samples_per_pass=1, bounces=k2.MAX_RECORDS))
    assert not k2.supports(scene, s.replace(samples_per_pass=1,
                                            bounces=k2.MAX_RECORDS + 1))
    assert k2.supports(scene, s.replace(samples_per_pass=4, bounces=4))
    assert not k2.supports(scene, s.replace(samples_per_pass=5, bounces=4))
    assert not k2.supports(scene, s.replace(has_hdr=True))
    big = scene.replace_spheres(**{
        f: getattr(scene.spheres, f).repeat(9, *[1] * (getattr(scene.spheres, f).dim() - 1))
        for f in ("pos", "radius", "emission", "color", "refl", "spec_color")})
    assert big.spheres.count == 72 and not k2.supports(big, s)
    assert k2.n_partials(8, False) == 51 and k2.n_partials(8, True) == 63


def test_train_params_from_numpy():
    jscene = _benign_scene()
    p = JTrainParams.from_scene(jscene, fresnel_coef=0.3, fresnel_pow=2.0,
                                camera=JCamera.default())
    t = interop.train_params_from_numpy(_numpy(p), device="cpu")
    np.testing.assert_array_equal(t.color.numpy(), np.asarray(p.color))
    np.testing.assert_array_equal(t.emission.numpy(), np.asarray(p.emission))
    assert float(t.fresnel_coef) == pytest.approx(0.3)
    assert t.camera is not None and float(t.camera.fov_deg) == 75.0
    assert len(t.leaves()) == 8 and len(t.with_leaves(t.leaves()).leaves()) == 8
    bare = interop.train_params_from_numpy(_numpy(p._replace(camera=None)),
                                           device="cpu")
    assert bare.camera is None and len(bare.leaves()) == 4
    # A trainable HDRI converts and round-trips through leaves/with_leaves.
    hdr = np.random.default_rng(3).uniform(0, 1, (2, 4, 3)).astype(np.float32)
    t = interop.train_params_from_numpy(dict(_numpy(p), hdr=hdr), device="cpu")
    np.testing.assert_array_equal(t.hdr.numpy(), hdr)
    assert len(t.leaves()) == 9 and t.leaves()[-1] is t.hdr
    back = t.with_leaves(t.leaves())
    assert back.hdr is t.hdr and back.camera is not None


def test_steps_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    s = vpt.RenderSettings(**MAIN)
    with pytest.raises(RuntimeError):
        vpt.train_step(s)
    with pytest.raises(RuntimeError):
        vpt.opt_step(s, torch.optim.SGD([torch.zeros(1, requires_grad=True)], lr=0.1))
    step = vpt.train_step(s, device="cpu")
    scene = Scene.analytic(s, "cpu")
    with pytest.raises(ValueError):
        step(vpt.TrainParams.from_scene(scene), Scene.analytic(s, "meta"),
             vpt.Camera.default("cpu"), torch.zeros((s.n_pixels, 3)), 1)
