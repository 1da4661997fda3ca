"""PyTorch port: a BASELINE-config-5-shaped scene at test size against the
JAX package.

The scene is examples/config5.py's, cut to run here: a paged UV sphere of
3,120 triangles over 7 pages (the spec sphere has ~499k over 122), the
gradient sky at 16x32, the Lambertian MERL table written as a ``.binary``
and read by ``load_brdf``, FXAA, remat; 48x32, 2 spp, 4 bounces, the
camera at z = 40 so the sphere fills the view.  The port's ``Renderer``
runs it on the CPU (paged plain search, compact waves); the JAX side runs
its XLA ``render_pass``, tonemap and ``fxaa`` on the same mesh packed
single-level.  Images are held to the golden contract of
tests/test_golden_cornell.py, the HDRI and MERL gradients to
tests/test_paged_grad_parity.py's policy.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_golden_cornell import _compare
from tests.test_mesh_render import write_uv_sphere
from vrenderer_pathtracer_tpu.accel.mesh import pack_mesh as j_pack_mesh
from vrenderer_pathtracer_tpu.config import RenderSettings as JSettings
from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.core.camera import generate_rays as j_generate_rays
from vrenderer_pathtracer_tpu.core.camera import pixel_ids as j_pixel_ids
from vrenderer_pathtracer_tpu.native import load_merl as j_load_merl
from vrenderer_pathtracer_tpu.native import load_obj as j_load_obj
from vrenderer_pathtracer_tpu.ops.fxaa import fxaa as j_fxaa
from vrenderer_pathtracer_tpu.ops.tonemap import tonemap as j_tonemap
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
from vrenderer_pathtracer_tpu.scene.spheres import build_sphere_set as j_spheres
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
from vrenderer_pathtracer_tpu_torch.accel.paged import pack_mesh_paged
from vrenderer_pathtracer_tpu_torch.examples.config5 import env_material_grads
from vrenderer_pathtracer_tpu_torch.native import load_obj
from vrenderer_pathtracer_tpu_torch.ops.brdf import TABLE_SIZE

W, H, Z = 48, 32, 40.0
GRAD_REL_L2, GRAD_TIGHT_FRAC = 5e-3, 0.995
_j_render_pass = jax.jit(j_render_pass, static_argnames=("settings", "seed"))


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    """examples/config5.py::synth_assets at test size."""
    tmp = tmp_path_factory.mktemp("tc5")
    obj = str(tmp / "mesh.obj")
    write_uv_sphere(obj, radius=12.0, n_theta=40, n_phi=40)
    v = np.linspace(0, 1, 16, dtype=np.float32)[:, None, None]
    sky = np.concatenate([1.2 * (1 - v), 0.7 * np.ones((16, 1, 1), np.float32),
                          1.2 * v], axis=2)
    sky = np.broadcast_to(sky, (16, 32, 3)).copy()
    brdf = str(tmp / "lambert.binary")
    scales = np.array([1.0, 1.15, 1.66]) / 1500.0
    with open(brdf, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        ((0.05 / scales)[:, None] * np.ones((3, TABLE_SIZE))).reshape(-1) \
            .astype(np.float64).tofile(f)
    return dict(obj=obj, sky=sky, brdf=brdf)


@pytest.fixture(scope="module")
def port(assets):
    mesh = pack_mesh_paged(load_obj(assets["obj"]), 512, device="cpu")
    r = vpt.Renderer(W, H, device="cpu", settings=vpt.RenderSettings(
        samples_per_pass=2, bounces=4, use_fxaa=True, use_brdf=True,
        remat_bounces=True))
    r.load_hdr(assets["sky"])
    r.load_brdf(assets["brdf"])
    r.init_mesh(mesh)
    r.update_camera(origin=(0.0, 0.0, Z))
    return r


def _jax_scene(assets):
    return JScene(spheres=j_spheres(False),
                  mesh=j_pack_mesh(j_load_obj(assets["obj"]), paged=False),
                  hdr=jnp.asarray(assets["sky"]),
                  brdf=jnp.asarray(j_load_merl(assets["brdf"])))


def _jax_settings():
    return JSettings(width=W, height=H, samples_per_pass=2, bounces=4,
                     use_cornell_box=False, use_brdf=True, has_mesh=True,
                     has_hdr=True, has_brdf=True, traversal="xla",
                     remat_bounces=True)


def _jax_rays():
    cam = JCamera.default()._replace(origin=jnp.asarray([0.0, 0.0, Z]))
    o, d = j_generate_rays(cam, W, H)
    return o, d, j_pixel_ids(W, H)


def test_config5_scene_resolves_and_renders_like_jax(assets, port):
    s = port.settings
    assert (s.radiance_kernel, s.traversal, s.compact_waves) == (
        "torch", "torch", True)
    assert s.use_fxaa and s.remat_bounces and s.has_brdf and s.has_hdr
    assert port.scene.mesh.paged.n_pages == 7
    before = (trav.traverse.count, trav.traverse_paged_reference.count)
    img, depth = port.render_frames(2)
    assert trav.traverse.count == before[0]
    assert trav.traverse_paged_reference.count == before[1] + 2 * s.bounces

    js, jscene = _jax_settings(), _jax_scene(assets)
    o, d, ids = _jax_rays()
    accum = jnp.zeros((W * H, 3), jnp.float32)
    for frame in (1, 2):
        rgb, jdepth = _j_render_pass(jscene, js, o, d, ids, jnp.uint32(frame),
                                     jnp.float32(0.1), jnp.float32(3.0))
        accum = accum + rgb
    jimg = j_fxaa(j_tonemap(accum, 2, js.gamma).reshape(H, W, 3), 0.75, 0.166)
    _compare(img, depth, np.asarray(jimg), np.asarray(jdepth).reshape(H, W))
    assert (depth < 1).mean() > 0.3 and img[H // 2, W // 2].mean() > 0.05


def test_config5_gradients_match_jax(assets, port):
    """Loss and gradients with respect to the MERL table and the HDRI
    (examples/config5.py's gradient: deferred_opt_step's loss, through
    remat and the compact chain) against jax.value_and_grad of the
    single-level XLA pass."""
    s = port.settings.replace(use_fxaa=False)
    rng = np.random.default_rng(5)
    target = rng.uniform(0, 1, (W * H, 3)).astype(np.float32)
    loss, g_brdf, g_hdr = env_material_grads(
        port.scene, s, port.camera, torch.tensor(target), port.fresnel_coef,
        port.fresnel_pow)

    js, jscene = _jax_settings(), _jax_scene(assets)
    jo, jd, ids = _jax_rays()

    def loss_fn(bt, e):
        rgb, _ = j_render_pass(jscene._replace(brdf=bt, hdr=e), js, jo, jd,
                               ids, jnp.uint32(1), jnp.float32(0.1),
                               jnp.float32(3.0))
        return jnp.mean((rgb - jnp.asarray(target)) ** 2)

    jl, (jg_brdf, jg_hdr) = jax.jit(jax.value_and_grad(loss_fn, (0, 1)))(
        jscene.brdf, jscene.hdr)
    assert np.isfinite(loss.item())
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-4)
    for got, want in ((g_brdf.numpy(), np.asarray(jg_brdf)),
                      (g_hdr.numpy(), np.asarray(jg_hdr))):
        assert np.isfinite(got).all() and np.abs(want).sum() > 0
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
        assert rel < GRAD_REL_L2, rel
        denom = np.abs(want) + 1e-4 * np.abs(want).max() + 1e-12
        assert np.mean(np.abs(got - want) / denom < 1e-2) >= GRAD_TIGHT_FRAC
