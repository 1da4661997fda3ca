"""PyTorch port: compact bounce waves, bounce remat and ray sorting
against the port's own full-width chain and against the JAX package.

The compact chain gathers the lanes that hit anything after the primary
search and runs every later bounce on them alone, with each lane's own
arithmetic and RNG streams, so its image is the full-width chain's bit for
bit.  Against the JAX XLA ``render_pass`` (also with ``compact_waves``) the
images agree within the repo's outlier-tolerant bounds (two differently
compiled programs flip a few discrete branches), and the HDRI and MERL
gradients under tests/test_paged_grad_parity.py's policy.  The scene is
tests/test_compact_waves.py's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_mesh_render import write_uv_sphere
from vrenderer_pathtracer_tpu.accel import sorting as j_sorting
from vrenderer_pathtracer_tpu.accel.mesh import pack_mesh as j_pack_mesh
from vrenderer_pathtracer_tpu.config import RenderSettings as JSettings
from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.core.camera import generate_rays as j_generate_rays
from vrenderer_pathtracer_tpu.core.camera import pixel_ids as j_pixel_ids
from vrenderer_pathtracer_tpu.native import load_obj as j_load_obj
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
from vrenderer_pathtracer_tpu.scene.spheres import build_sphere_set as j_spheres
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.accel import sorting
from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
from vrenderer_pathtracer_tpu_torch.accel.paged import pack_mesh_paged
from vrenderer_pathtracer_tpu_torch.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer_tpu_torch.native import load_obj
from vrenderer_pathtracer_tpu_torch.ops.brdf import TABLE_SIZE
from vrenderer_pathtracer_tpu_torch.render.integrator import render_pass
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import build_sphere_set

_j_render_pass = jax.jit(j_render_pass, static_argnames=("settings", "seed"))
# tests/test_paged_grad_parity.py's gradient policy.
GRAD_REL_L2, GRAD_TIGHT_FRAC = 5e-3, 0.995


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    p = tmp_path_factory.mktemp("tcompact") / "s.obj"
    write_uv_sphere(p, radius=10.0, n_theta=24, n_phi=24)
    rng = np.random.default_rng(0)
    hdr = rng.uniform(0, 1.5, (16, 32, 3)).astype(np.float32)
    brdf = rng.uniform(0.0, 0.05, (3, TABLE_SIZE)).astype(np.float32)
    host = load_obj(str(p))
    return dict(
        path=str(p), hdr=hdr, brdf=brdf,
        mesh=pack_mesh(host, device="cpu"),
        paged=pack_mesh_paged(host, 256, device="cpu"),
        jmesh=j_pack_mesh(j_load_obj(str(p)), paged=False))


def _scene(a, mesh, brdf=False):
    return Scene(spheres=build_sphere_set(False, "cpu"), mesh=a[mesh],
                 hdr=torch.tensor(a["hdr"]),
                 brdf=torch.tensor(a["brdf"]) if brdf else None)


def _rays(w, h, z):
    cam = Camera.default("cpu").replace(origin=torch.tensor([0.0, 0.0, z]))
    o, d = generate_rays(cam, w, h)
    return o, d, pixel_ids(w, h, "cpu")


def _port(scene, settings, w, h, z, frame=1):
    o, d, ids = _rays(w, h, z)
    return render_pass(scene, settings, o, d, ids, frame, torch.tensor(0.1),
                       torch.tensor(3.0))


def _jax(a, settings, w, h, z, frame=1, brdf=False, hdr=None):
    jscene = JScene(spheres=j_spheres(False), mesh=a["jmesh"],
                    hdr=jnp.asarray(a["hdr"] if hdr is None else hdr),
                    brdf=jnp.asarray(a["brdf"]) if brdf else None)
    cam = JCamera.default()._replace(origin=jnp.asarray([0.0, 0.0, z]))
    o, d = j_generate_rays(cam, w, h)
    return _j_render_pass(jscene, settings, o, d, j_pixel_ids(w, h),
                          jnp.uint32(frame), jnp.float32(0.1), jnp.float32(3.0))


def _settings(scene, **kw):
    return settings_for_scene(scene, vpt.RenderSettings(use_cornell_box=False,
                                                        **kw))


@pytest.mark.parametrize("z", [150.0, 40.0])
def test_compact_matches_full_width_bitwise(assets, z):
    """Single-level and paged meshes: the compact chain's image and depth
    are the full-width chain's, bit for bit."""
    for mesh in ("mesh", "paged"):
        scene = _scene(assets, mesh)
        s = _settings(scene, width=48, height=32, samples_per_pass=2,
                      bounces=3)
        assert s.compact_waves == (mesh == "paged")
        full = _port(scene, s.replace(compact_waves=False), 48, 32, z)
        comp = _port(scene, s.replace(compact_waves=True), 48, 32, z)
        assert float(full[0].abs().mean()) > 1e-3
        assert (full[1] < 1).any()
        for a, b in zip(comp, full):
            assert torch.equal(a, b), (mesh, z)


@pytest.mark.parametrize("z", [150.0, 40.0])
def test_compact_matches_jax_compact(assets, z):
    w, h = 64, 64
    kw = dict(width=w, height=h, samples_per_pass=2, bounces=3)
    scene = _scene(assets, "mesh")
    s = _settings(scene, compact_waves=True, **kw)
    got = _port(scene, s, w, h, z)
    js = JSettings(use_cornell_box=False, has_mesh=True, has_hdr=True,
                   traversal="xla", compact_waves=True, **kw)
    want = [np.asarray(x) for x in _jax(assets, js, w, h, z)]
    diff = np.abs(got[0].numpy() - want[0])
    assert (diff.max(axis=-1) > 1e-5).mean() < 0.02, (diff > 1e-5).mean()
    assert diff.mean() < 2e-3
    ddiff = np.abs(got[1].numpy() - want[1])
    assert (ddiff > 1e-3).mean() < 0.02
    assert (want[1] < 1).mean() > (0.002 if z == 150.0 else 0.2)


def _parity(got, want):
    got, want = got.astype(np.float64), want.astype(np.float64)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12)
    denom = np.abs(want) + 1e-4 * np.abs(want).max() + 1e-12
    tight = np.mean(np.abs(got - want) / denom < 1e-2)
    assert rel < GRAD_REL_L2, rel
    assert tight >= GRAD_TIGHT_FRAC, tight


def _port_grads(a, mesh, settings, w, h, z):
    scene = _scene(a, mesh, brdf=True)
    hdr = scene.hdr.clone().requires_grad_()
    brdf = scene.brdf.clone().requires_grad_()
    o, d, ids = _rays(w, h, z)
    rgb, _ = render_pass(scene.replace(hdr=hdr, brdf=brdf), settings, o, d,
                         ids, 3, torch.tensor(0.1), torch.tensor(3.0))
    loss = torch.mean(rgb ** 2)
    g_hdr, g_brdf = torch.autograd.grad(loss, (hdr, brdf))
    return loss.item(), g_hdr.numpy(), g_brdf.numpy()


def test_compact_gradients_match_jax(assets):
    """HDRI and MERL gradients through the compact chain (on a paged mesh)
    against jax.value_and_grad of the JAX compact chain on the single-level
    mesh."""
    w, h, z = 32, 32, 40.0
    kw = dict(width=w, height=h, samples_per_pass=1, bounces=2,
              use_brdf=True)
    s = _settings(_scene(assets, "paged", brdf=True), **kw)
    assert s.compact_waves and s.has_brdf
    loss, g_hdr, g_brdf = _port_grads(assets, "paged", s, w, h, z)
    js = JSettings(use_cornell_box=False, has_mesh=True, has_hdr=True,
                   has_brdf=True, traversal="xla", compact_waves=True, **kw)
    jscene = JScene(spheres=j_spheres(False), mesh=assets["jmesh"])
    cam = JCamera.default()._replace(origin=jnp.asarray([0.0, 0.0, z]))
    o, d = j_generate_rays(cam, w, h)
    ids = j_pixel_ids(w, h)

    def loss_fn(hdr, brdf):
        rgb, _ = j_render_pass(jscene._replace(hdr=hdr, brdf=brdf), js, o, d,
                               ids, jnp.uint32(3), jnp.float32(0.1),
                               jnp.float32(3.0))
        return jnp.mean(rgb ** 2)

    jl, (jg_hdr, jg_brdf) = jax.jit(jax.value_and_grad(loss_fn, (0, 1)))(
        jnp.asarray(assets["hdr"]), jnp.asarray(assets["brdf"]))
    np.testing.assert_allclose(loss, float(jl), rtol=1e-4)
    assert np.abs(g_brdf).sum() > 0 and np.abs(g_hdr).sum() > 0
    _parity(g_hdr, np.asarray(jg_hdr))
    _parity(g_brdf, np.asarray(jg_brdf))


def test_remat_gradients_equal_plain(assets):
    """remat_bounces recomputes each bounce in the backward pass: the same
    gradients, bit for bit, through the full-width and the compact chain."""
    w, h, z = 24, 16, 40.0
    for compact in (False, True):
        s = _settings(_scene(assets, "mesh", brdf=True), width=w, height=h,
                      samples_per_pass=2, bounces=3, use_brdf=True,
                      compact_waves=compact)
        plain = _port_grads(assets, "mesh", s, w, h, z)
        remat = _port_grads(assets, "mesh", s.replace(remat_bounces=True),
                            w, h, z)
        assert plain[0] == remat[0]
        for a, b in zip(plain[1:], remat[1:]):
            assert np.array_equal(a, b), compact


def test_ray_sort_keys_match_jax():
    rng = np.random.default_rng(5)
    o = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = 0.0  # octant ties and the 0.5 direction code
    lo = np.array([-20.0, -15.0, -10.0], np.float32)
    hi = np.array([20.0, 25.0, 10.0], np.float32)
    want = np.asarray(j_sorting.ray_sort_keys(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(lo), jnp.asarray(hi)))
    got = sorting.ray_sort_keys(torch.tensor(o), torch.tensor(d),
                                torch.tensor(lo), torch.tensor(hi))
    assert got.dtype == torch.int64 and got.min() >= 0
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_sorted_traverse_equals_unsorted(assets):
    """Sorting reorders the rays and scatters the results back: the same
    (slot, t) per ray, dead lanes (t_max 0) included, for the single-level
    and the paged plain searches; mesh_bounds reads the page boxes of a
    paged mesh."""
    rng = np.random.default_rng(6)
    n = 2048
    o = torch.tensor(rng.uniform(-25, 25, (n, 3)).astype(np.float32))
    d = torch.tensor(rng.standard_normal((n, 3)).astype(np.float32))
    d = d / d.norm(dim=1, keepdim=True)
    t_max = torch.tensor(rng.choice([1e6, 0.0], n, p=[0.9, 0.1])
                         .astype(np.float32))
    for name, search in (("mesh", trav.traverse),
                         ("paged", trav.traverse_paged_reference)):
        mesh = assets[name]
        want = search(mesh, o, d, t_max)
        got = sorting.sorted_traverse(search, mesh, o, d, t_max)
        assert (want[0] >= 0).sum() > 100
        assert all(torch.equal(a, b) for a, b in zip(got, want)), name
    lo, hi = sorting.mesh_bounds(assets["paged"])
    lo1, hi1 = sorting.mesh_bounds(assets["mesh"])
    assert torch.allclose(lo, lo1, atol=1e-5) and torch.allclose(hi, hi1, atol=1e-5)


def test_sort_rays_renders_the_same_image(assets):
    r = {}
    for sort in (False, True):
        t = vpt.Renderer(24, 24, device="cpu", settings=vpt.RenderSettings(
            samples_per_pass=2, bounces=3, sort_rays=sort))
        t.init_mesh(assets["paged"])
        t.load_hdr(assets["hdr"])
        t.update_camera(origin=(0.0, 0.0, 40.0))
        assert t.settings.sort_rays == sort and t.settings.compact_waves
        r[sort] = t.render_frames(1)
    assert all(np.array_equal(a, b) for a, b in zip(r[False], r[True]))


def test_compact_waves_follow_the_current_mesh(assets):
    """A paged mesh turns compact waves on; a single-level mesh loaded
    after it turns them off again, unless the request asked for them."""
    for request in (False, True):
        t = vpt.Renderer(8, 8, device="cpu", settings=vpt.RenderSettings(
            compact_waves=request))
        assert t.settings.compact_waves == request
        t.init_mesh(assets["paged"])
        assert t.settings.compact_waves
        t.init_mesh(assets["mesh"])
        assert t.settings.compact_waves == request
        t.load_hdr(assets["hdr"])
        assert t.settings.compact_waves == request
