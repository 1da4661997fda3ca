"""PyTorch port: K4's plain version (``records_reference`` + ``compose``)
against the JAX XLA wavefront, the oracle tests/test_pallas_mesh.py holds
the Pallas K4 to; K4's scope; the deferred-table gradients; and the
``Renderer`` with a MERL table.

The scenes are those of tests/test_pallas_mesh.py at 32x32 (one at 64x64):
the mesh in the Cornell box, the textured mesh under an HDRI, out-of-range
uvs, the example sphere with a MERL table under an HDRI, and lobe MIS on
the example sphere and on the mesh.  Inputs are made from a seed with numpy
and handed to both packages.  Contract (tests/test_pallas_mesh.py::_compare):
at most ``outlier_frac`` of the pixels (2%; 4-5% where MERL bin edges turn
float noise into value jumps) differ by more than 1e-3, the others by 1e-4
on average, and the depth likewise.  No Pallas kernel runs here: the
Pallas K4 parity runs of tests/test_pallas_mesh.py are ``slow`` (the root
conftest.py's ``SLOW``), outside tier-1, and run with
``python -m pytest -m slow tests/test_pallas_mesh.py``; this file holds the
port to their contract in tier-1.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from tests.test_golden_cornell import _compare as golden_compare
from tests.test_mesh_render import write_uv_sphere
import vrenderer_pathtracer_tpu as jvpt
from vrenderer_pathtracer_tpu.accel.mesh import pack_mesh as j_pack_mesh
from vrenderer_pathtracer_tpu.config import RenderSettings as JSettings
from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.core.camera import generate_rays as j_generate_rays
from vrenderer_pathtracer_tpu.core.camera import pixel_ids as j_pixel_ids
from vrenderer_pathtracer_tpu.native import load_obj as j_load_obj
from vrenderer_pathtracer_tpu.ops.brdf import TABLE_SIZE
from vrenderer_pathtracer_tpu.render import pallas_mesh as j_k4
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
from vrenderer_pathtracer_tpu.scene.spheres import build_sphere_set as j_spheres
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch import interop
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4
from vrenderer_pathtracer_tpu_torch.render import integrator
from vrenderer_pathtracer_tpu_torch.scene.scene import settings_for_scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import BRDF

W = H = 32
FC, FP = 0.1, 3.0


@pytest.fixture(scope="module")
def sphere_obj(tmp_path_factory):
    p = tmp_path_factory.mktemp("k4") / "sphere.obj"
    write_uv_sphere(p, radius=12.0, n_theta=8, n_phi=12)
    return str(p)


@pytest.fixture(scope="module")
def jmesh(sphere_obj):
    return j_pack_mesh(j_load_obj(sphere_obj), paged=False)


def _leaves(nt):
    return {k: None if v is None else np.asarray(v) for k, v in nt._asdict().items()}


def _pair(cornell, jmesh=None, **assets):
    """The same scene in both packages: (JAX scene, port scene on the CPU)."""
    jscene = JScene(spheres=j_spheres(cornell), mesh=jmesh,
                    **{k: jnp.asarray(v) for k, v in assets.items()})
    scene = interop.scene_from_numpy(
        _leaves(jscene.spheres), device="cpu",
        mesh=None if jmesh is None else _leaves(jmesh), **assets)
    return jscene, scene


def _glossy_table():
    """tests/test_pallas_mesh.py's glossy synthetic table: a sharp theta_h
    falloff that exercises the lobe strategy."""
    th = np.linspace(0, 1, 90) ** 0.5
    lobe = np.exp(-th * 12.0)[None, :, None, None] * np.ones((3, 90, 90, 180))
    return (3000.0 * lobe).reshape(3, TABLE_SIZE).astype(np.float32)


def _scene_case(name, jmesh):
    """(settings kwargs, JAX scene, port scene, outlier_frac) of one of
    tests/test_pallas_mesh.py's scenes."""
    if name == "mesh_in_cornell":
        kw = dict(use_cornell_box=True, has_hdr=False, has_mesh=True)
        return (kw, *_pair(True, jmesh), 0.02)
    if name in ("textured_mesh_hdri", "out_of_range_uv"):
        rng = np.random.default_rng(3 if name == "textured_mesh_hdri" else 11)
        if name == "out_of_range_uv":
            jmesh = jmesh._replace(tri_uv=jmesh.tri_uv * 2.0 - 0.7)
        kw = dict(has_hdr=True, has_mesh=True, has_diffuse_map=True)
        return (kw, *_pair(False, jmesh,
                           hdr=rng.uniform(0, 1.5, (8, 16, 3)).astype(np.float32),
                           diffuse_map=rng.uniform(0.1, 1.0, (16, 16, 3)).astype(np.float32)),
                0.02)
    if name == "textured_example_sphere_hdri":
        rng = np.random.default_rng(7)
        kw = dict(has_hdr=True, use_example_sphere=True, has_diffuse_map=True)
        return (kw, *_pair(False, None,
                           hdr=rng.uniform(0.1, 1.5, (8, 16, 3)).astype(np.float32),
                           diffuse_map=rng.uniform(0.1, 1.0, (16, 16, 3)).astype(np.float32)),
                0.02)
    if name == "example_sphere_merl_hdri":
        rng = np.random.default_rng(5)
        kw = dict(has_hdr=True, use_example_sphere=True, use_brdf=True, has_brdf=True)
        return (kw, *_pair(False, None,
                           hdr=rng.uniform(0, 1.5, (8, 16, 3)).astype(np.float32),
                           brdf=rng.uniform(0.0, 300.0, (3, TABLE_SIZE)).astype(np.float32)),
                0.04)
    if name == "example_sphere_merl_mis":
        rng = np.random.default_rng(7)
        kw = dict(has_hdr=True, use_example_sphere=True, use_brdf=True,
                  has_brdf=True, brdf_importance_sampling=True)
        return (kw, *_pair(False, None,
                           hdr=rng.uniform(0, 1.5, (8, 16, 3)).astype(np.float32),
                           brdf=_glossy_table()), 0.05)
    assert name == "mesh_merl_mis"
    rng = np.random.default_rng(8)
    kw = dict(has_hdr=True, has_mesh=True, use_brdf=True, has_brdf=True,
              brdf_importance_sampling=True)
    return (kw, *_pair(False, jmesh,
                       hdr=rng.uniform(0, 1.5, (8, 16, 3)).astype(np.float32),
                       brdf=rng.uniform(0.0, 300.0, (3, TABLE_SIZE)).astype(np.float32)),
            0.05)


def _jax_pass(jscene, js, frame=1, seed=0):
    cam = JCamera.default()
    ray_o, ray_d = j_generate_rays(cam, js.width, js.height)
    rgb, depth = j_render_pass(jscene, js, ray_o, ray_d,
                               j_pixel_ids(js.width, js.height), jnp.uint32(frame),
                               jnp.float32(FC), jnp.float32(FP), seed)
    return np.asarray(rgb), np.asarray(depth)


def _assert_contract(got, want, outlier_frac):
    """tests/test_pallas_mesh.py::_compare's contract."""
    (rgb, depth), (want_rgb, want_depth) = got, want
    diff = np.abs(rgb - want_rgb).max(axis=-1)
    assert (diff > 1e-3).mean() <= outlier_frac, (
        f"{(diff > 1e-3).mean():.3%} pixels diverge, max {diff.max()}")
    assert diff[diff <= 1e-3].mean() <= 1e-4
    assert (np.abs(depth - want_depth) > 1e-3).mean() <= outlier_frac


CASES = ["mesh_in_cornell", "textured_mesh_hdri", "out_of_range_uv",
         "example_sphere_merl_hdri", "example_sphere_merl_mis", "mesh_merl_mis"]


@pytest.mark.parametrize("name", CASES)
def test_render_pass_mesh_matches_xla_wavefront(jmesh, name):
    kw, jscene, scene, frac = _scene_case(name, jmesh)
    common = dict(width=W, height=H, samples_per_pass=2, bounces=3, **kw)
    js = JSettings(traversal="xla", **common)
    assert j_k4.supports(jscene, js)
    s = settings_for_scene(scene, vpt.RenderSettings(**common))
    assert k4.supports(scene, s) and s.radiance_kernel == "torch"
    before = (k4.records_reference.count, k4.launch_k4.count)
    got = k4.render_pass_mesh(scene, s, Camera.default("cpu"), 1, FC, FP, 0)
    assert (k4.records_reference.count, k4.launch_k4.count) == (
        before[0] + 1, before[1])
    got = tuple(x.numpy() for x in got)
    _assert_contract(got, _jax_pass(jscene, js), frac)
    assert got[0].mean() > 0.01  # lit


def test_render_pass_mesh_64_matches_xla_wavefront(jmesh):
    """A 64x64 pass of the MERL example sphere, frame 2, seed 3: raster
    order over several rows of what the TPU kernel tiled in 32x32 blocks."""
    kw, jscene, scene, frac = _scene_case("example_sphere_merl_hdri", jmesh)
    common = dict(width=64, height=64, samples_per_pass=1, bounces=2, **kw)
    s = settings_for_scene(scene, vpt.RenderSettings(**common))
    got = k4.render_pass_mesh(scene, s, Camera.default("cpu"), 2, FC, FP, 3)
    want = _jax_pass(jscene, JSettings(traversal="xla", **common), frame=2, seed=3)
    _assert_contract(tuple(x.numpy() for x in got), want, frac)


@pytest.mark.parametrize("name", ["textured_mesh_hdri", "example_sphere_merl_mis"])
def test_records_compose_like_the_wavefront(jmesh, name):
    """The port's own wavefront and K4's plain version agree on the same
    scene: records + compose is a reordering of the wavefront's estimator."""
    kw, _, scene, frac = _scene_case(name, jmesh)
    s = settings_for_scene(scene, vpt.RenderSettings(
        width=W, height=H, samples_per_pass=2, bounces=3, **kw))
    cam = Camera.default("cpu")
    got = k4.render_pass_mesh(scene, s, cam, 1, FC, FP, 0)
    want = integrator.render_camera_pass(scene, s, cam, 1, torch.tensor(FC),
                                         torch.tensor(FP), 0)
    _assert_contract(tuple(x.numpy() for x in got),
                     tuple(x.numpy() for x in want), frac)


def test_layout_matches_jax(jmesh):
    for name in CASES:
        kw, jscene, scene, _ = _scene_case(name, jmesh)
        for spp, bounces in ((1, 1), (2, 3)):
            common = dict(width=W, height=H, samples_per_pass=spp,
                          bounces=bounces, **kw)
            js = JSettings(**common)
            s = vpt.RenderSettings(**common)
            jd, d = j_k4._Defer(js), k4.Defer(s)
            for f in ("env", "tex", "merl", "emit", "any"):
                assert getattr(jd, f) == getattr(d, f), (name, f)
            assert jd.slots_per_sb() == d.slots_per_sb()
            assert j_k4._layout(js, jd) == k4.layout(s, d)


def _scope_cases(jmesh):
    """(name, JAX scene, port scene, settings kwargs) of
    tests/test_pallas_mesh.py::test_supports_scope and
    ::test_supports_rejects_out_of_scope_spheres."""
    base = dict(width=W, height=H, use_cornell_box=True, has_hdr=False,
                has_mesh=True)
    jscene, scene = _pair(True, jmesh)
    cases = [("base", jscene, scene, base),
             ("normal map", jscene, scene, dict(base, has_normal_map=True)),
             ("specular map", jscene, scene, dict(base, has_specular_map=True)),
             ("use_brdf without a table", jscene, scene, dict(base, use_brdf=True)),
             ("odd width", jscene, scene, dict(base, width=100))]
    refl = np.asarray(jscene.spheres.refl).copy()
    refl[0] = BRDF
    spec = np.asarray(jscene.spheres.spec_color).copy()
    spec[0] = (1.0, 0.5, 0.2)
    for what, sp in (("BRDF-typed sphere", dict(refl=refl)),
                     ("tinted specular sphere", dict(spec_color=spec))):
        js2 = jscene._replace(spheres=jscene.spheres._replace(
            **{k: jnp.asarray(v) for k, v in sp.items()}))
        s2 = interop.scene_from_numpy(_leaves(js2.spheres), device="cpu",
                                      mesh=_leaves(jmesh))
        cases.append((what, js2, s2, base))
    return cases


def test_supports_agrees_with_jax(jmesh):
    for name, jscene, scene, kw in _scope_cases(jmesh):
        want = j_k4.supports(jscene, JSettings(**kw))
        assert k4.supports(scene, vpt.RenderSettings(**kw)) == want, name
    # Beyond the TPU-only limits: spp x bounces > 32 stays in scope here.
    big = dict(width=W, height=H, use_cornell_box=True, has_hdr=False,
               has_mesh=True, samples_per_pass=8, bounces=8)
    jscene, scene = _pair(True, jmesh)
    assert not j_k4.supports(jscene, JSettings(**big))
    assert k4.supports(scene, vpt.RenderSettings(**big))
    # A mesh without its 8-wide tree stays on the wavefront (K3b).
    assert not k4.supports(scene.replace(mesh=scene.mesh.without_wide()),
                           vpt.RenderSettings(**big))


def test_render_pass_mesh_refuses_gradients_into_the_kernel(jmesh):
    kw, _, scene, _ = _scene_case("textured_mesh_hdri", jmesh)
    s = settings_for_scene(scene, vpt.RenderSettings(width=8, height=8, **kw))
    cam = Camera.default("cpu")
    yaw = cam.yaw.clone().requires_grad_()
    for bad in (dict(camera=cam.replace(yaw=yaw)),
                dict(fresnel_coef=torch.tensor(FC, requires_grad=True)),
                dict(scene=scene.replace_spheres(
                    color=scene.spheres.color.clone().requires_grad_()))):
        args = {**dict(scene=scene, camera=cam, fresnel_coef=FC), **bad}
        with pytest.raises(ValueError, match="requires grad"):
            k4.render_pass_mesh(args["scene"], s, args["camera"], 1,
                                args["fresnel_coef"], FP, 0)
    with pytest.raises(NotImplementedError):
        k4.render_pass_mesh(scene.replace(diffuse_map=None, normal_map=scene.hdr),
                            s.replace(has_normal_map=True), cam, 1, FC, FP, 0)


@pytest.mark.parametrize("name", ["textured_example_sphere_hdri",
                                  "example_sphere_merl_hdri"])
def test_deferred_table_grads_match_xla(jmesh, name):
    """Gradients with respect to the HDRI and the diffuse map or the MERL
    table through ``compose`` alone, against ``jax.grad`` of the XLA
    wavefront: the contract of tests/test_pallas_mesh.py::
    test_deferred_table_grads_match_xla (loss to 1e-3
    relative; at most 2% of gradient entries off by more than 1e-3 of the
    gradient's scale)."""
    kw, jscene, scene, _ = _scene_case(name, jmesh)
    common = dict(width=W, height=H, samples_per_pass=2, bounces=3, **kw)
    js = JSettings(traversal="xla", **common)
    table = "diffuse_map" if "textured" in name else "brdf"
    jcam = JCamera.default()

    def loss_xla(h, t):
        sc = jscene._replace(hdr=h, **{table: t})
        ray_o, ray_d = j_generate_rays(jcam, W, H)
        rgb, _ = j_render_pass(sc, js, ray_o, ray_d, j_pixel_ids(W, H),
                               jnp.uint32(1), jnp.float32(FC), jnp.float32(FP), 0)
        return jnp.mean(rgb ** 2)

    vx, gx = jax.value_and_grad(loss_xla, argnums=(0, 1))(
        jscene.hdr, getattr(jscene, table))
    s = settings_for_scene(scene, vpt.RenderSettings(**common))
    h = scene.hdr.clone().requires_grad_()
    t = getattr(scene, table).clone().requires_grad_()
    rgb, _ = k4.render_pass_mesh(scene.replace(hdr=h, **{table: t}), s,
                                 Camera.default("cpu"), 1, FC, FP, 0)
    vp = torch.mean(rgb ** 2)
    gp = torch.autograd.grad(vp, [h, t])
    assert abs(vp.item() - float(vx)) < 1e-3 * max(abs(float(vx)), 1e-6)
    for a, b in zip(gp, gx):
        a, b = a.numpy(), np.asarray(b)
        assert np.abs(b).max() > 0
        frac = (np.abs(a - b) > 1e-3 * np.abs(b).max()).mean()
        assert frac <= 0.02, f"{frac:.3%} grad entries diverge"


def test_deferred_opt_step_lowers_the_loss():
    """``deferred_opt_step`` with Adam on config 4's HDRI and MERL table
    (CPU, 16x16): the loss falls over a few steps, and the step keeps the
    resolved backend."""
    rng = np.random.default_rng(5)
    hdr = rng.uniform(0, 1.5, (8, 16, 3)).astype(np.float32)
    table = rng.uniform(0.0, 300.0, (3, TABLE_SIZE)).astype(np.float32)
    kw = dict(width=16, height=16, samples_per_pass=2, bounces=3,
              use_example_sphere=True, use_brdf=True)
    r = vpt.Renderer(16, 16, settings=vpt.RenderSettings(**kw), device="cpu")
    r.load_hdr(hdr)
    r.load_brdf(table)
    target, _ = k4.render_pass_mesh(r.scene.replace(hdr=r.scene.hdr * 1.5),
                                    r.settings, r.camera, 1, FC, FP, 0)
    params = vpt.DeferredParams.from_scene(r.scene, hdr=True, brdf=True)
    for leaf in params.leaves():
        leaf.requires_grad_()
    step = vpt.deferred_opt_step(
        r.settings, torch.optim.Adam(params.leaves(), lr=0.05), scene=r.scene,
        device="cpu")
    losses = []
    for _ in range(4):
        params, m = step(params, r.scene, r.camera, target, 1, FC, FP)
        losses.append(m["loss"].item())
        assert m["grad_global_norm"].item() > 0
    assert losses[-1] < losses[0], losses


def test_renderer_with_merl_matches_jax(tmp_path):
    """The port's ``Renderer`` with ``load_brdf`` (a written MERL binary) and
    ``use_brdf`` on the example sphere under an HDRI, against the JAX
    ``Renderer`` under the golden contract; ``use_brdf(False)`` goes back to
    the diffuse example sphere."""
    rng = np.random.default_rng(9)
    hdr = rng.uniform(0, 1.5, (16, 32, 3)).astype(np.float32)
    path = tmp_path / "synthetic.binary"
    raw = rng.uniform(0.0, 300.0, (3, TABLE_SIZE))
    with open(path, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        raw.reshape(-1).astype(np.float64).tofile(f)
    kw = dict(samples_per_pass=2, bounces=3)
    j = jvpt.Renderer(24, 24, settings=jvpt.RenderSettings(**kw))
    t = vpt.Renderer(24, 24, settings=vpt.RenderSettings(**kw), device="cpu")
    for r in (j, t):
        r.use_example_sphere(True)
        r.load_hdr(hdr)
        r.load_brdf(str(path))
        r.use_brdf(True)
        r.update_camera(origin=(0.0, 0.0, 40.0))
    assert t.settings.has_brdf and t.settings.use_brdf
    assert t.settings.radiance_kernel == "torch"
    golden_compare(*t.render_frames(2),
                   *(np.asarray(x) for x in j.render_frames(2)))
    for r in (j, t):
        r.use_brdf(False)
    assert not t.settings.use_brdf
    golden_compare(*t.render_frames(1),
                   *(np.asarray(x) for x in j.render_frames(1)))


def test_deferred_params_from_numpy(jmesh):
    """A JAX ``DeferredParams`` carries across through ``interop``, and
    ``apply_deferred`` grafts its tables into the scene."""
    from vrenderer_pathtracer_tpu.parallel.sharding import DeferredParams as JDeferred
    from vrenderer_pathtracer_tpu_torch.parallel.sharding import apply_deferred

    kw, jscene, scene, _ = _scene_case("example_sphere_merl_hdri", jmesh)
    jp = JDeferred.from_scene(jscene, hdr=True, brdf=True)
    p = interop.deferred_params_from_numpy(_leaves(jp), device="cpu")
    assert p.diffuse_map is None and len(p.leaves()) == 2
    np.testing.assert_array_equal(p.hdr.numpy(), np.asarray(jscene.hdr))
    np.testing.assert_array_equal(p.brdf.numpy(), np.asarray(jscene.brdf))
    grafted = apply_deferred(scene.replace(hdr=scene.hdr * 0.0), p)
    assert torch.equal(grafted.hdr, p.hdr) and grafted.brdf is p.brdf
    own = vpt.DeferredParams.from_scene(scene, hdr=True, brdf=True)
    assert own.hdr is not scene.hdr and torch.equal(own.brdf, scene.brdf)
