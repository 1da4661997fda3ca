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

The bounce's draws (``core/rng.py::bounce_uniforms``; K7 on the card)
leave the image as the int64 draws made it: on the CPU against the parent
design's ``_shade``, and on the card (marker ``cuda``, skipped without
one; the JAX package is imported by the fixture ``j`` alone, so these
import nothing of JAX) against the int64 draws forced on CUDA tensors:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_compact.py
"""

import types

import numpy as np
import pytest
import torch

import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.accel import sorting
from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
from vrenderer_pathtracer_tpu_torch.accel.paged import pack_mesh_paged
from vrenderer_pathtracer_tpu_torch.core import rng as port_rng
from vrenderer_pathtracer_tpu_torch.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer_tpu_torch.native import load_obj
from vrenderer_pathtracer_tpu_torch.ops.brdf import TABLE_SIZE
from vrenderer_pathtracer_tpu_torch.ops.shading import ORIGIN_OFFSET, scatter
from vrenderer_pathtracer_tpu_torch.render import integrator
from vrenderer_pathtracer_tpu_torch.render.integrator import render_pass
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import build_sphere_set
from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

# tests/test_paged_grad_parity.py's gradient policy.
GRAD_REL_L2, GRAD_TIGHT_FRAC = 5e-3, 0.995


@pytest.fixture(scope="module")
def j(assets):
    """The JAX package's side of the comparisons, imported here alone so
    that the card's tests below import nothing of JAX: its modules, the
    jitted ``render_pass`` and the single-level mesh of ``assets``."""
    import jax
    import jax.numpy as jnp

    from vrenderer_pathtracer_tpu.accel import sorting as j_sorting
    from vrenderer_pathtracer_tpu.accel.mesh import pack_mesh as j_pack_mesh
    from vrenderer_pathtracer_tpu.config import RenderSettings
    from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
    from vrenderer_pathtracer_tpu.core.camera import generate_rays, pixel_ids
    from vrenderer_pathtracer_tpu.native import load_obj as j_load_obj
    from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
    from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
    from vrenderer_pathtracer_tpu.scene.spheres import build_sphere_set as spheres

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, sorting=j_sorting, Settings=RenderSettings,
        Camera=JCamera, generate_rays=generate_rays, pixel_ids=pixel_ids,
        render_pass=j_render_pass, Scene=JScene, spheres=spheres,
        jit_render_pass=jax.jit(j_render_pass,
                                static_argnames=("settings", "seed")),
        mesh=j_pack_mesh(j_load_obj(assets["path"]), paged=False))


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
        paged=pack_mesh_paged(host, 256, device="cpu"))


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


def _jax(j, a, settings, w, h, z, frame=1, brdf=False, hdr=None):
    jnp = j.jnp
    jscene = j.Scene(spheres=j.spheres(False), mesh=j.mesh,
                     hdr=jnp.asarray(a["hdr"] if hdr is None else hdr),
                     brdf=jnp.asarray(a["brdf"]) if brdf else None)
    cam = j.Camera.default()._replace(origin=jnp.asarray([0.0, 0.0, z]))
    o, d = j.generate_rays(cam, w, h)
    return j.jit_render_pass(jscene, settings, o, d, j.pixel_ids(w, h),
                             jnp.uint32(frame), jnp.float32(0.1),
                             jnp.float32(3.0))


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
def test_compact_matches_jax_compact(assets, j, z):
    w, h = 64, 64
    kw = dict(width=w, height=h, samples_per_pass=2, bounces=3)
    scene = _scene(assets, "mesh")
    s = _settings(scene, compact_waves=True, **kw)
    got = _port(scene, s, w, h, z)
    js = j.Settings(use_cornell_box=False, has_mesh=True, has_hdr=True,
                    traversal="xla", compact_waves=True, **kw)
    want = [np.asarray(x) for x in _jax(j, assets, js, w, h, z)]
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


def test_compact_gradients_match_jax(assets, j):
    """HDRI and MERL gradients through the compact chain (on a paged mesh)
    against jax.value_and_grad of the JAX compact chain on the single-level
    mesh."""
    w, h, z = 32, 32, 40.0
    kw = dict(width=w, height=h, samples_per_pass=1, bounces=2,
              use_brdf=True)
    s = _settings(_scene(assets, "paged", brdf=True), **kw)
    assert s.compact_waves and s.has_brdf
    loss, g_hdr, g_brdf = _port_grads(assets, "paged", s, w, h, z)
    jax, jnp = j.jax, j.jnp
    js = j.Settings(use_cornell_box=False, has_mesh=True, has_hdr=True,
                    has_brdf=True, traversal="xla", compact_waves=True, **kw)
    jscene = j.Scene(spheres=j.spheres(False), mesh=j.mesh)
    cam = j.Camera.default()._replace(origin=jnp.asarray([0.0, 0.0, z]))
    o, d = j.generate_rays(cam, w, h)
    ids = j.pixel_ids(w, h)

    def loss_fn(hdr, brdf):
        rgb, _ = j.render_pass(jscene._replace(hdr=hdr, brdf=brdf), js, o, d,
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


def test_ray_sort_keys_match_jax(j):
    jnp = j.jnp
    rng = np.random.default_rng(5)
    o = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
    d = rng.standard_normal((4096, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:8] = 0.0  # octant ties and the 0.5 direction code
    lo = np.array([-20.0, -15.0, -10.0], np.float32)
    hi = np.array([20.0, 25.0, 10.0], np.float32)
    want = np.asarray(j.sorting.ray_sort_keys(
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


# --- the bounce's draws: one call a bounce, K7 on the card -----------------

def _shade_per_slot(ctx, hd, ray_o, ray_d, mask, alive, pix, samp, bounce):
    """``integrator._shade`` as it drew before ``bounce_uniforms``: one
    ``uniform2`` a slot (slot 2 only under the lobe sampler)."""
    live_hit = alive & hd.hit
    lh = live_hit[:, None]
    emitted = torch.where(lh, mask * hd.emission, torch.zeros_like(mask))
    u_reflect, _ = port_rng.uniform2(
        ctx.seed, pix, port_rng.make_stream(ctx.frame, samp, bounce, 0))
    u_phi, u_r = port_rng.uniform2(
        ctx.seed, pix, port_rng.make_stream(ctx.frame, samp, bounce, 1))
    u_b1 = u_b2 = None
    if ctx.brdf_sampler is not None:
        u_b1, u_b2 = port_rng.uniform2(
            ctx.seed, pix, port_rng.make_stream(ctx.frame, samp, bounce, 2))
    new_dir, mult = scatter(
        ray_d, hd.normal, hd.tangent, hd.color, hd.spec_color, hd.hit_type,
        u_reflect, u_phi, u_r, ctx.fresnel_coef, ctx.fresnel_pow,
        brdf_table=ctx.brdf_table, brdf_sampler=ctx.brdf_sampler, u_b1=u_b1,
        u_b2=u_b2)
    return (live_hit, emitted,
            torch.where(lh, hd.point + ORIGIN_OFFSET * hd.normal, ray_o),
            torch.where(lh, new_dir, ray_d), torch.where(lh, mask * mult, mask))


def _int64_draws(seed, pix, samp, frame, bounce, n_slots):
    """``bounce_uniforms``' words by the int64 path on any device."""
    return tuple(u for slot in range(n_slots) for u in port_rng.uniform2(
        seed, pix, port_rng.make_stream(frame, samp, bounce, slot)))


def _merl_renderer(a, device, mis, size=24):
    """The paged sphere with the HDRI and the MERL table: compact waves,
    4 bounces, 4 spp a pass."""
    r = vpt.Renderer(size, size, device=device, settings=vpt.RenderSettings(
        samples_per_pass=4, bounces=4, brdf_importance_sampling=mis))
    r.init_mesh(pack_mesh_paged(load_obj(a["path"]), 256, device=device))
    r.load_hdr(a["hdr"])
    r.load_brdf(a["brdf"])
    r.use_brdf(True)
    r.update_camera(origin=(0.0, 0.0, 40.0))
    assert r.settings.compact_waves and r.settings.has_brdf
    return r


@pytest.mark.parametrize("mis", [False, True])
def test_wavefront_image_unchanged_by_bounce_draws(assets, monkeypatch, mis):
    """The CPU wavefront's image and depth, bit for bit, with the bounce's
    draws from one ``bounce_uniforms`` call and from the per-slot draws."""
    got = _merl_renderer(assets, "cpu", mis).render_frames(2)
    monkeypatch.setattr(integrator, "_shade", _shade_per_slot)
    want = _merl_renderer(assets, "cpu", mis).render_frames(2)
    assert float(np.abs(want[0]).mean()) > 1e-3 and (want[1] < 1).any()
    for g, w in zip(got, want):
        assert np.array_equal(g, w), mis


@pytest.mark.cuda
@pytest.mark.parametrize("mis", [False, True])
def test_k7_renders_what_the_int64_draws_render(assets, monkeypatch, mis):
    """On the card, a paged-mesh scene (K5, compact waves, HDRI, MERL, with
    and without the lobe sampler) renders the same image and depth, bit for
    bit, with K7 once a bounce as with the int64 draws on CUDA tensors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    passes, r = 3, _merl_renderer(assets, "cuda", mis, size=64)
    assert (r.settings.radiance_kernel, r.settings.traversal) == (
        "wavefront", "cuda_paged")
    launches = port_rng.bounce_uniforms.count
    got = r.render_frames(passes)
    assert port_rng.bounce_uniforms.count == launches + 4 * passes
    monkeypatch.setattr(port_rng, "bounce_uniforms", _int64_draws)
    want = _merl_renderer(assets, "cuda", mis, size=64).render_frames(passes)
    assert float(np.abs(want[0]).mean()) > 1e-3 and (want[1] < 1).any()
    for g, w in zip(got, want):
        assert torch.equal(torch.from_numpy(g), torch.from_numpy(w)), mis
