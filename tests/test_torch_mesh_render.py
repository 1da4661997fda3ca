"""PyTorch port: the mesh, HDRI, texture and example-sphere render paths
against the JAX ``Renderer``, under the golden contract ``_compare`` of
tests/test_golden_cornell.py.

Scenes (the JAX package's own, at test size): the nm scene of
``bench.py::_nm_wavefront_bench`` (a UV sphere with diffuse, normal and
specular maps under an HDRI, no Cornell box, camera at z = 40), the
Cornell box with the mesh and a diffuse map (tests/test_config3_textured_mesh.py),
and the example sphere with diffuse and normal maps under an HDRI.  On the
CPU both sides run their plain traversal; no Pallas kernel runs here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_golden_cornell import _compare
from tests.test_mesh_render import write_uv_sphere
import vrenderer_pathtracer_tpu as jvpt
from vrenderer_pathtracer_tpu.accel.mesh import pack_mesh as j_pack_mesh
from vrenderer_pathtracer_tpu.core.camera import generate_rays as j_generate_rays
from vrenderer_pathtracer_tpu.core.camera import pixel_ids as j_pixel_ids
from vrenderer_pathtracer_tpu.native import load_obj as j_load_obj
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch import interop
from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
from vrenderer_pathtracer_tpu_torch.core.camera import generate_rays, pixel_ids
from vrenderer_pathtracer_tpu_torch.render.integrator import render_pass
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene


@pytest.fixture(scope="module")
def sphere_obj(tmp_path_factory):
    p = tmp_path_factory.mktemp("tmr") / "s.obj"
    write_uv_sphere(p, 14.0, 24, 32)
    return str(p)


def _assets(seed=0):
    """The nm scene's HDRI and maps (bench.py's recipe, at test size)."""
    rng = np.random.default_rng(seed)
    return dict(
        hdr=rng.uniform(0, 1.5, (16, 32, 3)).astype(np.float32),
        tex=rng.uniform(0.1, 1, (32, 32, 3)).astype(np.float32),
        nmap=(rng.uniform(0, 1, (32, 32, 3)) * 0.2
              + (0.4, 0.4, 0.8)).astype(np.float32),
        smap=rng.uniform(0, 1, (32, 32, 3)).astype(np.float32))


def _both(w, h, setup, frames, **kw):
    """Render the same scene with the JAX Renderer and the port's on the
    CPU; ``setup(r)`` loads the assets through the public API."""
    j = jvpt.Renderer(w, h, settings=jvpt.RenderSettings(**kw))
    t = vpt.Renderer(w, h, settings=vpt.RenderSettings(**kw), device="cpu")
    setup(j)
    setup(t)
    jimg, jdepth = j.render_frames(frames)
    timg, tdepth = t.render_frames(frames)
    assert t.get_frame_count() == j.get_frame_count() == frames + 1
    return (timg, tdepth), (np.asarray(jimg), np.asarray(jdepth)), t


def test_nm_scene_matches_jax(sphere_obj):
    a = _assets()

    def setup(r):
        r.load_mesh(sphere_obj)
        r.load_texture(a["tex"], 2.2, 0)
        r.load_texture(a["nmap"], 2.2, 1)
        r.load_texture(a["smap"], 2.2, 2)
        r.load_hdr(a["hdr"])
        r.update_camera(origin=(0.0, 0.0, 40.0))

    got, want, r = _both(32, 32, setup, 2, samples_per_pass=2, bounces=3)
    s = r.settings
    assert (s.has_mesh and s.has_hdr and s.has_diffuse_map and s.has_normal_map
            and s.has_specular_map and not s.use_cornell_box)
    assert s.radiance_kernel == "torch" and s.traversal == "torch"
    _compare(*got, *want)
    img, depth = got
    assert depth[12:20, 12:20].max() < 1.0 and img[12:20, 12:20].mean() > 0.05


def test_cornell_mesh_diffuse_map_matches_jax(sphere_obj):
    red = np.zeros((16, 16, 3), np.float32)
    red[..., 0] = 0.9

    def setup(r):
        r.load_mesh(sphere_obj)
        r.load_texture(red, 2.2, 0)

    got, want, _ = _both(48, 48, setup, 2, use_cornell_box=True, has_hdr=False,
                         samples_per_pass=4, bounces=2)
    _compare(*got, *want)
    c = got[0][18:30, 18:30].mean(axis=(0, 1))
    assert c[0] > 1.5 * c[1] and c[0] > 1.5 * c[2], c


def test_textured_example_sphere_under_hdri_matches_jax():
    a = _assets(1)

    def setup(r):
        r.use_example_sphere(True)
        r.load_texture(a["tex"], 2.2, 0)
        r.load_texture(a["nmap"], 2.2, 1)
        r.load_hdr(a["hdr"])
        r.update_camera(origin=(0.0, 0.0, 40.0))

    got, want, r = _both(32, 32, setup, 2, samples_per_pass=2, bounces=3)
    assert r.settings.use_example_sphere and r.settings.has_normal_map
    _compare(*got, *want)


def test_interop_mesh_scene_renders_like_jax(sphere_obj):
    """A JAX scene with a mesh, maps and an HDRI, converted through
    ``interop``, renders the same pass as in JAX."""
    a = _assets(2)
    jmesh = j_pack_mesh(j_load_obj(sphere_obj), paged=False)
    js = jvpt.RenderSettings(width=24, height=16, samples_per_pass=2,
                             bounces=3, has_mesh=True, has_hdr=True,
                             has_diffuse_map=True, has_specular_map=True)
    jscene = jvpt.Scene(spheres=jvpt.Scene.analytic(js).spheres, mesh=jmesh,
                        hdr=jnp.asarray(a["hdr"]),
                        diffuse_map=jnp.asarray(a["tex"]),
                        specular_map=jnp.asarray(a["smap"]))
    jcam = jvpt.Camera.default()._replace(origin=jnp.asarray([3.0, 2.0, 45.0]))
    ray_o, ray_d = j_generate_rays(jcam, 24, 16)
    want = j_render_pass(jscene, js, ray_o, ray_d, j_pixel_ids(24, 16),
                         jnp.uint32(3), jnp.float32(0.2), jnp.float32(2.0))

    scene = interop.scene_from_numpy(
        {k: np.asarray(v) for k, v in jscene.spheres._asdict().items()},
        device="cpu", hdr=a["hdr"], diffuse_map=a["tex"], specular_map=a["smap"],
        mesh={k: None if v is None else np.asarray(v)
              for k, v in jmesh._asdict().items()})
    cam = interop.camera_from_numpy(
        {k: np.asarray(v) for k, v in jcam._asdict().items()}, device="cpu")
    ts = settings_for_scene(scene, vpt.RenderSettings(
        width=24, height=16, samples_per_pass=2, bounces=3))
    assert ts.has_mesh and ts.has_hdr and not ts.has_normal_map
    o, d = generate_rays(cam, 24, 16)
    rgb, depth = render_pass(scene, ts, o, d, pixel_ids(24, 16, "cpu"), 3,
                             torch.tensor(0.2), torch.tensor(2.0))
    diff = np.abs(rgb.numpy() - np.asarray(want[0]))
    assert (diff > 1e-5).mean() < 0.01, (diff > 1e-5).mean()
    assert np.abs(depth.numpy() - np.asarray(want[1])).max() < 1e-3


def test_cpu_mesh_scene_resolves_to_plain_paths(sphere_obj):
    r = vpt.Renderer(8, 8, settings=vpt.RenderSettings(
        samples_per_pass=1, bounces=2), device="cpu")
    r.load_mesh(sphere_obj)
    s = r.settings
    assert (s.radiance_kernel, s.traversal) == ("torch", "torch")
    before = (trav.traverse.count, k3.launch_k3.count, k3.launch_k3b.count)
    r.render()
    assert trav.traverse.count == before[0] + 2  # one search per bounce
    assert (k3.launch_k3.count, k3.launch_k3b.count) == before[1:]
    for kw, err in ((dict(traversal="cuda"), ValueError),
                    (dict(traversal="cuda_paged"), ValueError),
                    (dict(radiance_kernel="wavefront"), ValueError),
                    (dict(radiance_kernel="cuda_mesh"), ValueError),
                    (dict(radiance_kernel="cuda"), ValueError)):
        with pytest.raises(err):
            settings_for_scene(r.scene, s.replace(**kw))
    # Ray sorting and compact waves are in scope: a single-level mesh
    # keeps compact waves only on request.
    for kw in (dict(sort_rays=True), dict(compact_waves=True)):
        got = settings_for_scene(r.scene, s.replace(**kw))
        assert got.traversal == "torch" and got.compact_waves == bool(
            kw.get("compact_waves"))
    with pytest.raises(ValueError, match="MERL"):
        Scene(spheres=r.scene.spheres, brdf=torch.zeros(3, 8))
