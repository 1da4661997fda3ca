"""PyTorch port: the Cornell slice end to end.

The port's ``Renderer`` on the CPU is held against the JAX ``Renderer`` and
against the independent NumPy tracer (tests/reference_tracer.py) under the
golden contract ``_compare`` of tests/test_golden_cornell.py.
"""

import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests import reference_tracer as ref
from tests.test_golden_cornell import _compare
import vrenderer_pathtracer_tpu as jvpt
from vrenderer_pathtracer_tpu.core.camera import generate_rays as j_generate_rays
from vrenderer_pathtracer_tpu.core.camera import pixel_ids as j_pixel_ids
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch import cli, interop
from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1

CORNELL = dict(use_cornell_box=True, has_hdr=False)
MOVED = dict(origin=(5.0, -3.0, 120.0), yaw=0.2, pitch=-0.1, fov_deg=60.0)


def _port(w, h, **kw):
    return vpt.Renderer(w, h, settings=vpt.RenderSettings(**CORNELL, **kw),
                        device="cpu")


@pytest.mark.parametrize("move", [{}, MOVED])
def test_renderer_matches_jax_renderer(move):
    kw = dict(samples_per_pass=2, bounces=4)
    j = jvpt.Renderer(48, 32, settings=jvpt.RenderSettings(**CORNELL, **kw))
    t = _port(48, 32, **kw)
    if move:
        j.update_camera(**move)
        t.update_camera(**move)
    jimg, jdepth = j.render_frames(3)
    timg, tdepth = t.render_frames(3)
    assert timg.shape == (32, 48, 3) and tdepth.shape == (32, 48)
    assert t.get_frame_count() == j.get_frame_count() == 4
    _compare(timg, tdepth, np.asarray(jimg), np.asarray(jdepth))


@pytest.mark.parametrize("w,h,spp,bounces,frames,camera", [
    (16, 16, 4, 2, 2, None),
    (12, 12, 2, 2, 2, MOVED),
])
def test_renderer_matches_reference_tracer(w, h, spp, bounces, frames, camera):
    r = _port(w, h, samples_per_pass=spp, bounces=bounces)
    if camera:
        r.update_camera(**camera)
    img, depth = r.render_frames(frames)
    eimg, edepth = ref.render_image(w, h, spp_per_frame=spp, frames=frames,
                                    bounces=bounces, use_cornell=True,
                                    camera=camera)
    _compare(img, depth, eimg, edepth)


def test_frame_counting_clear_buffer_and_current_frame():
    r = _port(8, 8, samples_per_pass=2, bounces=2)
    assert r.get_frame_count() == 1 and r.samples_per_pixel == 0
    img1, _ = r.render()
    img2, depth2 = r.render()
    assert r.get_frame_count() == 3 and r.samples_per_pixel == 4
    shown, shown_depth = r.current_frame()
    assert torch.equal(shown, img2) and torch.equal(shown_depth, depth2)
    assert r.get_frame_count() == 3  # displaying does not advance
    r.clear_buffer()
    assert r.get_frame_count() == 1
    assert torch.count_nonzero(r._accum) == 0
    again, _ = r.render()
    assert torch.equal(again, img1)  # frame 1 again: the same draws
    r.update_camera(yaw=0.1)
    assert r.get_frame_count() == 1
    r.use_cornell_box(True)
    assert r.get_frame_count() == 1


def test_fresnel_sliders_change_image_and_reset():
    r = _port(32, 32, samples_per_pass=4, bounces=3)
    a, _ = r.render_frames(1)
    r.set_fresnel_power(1.0)
    assert r.get_frame_count() == 1
    b, _ = r.render_frames(1)
    r.set_fresnel_coef(0.9)
    c, _ = r.render_frames(1)
    assert np.abs(a - b).max() > 1e-3 and np.abs(b - c).max() > 1e-3


def test_sync_render_records_stats():
    r = _port(8, 8, samples_per_pass=2, bounces=4)
    assert "no synced frame" in r.hud_line()
    r.render(sync=True)
    st = r.last_stats
    assert st.rays_per_pass == 8 * 8 * 2 * 4 and st.seconds_per_pass > 0
    assert "Mrays/s" in r.hud_line() and "2 spp" in r.hud_line()


@pytest.mark.parametrize("call,error,match", [
    # The viewer and the bench are ported; the bench runs on the card only.
    (lambda r: cli.main(["bench"]), RuntimeError, "no CUDA device"),
    # Sharding is ported: a mesh that is not a DeviceMesh, and two tiles in
    # a one-process world, are refused.
    (lambda r: vpt.Renderer(4, 4, device="cpu", device_mesh=object()),
     TypeError, "DeviceMesh"),
    (lambda r: cli.main(["render", "--cpu", "--width", "4", "--height", "4",
                         "--tiles", "2"]), ValueError, "world size"),
])
def test_unported_methods_raise(call, error, match, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(error, match=match):
        call(_port(4, 4))


@pytest.mark.parametrize("call", [
    lambda r: r.load_brdf(np.ones((3, 90 * 90 * 180), np.float32)),
    lambda r: r.use_brdf(True),
])
def test_brdf_methods_edit_the_scene(call):
    """``load_brdf`` and ``use_brdf`` are ported: each edits the scene or
    settings and resets the frame; a table of the wrong shape raises."""
    r = _port(4, 4)
    r.render()
    call(r)
    assert r.get_frame_count() == 1
    assert r.settings.has_brdf or r.settings.use_brdf
    r.render()
    with pytest.raises(ValueError, match="MERL"):
        r.load_brdf(np.zeros((3, 8), np.float32))


@pytest.fixture(scope="module")
def tiny_obj(tmp_path_factory):
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    p = tmp_path_factory.mktemp("tr") / "s.obj"
    write_uv_sphere(p, 14.0, 6, 8)
    return str(p)


def _packed(path):
    from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
    from vrenderer_pathtracer_tpu_torch.native import load_obj

    return pack_mesh(load_obj(path), device="cpu")


@pytest.mark.parametrize("call, check", [
    (lambda r, p: r.load_hdr(np.ones((4, 8, 3), np.float32)),
     lambda r: r.scene.hdr.shape == (4, 8, 3) and r.settings.has_hdr),
    (lambda r, p: r.load_texture(np.full((4, 4, 3), 0.25, np.float32)),
     lambda r: torch.allclose(r.scene.diffuse_map,
                              torch.tensor(0.25) ** (1 / 2.2))
     and r.settings.has_diffuse_map),
    (lambda r, p: r.init_mesh(_packed(p)),
     lambda r: r.settings.has_mesh and r.settings.traversal == "torch"),
    (lambda r, p: r.load_mesh(p),
     lambda r: r.scene.mesh.tri_count.item() == 2 * 8 * 5),
    (lambda r, p: r.use_example_sphere(True),
     lambda r: r.settings.use_example_sphere),
    (lambda r, p: r.use_cornell_box(False),
     lambda r: not r.settings.use_cornell_box and r.scene.spheres.count == 2),
])
def test_ported_methods_work_and_reset_frame(call, check, tiny_obj):
    r = _port(8, 8, samples_per_pass=1, bounces=2)
    r.render_frames(2)
    assert r.get_frame_count() == 3
    call(r, tiny_obj)
    assert check(r)
    assert r.get_frame_count() == 1 and torch.count_nonzero(r._accum) == 0
    img, depth = r.render_frames(1)
    assert np.isfinite(img).all() and img.shape == (8, 8, 3)


def test_load_texture_rejects_unknown_type():
    with pytest.raises(ValueError, match="texture type"):
        _port(4, 4).load_texture(np.zeros((4, 4, 3), np.float32), 2.2, 3)


@pytest.mark.parametrize("kw", [
    dict(settings=vpt.RenderSettings(**CORNELL),
         device_mesh=("cuda:0", "cuda:1")),
    dict(settings=vpt.RenderSettings(**CORNELL), device_mesh=object()),
])
def test_unported_constructor_options_raise(kw):
    """A device mesh is a torch.distributed DeviceMesh (make_render_mesh);
    a list of devices or another object is refused."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        vpt.Renderer(4, 4, device="cpu", **kw)


def test_non_cornell_scene_renders():
    """Without the box and without an HDRI a miss is black; the two
    analytic spheres are all the scene holds."""
    r = vpt.Renderer(16, 16, settings=vpt.RenderSettings(
        samples_per_pass=1, bounces=2), device="cpu")
    assert not r.settings.has_hdr and r.settings.radiance_kernel == "torch"
    img, depth = r.render_frames(1)
    assert np.isfinite(img).all() and (depth == 1.0).mean() > 0.9


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        vpt.Renderer(4, 4, settings=vpt.RenderSettings(**CORNELL),
                     device="cuda")
    with pytest.raises(RuntimeError):  # the card is the default
        vpt.Renderer(4, 4, settings=vpt.RenderSettings(**CORNELL))


def test_radiance_request_must_match_device():
    with pytest.raises(ValueError):
        vpt.Renderer(4, 4, settings=vpt.RenderSettings(
            radiance_kernel="cuda", **CORNELL), device="cpu")


def test_interop_scene_renders_like_jax():
    """A JAX scene, camera and sliders, converted, render the same image;
    the scene is edited first so the conversion carries real data."""
    js = jvpt.RenderSettings(width=32, height=16, samples_per_pass=2,
                             bounces=3, **CORNELL)
    jscene = jvpt.Scene.analytic(js)
    sph = jscene.spheres._replace(
        color=jscene.spheres.color.at[7].set(jnp.array([0.9, 0.2, 0.1])),
        emission=jscene.spheres.emission.at[6].set(jnp.array([0.5, 0.5, 2.0])))
    jscene = jscene._replace(spheres=sph)
    jcam = jvpt.Camera.default()._replace(yaw=jnp.float32(0.15))
    fc, fp = jnp.float32(0.3), jnp.float32(2.0)
    ray_o, ray_d = j_generate_rays(jcam, 32, 16)
    want = j_render_pass(jscene, js, ray_o, ray_d, j_pixel_ids(32, 16),
                         jnp.uint32(2), fc, fp)

    scene = interop.scene_from_numpy(
        {k: np.asarray(v) for k, v in sph._asdict().items()}, device="cpu")
    cam = interop.camera_from_numpy(
        {k: np.asarray(v) for k, v in jcam._asdict().items()}, device="cpu")
    tfc, tfp = interop.sliders_from_numpy(fc, fp, device="cpu")
    assert scene.spheres.refl.dtype == torch.int32
    ts = vpt.RenderSettings(width=32, height=16, samples_per_pass=2,
                            bounces=3, **CORNELL)
    rgb, depth = k1.render_pass_cuda(scene, ts, cam, 2, tfc, tfp)
    d = np.abs(rgb.numpy() - np.asarray(want[0]))
    assert (d > 1e-5).mean() < 0.01
    assert np.abs(depth.numpy() - np.asarray(want[1])).max() < 1e-3
    default, _ = k1.render_pass_reference(
        vpt.Scene.analytic(ts, "cpu"), ts, cam, 2, tfc, tfp)
    assert (rgb - default).abs().max() > 1e-2


def test_package_never_imports_jax(tmp_path):
    """Render a Cornell pass and a mesh scene (the port's own host-library
    build included) and take a train step, with no JAX module loaded."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import vrenderer_pathtracer_tpu_torch as v\n"
        "from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere\n"
        "write_uv_sphere('s.obj', 14.0, 6, 8)\n"
        "m = v.Renderer(8, 8, settings=v.RenderSettings(bounces=2), device='cpu')\n"
        "m.load_mesh('s.obj')\n"
        "m.load_texture(np.full((4, 4, 3), 0.5, np.float32), 2.2, 0)\n"
        "m.load_hdr(np.ones((4, 8, 3), np.float32))\n"
        "mi, _ = m.render_frames(1)\n"
        "assert m.settings.has_mesh and np.isfinite(mi).all()\n"
        "r = v.Renderer(8, 8, settings=v.RenderSettings(use_cornell_box=True,"
        " has_hdr=False), device='cpu')\n"
        "img, depth = r.render_frames(1)\n"
        "assert img.shape == (8, 8, 3)\n"
        "p = v.TrainParams.from_scene(r.scene)\n"
        "step = v.train_step(r.settings, device='cpu')\n"
        "p2, loss = step(p, r.scene, r.camera, 0.5 * r._accum, 1)\n"
        "assert float(loss) > 0 and not p2.emission.equal(p.emission)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('vrenderer_pathtracer_tpu.')"
        " or m == 'vrenderer_pathtracer_tpu']\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    root = str(__import__("pathlib").Path(__file__).resolve().parent.parent)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env={"PYTHONPATH": root, "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
