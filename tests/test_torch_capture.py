"""PyTorch port: win-time attribute capture (``settings.captured_attrs``)
against the JAX package, on the CPU.

* ``capture_fields`` is the JAX rule (read from the JAX ``mesh_hit`` itself)
  for all 16 combinations of the map and BRDF flags;
* ``capture_reference``, the plain version of K3c, against a numpy
  recompute from the JAX package's ``pack_mesh`` arrays at the JAX
  package's winning slots (the recompute of
  tests/test_pallas_traverse.py::test_capture_attrs_match_recompute), every
  field at rtol 1e-5 / atol 1e-6;
* the port's ``render_pass`` with ``captured_attrs=True`` against the JAX
  package's XLA ``render_pass`` without it, on the normal- and
  specular-mapped scene of tests/test_config3_textured_mesh.py, under that
  file's outlier contract (at most 2% of pixels with a max-channel error
  above 1e-3, mean at most 1e-4 over the rest);
* a mesh without its 8-wide tree (K3b) refuses the capture; a paged mesh
  ignores the setting.

No Pallas kernel runs here: the JAX side is its XLA traversal.
"""

import itertools
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_mesh_render import write_uv_sphere
from vrenderer_pathtracer_tpu.accel import pallas_traverse as jpallas
from vrenderer_pathtracer_tpu.accel import traverse as jtrav
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
from vrenderer_pathtracer_tpu_torch import interop
from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
from vrenderer_pathtracer_tpu_torch.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer_tpu_torch.native import load_obj
from vrenderer_pathtracer_tpu_torch.render.integrator import render_pass

FLAGS = ("has_normal_map", "has_diffuse_map", "has_specular_map", "use_brdf")


class _Asked(Exception):
    pass


def _jax_capture_rule(flags):
    """The fields the JAX ``mesh_hit`` asks its Pallas kernel to capture
    under ``flags``: its call to ``traverse_packets`` is intercepted before
    anything runs."""

    def spy(mesh, ray_o, ray_d, t_max, **kw):
        raise _Asked(kw["capture"])

    real = jpallas.traverse_packets
    jpallas.traverse_packets = spy
    try:
        s = JSettings(width=32, height=32, traversal="pallas",
                      captured_attrs=True, has_mesh=True, **flags)
        z = jnp.zeros((4, 3), jnp.float32)
        jtrav.mesh_hit(types.SimpleNamespace(mesh=None), s, z, z,
                       types.SimpleNamespace(t=jnp.zeros(4, jnp.float32)))
    except _Asked as e:
        return tuple(e.args[0])
    finally:
        jpallas.traverse_packets = real
    raise AssertionError("the JAX mesh_hit took no captured path")


def test_capture_fields_is_the_jax_rule():
    seen = set()
    for bits in itertools.product((False, True), repeat=len(FLAGS)):
        flags = dict(zip(FLAGS, bits))
        got = trav.capture_fields(vpt.RenderSettings(**flags))
        assert got == _jax_capture_rule(flags), flags
        seen.add(got)
    assert len(seen) == 4  # the field sets the rule asks for


@pytest.fixture(scope="module")
def cap_mesh(tmp_path_factory):
    """The 10x14 sphere of the JAX capture test, packed by both packages."""
    p = tmp_path_factory.mktemp("cap") / "cap.obj"
    write_uv_sphere(p, radius=12.0, n_theta=10, n_phi=14)
    jmesh = j_pack_mesh(j_load_obj(str(p)), paged=False)
    mesh = interop.mesh_from_numpy(
        {k: None if v is None else np.asarray(v)
         for k, v in jmesh._asdict().items()}, device="cpu")
    return mesh, jmesh, str(p)


def test_capture_reference_matches_numpy_recompute_of_jax_arrays(cap_mesh):
    mesh, jmesh, _ = cap_mesh
    rng = np.random.default_rng(4)
    o = (rng.uniform(-15, 15, (1024, 3)) * (1, 1, 0)
         + (0, 0, 30)).astype(np.float32)
    d = np.tile(np.array([[0, 0, -1]], np.float32), (1024, 1))
    t_max = np.full((1024,), 1e6, np.float32)
    s, _ = jtrav.traverse(jmesh, jnp.asarray(o), jnp.asarray(d),
                          jnp.asarray(t_max))
    s = np.array(s)
    hit = s >= 0
    assert hit.sum() > 200 and (~hit).sum() > 0
    got = trav.capture_reference(mesh, torch.from_numpy(o), torch.from_numpy(d),
                                 torch.from_numpy(s),
                                 ("normal", "uv", "tangent", "smooth"))
    si = s[hit]
    v0, e1, e2 = (np.asarray(getattr(jmesh, f))[si]
                  for f in ("tri_v0", "tri_e1", "tri_e2"))
    on, dn = o[hit], d[hit]
    pv = np.cross(dn, e2)
    det = np.einsum("ij,ij->i", e1, pv)
    tv = on - v0
    u = np.einsum("ij,ij->i", tv, pv) / det
    v = np.einsum("ij,ij->i", dn, np.cross(tv, e1)) / det
    w = 1.0 - u - v

    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-20)

    def bary(corners):  # [n,3,k]
        return (w[:, None] * corners[:, 0] + u[:, None] * corners[:, 1]
                + v[:, None] * corners[:, 2])

    want = {"normal": norm(np.cross(e1, e2)),
            "uv": bary(np.asarray(jmesh.tri_uv)[si]),
            "tangent": norm(bary(np.asarray(jmesh.tri_t)[si])),
            "smooth": norm(bary(np.asarray(jmesh.tri_n)[si]))}
    for f, x in got.items():
        assert x.dtype == torch.float32
        assert x.shape == (1024, trav.CAPTURE_WIDTHS[f])
        np.testing.assert_allclose(x.numpy()[hit], want[f], rtol=1e-5,
                                   atol=1e-6, err_msg=f)
        assert (x.numpy()[~hit] == 0).all(), f


def _config3_scene(obj):
    rng = np.random.default_rng(9)
    maps = dict(
        normal_map=(rng.uniform(0, 1, (16, 16, 3)) * 0.3
                    + (0.35, 0.35, 0.7)).astype(np.float32),
        specular_map=rng.uniform(0, 1, (16, 16, 3)).astype(np.float32),
        diffuse_map=rng.uniform(0.2, 1, (16, 16, 3)).astype(np.float32))
    flags = dict(use_cornell_box=True, has_hdr=False, samples_per_pass=4,
                 bounces=2, width=32, height=32, has_mesh=True,
                 has_diffuse_map=True, has_normal_map=True,
                 has_specular_map=True)
    return maps, flags


def test_captured_render_pass_matches_jax_xla(cap_mesh, tmp_path):
    p = tmp_path / "s.obj"
    write_uv_sphere(p, radius=14.0, n_theta=24, n_phi=32)
    maps, flags = _config3_scene(str(p))
    jmesh = j_pack_mesh(j_load_obj(str(p)), paged=False)
    jscene = JScene(spheres=j_spheres(True), mesh=jmesh,
                    **{k: jnp.asarray(v) for k, v in maps.items()})
    ro, rd = j_generate_rays(JCamera.default(), 32, 32)
    want, want_depth = j_render_pass(jscene, JSettings(**flags), ro, rd,
                                     j_pixel_ids(32, 32), jnp.uint32(1),
                                     jnp.float32(0.1), jnp.float32(3.0))

    mesh = pack_mesh(load_obj(str(p)), device="cpu")
    scene = vpt.Scene(spheres=vpt.Scene.analytic(
        vpt.RenderSettings(use_cornell_box=True), "cpu").spheres, mesh=mesh,
        **{k: torch.from_numpy(v) for k, v in maps.items()})
    s = vpt.RenderSettings(captured_attrs=True, **flags)
    o, d = generate_rays(Camera.default("cpu"), 32, 32)
    before = (trav.traverse.count, k3.launch_k3.capture_count)
    got, depth = render_pass(scene, s, o, d, pixel_ids(32, 32, "cpu"), 1,
                             torch.tensor(0.1), torch.tensor(3.0))
    assert trav.traverse.count == before[0] + 2  # one search a bounce
    assert k3.launch_k3.capture_count == before[1]
    err = np.abs(got.numpy() - np.asarray(want)).max(axis=-1)
    assert (err > 1e-3).mean() <= 0.02, f"{(err > 1e-3).mean():.3%} diverge"
    assert err[err <= 1e-3].mean() <= 1e-4
    assert np.abs(depth.numpy() - np.asarray(want_depth)).max() < 1e-3


def test_binary_mesh_refuses_capture_and_paged_mesh_ignores_it(cap_mesh):
    mesh, _, obj = cap_mesh
    s = vpt.RenderSettings(width=16, height=16, samples_per_pass=1, bounces=2,
                           captured_attrs=True)
    o, d = generate_rays(Camera.default("cpu").replace(
        origin=torch.tensor([0.0, 0.0, 40.0])), 16, 16)
    t = torch.full((256,), 1e6)
    with pytest.raises(ValueError, match="wide kernel"):
        k3.traverse_cuda(mesh.without_wide(), o, d, t, capture=("normal",))
    r = vpt.Renderer(16, 16, settings=s, device="cpu")
    r.init_mesh(mesh.without_wide())
    with pytest.raises(ValueError, match="wide kernel"):
        r.render()
    imgs = []
    for captured in (True, False):
        r = vpt.Renderer(16, 16, settings=s.replace(captured_attrs=captured),
                         device="cpu")
        r.init_mesh(pack_mesh(load_obj(obj), paged=True, device="cpu"))
        r.update_camera(origin=(0.0, 0.0, 40.0))
        assert r.settings.compact_waves == (not captured)
        before = trav.traverse_paged_reference.count
        imgs.append(r.render_frames(2))
        assert trav.traverse_paged_reference.count == before + 2 * 2
    assert all(np.array_equal(a, b) for a, b in zip(*imgs))
