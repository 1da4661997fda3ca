"""PyTorch port: texture and environment ops, mesh traversal and mesh hit
shading against the JAX package, on the same inputs made with numpy.

``traverse`` (the plain version of K3 and K3b) returns the JAX XLA
traversal's slots exactly and its t to rtol 1e-6; ``brute_force`` matches
the JAX oracle; ``shade_mesh_hit`` matches with and without the three maps
to 1e-5.  No Pallas kernel runs here.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_mesh_render import write_uv_sphere
from vrenderer_pathtracer_tpu.accel import traverse as jtrav
from vrenderer_pathtracer_tpu.accel.mesh import pack_mesh as j_pack_mesh
from vrenderer_pathtracer_tpu.config import RenderSettings as JSettings
from vrenderer_pathtracer_tpu.native import load_obj as j_load_obj
from vrenderer_pathtracer_tpu.ops import envmap as jenv
from vrenderer_pathtracer_tpu.ops import texture as jtex
from vrenderer_pathtracer_tpu.render.integrator import HitData as JHitData
from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
from vrenderer_pathtracer_tpu.scene.spheres import build_sphere_set as j_spheres
from vrenderer_pathtracer_tpu_torch import RenderSettings
from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
from vrenderer_pathtracer_tpu_torch.native import load_obj
from vrenderer_pathtracer_tpu_torch.ops import envmap, texture
from vrenderer_pathtracer_tpu_torch.render.integrator import HitData
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import build_sphere_set

RNG = np.random.default_rng(7)


def T(x):
    return torch.from_numpy(np.asarray(x).copy())


def N(x):
    return np.asarray(x)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    p = tmp_path_factory.mktemp("ttrav") / "s.obj"
    write_uv_sphere(p, 14.0, 24, 32)
    return pack_mesh(load_obj(str(p)), device="cpu"), j_pack_mesh(
        j_load_obj(str(p)), paged=False)


@pytest.fixture(scope="module")
def rays():
    """Camera-like rays from z = 40 at the sphere, rays from random points
    in random directions (some start inside the sphere), and per-ray
    bounds: wide open, cutting through the sphere, and 0 (a dead lane)."""
    rng = np.random.default_rng(3)
    n = 1024
    o1 = np.tile([[0.0, 0.0, 40.0]], (n // 2, 1))
    d1 = np.stack([rng.uniform(-0.45, 0.45, n // 2),
                   rng.uniform(-0.45, 0.45, n // 2), -np.ones(n // 2)], 1)
    o2 = rng.uniform(-30, 30, (n // 2, 3))
    d2 = rng.standard_normal((n // 2, 3))
    o = np.concatenate([o1, o2]).astype(np.float32)
    d = np.concatenate([d1, d2])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    d[:4, 0] = 0.0  # axis-parallel rays take the slab test's guarded 1/d
    t_max = rng.choice([1e6, 30.0, 0.0], size=n, p=[0.7, 0.25, 0.05])
    return o, d, t_max.astype(np.float32)


# -- texture and env ops ----------------------------------------------------

def test_texture_fetches_match_jax():
    tex = RNG.uniform(0, 1, (16, 24, 3)).astype(np.float32)
    u = RNG.uniform(-0.2, 1.2, 500).astype(np.float32)
    v = RNG.uniform(-0.2, 1.2, 500).astype(np.float32)
    for ours, theirs in ((texture.fetch_nearest, jtex.fetch_nearest),
                         (texture.fetch_bilinear, jtex.fetch_bilinear)):
        np.testing.assert_allclose(N(ours(T(tex), T(u), T(v))),
                                   N(theirs(jnp.asarray(tex), u, v)),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["nearest", "bilinear"])
def test_fetch_maps_combined_matches_jax(mode):
    a, b, c = (RNG.uniform(0, 1, (8, 8, 3)).astype(np.float32) for _ in range(3))
    odd = RNG.uniform(0, 1, (4, 6, 1)).astype(np.float32)
    u, v = (RNG.uniform(0, 1, 300).astype(np.float32) for _ in range(2))
    for maps in ([a, b, c], [a, None, c], [None, b, None], [a, odd, None]):
        got = texture.fetch_maps([None if m is None else T(m) for m in maps],
                                 T(u), T(v), mode)
        want = jtex.fetch_maps([None if m is None else jnp.asarray(m)
                                for m in maps], u, v, mode)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_allclose(N(g), N(w), rtol=1e-6, atol=1e-7)


def test_normal_map_decode_and_tbn_match_jax():
    texel = RNG.uniform(0.05, 0.95, (200, 3)).astype(np.float32)
    n = RNG.standard_normal((200, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    t = np.cross(n, RNG.standard_normal((200, 3))).astype(np.float32)
    t /= np.linalg.norm(t, axis=1, keepdims=True)
    np.testing.assert_allclose(N(texture.decode_normal_map(T(texel))),
                               N(jtex.decode_normal_map(texel)), atol=1e-6)
    ts = N(jtex.decode_normal_map(texel))
    np.testing.assert_allclose(N(texture.apply_tbn(T(n), T(t), T(ts))),
                               N(jtex.apply_tbn(n, t, ts)), atol=1e-6)


def test_env_ops_match_jax():
    hdr = RNG.uniform(0, 2, (16, 32, 3)).astype(np.float32)
    d = RNG.standard_normal((400, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:3] = [[0, 1, 0], [0, -1, 0], [0, 0, -1]]  # poles and the u seam
    for got, want in zip(envmap.direction_to_latlong(T(d)),
                         jenv.direction_to_latlong(d)):
        np.testing.assert_allclose(N(got), N(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(N(envmap.sample_env_nearest(T(hdr), T(d))),
                                  N(jenv.sample_env_nearest(jnp.asarray(hdr), d)))
    np.testing.assert_allclose(N(envmap.sample_env_bilinear(T(hdr), T(d))),
                               N(jenv.sample_env_bilinear(jnp.asarray(hdr), d)),
                               rtol=1e-5, atol=1e-6)
    assert envmap.ENV_SCALE == jenv.ENV_SCALE


# -- traversal ---------------------------------------------------------------

def test_traverse_matches_jax_xla_traversal(meshes, rays):
    mesh, jmesh = meshes
    o, d, t_max = rays
    before = trav.traverse.count
    slot, t = trav.traverse(mesh, T(o), T(d), T(t_max))
    assert trav.traverse.count == before + 1
    jslot, jt = jtrav.traverse(jmesh, o, d, t_max)
    np.testing.assert_array_equal(N(slot), N(jslot))
    np.testing.assert_allclose(N(t), N(jt), rtol=1e-6)
    hit = N(slot) >= 0
    assert 0.2 < hit.mean() < 0.9
    # A miss returns t_max; a hit lies inside it; a dead lane never hits.
    np.testing.assert_array_equal(N(t)[~hit], t_max[~hit])
    assert (N(t)[hit] < t_max[hit]).all()
    assert not hit[t_max == 0.0].any()
    # The rays that hit under an open bound but not under theirs hit beyond it.
    oslot, ot = trav.traverse(mesh, T(o), T(d), T(np.full_like(t_max, 1e6)))
    cut = (N(oslot) >= 0) & ~hit
    assert cut.sum() > 20 and (N(ot)[cut] >= t_max[cut]).all()


def test_brute_force_matches_jax_and_traverse(meshes, rays):
    mesh, jmesh = meshes
    o, d, t_max = rays
    slot, t = trav.brute_force(mesh, T(o), T(d), T(t_max))
    jslot, jt = jtrav.brute_force(jmesh, o, d, t_max)
    np.testing.assert_array_equal(N(slot), N(jslot))
    np.testing.assert_allclose(N(t), N(jt), rtol=1e-6)
    # traverse finds the same hits; a spatial split may duplicate the
    # winning triangle into another slot, so compare the geometry.
    tslot, tt = trav.traverse(mesh, T(o), T(d), T(t_max))
    assert torch.equal(tslot >= 0, slot >= 0)
    h = slot >= 0
    for f in ("tri_v0", "tri_e1", "tri_e2"):
        a = getattr(mesh, f)
        assert torch.equal(a[tslot[h].long()], a[slot[h].long()])
    torch.testing.assert_close(tt, t, rtol=1e-6, atol=0.0)


def test_wrapper_takes_plain_version_for_cpu_tensors(meshes, rays):
    mesh, _ = meshes
    o, d, t_max = rays
    before = (k3.launch_k3.count, k3.launch_k3b.count, trav.traverse.count)
    for m in (mesh, mesh.without_wide()):
        got = k3.traverse_cuda(m, T(o), T(d), T(t_max))
        want = trav.traverse(m, T(o), T(d), T(t_max))
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (k3.launch_k3.count, k3.launch_k3b.count) == before[:2]
    assert trav.traverse.count == before[2] + 4
    assert k3.supports(mesh) and k3.supports(mesh.without_wide())
    with pytest.raises(ValueError, match="CUDA"):
        k3.launch_k3(mesh, T(o), T(d), T(t_max))
    with pytest.raises(ValueError, match="CUDA"):
        k3.launch_k3b(mesh, T(o), T(d), T(t_max))


# -- shading ------------------------------------------------------------------

def _maps(with_maps):
    if not with_maps:
        return {}
    rng = np.random.default_rng(11)
    return dict(
        diffuse_map=rng.uniform(0.1, 1, (16, 16, 3)).astype(np.float32),
        normal_map=(rng.uniform(0, 1, (16, 16, 3)) * 0.2
                    + (0.4, 0.4, 0.8)).astype(np.float32),
        specular_map=rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))


@pytest.mark.parametrize("with_maps", [False, True])
def test_shade_mesh_hit_matches_jax(meshes, rays, with_maps):
    mesh, jmesh = meshes
    o, d, _ = rays
    maps = _maps(with_maps)
    flags = dict(has_mesh=True, has_diffuse_map=with_maps,
                 has_normal_map=with_maps, has_specular_map=with_maps)
    scene = Scene(spheres=build_sphere_set(False, "cpu"), mesh=mesh,
                  **{k: T(v) for k, v in maps.items()})
    jscene = JScene(spheres=j_spheres(False), mesh=jmesh,
                    **{k: jnp.asarray(v) for k, v in maps.items()})
    slot, _ = trav.traverse(mesh, T(o), T(d), T(np.full(len(o), 1e6, np.float32)))
    b = len(o)
    rng = np.random.default_rng(5)
    prev = dict(hit=np.zeros(b, bool), t=np.full(b, 1e20, np.float32),
                point=rng.standard_normal((b, 3)).astype(np.float32),
                normal=rng.standard_normal((b, 3)).astype(np.float32),
                tangent=np.zeros((b, 3), np.float32),
                color=rng.uniform(0, 1, (b, 3)).astype(np.float32),
                spec_color=np.zeros((b, 3), np.float32),
                emission=np.ones((b, 3), np.float32),
                hit_type=np.zeros(b, np.int32))
    got = trav.shade_mesh_hit(scene, RenderSettings(**flags), T(o), T(d), slot,
                              HitData(**{k: T(v) for k, v in prev.items()}))
    want = jtrav.shade_mesh_hit(jscene, JSettings(**flags), o, d, N(slot),
                                JHitData(**{k: jnp.asarray(v)
                                            for k, v in prev.items()}))
    assert (N(slot) >= 0).mean() > 0.3
    for name in HitData._fields:
        np.testing.assert_allclose(N(getattr(got, name)).astype(np.float64),
                                   N(getattr(want, name)).astype(np.float64),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
