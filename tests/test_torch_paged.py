"""PyTorch port: paged mesh packing and the plain paged traversal (K5's
plain version) against the JAX package, on the same host meshes and rays.

``pack_mesh_paged``'s flat slot arrays, ``tri_count`` and page boxes are
the JAX package's bit for bit; ``traverse_paged_reference`` returns the JAX
``brute_force``'s slots on every hit lane and its t to rtol 1e-4 (two
programs' float32 triangle tests), on random and aimed rays.  No Pallas
kernel runs here (``traverse_paged(..., interpret=True)`` takes tens of
seconds a call on a CPU).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_mesh_render import write_uv_sphere
from tests.test_mesh_traversal import _aimed_rays, _rays, _soup
from vrenderer_pathtracer_tpu.accel import paged as jpaged
from vrenderer_pathtracer_tpu.accel.traverse import brute_force as j_brute_force
from vrenderer_pathtracer_tpu.native import load_obj as j_load_obj
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch import interop
from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5
from vrenderer_pathtracer_tpu_torch.accel import mesh as tmesh
from vrenderer_pathtracer_tpu_torch.accel import paged
from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
from vrenderer_pathtracer_tpu_torch.native import HostMesh, load_obj
from vrenderer_pathtracer_tpu_torch.render import cuda_mesh
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene

FLAT = ("tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_t", "tri_uv")
T_RTOL = 1e-4


def _host(jhost):
    """The port's HostMesh with the JAX one's arrays."""
    return HostMesh(*[np.asarray(x) for x in jhost])


@pytest.fixture(scope="module")
def soup():
    return _soup(900, seed=3, extent=40.0)


@pytest.fixture(scope="module")
def sphere(tmp_path_factory):
    p = tmp_path_factory.mktemp("tpaged") / "s.obj"
    write_uv_sphere(p, 12.0, 30, 36)  # 2,088 triangles
    return j_load_obj(str(p)), load_obj(str(p))


@pytest.fixture(scope="module")
def rays(soup):
    o1, d1 = _rays(1024, seed=4)
    o2, d2 = _aimed_rays(soup, 1024, seed=5)
    o = np.concatenate([np.asarray(o1), np.asarray(o2)])
    d = np.concatenate([np.asarray(d1), np.asarray(d2)])
    return o, d, np.full((2048,), 1e6, np.float32)


def _assert_flat_equal(mesh, jmesh):
    for k in FLAT:
        np.testing.assert_array_equal(getattr(mesh, k).numpy(),
                                      np.asarray(getattr(jmesh, k)), err_msg=k)
    np.testing.assert_array_equal(mesh.paged.bbox.numpy(),
                                  np.asarray(jmesh.paged.bbox))
    assert int(mesh.tri_count) == int(jmesh.tri_count)


def test_morton_codes_match_jax():
    x = np.random.default_rng(0).uniform(0, 1, (4096, 3)).astype(np.float32)
    x[:3] = [[0, 0, 0], [0.999999, 0.999999, 0.999999], [1.0, 0.5, 0.0]]
    np.testing.assert_array_equal(paged._morton3(x), jpaged._morton3(x))


@pytest.mark.parametrize("page_tris", [128, 256])
def test_pack_mesh_paged_matches_jax_on_soup(soup, page_tris):
    jmesh = jpaged.pack_mesh_paged(soup, page_tris=page_tris)
    mesh = paged.pack_mesh_paged(_host(soup), page_tris, device="cpu")
    _assert_flat_equal(mesh, jmesh)
    pg = mesh.paged
    assert pg.n_pages == -(-900 // page_tris) and pg.page_tris == page_tris
    # Every triangle is in exactly one leaf row, under its own slot.
    slots = pg.tri_pack[:, 9].long()
    real = (pg.tri_pack[:, 3:9] != 0).any(dim=1)
    assert sorted(slots[real].tolist()) == sorted(
        torch.nonzero((mesh.tri_e1 != 0).any(dim=1)).squeeze(1).tolist())
    # The page roots are the top tree's inner children past it, one a page,
    # and the first page's nodes follow the top tree.
    top = pg.nodes8_i[:pg.n_top].view(pg.n_top, 8, 2)
    refs = top[..., 0][(top[..., 1] == 0) & (top[..., 0] >= pg.n_top)]
    roots = sorted(set(refs.tolist()))
    assert len(roots) == len(refs) == pg.n_pages and roots[0] == pg.n_top


def test_pack_mesh_paged_matches_jax_on_sphere(sphere):
    jhost, host = sphere
    jmesh = jpaged.pack_mesh_paged(jhost, page_tris=512)
    mesh = paged.pack_mesh_paged(host, 512, device="cpu")
    _assert_flat_equal(mesh, jmesh)
    assert mesh.paged.n_pages == 5 and mesh.nodes8_f is None


def test_plain_paged_traversal_matches_jax_brute_force(soup, rays):
    o, d, t_max = rays
    for page_tris in (128, 256):
        jmesh = jpaged.pack_mesh_paged(soup, page_tris=page_tris)
        mesh = paged.pack_mesh_paged(_host(soup), page_tris, device="cpu")
        want_s, want_t = (np.asarray(x) for x in j_brute_force(
            jmesh, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max)))
        got_s, got_t = (x.numpy() for x in trav.traverse_paged_reference(
            mesh, torch.tensor(o), torch.tensor(d), torch.tensor(t_max)))
        hit = want_s >= 0
        assert hit.sum() > 300
        np.testing.assert_array_equal(got_s >= 0, hit)
        np.testing.assert_array_equal(got_s[hit], want_s[hit])
        np.testing.assert_allclose(got_t[hit], want_t[hit], rtol=T_RTOL)
        np.testing.assert_array_equal(got_t[~hit], t_max[~hit])


def test_plain_paged_traversal_bounds_and_dead_lanes(sphere):
    """Per-ray bounds: a hit past t_max is a miss returning t_max, and a
    dead lane (t_max 0) returns a miss without a search."""
    _, host = sphere
    mesh = paged.pack_mesh_paged(host, 512, device="cpu")
    rng = np.random.default_rng(9)
    n = 512
    o = np.tile([[0.0, 0.0, 40.0]], (n, 1)).astype(np.float32)
    d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                  -np.ones(n)], 1)
    d = torch.tensor((d / np.linalg.norm(d, axis=1, keepdims=True))
                     .astype(np.float32))
    o = torch.tensor(o)
    t_max = torch.tensor(rng.choice([1e6, 30.0, 0.0], n).astype(np.float32))
    slot, t = trav.traverse_paged_reference(mesh, o, d, t_max)
    want_s, want_t = trav.brute_force(mesh, o, d, t_max)
    assert torch.equal(slot >= 0, want_s >= 0) and (slot >= 0).sum() > 50
    hit = slot >= 0
    assert torch.equal(slot[hit], want_s[hit])
    assert torch.equal(t[~hit], t_max[~hit])
    assert (slot[t_max == 0] == -1).all()


def test_plain_paged_traversal_nan_rays_leave_others_bit_identical(soup, rays):
    o, d, t_max = (torch.tensor(x) for x in rays)
    mesh = paged.pack_mesh_paged(_host(soup), 128, device="cpu")
    bad = torch.zeros(o.shape[0], dtype=torch.bool)
    bad[::7] = True
    bad[3::11] = True
    o2, d2 = o.clone(), d.clone()
    o2[::7] = float("nan")
    d2[3::11, 1] = float("nan")
    clean = trav.traverse_paged_reference(mesh, o, d, t_max)
    mixed = trav.traverse_paged_reference(mesh, o2, d2, t_max)
    for a, b in zip(clean, mixed):
        assert torch.equal(a[~bad], b[~bad])
    assert (mixed[0][bad] == -1).all()
    # The wrapper takes the plain version for CPU tensors.
    got = k5.traverse_paged_cuda(mesh, o2, d2, t_max)
    assert all(torch.equal(a, b) for a, b in zip(got, mixed))


def test_auto_paging_rule():
    """pack_mesh(paged=None) pages BASELINE config 5's sphere (500 x 500
    rings: 499,000 triangles) and not the nm sphere (28,560), as the JAX
    package does; no 500k mesh is built here."""
    assert 2 * 500 * (500 - 1) == 499_000
    assert tmesh.auto_paged(499_000)
    assert not tmesh.auto_paged(28_560)
    assert tmesh.auto_paged(tmesh.PAGED_MIN_TRIS + 1)
    assert not tmesh.auto_paged(tmesh.PAGED_MIN_TRIS)


def test_pack_mesh_paged_flag(sphere):
    _, host = sphere
    assert tmesh.pack_mesh(host, device="cpu").paged is None
    forced = tmesh.pack_mesh(host, paged=True, device="cpu")
    assert forced.paged is not None and forced.paged.page_tris == paged.PAGE_TRIS
    assert tmesh.pack_mesh(host, paged=False, device="cpu").paged is None


def test_interop_carries_a_paged_jax_mesh(soup, rays):
    """A JAX paged mesh converts with its slot numbers: the port's page
    trees over its slots find the JAX brute_force's slots."""
    o, d, t_max = rays
    jmesh = jpaged.pack_mesh_paged(soup, page_tris=256)
    leaves = {k: (v if k == "paged" else None if v is None else np.asarray(v))
              for k, v in jmesh._asdict().items()}
    mesh = interop.mesh_from_numpy(leaves, device="cpu")
    _assert_flat_equal(mesh, jmesh)
    want_s = np.asarray(j_brute_force(jmesh, jnp.asarray(o), jnp.asarray(d),
                                      jnp.asarray(t_max))[0])
    got_s = trav.traverse_paged_reference(
        mesh, torch.tensor(o), torch.tensor(d), torch.tensor(t_max))[0].numpy()
    np.testing.assert_array_equal(got_s, want_s)
    # The same as a mapping of the JAX PagedNodes' leaves.
    as_map = interop.mesh_from_numpy(
        dict(leaves, paged={k: np.asarray(v) for k, v in
                            jmesh.paged._asdict().items()}), device="cpu")
    assert torch.equal(as_map.paged.tri_pack, mesh.paged.tri_pack)


def test_paged_cpu_scene_resolves_to_plain_paged_search(sphere):
    """A paged CPU mesh resolves to traversal 'torch' with compact waves
    on; its search is traverse_paged_reference, never the single-level
    traverse (which refuses a paged mesh), and K4 refuses it."""
    _, host = sphere
    mesh = paged.pack_mesh_paged(host, 512, device="cpu")
    r = vpt.Renderer(16, 16, device="cpu", settings=vpt.RenderSettings(
        samples_per_pass=1, bounces=2))
    r.init_mesh(mesh)
    s = r.settings
    assert (s.radiance_kernel, s.traversal, s.compact_waves) == (
        "torch", "torch", True)
    assert not cuda_mesh.supports(r.scene, s.replace(has_hdr=False))
    with pytest.raises(ValueError):
        settings_for_scene(r.scene, s.replace(traversal="cuda_paged"))
    before = (trav.traverse.count, trav.traverse_paged_reference.count)
    r.update_camera(origin=(0.0, 0.0, 40.0))
    img, depth = r.render_frames(1)
    assert trav.traverse.count == before[0]
    assert trav.traverse_paged_reference.count == before[1] + 2
    assert (depth < 1).mean() > 0.2 and np.isfinite(img).all()
    with pytest.raises(ValueError, match="paged"):
        trav.traverse(mesh, torch.zeros(1, 3), torch.ones(1, 3), torch.ones(1))
    with pytest.raises(ValueError):
        k5.launch_k5(mesh, torch.zeros(1, 3), torch.ones(1, 3), torch.ones(1))
    assert k5.supports(mesh) and not k5.supports(
        dataclasses.replace(mesh, paged=None))
    assert Scene(spheres=r.scene.spheres, mesh=mesh).mesh.paged is not None


def test_hit_agreement_across_packs(sphere):
    """A single-level and a paged pack of one mesh number the triangles
    differently; ``hit_agreement(..., want_mesh=)`` compares the winners by
    geometry, so the two plain searches agree on every ray."""
    from vrenderer_pathtracer_tpu_torch.accel.cuda_traverse import hit_agreement

    _, host = sphere
    flat = tmesh.pack_mesh(host, device="cpu")
    mesh = paged.pack_mesh_paged(host, 512, device="cpu")
    rng = np.random.default_rng(12)
    n = 1024
    o = torch.tensor(np.tile([[1.0, 2.0, 40.0]], (n, 1)).astype(np.float32))
    d = np.stack([rng.uniform(-0.35, 0.35, n), rng.uniform(-0.35, 0.35, n),
                  -np.ones(n)], 1)
    d = torch.tensor((d / np.linalg.norm(d, axis=1, keepdims=True))
                     .astype(np.float32))
    t_max = torch.full((n,), 1e6)
    got = trav.traverse(flat, o, d, t_max)
    want = trav.traverse_paged_reference(mesh, o, d, t_max)
    a = hit_agreement(flat, got, want, t_max, want_mesh=mesh)
    assert a["hit_frac"] > 0.2 and a["hit_mismatch"] == 0
    assert a["geometry_mismatch"] == 0 and a["t_rel_max"] < T_RTOL
    assert hit_agreement(flat, got, want, t_max)["geometry_mismatch"] > 0.1
