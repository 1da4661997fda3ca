"""PyTorch port: the mesh path's host side against the JAX package.

The port's own copy of the host library (``native/``), the 8-wide collapse
(``accel/wide.py``) and ``pack_mesh`` give the JAX package's arrays, bit for
bit, on the same written sphere OBJ (~1.5k triangles); a JAX mesh converted
through ``interop`` equals the port's own pack.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_mesh_render import write_uv_sphere
from vrenderer_pathtracer_tpu import native as jnative
from vrenderer_pathtracer_tpu.accel import wide as jwide
from vrenderer_pathtracer_tpu.accel.mesh import pack_mesh as j_pack_mesh
from vrenderer_pathtracer_tpu_torch import interop, native
from vrenderer_pathtracer_tpu_torch.accel import mesh as tmesh
from vrenderer_pathtracer_tpu_torch.accel import wide
from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import (
    write_uv_sphere as t_write_uv_sphere)

K4_PACKS = ("tri_aux_pack", "tri_nrm_pack")
# The kernels' copies: the CUDA walk's of the 8-wide tree, held to
# nodes8_*/tri_pack by tests/test_torch_wide_compact.py, and K3b's of the
# binary tree, held to nodes_*/tri_* by tests/test_torch_binary_compact.py.
KERNEL_COPY = ("nodes8_c", "leaf_rows", "nodes_c", "tri_rows")


@pytest.fixture(scope="module")
def sphere_obj(tmp_path_factory):
    p = tmp_path_factory.mktemp("tmesh") / "s.obj"
    write_uv_sphere(p, 14.0, 24, 32)
    return str(p)


@pytest.fixture(scope="module")
def host(sphere_obj):
    return native.load_obj(sphere_obj), jnative.load_obj(sphere_obj)


@pytest.fixture(scope="module")
def packed(host):
    hm, jhm = host
    return (tmesh.pack_mesh(hm, device="cpu"),
            j_pack_mesh(jhm, paged=False))


def test_uv_sphere_copy_writes_the_same_file(tmp_path):
    a, b = tmp_path / "a.obj", tmp_path / "b.obj"
    write_uv_sphere(a, 14.0, 24, 32)
    t_write_uv_sphere(b, 14.0, 24, 32)
    assert a.read_bytes() == b.read_bytes()


def test_load_obj_matches_jax(host):
    hm, jhm = host
    assert len(hm.tris) == 2 * 32 * 23
    for name in hm._fields:
        np.testing.assert_array_equal(getattr(hm, name), getattr(jhm, name),
                                      err_msg=name)


def test_build_sbvh_matches_jax(host):
    hm, _ = host
    for spatial in (True, False):
        got = native.build_sbvh(hm.verts, hm.tris, allow_spatial=spatial)
        want = jnative.build_sbvh(hm.verts, hm.tris, allow_spatial=spatial)
        for name in got._fields:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(want, name), err_msg=name)
        assert tmesh.binary_depth(got.nodes_i) == got.max_depth


def test_collapse_and_leaf_packs_match_jax(host):
    hm, _ = host
    bvh = native.build_sbvh(hm.verts, hm.tris)
    got = wide.collapse_bvh8(bvh.nodes_f, bvh.nodes_i)
    want = jwide.collapse_bvh8(bvh.nodes_f, bvh.nodes_i, mode="sah")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert tmesh.wide_depth(got[1]) == got[3]
    rng = np.random.default_rng(0)
    r = len(bvh.tri_order)
    args = [rng.standard_normal((r, k)).astype(np.float32)
            for k in (3, 3, 3, 6, 9)]
    nrms = rng.standard_normal((r, 9)).astype(np.float32)
    for g, w in zip(wide.build_leaf_packs(got[1], *args, slot_base=5, nrms9=nrms),
                    jwide.build_leaf_packs(got[1], *args, slot_base=5,
                                           nrms9=nrms)):
        np.testing.assert_array_equal(g, w)


def _numpy_leaves(jmesh):
    return {k: None if v is None else np.asarray(v)
            for k, v in jmesh._asdict().items()}


def test_pack_mesh_matches_jax(packed):
    mesh, jmesh = packed
    assert mesh.nodes8_f.shape[1] == 8 and mesh.paged is None
    for f in dataclasses.fields(mesh):
        if f.name in KERNEL_COPY:  # not a JAX field
            assert getattr(mesh, f.name) is not None, f.name
            continue
        got, want = getattr(mesh, f.name), getattr(jmesh, f.name)
        if f.name in K4_PACKS:  # K4's packs: not built until K4 reads them
            assert got is None, f.name
            continue
        if got is None:
            assert want is None, f.name
            continue
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(want).reshape(got.shape), err_msg=f.name)
        assert got.dtype in (torch.float32, torch.int32), f.name


def test_mesh_from_numpy_equals_pack_mesh(packed):
    mesh, jmesh = packed
    conv = interop.mesh_from_numpy(_numpy_leaves(jmesh), device="cpu")
    for f in dataclasses.fields(mesh):
        a, b = getattr(mesh, f.name), getattr(conv, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            assert torch.equal(a, b), f.name
    binary = interop.mesh_from_numpy(
        dict(_numpy_leaves(jmesh), nodes8_f=None, nodes8_i=None,
             nodes8_ax=None, tri_pack=None, tri_aux_pack=None,
             tri_nrm_pack=None), device="cpu")
    assert binary.nodes8_f is None and torch.equal(binary.nodes_i, mesh.nodes_i)
    assert mesh.without_wide().nodes8_f is None


def test_mesh_from_numpy_refuses_tpu_layouts(packed):
    _, jmesh = packed
    leaves = _numpy_leaves(jmesh)
    with pytest.raises(ValueError, match="paged"):
        interop.mesh_from_numpy(dict(leaves, paged=(1, 2)), device="cpu")
    with pytest.raises(ValueError, match="lane-dense"):
        interop.mesh_from_numpy(
            dict(leaves, nodes8_f=jwide.lane_dense_boxes(leaves["nodes8_f"])),
            device="cpu")


def test_stack_bounds():
    assert tmesh.wide_stack_need(36) <= tmesh.WIDE_STACK_DEPTH
    tmesh._check_wide_stack_bound(36)
    with pytest.raises(ValueError, match="stack"):
        tmesh._check_wide_stack_bound(37)
    tmesh._check_stack_bound(tmesh.STACK_DEPTH - 2)
    with pytest.raises(ValueError, match="stack"):
        tmesh._check_stack_bound(tmesh.STACK_DEPTH - 1)


def test_load_mesh_file_dispatch(tmp_path, host):
    ply = tmp_path / "tri.ply"
    ply.write_text("ply\nformat ascii 1.0\nelement vertex 3\nproperty float x\n"
                   "property float y\nproperty float z\nelement face 1\n"
                   "property list uchar int vertex_indices\nend_header\n"
                   "0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n")
    got, want = native.load_mesh_file(str(ply)), jnative.load_mesh_file(str(ply))
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    with pytest.raises(IOError, match="cannot open"):
        native.load_obj(str(tmp_path / "missing.obj"))
    with pytest.raises(IOError, match=r"load_fbx\(.*cannot open"):
        native.load_mesh_file(str(tmp_path / "m.fbx"))
    with pytest.raises(IOError, match="unknown mesh format"):
        native.load_mesh_file(str(tmp_path / "m.stl"))


def test_host_library_builds_from_the_port_sources():
    from vrenderer_pathtracer_tpu.native import build as jbuild
    from vrenderer_pathtracer_tpu_torch.native import build

    lib = build.build()
    assert lib.is_file() and lib.parent == build.BUILD_DIR
    assert lib == build.library_path()
    assert build.CXXFLAGS == jbuild.CXXFLAGS  # the same tree on one machine
    # The EXR and FBX sources too; the TPU dense page builder is not copied.
    assert {"exr.cc", "piz.cc", "dwa.cc", "fbx.cc"} <= set(build.SOURCES)
    assert "dense.cc" not in build.SOURCES
    for src in [*build.SOURCES, "math3.h"]:
        assert (build.CSRC / src).read_bytes() == (jbuild.CSRC / src).read_bytes()
