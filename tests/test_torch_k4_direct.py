"""PyTorch port: K4's two modes and the 8-wide walk's stack, on the CPU.

K4 (``render/cuda_mesh.py``, ``csrc/mesh.cu``) runs a pass in one of two
modes: ``records`` (the per-(sample, bounce) records, then ``compose``,
whose autograd carries the table gradients) when autograd is on and a
table requires a gradient, else ``direct`` (the kernel fetches the HDRI,
the diffuse texture and the MERL table itself and writes depth and rgb).
On the CPU both modes compute ``compose(records_reference(...))``, so the
images are bitwise equal; the direct mode's own arithmetic is held against
that plain version only on the card (tests/test_torch_cuda.py,
chip_smoke.py).  The 8-wide walk (``csrc/traverse.cuh``) keeps one
``kWideStack``-entry stack, which holds every tree the packers accept.
32x32 scenes, no JAX.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.accel.mesh import (
    WIDE_STACK_DEPTH, _check_wide_stack_bound, pack_mesh, wide_depth,
    wide_stack_need)
from vrenderer_pathtracer_tpu_torch.accel.paged import pack_mesh_paged
from vrenderer_pathtracer_tpu_torch.native import load_obj
from vrenderer_pathtracer_tpu_torch.ops.brdf import TABLE_SIZE
from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4
from vrenderer_pathtracer_tpu_torch.render import renderer as renderer_mod
from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

CSRC = pathlib.Path(k4.__file__).resolve().parent.parent / "csrc"
FC, FP = 0.1, 3.0


@pytest.fixture(scope="module")
def sphere_obj(tmp_path_factory):
    p = tmp_path_factory.mktemp("k4d") / "s.obj"
    write_uv_sphere(p, 14.0, 24, 32)  # 1,472 triangles, 4 wide levels
    return str(p)


def _renderer(obj, kind):
    """A 32x32 K4 scene on the CPU: the textured mesh under an HDRI, or the
    example sphere with a MERL table under it (lobe MIS)."""
    rng = np.random.default_rng(4)
    r = vpt.Renderer(32, 32, device="cpu", settings=vpt.RenderSettings(
        samples_per_pass=2, bounces=3,
        brdf_importance_sampling=kind == "merl"))
    if kind == "merl":
        r.use_example_sphere(True)
        r.load_brdf(rng.uniform(0.0, 300.0, (3, TABLE_SIZE)).astype(np.float32))
        r.use_brdf(True)
    else:
        r.load_mesh(obj)
        r.load_texture(rng.uniform(0.1, 1, (16, 16, 3)).astype(np.float32), 2.2, 0)
    r.load_hdr(rng.uniform(0, 1.5, (8, 16, 3)).astype(np.float32))
    r.update_camera(origin=(0.0, 0.0, 40.0))
    return r


@pytest.mark.parametrize("table", ["hdr", "diffuse_map", "brdf"])
def test_mode_is_records_only_under_grad_with_a_table_that_requires_it(
        sphere_obj, table):
    r = _renderer(sphere_obj, "merl" if table == "brdf" else "mesh")
    assert k4.mode(r.scene) == k4.DIRECT
    leaf = getattr(r.scene, table).clone().requires_grad_()
    scene = r.scene.replace(**{table: leaf})
    assert k4.mode(scene) == k4.RECORDS
    with torch.no_grad():
        assert k4.mode(scene) == k4.DIRECT
    assert k4.mode(r.scene.replace(**{table: leaf.detach()})) == k4.DIRECT


def test_renderer_passes_take_the_direct_mode(sphere_obj, monkeypatch):
    """The Renderer's pass on a K4 scene (on the card ``radiance_kernel``
    resolves to "cuda_mesh"; here the dispatch is asked for it) takes the
    direct mode; a training step through ``deferred_opt_step`` the records
    mode and ``compose``."""
    seen = []
    real = k4.mode

    def spy(scene):
        seen.append(real(scene))
        return seen[-1]

    monkeypatch.setattr(k4, "mode", spy)
    r = _renderer(sphere_obj, "mesh")
    s = r.settings.replace(radiance_kernel="cuda_mesh")
    before = k4.compose.count
    rgb, depth = renderer_mod.render_pass(r.scene, s, r.camera, 1, FC, FP)
    assert seen == [k4.DIRECT] and k4.compose.count == before + 1
    assert rgb.shape == (32 * 32, 3) and depth.shape == (32 * 32,)
    params = vpt.DeferredParams.from_scene(r.scene, hdr=True)
    for leaf in params.leaves():
        leaf.requires_grad_()
    step = vpt.deferred_opt_step(s, torch.optim.Adam(params.leaves(), lr=0.05),
                                 device="cpu")
    step(params, r.scene, r.camera, rgb.detach() * 0.5, 1, FC, FP)
    assert seen[-1] == k4.RECORDS


@pytest.mark.parametrize("kind", ["mesh", "merl"])
def test_cpu_modes_give_the_same_image_and_detach_only_direct(sphere_obj, kind):
    """The mode switch on the CPU: a table that requires grad gives a
    records pass whose image carries the gradient, otherwise the direct
    pass's image is detached; both are the one plain function, so this does
    not check the direct mode's arithmetic (the card tests do)."""
    r = _renderer(sphere_obj, kind)
    args = (r.settings, r.camera, 1, FC, FP)
    direct = k4.render_pass_mesh(r.scene, *args)
    table = "brdf" if kind == "merl" else "diffuse_map"
    scene = r.scene.replace(**{table: getattr(r.scene, table).clone()
                               .requires_grad_()})
    assert k4.mode(scene) == k4.RECORDS
    records = k4.render_pass_mesh(scene, *args)
    assert records[0].requires_grad and not direct[0].requires_grad
    assert torch.equal(direct[0], records[0].detach())
    assert torch.equal(direct[1], records[1])
    assert bool(torch.isfinite(direct[0]).all()) and direct[0].mean() > 0


@pytest.mark.parametrize("depth", [1, 2, 4, 5, 9, 10, 36])
def test_the_walks_stack_holds_every_tree_the_packers_accept(depth):
    assert wide_stack_need(depth) <= WIDE_STACK_DEPTH
    _check_wide_stack_bound(depth)


def test_a_tree_past_the_walks_stack_is_refused_at_pack_time():
    assert wide_stack_need(37) > WIDE_STACK_DEPTH
    with pytest.raises(ValueError, match="WIDE_STACK_DEPTH"):
        _check_wide_stack_bound(37)


def test_the_walks_stack_is_the_packers_bound():
    src = (CSRC / "traverse.cuh").read_text()
    assert f"constexpr int kWideStack = {WIDE_STACK_DEPTH};" in src
    assert "Entry stack[kWideStack];" in src
    assert "sp < kWideStack" in src


def test_meshes_fit_the_walks_stack(sphere_obj):
    """K3, K3c and K4 walk a mesh's tree from its root, K5 each page's
    tree: the whole paged tree (top levels and pages) fits as well."""
    host = load_obj(sphere_obj)
    mesh = pack_mesh(host, device="cpu")
    assert wide_stack_need(wide_depth(mesh.nodes8_i.numpy())) <= 32
    paged = pack_mesh_paged(host, 256, device="cpu").paged
    assert paged.n_pages > 1
    assert wide_stack_need(wide_depth(paged.nodes8_i.numpy())) <= WIDE_STACK_DEPTH


# The K4 launch arguments before this mode existed (the mesh now as its
# compressed copy, nodes and rows), and the fields the direct mode adds.
K4_FIELDS = ["cam", "spheres", "nodes", "rows", "tri_e1",
             "tri_e2", "tri_uv", "tri_t", "mis", "records", "stats",
             "n_spheres", "width", "height", "spp", "bounces", "flags",
             "per_sb", "off_a", "off_e", "off_dir", "off_uv", "off_midx",
             "rgb_slot", "fault", "seed_lo", "seed_hi", "frame",
             "depth_scale", "fault_arg"]
DIRECT_FIELDS = ["hdr", "tex", "brdf", "hdr_w", "hdr_h", "tex_w", "tex_h",
                 "bilinear", "direct"]
# A shard's place in the frame (parallel/sharding.py), after the direct
# fields.
SHARD_FIELDS = ["pixel_offset", "n_local", "sample_offset"]


def _cuda_params():
    """The field names of ``struct Params`` in csrc/mesh.cu, in order."""
    src = (CSRC / "mesh.cu").read_text()
    body = re.search(r"struct Params \{(.*?)\n\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in body.split(";"):
        decl = decl.strip()
        if decl:
            names += [re.split(r"[\s*]+", x.strip())[-1]
                      for x in decl.split(",")]
    return names


def test_params_grow_by_exactly_the_direct_fields_in_declared_order():
    names = [f[0] for f in k4._Params._fields_]
    assert names == K4_FIELDS + DIRECT_FIELDS + SHARD_FIELDS
    assert _cuda_params() == names
    types = dict(k4._Params._fields_)
    assert all(types[f] is types["cam"] for f in ("hdr", "tex", "brdf"))
    assert all(types[f] is types["width"]
               for f in DIRECT_FIELDS[3:] + SHARD_FIELDS[:2])
    assert types["sample_offset"] is types["frame"]


def test_stats_and_faults_of_the_direct_mode():
    assert k4.STATS[-2:] == ("env_fetches", "tex_fetches")
    assert len(set(k4.DIRECT_FAULTS) | {k4.NO_FAULT, k4.FAULT_MIS_FACTOR,
                                         k4.FAULT_MERL_INDEX, k4.FAULT_KILL,
                                         k4.FAULT_UV}) == 8
    src = (CSRC / "mesh.cu").read_text()
    assert f"constexpr int kStats = {len(k4.STATS)};" in src
    assert (f"kFaultEnvU = {k4.FAULT_ENV_U}, kFaultTexV = {k4.FAULT_TEX_V}, "
            f"kFaultMerlScale = {k4.FAULT_MERL_SCALE};") in src


def test_launch_k4_refuses_a_cpu_scene(sphere_obj):
    from vrenderer_pathtracer_tpu_torch.render.cuda_radiance import (
        pack_camera, pack_spheres)

    r = _renderer(sphere_obj, "mesh")
    args = (pack_camera(r.camera, r.settings, FC, FP),
            pack_spheres(r.scene.spheres), r.scene, r.settings, 1)
    for kw in ({}, {"direct": True}, {"direct": True, "fault": k4.FAULT_TEX_V}):
        with pytest.raises(ValueError, match="CUDA"):
            k4.launch_k4(*args, **kw)
