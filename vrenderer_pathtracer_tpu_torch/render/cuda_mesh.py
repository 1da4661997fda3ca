"""K4, the fused mesh-scene kernel: wrapper, records and epilogue.

Port of ``vrenderer_pathtracer_tpu/render/pallas_mesh.py``.  The kernel is
hand-written CUDA C++ in ``csrc/mesh.cu``; its header says what it computes
and what bounds it on the card.  It runs the whole bounce loop of the
general scene (spheres, the example sphere or the mesh through K3's device
search, threefry draws, the Fresnel/diffuse/mirror scatter, the MERL cosine
sample or lobe MIS).  Three tables enter the estimator only as factors:

    radiance = sum_b [ A_b * PD_b  +  E_b * env(dir_b) * PD_b ],
    PD_b     = prod_{j<b} D_j,

with ``A_b = live_b * M_b * em_b`` and ``E_b = miss_b * M_b`` carrying the
kernel's throughput ``M_b`` and ``D_j`` the table factors (the diffuse
texture's colour at ``uv_j``, ``24 * max(merl[midx_j], 0)``; 1 elsewhere).
In direct mode (every forward pass) K4 fetches the tables and sums this
itself.  In records mode it writes the per-(sample, bounce) records
``A``, ``E``, ``dir``, ``uv``, ``midx`` instead, and :func:`compose` does
the fetches and the sum in torch, so gradients with respect to the HDRI,
the diffuse map and the MERL table flow through it alone: K4 has no
backward, and takes no input that requires one.

This module:

* ``Defer`` / ``layout`` — what is deferred and the record slots;
* ``supports`` — K4's scope (everything else runs the wavefront);
* ``records_reference`` — the plain PyTorch version of K4, the same records
  from the integrator's intersection and scatter with the deferred factors
  held at 1; ``.count`` counts its calls;
* ``mode`` — which of K4's two modes a pass takes: ``"records"`` (the
  records, then ``compose``) when autograd is on and a table requires a
  gradient, else ``"direct"`` (K4 fetches the tables itself and writes only
  depth and rgb, ``[4, N]``; no records and no ``compose``);
* ``launch_k4`` — the launch on packed tables, in either mode; ``.count``
  counts launches;
* ``compose`` — the differentiable epilogue; ``.count`` counts calls;
* ``render_pass_mesh`` — the pass: K4 for CUDA tensors in the pass's mode,
  the plain version (``records_reference`` + ``compose``, the same function
  in both modes) for CPU tensors;
* ``records_agreement`` — how two record sets agree (the card's contract).

A pass may take a shard of the frame (``parallel/sharding.py``): the raster
range ``[pixel_offset, pixel_offset + n_local_pixels)`` with the samples
from ``sample_offset`` (defaults: the whole frame, sample 0).  The records
and images are then the range's, ``[.., n_local_pixels]``, and
:func:`compose` fetches the tables for those records alone.
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref

import torch

from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse
from vrenderer_pathtracer_tpu_torch.accel.wide import CW_WORDS, ROW_WORDS
from vrenderer_pathtracer_tpu_torch.accel.traverse import (
    _moller_trumbore, shade_mesh_hit, traverse)
from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core import rng
from vrenderer_pathtracer_tpu_torch.core.camera import Camera, generate_rays, pixel_ids
from vrenderer_pathtracer_tpu_torch.ops import brdf_sampling
from vrenderer_pathtracer_tpu_torch.ops import texture as tex_ops
from vrenderer_pathtracer_tpu_torch.ops.brdf import TABLE_SIZE, channel_scale, merl_index
from vrenderer_pathtracer_tpu_torch.ops.envmap import sample_env
from vrenderer_pathtracer_tpu_torch.ops.shading import ORIGIN_OFFSET, scatter
from vrenderer_pathtracer_tpu_torch.render import integrator
from vrenderer_pathtracer_tpu_torch.render.cuda_radiance import (
    pack_camera, pack_spheres)
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import BRDF
from vrenderer_pathtracer_tpu_torch.utils.profiling import plain_version

# Planted faults of the kernel (``launch_k4(fault=...)``): each makes K4 a
# wrong kernel in one way, for checking that the card's contract catches it
# (the lobe-MIS factor left at 1; the MERL index one phi_d bin off; a killed
# Cornell sample's A and E records and emission kept; uv shifted by
# ``fault_arg``); and in direct mode only (``DIRECT_FAULTS``, instances of
# their own) the HDRI fetched one texel on in u, the diffuse texture at
# 1 - v, the MERL factor without its channel scale.  Every real launch
# passes NO_FAULT.
NO_FAULT, FAULT_MIS_FACTOR, FAULT_MERL_INDEX, FAULT_KILL, FAULT_UV = range(5)
FAULT_ENV_U, FAULT_TEX_V, FAULT_MERL_SCALE = range(5, 8)
DIRECT_FAULTS = (FAULT_ENV_U, FAULT_TEX_V, FAULT_MERL_SCALE)
RECORDS, DIRECT = "records", "direct"


class Defer:
    """What the settings defer to :func:`compose` (``_Defer`` of the JAX
    module)."""

    def __init__(self, settings: RenderSettings):
        objects = settings.has_mesh or settings.use_example_sphere
        self.env = settings.has_hdr and not settings.use_cornell_box
        self.tex = settings.has_diffuse_map and not settings.use_brdf and objects
        self.merl = settings.use_brdf and settings.has_brdf and objects
        # Emission is deferred whenever a multiplicative factor is (A_b
        # needs the prefix PD_b, known only after the fetches).
        self.emit = self.tex or self.merl
        self.any = self.env or self.tex or self.merl

    def slots_per_sb(self) -> int:
        return 3 * self.emit + 6 * self.env + 2 * self.tex + self.merl


def layout(settings: RenderSettings, defer: Defer | None = None):
    """``({field key: first slot}, n_slots)`` in K4's write order: depth,
    then per (s, b) ``A``, ``E``, ``dir``, ``uv``, ``midx`` (those that are
    deferred), then ``rgb`` where emission is summed in the kernel."""
    defer = defer or Defer(settings)
    idx, slot = {("depth",): 0}, 1
    if defer.any:
        for s in range(settings.samples_per_pass):
            for b in range(settings.bounces):
                for name, width, on in (("A", 3, defer.emit), ("E", 3, defer.env),
                                        ("dir", 3, defer.env), ("uv", 2, defer.tex),
                                        ("midx", 1, defer.merl)):
                    if on:
                        idx[(name, s, b)] = slot
                        slot += width
    if not defer.emit:
        idx[("rgb",)] = slot
        slot += 3
    return idx, slot


def supports(scene: Scene, settings: RenderSettings) -> bool:
    """K4's scope: the JAX kernel's, without its TPU-only limits (VMEM and
    records budgets, ``spp * bounces <= 32``).  Out of scope, and left to
    the wavefront: normal or specular maps (their values steer rays),
    ``use_brdf`` without a table, BRDF-typed or non-gray-specular spheres,
    a mesh without its 8-wide tree, and a paged mesh (as the JAX kernel
    refuses one: the wavefront with K5 renders it)."""
    if settings.has_normal_map or settings.has_specular_map:
        return False
    if settings.use_brdf and not (settings.has_brdf and scene.brdf is not None):
        return False
    sp = scene.spheres
    if bool((sp.refl == BRDF).any()):
        return False
    spec = sp.spec_color
    if not bool(((spec[:, 0] == spec[:, 1]) & (spec[:, 1] == spec[:, 2])).all()):
        return False
    if settings.has_mesh and not settings.use_example_sphere:
        mesh = scene.mesh
        if (mesh is None or mesh.paged is not None or mesh.nodes8_f is None
                or not cuda_traverse.supports(mesh)):
            return False
    return True


# --- the plain version ------------------------------------------------------

def _example_uv(normal):
    """The example sphere's uv from its fresh normal."""
    u = torch.atan2(normal[:, 0], normal[:, 2]) / (2.0 * math.pi) + 0.5
    return torch.stack([u, normal[:, 1] * 0.5 + 0.5], dim=-1)


def _mesh_uv(mesh, ray_o, ray_d, slot):
    """Barycentric uv of the winning triangle ``slot`` (clamped at 0)."""
    safe = torch.clamp(slot, min=0).long()
    _, u, v, _ = _moller_trumbore(ray_o, ray_d, mesh.tri_v0[safe][:, None],
                                  mesh.tri_e1[safe][:, None],
                                  mesh.tri_e2[safe][:, None])
    u, v = u[:, 0:1], v[:, 0:1]
    c = mesh.tri_uv[safe]  # [B,3,2]
    return (1.0 - u - v) * c[:, 0] + u * c[:, 1] + v * c[:, 2]


def _intersect(scene, settings, ray_o, ray_d, alive):
    """The integrator's scene intersection with the plain traversal as the
    mesh search: ``(hit data, object won [B] bool, object uv [B,2])``."""
    hd = integrator._intersect_sphere_set(scene, ray_o, ray_d)
    if settings.use_example_sphere:
        ex = integrator._example_sphere_hit(scene, settings, ray_o, ray_d, hd)
        return ex, ex.t < hd.t, _example_uv(ex.normal)
    if settings.has_mesh:
        t_max = hd.t if alive is None else torch.where(
            alive, hd.t, torch.zeros_like(hd.t))
        slot, _ = traverse(scene.mesh, ray_o.contiguous(), ray_d.contiguous(),
                           t_max.contiguous())
        mh = shade_mesh_hit(scene, settings, ray_o, ray_d, slot,
                            hd._replace(t=t_max))
        return mh, slot >= 0, _mesh_uv(scene.mesh, ray_o, ray_d, slot)
    return hd, torch.zeros_like(hd.hit), torch.zeros_like(ray_d[:, :2])


@plain_version
@torch.no_grad()
def records_reference(scene: Scene, settings: RenderSettings, camera: Camera,
                      frame: int, fresnel_coef, fresnel_pow, seed: int = 0,
                      pixel_offset: int = 0, sample_offset: int = 0,
                      n_local_pixels=None):
    """The plain PyTorch version of K4: its records ``[n_slots, n]`` of the
    pixel range and samples the offsets name.

    The samples run as lanes of one batch (``spp * N``), through the
    integrator's intersection (spheres, then the example sphere or the mesh
    with the plain ``traverse``) and ``ops/shading.py::scatter``, with each
    deferred factor held at 1: textured hits shade with colour 1, BRDF hits
    weight their direction by 1 (cosine sample) or ``cos / (pi p_mix)``
    (lobe MIS).  Mesh and example-sphere hits carry no specular colour in
    K4's scope, so their Fresnel branch never reflects and a textured hit
    is active wherever it is live and not BRDF-typed.
    """
    records_reference.count += 1
    defer = Defer(settings)
    idx, n_slots = layout(settings, defer)
    w, h = settings.width, settings.height
    off, n = integrator.pixel_range(settings, pixel_offset, n_local_pixels)
    spp, bounces = settings.samples_per_pass, settings.bounces
    dev = scene.device
    mis = settings.brdf_importance_sampling and defer.merl
    shade_settings = settings.replace(has_diffuse_map=False)  # colour 1
    sampler = brdf_sampling.build_merl_sampler(scene.brdf) if mis else None

    ray_o0, ray_d0 = generate_rays(camera, w, h)
    ray_o0, ray_d0 = ray_o0[off:off + n], ray_d0[off:off + n]
    ids = pixel_ids(w, h, dev)[off:off + n].repeat(spp)
    sids = torch.arange(sample_offset, sample_offset + spp, dtype=torch.int64,
                        device=dev).repeat_interleave(n)
    o, d = ray_o0.repeat(spp, 1), ray_d0.repeat(spp, 1)
    f32 = dict(dtype=torch.float32, device=dev)
    m = torch.ones((spp * n, 3), **f32)
    alive = torch.ones((spp * n,), dtype=torch.bool, device=dev)
    killed = torch.zeros_like(alive)
    depth = torch.ones((spp * n,), **f32)
    acc = torch.zeros((spp * n, 3), **f32)
    rec = {}  # (name, b) -> [spp*n, width]

    for b in range(bounces):
        hd, obj, uv = _intersect(scene, shade_settings, o, d,
                                 None if b == 0 else alive)
        live, miss = alive & hd.hit, alive & ~hd.hit
        if settings.use_cornell_box:
            killed = killed | miss
        if b == 0:
            depth = torch.where(live, hd.t / settings.depth_scale, depth)
        emitted = torch.where(live[:, None], m * hd.emission, torch.zeros_like(m))
        if defer.emit:
            rec[("A", b)] = emitted
        else:
            acc = acc + emitted
        if defer.env:
            rec[("E", b)] = torch.where(miss[:, None], m, torch.zeros_like(m))
            rec[("dir", b)] = d

        u_reflect, _, u_phi, u_r, *u_b = rng.bounce_uniforms(
            seed, ids, sids, frame, b, 3 if mis else 2)
        new_dir, mult = scatter(d, hd.normal, hd.tangent, hd.color,
                                hd.spec_color, hd.hit_type, u_reflect, u_phi,
                                u_r, fresnel_coef, fresnel_pow)
        is_brdf = hd.hit_type == BRDF
        if defer.merl:
            if mis:
                u_b1, u_b2 = u_b
                bdir, p_mix, cos_o = brdf_sampling.mis_direction(
                    sampler, d, hd.normal, new_dir, u_reflect, u_b1, u_b2, u_phi)
                fac = torch.where(p_mix > 0.0, (1.0 / math.pi) * cos_o
                                  / torch.clamp(p_mix, min=1e-8),
                                  torch.zeros_like(p_mix))[:, None]
            else:
                bdir, fac = new_dir, torch.ones_like(mult)
            b3 = is_brdf[:, None]
            new_dir = torch.where(b3, bdir, new_dir)
            mult = torch.where(b3, fac.expand_as(mult), mult)
            midx = merl_index(bdir, d, hd.normal, hd.tangent).to(torch.float32)
            rec[("midx", b)] = torch.where(live & is_brdf, midx,
                                           torch.full_like(midx, -1.0))[:, None]
        if defer.tex:
            active = live & obj & ~is_brdf
            rec[("uv", b)] = torch.stack([
                torch.where(active, uv[:, 0], torch.full_like(uv[:, 0], math.inf)),
                torch.where(active, uv[:, 1], torch.zeros_like(uv[:, 1]))], dim=-1)

        lh = live[:, None]
        o = torch.where(lh, hd.point + ORIGIN_OFFSET * hd.normal, o)
        d = torch.where(lh, new_dir, d)
        m = torch.where(lh, m * mult, m)
        alive = live

    if settings.use_cornell_box:
        depth = torch.where(killed, torch.zeros_like(depth), depth)
        keep = (~killed)[:, None].to(torch.float32)
        for key in rec:
            if key[0] in ("A", "E"):
                rec[key] = rec[key] * keep
        acc = torch.where(killed[:, None], torch.zeros_like(acc), acc)

    out = torch.empty((n_slots, n), **f32)
    out[0] = depth[(spp - 1) * n:]  # the last sample's (all share the primary ray)
    for key, k in idx.items():
        if key[0] == "rgb":
            out[k:k + 3] = (acc.reshape(spp, n, 3).sum(dim=0) * (1.0 / spp)).T
        elif key[0] != "depth":
            name, s, b = key
            field = rec[(name, b)][s * n:(s + 1) * n]
            out[k:k + field.shape[1]] = field.T
    return out


records_reference.count = 0


# --- the kernel -------------------------------------------------------------

class _Params(ctypes.Structure):
    """The kernel's arguments (``csrc/mesh.cu`` ``Params``, field for
    field)."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cam", "spheres", "nodes", "rows", "tri_e1",
        "tri_e2", "tri_uv", "tri_t", "mis", "records", "stats")] + [
        (name, ctypes.c_int) for name in (
            "n_spheres", "width", "height", "spp", "bounces", "flags",
            "per_sb", "off_a", "off_e", "off_dir", "off_uv", "off_midx",
            "rgb_slot", "fault")] + [
        (name, ctypes.c_uint) for name in ("seed_lo", "seed_hi", "frame")] + [
        ("depth_scale", ctypes.c_float), ("fault_arg", ctypes.c_float)] + [
        (name, ctypes.c_void_p) for name in ("hdr", "tex", "brdf")] + [
        (name, ctypes.c_int) for name in (
            "hdr_w", "hdr_h", "tex_w", "tex_h", "bilinear", "direct",
            "pixel_offset", "n_local")] + [("sample_offset", ctypes.c_uint)]


# The kernel's work counters (csrc/mesh.cu kStats), in order; the last two
# count direct mode's HDRI and texture fetches (0 in records mode).
STATS = ("node_visits", "box_tests", "triangle_tests", "traced_steps", "hits",
         "brdf_hits", "mis_draws", "env_fetches", "tex_fetches")

# Flag bits (csrc/mesh.cu kFlag*).
_CORNELL, _EXAMPLE, _MESH, _USE_BRDF, _ENV, _TEX, _MERL, _MIS = (1 << i for i in range(8))


@functools.lru_cache(maxsize=None)
def _k4():
    from vrenderer_pathtracer_tpu_torch.kernels import build

    fn = build.load("mesh").vpt_mesh
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_MIS_CACHE: dict = {}


def mis_tables(table: torch.Tensor) -> torch.Tensor:
    """[361] float32 on the table's device: the sampler's mass and CDF
    (``build_merl_sampler``), then ``_COS_EDGES`` and ``_BIN_DOMEGA``.

    Cached with the table: rebuilt only when a different table comes, or
    this one was changed in place (its version counter moved, as an
    optimiser's step moves it)."""
    key = id(table)
    hit = _MIS_CACHE.get(key)
    if hit is not None and hit[0]() is table and hit[1] == table._version:
        return hit[2]
    s = brdf_sampling.build_merl_sampler(table)
    packed = torch.cat([
        s.mass, s.cdf,
        torch.as_tensor(brdf_sampling._COS_EDGES, device=table.device),
        torch.as_tensor(brdf_sampling._BIN_DOMEGA, device=table.device),
    ]).contiguous()
    _MIS_CACHE[key] = (weakref.ref(table, lambda _: _MIS_CACHE.pop(key, None)),
                       table._version, packed)
    return packed


def _check(name, t, device, dtype, shape=None):
    if t.device != device:
        raise ValueError(f"K4 {name} on {t.device}, want {device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"K4 {name} must be contiguous {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"K4 {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"K4 {name} is not 16-byte aligned")


def mode(scene: Scene) -> str:
    """The mode of a K4 pass on ``scene``: ``RECORDS`` when autograd is on
    and any of ``scene.hdr``, ``scene.diffuse_map`` or ``scene.brdf``
    requires a gradient (``deferred_opt_step``: the gradients flow through
    :func:`compose`), else ``DIRECT`` (every ``Renderer`` pass)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (scene.hdr, scene.diffuse_map, scene.brdf)):
        return RECORDS
    return DIRECT


def _table(name, t, device, shape):
    """A table the direct mode fetches, as the kernel reads it."""
    if t is None:
        raise ValueError(f"K4's direct mode fetches {name}, and the scene has none")
    t = t.detach().contiguous()  # read by element: any alignment will do
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"K4 {name}: {t.dtype} {tuple(t.shape)} on {t.device}, "
                         f"want float32 {shape} on {device}")
    return t


def launch_k4(cam: torch.Tensor, sph: torch.Tensor, scene: Scene,
              settings: RenderSettings, frame: int, seed: int = 0, *,
              direct: bool = False, stats=None, fault: int = NO_FAULT,
              fault_arg: float = 0.0, pixel_offset: int = 0,
              sample_offset: int = 0, n_local_pixels=None) -> torch.Tensor:
    """Launch K4 on packed tables (``cuda_radiance.pack_camera`` /
    ``pack_spheres``) on the current stream, over the pixels and samples
    the offsets name (module docstring; ``n`` pixels).  Returns the records
    ``[n_slots, n]`` in :func:`layout`'s order, or with ``direct`` the
    composed pass, ``[4, n]``: depth, then the rgb mean (what
    :func:`compose` makes of the records; the kernel fetches the HDRI,
    texture and MERL values itself).  ``stats`` (an int64 [len(STATS)] CUDA
    tensor) makes the kernel add its work counts to it; ``fault`` plants one
    of the faults above (``fault_arg``: the uv shift), those of
    ``DIRECT_FAULTS`` in direct mode only."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA devices, not {device}")
    for name, t in (("cam", cam), ("spheres", sph)):
        if t.requires_grad:
            raise ValueError(f"K4 has no backward: its {name} table requires grad")
    _check("cam", cam, device, torch.float32, (14,))
    _check("spheres", sph, device, torch.float32)
    if sph.dim() != 2 or sph.shape[1] != 14 or not 0 < sph.shape[0] < 2 ** 24:
        raise ValueError(f"K4 spheres table has shape {tuple(sph.shape)}")
    if not supports(scene, settings):
        raise NotImplementedError("K4 does not cover this scene (cuda_mesh.supports)")
    if (fault in DIRECT_FAULTS) != (direct and fault != NO_FAULT):
        raise ValueError(f"K4 fault {fault} does not apply to the "
                         f"{'direct' if direct else 'records'} mode")
    if not 0 < settings.n_pixels < 2 ** 31:
        raise ValueError(f"{settings.n_pixels} pixels is out of the kernel's range")
    off, n = integrator.pixel_range(settings, pixel_offset, n_local_pixels)
    if not 0 <= sample_offset < 2 ** 32 - settings.samples_per_pass:
        raise ValueError(f"sample_offset {sample_offset} is out of range")
    defer = Defer(settings)
    idx, n_slots = layout(settings, defer)
    mis = settings.brdf_importance_sampling and defer.merl
    has_mesh = settings.has_mesh and not settings.use_example_sphere
    keep = []  # tensors whose pointers the launch holds

    def ptr(t):
        keep.append(t)
        return t.data_ptr()

    p = _Params()
    p.cam, p.spheres, p.n_spheres = ptr(cam), ptr(sph), sph.shape[0]
    if has_mesh:
        mesh = scene.mesh
        if mesh.nodes8_c is None or mesh.leaf_rows is None:
            raise ValueError("K4 walks the mesh's compressed copy "
                             "(accel/mesh.py builds it), which it lacks")
        r = mesh.tri_v0.shape[0]
        for name, dtype, shape in (("nodes8_c", torch.int32,
                                    (mesh.nodes8_c.shape[0], CW_WORDS)),
                                   ("leaf_rows", torch.float32,
                                    (mesh.leaf_rows.shape[0], ROW_WORDS)),
                                   ("tri_e1", torch.float32, (r, 3)),
                                   ("tri_e2", torch.float32, (r, 3)),
                                   ("tri_uv", torch.float32, (r, 3, 2)),
                                   ("tri_t", torch.float32, (r, 3, 3))):
            _check(name, getattr(mesh, name), device, dtype, shape)
        p.nodes, p.rows = ptr(mesh.nodes8_c), ptr(mesh.leaf_rows)
        p.tri_e1, p.tri_e2 = ptr(mesh.tri_e1), ptr(mesh.tri_e2)
        p.tri_uv, p.tri_t = ptr(mesh.tri_uv), ptr(mesh.tri_t)
    if mis:
        p.mis = ptr(mis_tables(scene.brdf))
    if direct:
        if defer.env:
            hdr = scene.hdr
            hdr = _table("hdr", hdr, device, (hdr.shape[0], hdr.shape[1], 3))
            p.hdr, p.hdr_h, p.hdr_w = ptr(hdr), hdr.shape[0], hdr.shape[1]
        if defer.tex:
            tex = scene.diffuse_map
            tex = _table("diffuse_map", tex, device, (tex.shape[0], tex.shape[1], 3))
            p.tex, p.tex_h, p.tex_w = ptr(tex), tex.shape[0], tex.shape[1]
        if defer.merl:
            p.brdf = ptr(_table("brdf", scene.brdf, device, (3, TABLE_SIZE)))
        p.bilinear = int(settings.texture_filter == "bilinear")
        p.direct = 1
        out = torch.empty((4, n), dtype=torch.float32, device=device)
    else:
        out = torch.empty((n_slots, n), dtype=torch.float32, device=device)
    p.records = ptr(out)
    if stats is not None:
        _check("stats", stats, device, torch.int64, (len(STATS),))
        p.stats = ptr(stats)
    p.width, p.height = settings.width, settings.height
    p.spp, p.bounces = settings.samples_per_pass, settings.bounces
    p.flags = ((_CORNELL if settings.use_cornell_box else 0)
               | (_EXAMPLE if settings.use_example_sphere else 0)
               | (_MESH if has_mesh else 0)
               | (_USE_BRDF if settings.use_brdf else 0)
               | (_ENV if defer.env else 0) | (_TEX if defer.tex else 0)
               | (_MERL if defer.merl else 0) | (_MIS if mis else 0))
    p.per_sb = defer.slots_per_sb()
    # Offsets of the fields within a (s, b) group; (s, b)'s group starts at
    # slot 1 + (s * bounces + b) * per_sb.
    p.off_a = idx[("A", 0, 0)] - 1 if defer.emit else -1
    p.off_e = idx[("E", 0, 0)] - 1 if defer.env else -1
    p.off_dir = idx[("dir", 0, 0)] - 1 if defer.env else -1
    p.off_uv = idx[("uv", 0, 0)] - 1 if defer.tex else -1
    p.off_midx = idx[("midx", 0, 0)] - 1 if defer.merl else -1
    p.rgb_slot = idx.get(("rgb",), -1)
    p.fault, p.fault_arg = int(fault), float(fault_arg)
    p.seed_lo, p.seed_hi = seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF
    p.frame = int(frame) & 0xFFFFFFFF
    p.depth_scale = settings.depth_scale
    p.pixel_offset, p.n_local, p.sample_offset = off, n, sample_offset
    fn = _k4()
    with torch.cuda.device(device):
        err = fn(ctypes.addressof(p), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError_t {err}")
    launch_k4.count += 1
    return out


launch_k4.count = 0


# --- the epilogue -----------------------------------------------------------

def compose(records: torch.Tensor, scene: Scene, settings: RenderSettings):
    """K4's records ``[n_slots, N]`` -> ``(rgb [N,3], depth [N])``: the
    deferred texture, MERL and HDRI fetches and the ``PD_b`` composition,
    differentiable with respect to ``scene.hdr``, ``scene.diffuse_map`` and
    ``scene.brdf``.  A path misses at most once, so the HDRI is fetched once
    a sample, at the direction of the bounce whose ``E`` is nonzero.
    ``.count`` counts calls."""
    compose.count += 1
    defer = Defer(settings)
    idx, n_slots = layout(settings, defer)
    if records.shape[0] != n_slots:
        raise ValueError(f"{records.shape[0]} record slots, layout has {n_slots}")
    depth = records[0]

    def field(key, width):
        k = idx[key]
        return records[k:k + width].T  # [N, width]

    if not defer.emit and not defer.env:
        return field(("rgb",), 3), depth
    bilinear = settings.texture_filter == "bilinear"
    fetch = tex_ops.fetch_bilinear if bilinear else tex_ops.fetch_nearest
    n = records.shape[1]
    ones = torch.ones((n, 3), dtype=records.dtype, device=records.device)
    total = torch.zeros_like(ones)
    for s in range(settings.samples_per_pass):
        pd = ones
        env_w = env_dir = None
        for b in range(settings.bounces):
            if defer.emit:
                total = total + field(("A", s, b), 3) * pd
            if defer.env:
                e, dirs = field(("E", s, b), 3), field(("dir", s, b), 3)
                if env_w is None:
                    env_w, env_dir = e * pd, dirs
                else:
                    env_w = env_w + e * pd
                    miss_here = torch.any(e > 0.0, dim=-1, keepdim=True)
                    env_dir = torch.where(miss_here, dirs, env_dir)
            d_fac = ones
            if defer.tex:
                uu, vv = field(("uv", s, b), 2).unbind(-1)
                active = torch.isfinite(uu)
                zero = torch.zeros_like(uu)
                texc = fetch(scene.diffuse_map, torch.where(active, uu, zero),
                             torch.where(active, vv, zero))
                d_fac = d_fac * torch.where(active[:, None], texc, ones)
            if defer.merl:
                mi = records[idx[("midx", s, b)]]
                # index_select: its backward is an atomic index_add_, where
                # the backward of brdf[:, i] accumulates the many lanes that
                # share a MERL cell one cell at a time (97% of a step).
                val = (torch.index_select(scene.brdf, 1, torch.clamp(mi, min=0.0).long()).T
                       * channel_scale(records)[None, :])
                fac = 24.0 * torch.clamp(val, min=0.0)
                d_fac = d_fac * torch.where((mi >= 0.0)[:, None], fac, ones)
            pd = pd * d_fac
        if defer.env:
            # A never-missed path carries env_w = 0 with a stale direction;
            # the guard keeps a non-finite HDR texel out of it (0 * inf).
            ever_missed = torch.any(env_w != 0.0, dim=-1, keepdim=True)
            total = total + torch.where(
                ever_missed, env_w * sample_env(scene.hdr, env_dir, bilinear),
                torch.zeros_like(env_w))
    total = total / settings.samples_per_pass
    if not defer.emit:
        total = total + field(("rgb",), 3)
    return total, depth


compose.count = 0


# --- the pass ---------------------------------------------------------------

def _refuse_grad(scene: Scene, camera: Camera, fresnel_coef, fresnel_pow):
    leaves = {"camera." + k: getattr(camera, k)
              for k in ("origin", "yaw", "pitch", "fov_deg")}
    leaves.update({"fresnel_coef": fresnel_coef, "fresnel_pow": fresnel_pow})
    leaves.update({"spheres." + k: getattr(scene.spheres, k)
                   for k in ("pos", "radius", "color", "emission", "spec_color")})
    for name, t in leaves.items():
        if isinstance(t, torch.Tensor) and t.requires_grad:
            raise ValueError(
                f"{name} requires grad, but K4 has no backward: only the "
                "deferred tables (hdr, diffuse_map, brdf) differentiate "
                "through render_pass_mesh; use radiance_kernel='wavefront' "
                "(or K2 for Cornell scenes)")


def render_pass_mesh(scene: Scene, settings: RenderSettings, camera: Camera,
                     frame: int, fresnel_coef, fresnel_pow, seed: int = 0,
                     pixel_offset: int = 0, sample_offset: int = 0,
                     n_local_pixels=None):
    """One progressive pass through K4: ``(rgb_mean [n,3], depth [n])`` over
    the pixels and samples the offsets name (module docstring).

    CUDA tensors launch K4 (built at first use) in the pass's
    :func:`mode`: direct (the kernel's own ``[4, N]``), or the records and
    then :func:`compose`, whose autograd carries the tables' gradients.  CPU
    tensors take :func:`records_reference` and :func:`compose` in both modes
    (the function both compute).  Raises on a scene K4 does not cover and on
    inputs other than the deferred tables that require a gradient; a failed
    build or launch raises in either mode.
    """
    device = scene.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"K4 runs on CUDA devices (or its plain version on "
                         f"the CPU), not {device}")
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    if not supports(scene, settings):
        raise NotImplementedError("K4 does not cover this scene (cuda_mesh.supports)")
    _refuse_grad(scene, camera, fresnel_coef, fresnel_pow)
    pass_mode = mode(scene)
    shard = dict(pixel_offset=pixel_offset, sample_offset=sample_offset,
                 n_local_pixels=n_local_pixels)
    if device.type == "cpu":
        records = records_reference(scene, settings, camera, frame,
                                    fresnel_coef, fresnel_pow, seed, **shard)
        return compose(records, scene, settings)
    args = (pack_camera(camera, settings, fresnel_coef, fresnel_pow),
            pack_spheres(scene.spheres), scene, settings, frame, seed)
    if pass_mode == RECORDS:
        return compose(launch_k4(*args, **shard), scene, settings)
    out = launch_k4(*args, direct=True, **shard)
    return out[1:].T, out[0]


# --- the contract -----------------------------------------------------------

def records_agreement(got: torch.Tensor, want: torch.Tensor,
                      settings: RenderSettings, atol=None) -> dict:
    """How two record sets of the same layout agree, per field name:
    ``{name: (fraction of elements off by more than the field's tolerance,
    max abs err)}``.  Tolerances: 1e-4, or ``atol[name]``; ``midx`` exact.
    Equal infinities agree, and the max is taken where both are finite."""
    idx, n_slots = layout(settings)
    assert got.shape == want.shape and got.shape[0] == n_slots
    widths = {"depth": 1, "A": 3, "E": 3, "dir": 3, "uv": 2, "midx": 1, "rgb": 3}
    rows: dict = {}
    for key, k in idx.items():
        rows.setdefault(key[0], []).extend(range(k, k + widths[key[0]]))
    out = {}
    for name, r in rows.items():
        g, w = got[r], want[r]
        same = (g == w) | (torch.isnan(g) & torch.isnan(w))
        finite = torch.isfinite(g) & torch.isfinite(w)
        err = torch.where(finite, (g - w).abs(), torch.zeros_like(g))
        tol = 0.0 if name == "midx" else (atol or {}).get(name, 1e-4)
        bad = ~same & (~finite | (err > tol))
        out[name] = (bad.float().mean().item(), err.max().item())
    return out
