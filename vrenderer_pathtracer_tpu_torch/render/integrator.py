"""Wavefront path integrator (port of ``render/integrator.py``).

Each bounce is one vectorised step over ``[B]`` SoA tensors (origins,
directions, throughput, radiance); finished lanes are masked with
``torch.where``.  This is the plain PyTorch version of the radiance kernel
(``render/cuda_radiance.py``), the CPU path, the base of the autograd train
step, and, on the card, the integrator of every scene K1 does not cover,
with K3/K3b as its mesh search.

Estimator (the JAX package's, constant for constant):

* Cornell mode: a miss kills the path, discarding prior emission.  Otherwise
  a miss fetches the HDRI: ``accum += mask * 2 * hdr[latlong]``.
* depth = ``|origin - hit| / depth_scale`` at the first bounce.
* ``accum += mask * emission``, then the material scatter
  (``ops/shading.py``).
* Scene intersection: the analytic spheres, then the example sphere *or*
  the mesh, a later hit winning only if strictly closer.

* Measured BRDFs: BRDF-typed hits weight a cosine sample by
  ``24 * max(merl, 0)``, or take the one-sample lobe MIS of
  ``ops/brdf_sampling.py`` under ``brdf_importance_sampling`` (its sampler
  built once a pass from the detached table, its two extra uniforms from
  the slot-2 draws).

* Compact bounce waves (:func:`radiance`) and ``remat_bounces`` (each
  bounce checkpointed, ``torch.utils.checkpoint``).  Win-time attribute
  capture (``captured_attrs``, ``accel/traverse.py::mesh_hit``) shades
  from the search's own attributes, forward only, at full width: compact
  waves are off under it, as in the JAX integrator.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core import rng
from vrenderer_pathtracer_tpu_torch.core.camera import generate_rays, pixel_ids
from vrenderer_pathtracer_tpu_torch.ops import texture as tex_ops
from vrenderer_pathtracer_tpu_torch.ops.envmap import (
    sample_env_bilinear, sample_env_nearest)
from vrenderer_pathtracer_tpu_torch.ops.intersect import INF, intersect_spheres
from vrenderer_pathtracer_tpu_torch.ops.shading import ORIGIN_OFFSET, scatter
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import (
    BRDF, DIFF, EXAMPLE_SPHERE_POS, EXAMPLE_SPHERE_RADIUS)


class HitData(NamedTuple):
    """SoA hit record, one entry per ray lane."""

    hit: torch.Tensor         # [B] bool
    t: torch.Tensor           # [B]
    point: torch.Tensor       # [B,3]
    normal: torch.Tensor      # [B,3]
    tangent: torch.Tensor     # [B,3]
    color: torch.Tensor       # [B,3]
    spec_color: torch.Tensor  # [B,3]
    emission: torch.Tensor    # [B,3]
    hit_type: torch.Tensor    # [B] int32


def _norm(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-20)


def _intersect_sphere_set(scene: Scene, ray_o, ray_d) -> HitData:
    """Nearest analytic-sphere hit per lane.

    A running min over the sphere list; strict ``<`` lets the earlier
    sphere win a tie, as the reference does.
    """
    s = scene.spheres
    b = ray_o.shape[0]
    f32 = dict(dtype=torch.float32, device=ray_o.device)
    best_t = torch.full((b,), INF, **f32)
    best_pos = torch.zeros((b, 3), **f32)
    color = torch.zeros((b, 3), **f32)
    spec = torch.zeros((b, 3), **f32)
    emission = torch.zeros((b, 3), **f32)
    refl = torch.zeros((b,), dtype=torch.int32, device=ray_o.device)
    for i in range(s.count):
        dist = intersect_spheres(ray_o, ray_d, s.pos[i][None, :],
                                 s.radius[i][None])[:, 0]
        closer = dist < best_t
        c3 = closer[:, None]
        best_t = torch.where(closer, dist, best_t)
        best_pos = torch.where(c3, s.pos[i][None, :], best_pos)
        color = torch.where(c3, s.color[i][None, :], color)
        spec = torch.where(c3, s.spec_color[i][None, :], spec)
        emission = torch.where(c3, s.emission[i][None, :], emission)
        refl = torch.where(closer, s.refl[i], refl)

    hit = best_t < INF
    # Miss lanes carry t=INF; the masked-out hit point would overflow and
    # poison the backward pass of torch.where, so clamp t on those lanes.
    t_safe = torch.where(hit, best_t, torch.zeros_like(best_t))
    point = ray_o + ray_d * t_safe[:, None]
    normal = _norm(point - best_pos)
    return HitData(hit=hit, t=best_t, point=point, normal=normal,
                   tangent=torch.zeros_like(normal), color=color,
                   spec_color=spec, emission=emission, hit_type=refl)


def _example_sphere_hit(scene: Scene, settings: RenderSettings, ray_o, ray_d,
                        prev: HitData) -> HitData:
    """Example-sphere intersection with texture/normal-map shading.

    UVs come from the fresh surface normal (the reference reads a stale
    one); the spherical tangent estimate is the reference's, also used as
    the BRDF tangent.
    """
    f32 = dict(dtype=torch.float32, device=ray_o.device)
    pos = torch.tensor(EXAMPLE_SPHERE_POS, **f32)
    r = torch.tensor([EXAMPLE_SPHERE_RADIUS], **f32)
    dist = intersect_spheres(ray_o, ray_d, pos[None, :], r)[:, 0]
    closer = dist < prev.t

    dist_safe = torch.where(dist < INF, dist, torch.zeros_like(dist))
    point = ray_o + ray_d * dist_safe[:, None]
    normal = _norm(point - pos[None, :])
    u = torch.atan2(normal[:, 0], normal[:, 2]) / (2.0 * math.pi) + 0.5
    v = normal[:, 1] * 0.5 + 0.5

    use_tex = not settings.use_brdf
    texd, texn, texs = tex_ops.fetch_maps(
        [scene.diffuse_map if settings.has_diffuse_map and use_tex else None,
         scene.normal_map if settings.has_normal_map else None,
         scene.specular_map if settings.has_specular_map and use_tex
         else None],
        u, v, settings.texture_filter)
    color = texd if texd is not None else torch.ones_like(point)

    # Spherical tangent estimate (the reference's formula, kept for parity).
    pr = torch.clamp(torch.linalg.norm(point, dim=-1), min=1e-12)
    theta = torch.arccos(torch.clamp(point[:, 2] / pr, -1.0, 1.0))
    phi = torch.atan2(point[:, 1], point[:, 0])
    tangent = torch.stack([torch.sin(theta) * torch.cos(phi),
                           torch.sin(theta) * torch.sin(phi),
                           torch.cos(theta)], dim=-1)

    if settings.has_normal_map:
        normal = tex_ops.apply_tbn(normal, tangent,
                                   tex_ops.decode_normal_map(texn))

    spec = texs if texs is not None else torch.zeros_like(point)
    hit_type = torch.full(dist.shape, BRDF if settings.use_brdf else DIFF,
                          dtype=torch.int32, device=dist.device)
    c3 = closer[:, None]
    return HitData(
        hit=prev.hit | closer,
        t=torch.where(closer, dist, prev.t),
        point=torch.where(c3, point, prev.point),
        normal=torch.where(c3, normal, prev.normal),
        tangent=torch.where(c3, tangent, prev.tangent),
        color=torch.where(c3, color, prev.color),
        spec_color=torch.where(c3, spec, prev.spec_color),
        emission=torch.where(c3, torch.zeros_like(point), prev.emission),
        hit_type=torch.where(closer, hit_type, prev.hit_type),
    )


def intersect_scene(scene: Scene, settings: RenderSettings, ray_o, ray_d,
                    alive=None) -> HitData:
    """Scene intersection in the reference's priority order: Cornell and
    analytic spheres, then the example sphere *or* the mesh, later hits
    winning only if strictly closer.

    ``alive`` ([B] bool, optional): lanes already terminated.  Their hit
    record is masked out by every consumer; giving them a zero search bound
    makes the mesh search return at once for them (K3/K3b exit on
    ``t_max <= 0``), with live-lane results unchanged.
    """
    hd = _intersect_sphere_set(scene, ray_o, ray_d)
    if settings.use_example_sphere:
        hd = _example_sphere_hit(scene, settings, ray_o, ray_d, hd)
    elif settings.has_mesh:
        from vrenderer_pathtracer_tpu_torch.accel.traverse import mesh_hit

        if alive is not None:
            hd = hd._replace(t=torch.where(alive, hd.t, torch.zeros_like(hd.t)))
        hd = mesh_hit(scene, settings, ray_o, ray_d, hd)
    return hd


class _Pass(NamedTuple):
    """What every bounce of one :func:`radiance` call reads."""

    scene: Scene
    settings: RenderSettings
    frame: object
    fresnel_coef: object
    fresnel_pow: object
    seed: int
    brdf_table: object
    brdf_sampler: object
    use_env: bool


def _shade(ctx: _Pass, hd: HitData, ray_o, ray_d, mask, alive, pix, samp,
           bounce: int):
    """One bounce's shading from its hit record: the live-hit mask, the
    emission term and the scattered ray's origin, direction and
    throughput, on the lanes given (pixel and sample ids ``pix``, ``samp``
    name each lane's RNG streams)."""
    live_hit = alive & hd.hit
    lh = live_hit[:, None]
    emitted = torch.where(lh, mask * hd.emission, torch.zeros_like(mask))
    mis = ctx.brdf_sampler is not None
    u_reflect, _, u_phi, u_r, *u_b = rng.bounce_uniforms(
        ctx.seed, pix, samp, ctx.frame, bounce, 3 if mis else 2)
    u_b1, u_b2 = u_b if mis else (None, None)
    new_dir, mult = scatter(
        ray_d, hd.normal, hd.tangent, hd.color, hd.spec_color, hd.hit_type,
        u_reflect, u_phi, u_r, ctx.fresnel_coef, ctx.fresnel_pow,
        brdf_table=ctx.brdf_table, brdf_sampler=ctx.brdf_sampler, u_b1=u_b1,
        u_b2=u_b2)
    return (live_hit, emitted,
            torch.where(lh, hd.point + ORIGIN_OFFSET * hd.normal, ray_o),
            torch.where(lh, new_dir, ray_d), torch.where(lh, mask * mult, mask))


def _bounce(ctx: _Pass, bounce: int, pix, samp, ray_o, ray_d, mask, accum,
            depth, alive, killed, env_w, env_dir, slot0=None):
    """One bounce over the lanes given: intersect, record a miss (Cornell
    kill, or the HDRI weight and direction), the first-hit depth, the
    emission, and scatter.  Returns the new carry.

    ``slot0``: the compact chain's bounce 0, whose mesh slots were searched
    at full width; the hit is shaded from them (the sphere record is
    recomputed: the same function on the same inputs)."""
    from vrenderer_pathtracer_tpu_torch.accel.traverse import shade_mesh_hit

    settings = ctx.settings
    if slot0 is not None:
        prev = _intersect_sphere_set(ctx.scene, ray_o, ray_d)
        hd = shade_mesh_hit(ctx.scene, settings, ray_o, ray_d, slot0, prev)
    else:
        hd = intersect_scene(ctx.scene, settings, ray_o, ray_d,
                             alive=None if bounce == 0 else alive)
    miss = alive & ~hd.hit
    if settings.use_cornell_box:
        killed = killed | miss
    elif ctx.use_env:
        env_w = env_w + torch.where(miss[:, None], mask, torch.zeros_like(mask))
        env_dir = torch.where(miss[:, None], ray_d, env_dir)
    if bounce == 0:
        d0 = torch.linalg.norm(ray_o - hd.point, dim=-1) / settings.depth_scale
        depth = torch.where(alive & hd.hit, d0, depth)
    live_hit, emitted, ray_o, ray_d, mask = _shade(
        ctx, hd, ray_o, ray_d, mask, alive, pix, samp, bounce)
    return (ray_o, ray_d, mask, accum + emitted, depth, live_hit, killed,
            env_w, env_dir)


def _env_term(ctx: _Pass, env_w, env_dir):
    """The collapsed HDRI fetch: ``env_w * hdr(env_dir)`` on the lanes that
    ever missed.  Paths that never missed carry env_w = 0 and a stale
    direction; an HDR asset may hold inf/NaN texels, and 0 * inf would
    poison them."""
    env_fetch = (sample_env_bilinear
                 if ctx.settings.texture_filter == "bilinear"
                 else sample_env_nearest)
    ever_missed = torch.any(env_w != 0.0, dim=-1, keepdim=True)
    return torch.where(ever_missed, env_w * env_fetch(ctx.scene.hdr, env_dir),
                       torch.zeros_like(env_w))


def _stepper(settings: RenderSettings):
    """``run(fn, *args)``: ``fn(*args)``, or under ``remat_bounces`` the same
    call checkpointed (``torch.utils.checkpoint``, non-reentrant): its
    intermediates are recomputed in the backward pass instead of kept, so
    a bounce holds only its carry."""
    if not settings.remat_bounces:
        return lambda fn, *args: fn(*args)
    from torch.utils.checkpoint import checkpoint

    return lambda fn, *args: checkpoint(fn, *args, use_reentrant=False)


def radiance(scene: Scene, settings: RenderSettings, ray_o, ray_d, pixel_ids,
             sample_ids, frame, fresnel_coef, fresnel_pow, seed: int = 0):
    """Trace a ray batch for ``settings.bounces`` bounces.

    Returns ``(rgb [B,3], depth [B])``: the per-sample radiance estimate and
    the normalised first-hit depth.

    Compact bounce waves (``settings.compact_waves``, on for every paged
    mesh scene): the primary mesh search runs detached at full width; the
    lanes that hit anything are gathered (``torch.nonzero``, the exact
    count), and bounce-0 shading and every later bounce run at that width,
    accumulating per compact lane, with one scatter back at the end.  Each
    lane's arithmetic and RNG streams (its gathered pixel and sample ids)
    are the full-width chain's, so the image is the same.  There is no
    capacity: ``compact_capacity_frac`` and ``compact_mode`` (the JAX
    package's static capacity and its ``lax.cond`` fallback ladder) are
    accepted and have no effect, and no hit count can overflow.
    """
    from vrenderer_pathtracer_tpu_torch.ops.brdf_sampling import build_merl_sampler

    n_rays = ray_o.shape[0]
    brdf_table = scene.brdf if settings.has_brdf else None
    # Lobe importance sampler (opt-in): 90 numbers from the detached table,
    # built once a pass.
    brdf_sampler = None
    if settings.brdf_importance_sampling and brdf_table is not None:
        brdf_sampler = build_merl_sampler(brdf_table)
    # Env-fetch collapse: a path misses at most once, so the per-bounce HDRI
    # fetches fold into ONE fetch after the loop, from the weight and the
    # direction at the miss.
    use_env = (not settings.use_cornell_box and settings.has_hdr
               and scene.hdr is not None)
    ctx = _Pass(scene, settings, frame, fresnel_coef, fresnel_pow, seed,
                brdf_table, brdf_sampler, use_env)
    run = _stepper(settings)
    f32 = dict(dtype=torch.float32, device=ray_o.device)
    mask = torch.ones((n_rays, 3), **f32)
    accum = torch.zeros((n_rays, 3), **f32)
    depth = torch.ones((n_rays,), **f32)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=ray_o.device)
    killed = torch.zeros_like(alive)  # Cornell mode: a miss kills the path
    env_w = torch.zeros((n_rays, 3), **f32)
    env_dir = ray_d
    compact = (settings.compact_waves and settings.has_mesh
               and scene.mesh is not None and not settings.use_example_sphere
               and not settings.captured_attrs)

    if not compact:
        carry = (ray_o, ray_d, mask, accum, depth, alive, killed, env_w,
                 env_dir)
        for bounce in range(settings.bounces):
            carry = run(functools.partial(_bounce, ctx, bounce, pixel_ids,
                                          sample_ids), *carry)
        _, _, _, accum, depth, _, killed, env_w, env_dir = carry
    elif settings.bounces > 0:
        from vrenderer_pathtracer_tpu_torch.accel.traverse import mesh_search

        # The primary search at full width, detached; its misses stay
        # full width (the Cornell kill, or the HDRI weight and direction).
        hd_sph = _intersect_sphere_set(scene, ray_o, ray_d)
        slot0, _ = mesh_search(scene, settings, ray_o, ray_d, hd_sph.t)
        hit = hd_sph.hit | (slot0 >= 0)
        miss0 = ~hit
        if settings.use_cornell_box:
            killed = killed | miss0
        elif use_env:
            env_w = env_w + torch.where(miss0[:, None], mask,
                                        torch.zeros_like(mask))
            env_dir = torch.where(miss0[:, None], ray_d, env_dir)
        # The hit lanes, compactly: radiance, the HDRI weight and
        # direction, the Cornell kill and the depth accumulate per lane.
        idx = torch.nonzero(hit).squeeze(1)
        n_c = idx.shape[0]
        d_c = ray_d[idx]
        cc = (ray_o[idx], d_c, mask[idx], torch.zeros((n_c, 3), **f32),
              torch.ones((n_c,), **f32),
              torch.ones((n_c,), dtype=torch.bool, device=ray_o.device),
              torch.zeros((n_c,), dtype=torch.bool, device=ray_o.device),
              torch.zeros((n_c, 3), **f32), d_c)
        pix_c, samp_c = pixel_ids[idx], sample_ids[idx]
        for bounce in range(settings.bounces):
            cc = run(functools.partial(
                _bounce, ctx, bounce, pix_c, samp_c,
                slot0=slot0[idx] if bounce == 0 else None), *cc)
        _, _, _, acc_c, depth_c, _, kill_c, envw_c, envdir_c = cc
        if use_env:
            acc_c = acc_c + _env_term(ctx, envw_c, envdir_c)
        accum = accum.index_add(0, idx, acc_c)
        depth = depth.index_put((idx,), depth_c)
        if settings.use_cornell_box:
            killed = killed.index_put((idx,), kill_c)

    if use_env:
        accum = accum + _env_term(ctx, env_w, env_dir)
    if settings.use_cornell_box:
        accum = torch.where(killed[:, None], torch.zeros_like(accum), accum)
        depth = torch.where(killed, torch.zeros_like(depth), depth)
    return accum, depth


def render_pass(scene: Scene, settings: RenderSettings, ray_o, ray_d,
                pixel_ids, frame, fresnel_coef, fresnel_pow, seed: int = 0,
                sample_offset: int = 0):
    """One progressive pass: ``samples_per_pass`` estimates per pixel.

    Samples are batched into the lane dimension (B = N * S), in chunks of
    ``samples_per_chunk`` to bound memory.  ``sample_offset`` shifts the
    sample ids of the draws, so that a sample shard draws its own streams
    (``parallel/sharding.py``).  Returns ``(rgb_mean [N,3], depth [N])``.
    """
    n = ray_o.shape[0]
    s = settings.samples_per_pass
    chunk = min(settings.samples_per_chunk or s, s)
    if s % chunk:
        raise ValueError(f"samples_per_pass={s} not divisible by chunk={chunk}")

    rgb_sum = torch.zeros((n, 3), dtype=torch.float32, device=ray_o.device)
    depth = None
    for c0 in range(0, s, chunk):
        big_o = ray_o.repeat(chunk, 1)
        big_d = ray_d.repeat(chunk, 1)
        big_ids = pixel_ids.repeat(chunk)
        sample_ids = torch.arange(
            sample_offset + c0, sample_offset + c0 + chunk, dtype=torch.int64,
            device=ray_o.device).repeat_interleave(n)
        rgb_c, depth_c = radiance(scene, settings, big_o, big_d, big_ids,
                                  sample_ids, frame, fresnel_coef,
                                  fresnel_pow, seed)
        rgb_sum = rgb_sum + rgb_c.reshape(chunk, n, 3).sum(dim=0)
        depth = depth_c.reshape(chunk, n)[-1]  # same primary ray: last write
    return rgb_sum / s, depth


def pixel_range(settings: RenderSettings, pixel_offset: int = 0,
                n_local_pixels=None) -> tuple:
    """``(offset, n)`` of the raster range ``[offset, offset + n)`` a pass
    renders: the whole frame by default; raises if it leaves the frame."""
    n = settings.n_pixels - pixel_offset if n_local_pixels is None \
        else n_local_pixels
    if pixel_offset < 0 or n <= 0 or pixel_offset + n > settings.n_pixels:
        raise ValueError(f"pixels [{pixel_offset}, {pixel_offset + n}) are "
                         f"not in the frame's {settings.n_pixels}")
    return pixel_offset, n


def render_camera_pass(scene: Scene, settings: RenderSettings, camera,
                       frame, fresnel_coef, fresnel_pow, seed: int = 0,
                       pixel_offset: int = 0, sample_offset: int = 0,
                       n_local_pixels=None):
    """One pass from the camera: ``generate_rays`` + :func:`render_pass`,
    ``(rgb_mean [n,3], depth [n])``.  K1's plain version, and the pass of
    every scene K1 does not cover.

    A shard renders the raster range ``[pixel_offset, pixel_offset +
    n_local_pixels)`` of the frame (default: the whole frame) with the
    samples ``sample_offset, ...``: its pixels' global ids key the draws,
    so shards tile together into the single-device image."""
    off, n = pixel_range(settings, pixel_offset, n_local_pixels)
    ray_o, ray_d = generate_rays(camera, settings.width, settings.height)
    ids = pixel_ids(settings.width, settings.height, scene.device)
    if n != settings.n_pixels:
        ray_o, ray_d, ids = ray_o[off:off + n], ray_d[off:off + n], ids[off:off + n]
    return render_pass(scene, settings, ray_o, ray_d, ids, frame,
                       fresnel_coef, fresnel_pow, seed, sample_offset)
