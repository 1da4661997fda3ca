"""Wavefront path integrator for sphere scenes (port of ``render/integrator.py``).

Each bounce is one vectorised step over ``[B]`` SoA tensors (origins,
directions, throughput, radiance); finished lanes are masked with
``torch.where``.  This is the plain PyTorch version of the radiance kernel
(``render/cuda_radiance.py``), the CPU path, and, being differentiable,
the base of the autograd train step.

Estimator (the JAX package's, constant for constant):

* Cornell mode: a miss kills the path, discarding prior emission.
* depth = ``|origin - hit| / depth_scale`` at the first bounce.
* ``accum += mask * emission``, then the material scatter
  (``ops/shading.py``).

Mesh, HDRI, example-sphere and measured-BRDF scenes are not in this slice
and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core import rng
from vrenderer_pathtracer_tpu_torch.ops.intersect import INF, intersect_spheres
from vrenderer_pathtracer_tpu_torch.ops.shading import ORIGIN_OFFSET, scatter
from vrenderer_pathtracer_tpu_torch.scene.scene import MESH_SLICE, Scene


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


def check_scope(settings: RenderSettings) -> None:
    """Raise ``NotImplementedError`` for settings outside the sphere slice.

    The other asset flags (``has_hdr``, ``has_brdf``, texture maps) change
    nothing without the asset, and a port ``Scene`` holds none.
    """
    unported = [f for f in ("use_example_sphere", "has_mesh")
                if getattr(settings, f)]
    if unported:
        raise NotImplementedError(f"settings {unported}: {MESH_SLICE}")


def radiance(scene: Scene, settings: RenderSettings, ray_o, ray_d, pixel_ids,
             sample_ids, frame, fresnel_coef, fresnel_pow, seed: int = 0):
    """Trace a ray batch for ``settings.bounces`` bounces.

    Returns ``(rgb [B,3], depth [B])``: the per-sample radiance estimate and
    the normalised first-hit depth.
    """
    check_scope(settings)
    n_rays = ray_o.shape[0]
    f32 = dict(dtype=torch.float32, device=ray_o.device)
    mask = torch.ones((n_rays, 3), **f32)
    accum = torch.zeros((n_rays, 3), **f32)
    depth = torch.ones((n_rays,), **f32)
    alive = torch.ones((n_rays,), dtype=torch.bool, device=ray_o.device)
    killed = torch.zeros_like(alive)  # Cornell mode: a miss kills the path
    zero3 = torch.zeros_like(mask)

    for bounce in range(settings.bounces):
        hd = _intersect_sphere_set(scene, ray_o, ray_d)
        miss = alive & ~hd.hit
        live_hit = alive & hd.hit
        if settings.use_cornell_box:
            killed = killed | miss
        if bounce == 0:
            d0 = torch.linalg.norm(ray_o - hd.point, dim=-1) / settings.depth_scale
            depth = torch.where(live_hit, d0, depth)

        lh = live_hit[:, None]
        accum = accum + torch.where(lh, mask * hd.emission, zero3)

        u_reflect, _ = rng.uniform2(
            seed, pixel_ids, rng.make_stream(frame, sample_ids, bounce, 0))
        u_phi, u_r = rng.uniform2(
            seed, pixel_ids, rng.make_stream(frame, sample_ids, bounce, 1))
        new_dir, mult = scatter(
            ray_d, hd.normal, hd.tangent, hd.color, hd.spec_color, hd.hit_type,
            u_reflect, u_phi, u_r, fresnel_coef, fresnel_pow)

        ray_o = torch.where(lh, hd.point + ORIGIN_OFFSET * hd.normal, ray_o)
        ray_d = torch.where(lh, new_dir, ray_d)
        mask = torch.where(lh, mask * mult, mask)
        alive = live_hit

    if settings.use_cornell_box:
        accum = torch.where(killed[:, None], zero3, accum)
        depth = torch.where(killed, torch.zeros_like(depth), depth)
    return accum, depth


def render_pass(scene: Scene, settings: RenderSettings, ray_o, ray_d,
                pixel_ids, frame, fresnel_coef, fresnel_pow, seed: int = 0):
    """One progressive pass: ``samples_per_pass`` estimates per pixel.

    Samples are batched into the lane dimension (B = N * S), in chunks of
    ``samples_per_chunk`` to bound memory.  Returns
    ``(rgb_mean [N,3], depth [N])``.
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
        sample_ids = torch.arange(c0, c0 + chunk, dtype=torch.int64,
                                  device=ray_o.device).repeat_interleave(n)
        rgb_c, depth_c = radiance(scene, settings, big_o, big_d, big_ids,
                                  sample_ids, frame, fresnel_coef,
                                  fresnel_pow, seed)
        rgb_sum = rgb_sum + rgb_c.reshape(chunk, n, 3).sum(dim=0)
        depth = depth_c.reshape(chunk, n)[-1]  # same primary ray: last write
    return rgb_sum / s, depth
