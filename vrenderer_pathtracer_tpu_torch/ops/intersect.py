"""Batched ray-primitive intersection (port of ``ops/intersect.py``).

* Sphere quadratic: ``b = dot(op, d)``, ``det = b^2 - |op|^2 + r^2``; the
  nearest root greater than 1e-4, else the far root, else a miss.
* Moller-Trumbore ray/triangle with barycentrics, epsilon 3e-10.
* The AABB slab test on guarded inverse directions.

The BVH walks have their own fused forms of the last two
(``accel/traverse.py`` and the kernels); these are the plain per-lane
functions.
"""

from __future__ import annotations

import torch

SPHERE_EPS = 1e-4
TRI_EPS = 3e-10
INF = 1e20


def intersect_spheres(ray_o, ray_d, pos, radius):
    """ray_o/ray_d: [B,3]; pos: [N,3]; radius: [N].

    Returns dist [B,N], INF for misses.
    """
    op = pos[None, :, :] - ray_o[:, None, :]              # [B,N,3]
    b = torch.sum(op * ray_d[:, None, :], dim=-1)          # [B,N]
    det = b * b - torch.sum(op * op, dim=-1) + (radius * radius)[None, :]
    ok = det >= 0.0
    sq = torch.sqrt(torch.where(ok, det, torch.zeros_like(det)))
    t_near = b - sq
    t_far = b + sq
    zero = torch.zeros_like(t_near)
    t = torch.where(t_near > SPHERE_EPS, t_near,
                    torch.where(t_far > SPHERE_EPS, t_far, zero))
    return torch.where(ok & (t > 0.0), t, torch.full_like(t, INF))


def intersect_triangles(ray_o, ray_d, v0, v1, v2):
    """One ray against one triangle per lane (Moller-Trumbore).

    All inputs [B,3].  Returns ``(dist [B], u [B], v [B])``, dist INF on a
    miss; the hit point is ``(1-u-v)*v0 + u*v1 + v*v2``.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    p = torch.linalg.cross(ray_d, e2)
    det = torch.sum(e1 * p, dim=-1)
    parallel = torch.abs(det) < TRI_EPS
    inv_det = 1.0 / torch.where(parallel, torch.ones_like(det), det)
    tvec = ray_o - v0
    u = torch.sum(tvec * p, dim=-1) * inv_det
    q = torch.linalg.cross(tvec, e1)
    v = torch.sum(ray_d * q, dim=-1) * inv_det
    dist = torch.sum(e2 * q, dim=-1) * inv_det
    miss = (parallel | (u < 0.0) | (u > 1.0) | (v < 0.0) | (u + v > 1.0)
            | (dist <= TRI_EPS))
    return torch.where(miss, torch.full_like(dist, INF), dist), u, v


def slab_test(ray_o, inv_d, box_lo, box_hi, t_min=0.0, t_max=INF):
    """Ray-AABB slab test on inverse directions (:func:`safe_inv_dir`).

    ray_o, inv_d: [B,3]; box_lo/box_hi broadcast against them.  Returns
    ``(t_enter [B], t_exit [B], hit [B])``.
    """
    lo = box_lo * inv_d - ray_o * inv_d
    hi = box_hi * inv_d - ray_o * inv_d
    t_enter = torch.clamp(torch.minimum(lo, hi).amax(dim=-1), min=t_min)
    t_exit = torch.clamp(torch.maximum(lo, hi).amin(dim=-1), max=t_max)
    return t_enter, t_exit, t_exit >= t_enter


def safe_inv_dir(ray_d, eps: float = 1e-8):
    """1/d with the reference's epsilon guard: components of magnitude at
    most ``eps`` become ``+-eps`` (the sign of d, +eps for zero)."""
    guard = torch.where(ray_d >= 0, torch.full_like(ray_d, eps),
                        torch.full_like(ray_d, -eps))
    return 1.0 / torch.where(torch.abs(ray_d) > eps, ray_d, guard)
