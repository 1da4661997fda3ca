"""Batched ray-sphere intersection (port of ``ops/intersect.py``).

Sphere quadratic: ``b = dot(op, d)``, ``det = b^2 - |op|^2 + r^2``; the
nearest root greater than 1e-4, else the far root, else a miss.
"""

from __future__ import annotations

import torch

SPHERE_EPS = 1e-4
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
