"""MERL-100 measured-BRDF evaluation (port of ``ops/brdf.py``).

Rusinkiewicz half/diff parameterisation:

* half vector ``H = normalize(out - in)`` where ``in`` is the incoming ray
  direction (pointing at the surface) and ``out`` the scattered direction;
* ``theta_h = acos(n.H)``, ``theta_d = acos(H.out)``; ``phi_d`` from a
  Gram-Schmidt diff frame, falling back to the tangent frame when
  ``theta_d < 1e-3`` and to 0 when ``theta_h <= 1e-3``;
* a sqrt warp on the ``theta_h`` index (90 bins), linear 90/180 bins for
  ``theta_d``/``phi_d`` with the reciprocity fold ``phi_d += pi``;
* per-channel scales (1, 1.15, 1.66)/1500.

Table layout: ``[3, 90*90*180]`` channels-major, index
``phi_d + theta_d*180 + theta_h*180*90``, the MERL binary's after the loader
splits channels.  ``lookup_brdf`` is differentiable with respect to the
table (the gather's backward is a scatter-add); ``lookup_brdf.grad_lanes``
counts the lanes it gathers for a gradient
(``utils/profiling.py::count_grad_lanes``).  K4 (``csrc/mesh.cu``)
computes the same index with libdevice ``acosf``/``atan2f``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vrenderer_pathtracer_tpu_torch.utils.profiling import count_grad_lanes

RES_THETA_H = 90
RES_THETA_D = 90
RES_PHI_D = 180  # the retained half of the 360 phi_d bins (reciprocity)

CHANNEL_SCALE = np.array([1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0], np.float32)

TABLE_SIZE = RES_THETA_H * RES_THETA_D * RES_PHI_D


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _norm(x, eps):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=eps)


def merl_index(out_dir, in_dir, normal, tangent):
    """Flat MERL table index per lane (int64).  All inputs [B,3] unit
    vectors."""
    bitangent = torch.linalg.cross(normal, tangent)
    h = _norm(out_dir - in_dir, 1e-12)

    theta_h = torch.arccos(torch.clamp(_dot(normal, h), 0.0, 1.0))
    theta_d = torch.arccos(torch.clamp(_dot(h, out_dir), 0.0, 1.0))

    # phi_d: three cases in the reference's order.
    phi_tangent = torch.atan2(
        torch.clamp(-_dot(out_dir, bitangent), -1.0, 1.0),
        torch.clamp(_dot(out_dir, tangent), -1.0, 1.0),
    )
    u = -_norm(normal - _dot(normal, h)[:, None] * h, 1e-12)
    v = torch.linalg.cross(h, u)
    phi_gs = torch.atan2(
        torch.clamp(_dot(out_dir, v), -1.0, 1.0),
        torch.clamp(_dot(out_dir, u), -1.0, 1.0),
    )

    zero = torch.zeros_like(theta_h)
    small_td = theta_d < 1e-3
    big_th = theta_h > 1e-3
    phi_d = torch.where(small_td, phi_tangent, torch.where(big_th, phi_gs, zero))
    theta_h = torch.where(small_td | big_th, theta_h, zero)

    phi_d = torch.where(phi_d < 0.0, phi_d + math.pi, phi_d)
    idx_pd = torch.clamp((phi_d * (RES_PHI_D / math.pi)).to(torch.int32),
                         0, RES_PHI_D - 1)
    idx_th = torch.where(
        theta_h <= 0.0,
        torch.zeros_like(idx_pd),
        torch.clamp((torch.sqrt(theta_h * (2.0 / math.pi)) * RES_THETA_H)
                    .to(torch.int32), 0, RES_THETA_H - 1),
    )
    idx_td = torch.clamp((theta_d * (2.0 / math.pi * RES_THETA_D))
                         .to(torch.int32), 0, RES_THETA_D - 1)
    return (idx_pd + idx_td * RES_PHI_D
            + idx_th * RES_PHI_D * RES_THETA_D).long()


def channel_scale(like: torch.Tensor) -> torch.Tensor:
    """``CHANNEL_SCALE`` as a [3] tensor on ``like``'s device."""
    return torch.as_tensor(CHANNEL_SCALE, device=like.device)


def lookup_brdf(table, out_dir, in_dir, normal, tangent):
    """RGB BRDF values, scaled per channel: table [3, TABLE_SIZE] -> [B,3]."""
    ind = merl_index(out_dir, in_dir, normal, tangent)
    count_grad_lanes(lookup_brdf, table, ind.shape[0])
    return table[:, ind].T * channel_scale(table)[None, :]


lookup_brdf.grad_lanes = 0
