"""Lat-long HDRI environment sampling (port of ``ops/envmap.py``).

The miss shader: ``u = atan2(d.x, d.z)`` wrapped to [0, 2pi) then / 2pi;
``v = acos(d.y) / pi``; a nearest-texel fetch with a flat-index clamp; the
contribution is ``mask * 2 * hdr[addr]``.  ``sample_env_bilinear`` is smooth
in direction too, for optimising the map.  :func:`sample_env`, the fetch the
integrators call, picks one by the texture filter; ``sample_env.grad_lanes``
counts the lanes it fetches for a gradient
(``utils/profiling.py::count_grad_lanes``).
"""

from __future__ import annotations

import math

import torch

from vrenderer_pathtracer_tpu_torch.utils.profiling import count_grad_lanes

ENV_SCALE = 2.0  # the reference multiplies HDR radiance by 2


def direction_to_latlong(ray_d):
    """[B,3] directions -> (u,v) in [0,1)x[0,1]."""
    u = torch.atan2(ray_d[:, 0], ray_d[:, 2])
    u = torch.where(u < 0.0, u + 2.0 * math.pi, u) / (2.0 * math.pi)
    v = torch.arccos(torch.clamp(ray_d[:, 1], -1.0, 1.0)) / math.pi
    return u, v


def sample_env_nearest(hdr, ray_d):
    """Reference-parity nearest fetch. hdr [H,W,3], ray_d [B,3] -> [B,3]."""
    height, width = hdr.shape[0], hdr.shape[1]
    u, v = direction_to_latlong(ray_d)
    x = (u * width).to(torch.int32)
    y = (v * height).to(torch.int32)
    addr = torch.clamp(x + y * width, 0, width * height - 1)
    return hdr.reshape(-1, 3)[addr.long()] * ENV_SCALE


def sample_env_bilinear(hdr, ray_d):
    """Bilinear fetch (wraps in u, clamps in v) for smooth env-map gradients."""
    height, width = hdr.shape[0], hdr.shape[1]
    u, v = direction_to_latlong(ray_d)
    fx = u * width - 0.5
    fy = v * height - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    x1 = torch.remainder(x0 + 1, width)
    x0 = torch.remainder(x0, width)
    y1 = torch.clamp(y0 + 1, 0, height - 1)
    y0 = torch.clamp(y0, 0, height - 1)
    flat = hdr.reshape(-1, 3)
    c00 = flat[(x0 + y0 * width).long()]
    c10 = flat[(x1 + y0 * width).long()]
    c01 = flat[(x0 + y1 * width).long()]
    c11 = flat[(x1 + y1 * width).long()]
    top = c00 * (1 - wx) + c10 * wx
    bot = c01 * (1 - wx) + c11 * wx
    return (top * (1 - wy) + bot * wy) * ENV_SCALE


def sample_env(hdr, ray_d, bilinear: bool = False):
    """The HDRI fetch of a miss: :func:`sample_env_bilinear` or
    :func:`sample_env_nearest`."""
    count_grad_lanes(sample_env, hdr, ray_d.shape[0])
    fetch = sample_env_bilinear if bilinear else sample_env_nearest
    return fetch(hdr, ray_d)


sample_env.grad_lanes = 0
