"""MERL measured-BRDF importance sampling (port of ``ops/brdf_sampling.py``).

A tabulated inverse CDF over the half-angle ``theta_h`` marginal of the
measured lobe, mixed 50/50 with the cosine strategy under the one-sample
MIS balance heuristic:

* the sampler is 90 numbers, the luminance mass of each MERL ``theta_h``
  bin times the bin's solid angle, normalised into a CDF;
* a half vector ``H`` is drawn with ``cos(theta_h)`` uniform inside the
  chosen bin and uniform azimuth, then reflected, ``out = 2(wi.H)H - wi``,
  with the ``1/(4 wi.H)`` Jacobian;
* estimator ``(24/pi) * f * cos / p_mix`` with ``p_mix = 0.5 p_lobe + 0.5
  p_cos``, the same integral as the cosine estimator ``24 f``;
* detached pdfs: the CDF is built from the detached table and every pdf
  factor is detached, so gradients with respect to the table flow only
  through ``lookup_brdf``.

K4 (``csrc/mesh.cu``) runs the same draw with the same tables
(``_COS_EDGES``, ``_BIN_DOMEGA`` and the sampler's mass and CDF).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from vrenderer_pathtracer_tpu_torch.ops.brdf import (
    CHANNEL_SCALE, RES_PHI_D, RES_THETA_D, RES_THETA_H, lookup_brdf)

# theta_h bin edges under the MERL sqrt warp: bin i covers
# [(i/90)^2, ((i+1)/90)^2] * pi/2 (the inverse of ops/brdf.py's idx_th).
# Built in float64 and cast, exactly as the JAX module does.
_THETA_EDGES = (np.arange(RES_THETA_H + 1, dtype=np.float64) / RES_THETA_H) ** 2 * (np.pi / 2)
_COS_EDGES = np.cos(_THETA_EDGES).astype(np.float32)          # [91], 1 -> 0
_BIN_DOMEGA = (2.0 * np.pi * (_COS_EDGES[:-1] - _COS_EDGES[1:])).astype(np.float32)

_MIX_Q = 0.5  # probability of drawing from the lobe strategy


class MerlSampler(NamedTuple):
    """Tabulated theta_h sampler for one MERL table (detached tensors)."""

    mass: torch.Tensor  # [90] per-bin probability mass (sums to 1)
    cdf: torch.Tensor   # [90] inclusive cumulative mass


def _const(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, device=like.device)


def build_merl_sampler(table) -> MerlSampler:
    """The half-angle CDF of a ``[3, TABLE_SIZE]`` MERL table: per-bin mean
    luminance (channel scales applied) times the bin's solid angle, with a
    small floor that keeps every bin sampleable."""
    table = table.detach()
    t = torch.clamp(table, min=0.0).reshape(3, RES_THETA_H, RES_THETA_D * RES_PHI_D)
    scale = _const(CHANNEL_SCALE, table)[:, None, None]
    lum = torch.mean(t * scale, dim=(0, 2))             # [90]
    mass = lum * _const(_BIN_DOMEGA, table)
    mass = mass + 1e-4 * torch.max(mass) + 1e-20
    mass = mass / torch.sum(mass)
    return MerlSampler(mass=mass, cdf=torch.cumsum(mass, dim=0))


def _frame(normal):
    """Orthonormal frame about ``normal`` (cosine_hemisphere's construction)."""
    w = normal
    flip = (torch.abs(w[:, 0]) > 0.1)[:, None]
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    axis = torch.where(flip, e_y[None, :], e_x[None, :])
    u = torch.linalg.cross(axis, w)
    u = u / torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-20)
    v = torch.linalg.cross(w, u)
    return u, v, w


def _unit(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-20)


def _theta_h_bin(cos_th):
    """MERL theta_h bin index (int64) from cos(theta_h), the lookup's warp."""
    th = torch.arccos(torch.clamp(cos_th, 0.0, 1.0))
    idx = (torch.sqrt(th * (2.0 / math.pi)) * RES_THETA_H).to(torch.int32)
    return torch.clamp(idx, 0, RES_THETA_H - 1).long()


def sample_lobe(sampler: MerlSampler, ray_d, normal, u_bin, u_cos, u_phi):
    """Directions [B,3] drawn from the half-angle lobe strategy (unit,
    possibly below the horizon: the estimator's cos clamp zeroes those)."""
    cos_e = _const(_COS_EDGES, normal)
    idx = torch.clamp(
        torch.searchsorted(sampler.cdf, u_bin.contiguous(), right=True),
        0, RES_THETA_H - 1)
    c_lo = cos_e[idx]
    c_hi = cos_e[idx + 1]
    cos_th = c_lo - u_cos * (c_lo - c_hi)              # uniform in cos inside the bin
    sin_th = torch.sqrt(torch.clamp(1.0 - cos_th * cos_th, min=0.0))
    phi = 2.0 * math.pi * u_phi

    u, v, w = _frame(normal)
    h = (u * (torch.cos(phi) * sin_th)[:, None]
         + v * (torch.sin(phi) * sin_th)[:, None]
         + w * cos_th[:, None])
    wi = -ray_d
    wi_h = torch.sum(wi * h, dim=-1, keepdim=True)
    return _unit(2.0 * wi_h * h - wi)


def pdf_lobe(sampler: MerlSampler, ray_d, normal, out):
    """Solid-angle pdf of ``out`` under the lobe strategy (detached)."""
    wi = -ray_d
    h = _unit(wi + out)
    # The preimage of ``out`` is +-normalize(wi + out); sample_lobe draws
    # only upper-hemisphere half vectors, so fold to the upper one.
    cos_th = torch.sum(normal * h, dim=-1)
    h = torch.where(cos_th[:, None] < 0.0, -h, h)
    cos_th = torch.abs(cos_th)
    idx = _theta_h_bin(cos_th)
    dom = _const(_BIN_DOMEGA, normal)[idx]
    p_h = sampler.mass[idx] / dom
    wi_h = torch.abs(torch.sum(wi * h, dim=-1))
    return (p_h / torch.clamp(4.0 * wi_h, min=1e-6)).detach()


def pdf_cosine(normal, out):
    """Solid-angle pdf of the cosine strategy (detached)."""
    c = torch.sum(normal * out, dim=-1)
    return (torch.clamp(c, min=0.0) / math.pi).detach()


def mis_direction(sampler: MerlSampler, ray_d, normal, cos_dir, u_select,
                  u_bin, u_cos, u_phi):
    """The one-sample MIS draw: ``(new_dir [B,3], p_mix [B], cos_o [B])``.

    Lanes with ``u_select < 0.5`` replace the cosine direction ``cos_dir``
    with a lobe draw; ``p_mix`` is the mixture pdf of the final direction
    and ``cos_o = max(n.new_dir, 0)``.
    """
    lobe_dir = sample_lobe(sampler, ray_d, normal, u_bin, u_cos, u_phi)
    take_lobe = (u_select < _MIX_Q)[:, None]
    new_dir = torch.where(take_lobe, lobe_dir, cos_dir)
    p_mix = (_MIX_Q * pdf_lobe(sampler, ray_d, normal, new_dir)
             + (1.0 - _MIX_Q) * pdf_cosine(normal, new_dir))
    cos_o = torch.clamp(torch.sum(normal * new_dir, dim=-1), min=0.0)
    return new_dir, p_mix, cos_o


def sample_brdf_mis(sampler: MerlSampler, table, ray_d, normal, tangent,
                    cos_dir, u_select, u_bin, u_cos, u_phi):
    """One-sample MIS between the lobe and cosine strategies.

    Returns ``(new_dir [B,3], weight [B,3])``, the weight being the whole
    throughput multiplier ``(24/pi) f cos / p_mix``.
    """
    new_dir, p_mix, cos_o = mis_direction(sampler, ray_d, normal, cos_dir,
                                          u_select, u_bin, u_cos, u_phi)
    f = torch.clamp(lookup_brdf(table, new_dir, ray_d, normal, tangent), min=0.0)
    w = (24.0 / math.pi) * f * (cos_o / torch.clamp(p_mix, min=1e-8))[:, None]
    # Zero-pdf lanes (possible at exact grazing) contribute 0.
    return new_dir, torch.where((p_mix > 0.0)[:, None], w, torch.zeros_like(w))
