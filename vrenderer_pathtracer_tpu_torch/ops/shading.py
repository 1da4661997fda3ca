"""Material scattering: mirror and diffuse-with-Fresnel (port of
``ops/shading.py``).

* SPEC (type 0): mirror reflection, not re-normalised, throughput unchanged.
* DIFF (type 1): stochastic Fresnel mix,
  ``f = lerp((1-cos)^p, 1, c) * spec_color.x``; with probability ``f`` a
  normalised mirror reflection weighted by the specular colour, otherwise a
  cosine-weighted hemisphere sample weighted by ``albedo * cos * 2``.
* BRDF (type 2): the cosine sample; with a MERL table the weight is
  ``24 * max(merl_lookup, 0)``, or with a sampler the one-sample lobe MIS of
  ``ops/brdf_sampling.py``; without a table the diffuse weight.

The Fresnel comparison ``u < f`` is discrete, so the chosen branch's weight
is scaled by the ratio ``p / p.detach()``: its value is 1, and its gradient
carries the score-function estimator for d/d(fresnel_coef, fresnel_pow).
"""

from __future__ import annotations

import math

import torch

from vrenderer_pathtracer_tpu_torch.ops.brdf import lookup_brdf
from vrenderer_pathtracer_tpu_torch.scene.spheres import BRDF, SPEC

ORIGIN_OFFSET = 0.05  # the next ray starts 0.05*n off the surface


def _norm(x):
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True), min=1e-20)


def reflect(d, n):
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def cosine_hemisphere(normal, u1, u2):
    """Cosine-weighted direction about ``normal`` from two uniforms.

    The frame axis flips on |n.x| > 0.1; 2*pi*u1 is the azimuth and
    sqrt(u2) the radius.
    """
    w = normal
    flip = (torch.abs(w[:, 0]) > 0.1)[:, None]
    e_y = torch.tensor([0.0, 1.0, 0.0], dtype=w.dtype, device=w.device)
    e_x = torch.tensor([1.0, 0.0, 0.0], dtype=w.dtype, device=w.device)
    axis = torch.where(flip, e_y[None, :], e_x[None, :])
    u = _norm(torch.linalg.cross(axis, w))
    v = torch.linalg.cross(w, u)
    phi = (2.0 * math.pi) * u1
    r = torch.sqrt(u2)
    d = (
        u * (torch.cos(phi) * r)[:, None]
        + v * (torch.sin(phi) * r)[:, None]
        + w * torch.sqrt(torch.clamp(1.0 - u2, min=0.0))[:, None]
    )
    return _norm(d)


def scatter(ray_d, normal, tangent, color, spec_color, hit_type,
            u_reflect, u_phi, u_r, fresnel_coef, fresnel_pow,
            brdf_table=None, brdf_sampler=None, u_b1=None, u_b2=None):
    """One bounce of material interaction for a [B] lane batch.

    Returns ``(new_dir [B,3], mask_mult [B,3])``; the caller moves the origin
    to ``hit + ORIGIN_OFFSET * normal`` and multiplies throughput by
    ``mask_mult``.  ``tangent`` is read only by the measured-BRDF lookup.

    With ``brdf_sampler`` and the two extra uniforms ``u_b1``/``u_b2``, BRDF
    lanes take the one-sample lobe MIS instead of the cosine sample;
    ``u_reflect`` selects the strategy there and ``u_phi`` is the lobe's
    azimuth (each lane takes one branch).
    """
    mirror_dir = reflect(ray_d, normal)          # SPEC: not normalised
    fresnel_dir = _norm(mirror_dir)              # DIFF specular: normalised
    cos_dir = cosine_hemisphere(normal, u_phi, u_r)

    # --- DIFF: Fresnel estimate and branch weights -------------------------
    aoi = torch.sum(normal * (-ray_d), dim=-1)
    grazing = torch.pow(torch.clamp(1.0 - aoi, min=0.0), fresnel_pow)
    fresnel = (grazing * (1.0 - fresnel_coef) + fresnel_coef) * spec_color[:, 0]
    take_reflect = (u_reflect < fresnel)[:, None]

    # Ratio trick: value-preserving, gradient-carrying branch weights.
    p = torch.clamp(fresnel, 1e-6, 1.0 - 1e-6)
    w_reflect = p / p.detach()
    w_diffuse = (1.0 - p) / (1.0 - p).detach()

    diffuse_weight = color * (torch.sum(cos_dir * normal, dim=-1) * 2.0)[:, None]
    diff_dir = torch.where(take_reflect, fresnel_dir, cos_dir)
    diff_mult = torch.where(take_reflect, spec_color * w_reflect[:, None],
                            diffuse_weight * w_diffuse[:, None])

    # --- BRDF: measured reflectance about a cosine (or lobe MIS) sample ---
    brdf_dir = cos_dir
    if brdf_table is not None and brdf_sampler is not None:
        from vrenderer_pathtracer_tpu_torch.ops.brdf_sampling import sample_brdf_mis

        brdf_dir, brdf_mult = sample_brdf_mis(
            brdf_sampler, brdf_table, ray_d, normal, tangent, cos_dir,
            u_reflect, u_b1, u_b2, u_phi)
    elif brdf_table is not None:
        brdf_val = lookup_brdf(brdf_table, cos_dir, ray_d, normal, tangent)
        brdf_mult = 24.0 * torch.clamp(brdf_val, min=0.0)
    else:
        brdf_mult = diffuse_weight

    is_spec = (hit_type == SPEC)[:, None]
    is_brdf = (hit_type == BRDF)[:, None]
    new_dir = torch.where(is_spec, mirror_dir,
                          torch.where(is_brdf, brdf_dir, diff_dir))
    mask_mult = torch.where(is_spec, torch.ones_like(diff_mult),
                            torch.where(is_brdf, brdf_mult, diff_mult))
    return new_dir, mask_mult
