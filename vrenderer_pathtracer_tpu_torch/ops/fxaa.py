"""FXAA 3.11 post-process, quality preset 29 (port of ``ops/fxaa.py``).

The display pass of the reference (NVIDIA FXAA 3.11, PC quality path):
12 edge-search steps (1, 1.5, 2 x 8, 4, 8), green as luma, the UI defaults
subpix quality 0.75 and edge threshold 0.166.  Every pixel runs the whole
algorithm with masked selects, and every fetch is a whole-image shift by a
static integer offset with clamp-to-edge borders (a lane only advances
along its edge while it advanced at every step before, so search step k
reads at a fixed cumulative offset); the half-texel bilinear taps are
averages of two shifts.  No gather.  Plain PyTorch on ``[H,W,3]`` tensors,
differentiable; the JAX version is XLA, not a Pallas kernel.
"""

from __future__ import annotations

import torch

QUALITY_STEPS = (1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0)
EDGE_THRESHOLD_MIN = 0.0833  # FXAA_QUALITY__EDGE_THRESHOLD_MIN default


def _shift(a, d: int, dim: int):
    """Shift along ``dim`` with clamp-to-edge: out[i] = a[clip(i + d)]."""
    n = a.shape[dim]
    if d == 0:
        return a
    if d > 0:
        d = min(d, n)
        edge = a.narrow(dim, n - 1, 1)
        return torch.cat([a.narrow(dim, d, n - d),
                          edge.expand(*a.shape[:dim], d, *a.shape[dim + 1:])],
                         dim=dim)
    d = min(-d, n)
    edge = a.narrow(dim, 0, 1)
    return torch.cat([edge.expand(*a.shape[:dim], d, *a.shape[dim + 1:]),
                      a.narrow(dim, 0, n - d)], dim=dim)


def _shift2d(a, dy: int, dx: int):
    """out[y,x] = a[clip(y+dy), clip(x+dx)]: slices, no gather."""
    return _shift(_shift(a, dy, 0), dx, 1)


def fxaa(img, subpix_quality: float = 0.75, edge_threshold: float = 0.166,
         edge_threshold_min: float = EDGE_THRESHOLD_MIN):
    """Antialias a display-space image: ``img`` [H,W,3] in [0,1] ->
    [H,W,3]."""
    luma = img[..., 1]  # green as luma
    l_m = luma
    l_n = _shift2d(luma, -1, 0)
    l_s = _shift2d(luma, 1, 0)
    l_w = _shift2d(luma, 0, -1)
    l_e = _shift2d(luma, 0, 1)
    l_nw = _shift2d(luma, -1, -1)
    l_ne = _shift2d(luma, -1, 1)
    l_sw = _shift2d(luma, 1, -1)
    l_se = _shift2d(luma, 1, 1)

    range_max = torch.maximum(l_m, torch.maximum(torch.maximum(l_n, l_s),
                                                 torch.maximum(l_w, l_e)))
    range_min = torch.minimum(l_m, torch.minimum(torch.minimum(l_n, l_s),
                                                 torch.minimum(l_w, l_e)))
    lrange = range_max - range_min
    early_exit = lrange < torch.clamp(range_max * edge_threshold,
                                      min=edge_threshold_min)

    # --- edge orientation ------------------------------------------------
    edge_horz = (torch.abs(l_nw - 2 * l_w + l_sw)
                 + 2 * torch.abs(l_n - 2 * l_m + l_s)
                 + torch.abs(l_ne - 2 * l_e + l_se))
    edge_vert = (torch.abs(l_nw - 2 * l_n + l_ne)
                 + 2 * torch.abs(l_w - 2 * l_m + l_e)
                 + torch.abs(l_sw - 2 * l_s + l_se))
    horz_span = edge_horz >= edge_vert

    luma1 = torch.where(horz_span, l_n, l_w)  # perpendicular to the edge
    luma2 = torch.where(horz_span, l_s, l_e)
    grad1 = torch.abs(luma1 - l_m)
    grad2 = torch.abs(luma2 - l_m)
    pair1 = grad1 >= grad2
    gradient_scaled = 0.25 * torch.maximum(grad1, grad2)
    # Perpendicular step direction: -1 towards N/W, +1 towards S/E.
    length_sign = torch.where(pair1, -1.0, 1.0)
    luma_nn = torch.where(pair1, luma1, luma2) + l_m
    luma_nn_half = luma_nn * 0.5

    # --- end-of-edge search ----------------------------------------------
    # Edge rows half a texel off the pixel: the mean of two shifts.
    perp_n = 0.5 * (luma + l_n)
    perp_s = 0.5 * (luma + l_s)
    perp_w = 0.5 * (luma + l_w)
    perp_e = 0.5 * (luma + l_e)

    def edge_luma(c: float, sign: int):
        """Edge-row luma at the static offset sign * c along the span."""
        m = int(c)
        frac = c - m

        def along(pa, pb, axis):
            dy, dx = (0, sign * m) if axis == 0 else (sign * m, 0)
            va, vb = _shift2d(pa, dy, dx), _shift2d(pb, dy, dx)
            if frac:
                dy2, dx2 = ((0, sign * (m + 1)) if axis == 0
                            else (sign * (m + 1), 0))
                va = 0.5 * (va + _shift2d(pa, dy2, dx2))
                vb = 0.5 * (vb + _shift2d(pb, dy2, dx2))
            return torch.where(pair1, va, vb)

        return torch.where(horz_span, along(perp_n, perp_s, 0),
                           along(perp_w, perp_e, 1))

    cum = QUALITY_STEPS[0]
    end_n = edge_luma(cum, -1) - luma_nn_half
    end_p = edge_luma(cum, +1) - luma_nn_half
    done_n = torch.abs(end_n) >= gradient_scaled
    done_p = torch.abs(end_p) >= gradient_scaled
    dst_n = torch.full_like(luma, cum)
    dst_p = torch.full_like(luma, cum)
    for step in QUALITY_STEPS[1:]:
        cum += step
        adv_n, adv_p = ~done_n, ~done_p
        end_n = torch.where(adv_n, edge_luma(cum, -1) - luma_nn_half, end_n)
        end_p = torch.where(adv_p, edge_luma(cum, +1) - luma_nn_half, end_p)
        dst_n = torch.where(adv_n, cum, dst_n)
        dst_p = torch.where(adv_p, cum, dst_p)
        done_n = done_n | (torch.abs(end_n) >= gradient_scaled)
        done_p = done_p | (torch.abs(end_p) >= gradient_scaled)

    direction_n = dst_n < dst_p
    dst = torch.minimum(dst_n, dst_p)
    span_length = dst_p + dst_n
    luma_m_lt = (l_m - luma_nn_half) < 0.0
    good_span_n = (end_n < 0.0) != luma_m_lt
    good_span_p = (end_p < 0.0) != luma_m_lt
    good_span = torch.where(direction_n, good_span_n, good_span_p)
    pixel_offset = -dst / torch.clamp(span_length, min=1e-6) + 0.5
    pixel_offset_good = torch.where(good_span, pixel_offset,
                                    torch.zeros_like(pixel_offset))

    # --- sub-pixel aliasing removal --------------------------------------
    subpix_a = 2.0 * (l_n + l_s + l_w + l_e) + (l_nw + l_sw + l_ne + l_se)
    subpix_b = subpix_a * (1.0 / 12.0) - l_m
    subpix_c = torch.clamp(torch.abs(subpix_b) / torch.clamp(lrange, min=1e-6),
                           0.0, 1.0)
    subpix_d = -2.0 * subpix_c + 3.0
    subpix_f = subpix_d * subpix_c * subpix_c
    subpix_h = subpix_f * subpix_f * subpix_quality

    # --- final resample: a fractional offset o perpendicular to the edge,
    # as the hat-weighted sum of the -1/0/+1 shifted images (|o| < 1).
    offset = torch.maximum(pixel_offset_good, subpix_h) * length_sign
    u = offset[..., None]

    def hat(k):
        return torch.clamp(1.0 - torch.abs(u - k), min=0.0)

    w_m1, w_0, w_p1 = hat(-1.0), hat(0.0), hat(1.0)
    row_mix = (_shift2d(img, -1, 0) * w_m1 + img * w_0
               + _shift2d(img, 1, 0) * w_p1)
    col_mix = (_shift2d(img, 0, -1) * w_m1 + img * w_0
               + _shift2d(img, 0, 1) * w_p1)
    filtered = torch.where(horz_span[..., None], row_mix, col_mix)
    return torch.where(early_exit[..., None], img, filtered)
