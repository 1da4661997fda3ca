"""The plain path tracer the benchmark judges the program against.

Frozen copies of the estimator's arithmetic, written out in plain PyTorch
with no kernel, cache or compaction: the Threefry-2x32 draws keyed by
(seed, pixel, frame, sample, bounce, slot), the pinhole camera with its
quarter-pixel offset, the analytic spheres (the Cornell shells and the
mirror and Fresnel spheres), the mirror / Fresnel-diffuse / measured-BRDF
scatter, the lat-long environment fetch, the display tonemap and FXAA 3.11
(quality 29).  Nothing here imports the program: its constants and
formulas are restated, so a change to the program cannot move the
yardstick.

Every float tensor is made in ``dtype`` (float32 as the configurations
state; bfloat16 for the lower-precision control).  The draws are integer
arithmetic and are rounded to ``dtype`` once made.
"""

from __future__ import annotations

import math

import torch

INF = 1e20
SPHERE_EPS = 1e-4
TRI_EPS = 1e-7
ORIGIN_OFFSET = 0.05
ENV_SCALE = 2.0
SPEC, DIFF, BRDF = 0, 1, 2

# (radius, pos, emission, color, type, specular colour) in the scene's
# order; the earliest row wins a tie.
MIRROR_AND_FRESNEL = [
    (3.5, (15.0, 0.0, 15.0), (0, 0, 0), (0, 0, 0), SPEC, (1, 1, 1)),
    (3.5, (25.0, 0.0, 15.0), (0, 0, 0), (1, 1, 1), DIFF, (1, 1, 1)),
]
CORNELL = [
    (160.0, (0.0, 209.0, 0.0), (4.0, 3.6, 3.2), (0, 0, 0), DIFF, (0, 0, 0)),
    (1e5, (1e5 + 50.0, 0.0, 0.0), (0.075, 0.025, 0.025), (0.75, 0.25, 0.25), DIFF, (0, 0, 0)),
    (1e5, (-1e5 - 50.0, 0.0, 0.0), (0.025, 0.075, 0.025), (0.25, 0.75, 0.25), DIFF, (0, 0, 0)),
    (1e5, (0.0, 0.0, -1e5 - 100.0), (0, 0, 0), (1, 1, 1), DIFF, (0, 0, 0)),
    (1e5, (0.0, 1e5 + 50.0, 0.0), (0, 0, 0), (1, 1, 1), DIFF, (0, 0, 0)),
    (1e5, (0.0, -1e5 - 50.0, 0.0), (0, 0, 0), (1, 1, 1), DIFF, (0, 0, 0)),
]


def sphere_rows(cornell: bool):
    return (CORNELL if cornell else []) + MIRROR_AND_FRESNEL


def pick(table, row):
    """``table[row]``; when ``table`` takes gradients, as a chain of
    selects, whose backward is one sum a row instead of a scatter of
    atomic adds onto a few addresses."""
    if not table.requires_grad:
        return table[row]
    out = table[0].expand(row.shape[0], *table.shape[1:])
    for i in range(1, table.shape[0]):
        out = torch.where((row == i)[:, None], table[i], out)
    return out


class Spheres:
    """The sphere table as tensors: pos [N,3], radius [N], emission [N,3],
    color [N,3], kind [N] int64, spec [N,3]."""

    def __init__(self, rows, device, dtype, color=None, emission=None):
        f = dict(dtype=dtype, device=device)
        self.pos = torch.tensor([r[1] for r in rows], **f)
        self.radius = torch.tensor([r[0] for r in rows], **f)
        self.emission = (torch.tensor([r[2] for r in rows], **f)
                         if emission is None else emission)
        self.color = (torch.tensor([r[3] for r in rows], **f)
                      if color is None else color)
        self.kind = torch.tensor([r[4] for r in rows], dtype=torch.int64,
                                 device=device)
        self.spec = torch.tensor([r[5] for r in rows], **f)
        self.count = len(rows)


# --- Threefry-2x32 (Salmon et al., SC'11), 20 rounds -----------------------
#
# Words are the uint32 bit patterns held in int32 tensors: adds wrap, and a
# right shift is masked to stay logical.

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_SAMPLE_KEY_MULT = 0x9E3779B9


def _i32(v):
    """uint32 values (a Python int or an int64 tensor) as int32 bits."""
    if isinstance(v, torch.Tensor):
        v = v & _M32
        return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 of int32 words (tensors or ints, uint32 bits)."""
    k2 = k0 ^ k1 ^ _i32(0x1BD11BDA)
    x0 = x0 + k0
    x1 = x1 + k1
    inject = ((k1, k2), (k2, k0), (k0, k1), (k1, k2), (k2, k0))
    for g, (a0, a1) in enumerate(inject):
        for r in _ROT[g % 2]:
            x0 = x0 + x1
            x1 = ((x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))) ^ x0
        x0 = x0 + a0
        x1 = x1 + a1 + (g + 1)
    return x0, x1


def uniform2(seed: int, pix, frame: int, sample, bounce: int, slot: int,
             dtype):
    """Two U[0,1) draws per lane: ``pix`` and ``sample`` int64 [B] (the
    pixel id is the counter's first word, the frame, bounce and slot its
    second, the sample id times an odd constant salts the key)."""
    counter = ((int(frame) << 7) & _M32) ^ (bounce << 2) ^ slot
    k0 = _i32((sample * _SAMPLE_KEY_MULT) ^ (seed & _M32))
    k1 = _i32(seed >> 32)
    b0, b1 = threefry2x32(k0, k1, _i32(pix), torch.full(
        pix.shape, _i32(counter), dtype=torch.int32, device=pix.device))
    scale = 2.0 ** -24
    return ((((b0 >> 8) & 0xFFFFFF).to(torch.float32) * scale).to(dtype),
            (((b1 >> 8) & 0xFFFFFF).to(torch.float32) * scale).to(dtype))


# --- camera ----------------------------------------------------------------

def _normalize(x, eps=None):
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / (n if eps is None else torch.clamp(n, min=eps))


def camera_rays(view: dict, width: int, height: int, pix, dtype):
    """Origins and directions [B,3] of the primary rays of pixels ``pix``
    (row-major ids) for ``view`` = {origin, yaw, pitch, fov_deg}."""
    dev = pix.device
    f = dict(dtype=dtype, device=dev)
    yaw = torch.tensor(view["yaw"], **f)
    pitch = torch.tensor(view["pitch"], **f)
    fwd = _normalize(torch.stack([torch.sin(yaw) * torch.cos(pitch),
                                  torch.sin(pitch),
                                  torch.cos(yaw) * torch.cos(pitch)]))
    bent = fwd + torch.tensor([0.0, 1.0, 0.0], **f)
    right = _normalize(torch.linalg.cross(bent, fwd))
    up = torch.linalg.cross(fwd, right)
    fov_scale = torch.tan(torch.tensor(view["fov_deg"], **f)
                          * (math.pi / 360.0))
    cx = (fov_scale * (width / height)) * right
    cy = fov_scale * up
    xx = (pix % width).to(dtype)
    yy = (pix // width).to(dtype)
    u = (0.25 + xx) / width - 0.5
    v = (0.25 + yy) / height - 0.5
    d = _normalize(-fwd[None, :] + u[:, None] * cx[None, :]
                   + v[:, None] * cy[None, :])
    o = torch.tensor(view["origin"], **f)[None, :].expand(d.shape)
    return o, d


# --- intersection and shading ----------------------------------------------

def intersect_spheres(sph: Spheres, o, d):
    """Nearest sphere per lane: (t [B] with INF on a miss, row [B])."""
    best = torch.full(o.shape[:1], INF, dtype=o.dtype, device=o.device)
    row = torch.zeros(o.shape[:1], dtype=torch.int64, device=o.device)
    for i in range(sph.count):
        op = sph.pos[i][None, :] - o
        b = torch.sum(op * d, dim=-1)
        det = b * b - torch.sum(op * op, dim=-1) + sph.radius[i] * sph.radius[i]
        ok = det >= 0.0
        sq = torch.sqrt(torch.where(ok, det, torch.zeros_like(det)))
        tn, tf = b - sq, b + sq
        t = torch.where(tn > SPHERE_EPS, tn,
                        torch.where(tf > SPHERE_EPS, tf, torch.zeros_like(tn)))
        t = torch.where(ok & (t > 0.0), t, torch.full_like(t, INF))
        closer = t < best
        best = torch.where(closer, t, best)
        row = torch.where(closer, torch.full_like(row, i), row)
    return best, row


def reflect(d, n):
    return d - 2.0 * torch.sum(d * n, dim=-1, keepdim=True) * n


def cosine_hemisphere(n, u1, u2):
    flip = (torch.abs(n[:, 0]) > 0.1)[:, None]
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    a = _normalize(torch.linalg.cross(torch.where(flip, ey, ex), n), 1e-20)
    b = torch.linalg.cross(n, a)
    phi = (2.0 * math.pi) * u1
    r = torch.sqrt(u2)
    out = (a * (torch.cos(phi) * r)[:, None] + b * (torch.sin(phi) * r)[:, None]
           + n * torch.sqrt(torch.clamp(1.0 - u2, min=0.0))[:, None])
    return _normalize(out, 1e-20)


# MERL-100 (Matusik et al. 2003) half/diff lookup: 90 x 90 x 180 bins, a
# sqrt warp on theta_h, per-channel scales (1, 1.15, 1.66) / 1500.
MERL_TH, MERL_TD, MERL_PD = 90, 90, 180
MERL_SIZE = MERL_TH * MERL_TD * MERL_PD
MERL_SCALE = (1.0 / 1500.0, 1.15 / 1500.0, 1.66 / 1500.0)


def merl_lookup(table, out_dir, in_dir, n, tangent):
    dot = lambda a, b: torch.sum(a * b, dim=-1)  # noqa: E731
    bt = torch.linalg.cross(n, tangent)
    h = _normalize(out_dir - in_dir, 1e-12)
    th = torch.arccos(torch.clamp(dot(n, h), 0.0, 1.0))
    td = torch.arccos(torch.clamp(dot(h, out_dir), 0.0, 1.0))
    phi_t = torch.atan2(torch.clamp(-dot(out_dir, bt), -1.0, 1.0),
                        torch.clamp(dot(out_dir, tangent), -1.0, 1.0))
    u = -_normalize(n - dot(n, h)[:, None] * h, 1e-12)
    v = torch.linalg.cross(h, u)
    phi_gs = torch.atan2(torch.clamp(dot(out_dir, v), -1.0, 1.0),
                         torch.clamp(dot(out_dir, u), -1.0, 1.0))
    small_td, big_th = td < 1e-3, th > 1e-3
    pd = torch.where(small_td, phi_t,
                     torch.where(big_th, phi_gs, torch.zeros_like(th)))
    th = torch.where(small_td | big_th, th, torch.zeros_like(th))
    pd = torch.where(pd < 0.0, pd + math.pi, pd)
    i_pd = torch.clamp((pd * (MERL_PD / math.pi)).to(torch.int32), 0, MERL_PD - 1)
    i_th = torch.where(th <= 0.0, torch.zeros_like(i_pd), torch.clamp(
        (torch.sqrt(th * (2.0 / math.pi)) * MERL_TH).to(torch.int32),
        0, MERL_TH - 1))
    i_td = torch.clamp((td * (2.0 / math.pi * MERL_TD)).to(torch.int32),
                       0, MERL_TD - 1)
    idx = (i_pd + i_td * MERL_PD + i_th * MERL_PD * MERL_TD).long()
    scale = torch.tensor(MERL_SCALE, dtype=table.dtype, device=table.device)
    return table[:, idx].T * scale[None, :]


def scatter(d, n, tangent, color, spec, kind, u_refl, u_phi, u_r, fc, fp,
            table=None):
    """One bounce's material: (new direction [B,3], throughput factor
    [B,3]).  The Fresnel branch weight carries p / p.detach(), whose value
    is 1 and whose gradient is the score-function term for the sliders."""
    mirror = reflect(d, n)
    cos_dir = cosine_hemisphere(n, u_phi, u_r)
    aoi = torch.sum(n * (-d), dim=-1)
    fres = (torch.pow(torch.clamp(1.0 - aoi, min=0.0), fp) * (1.0 - fc)
            + fc) * spec[:, 0]
    take = (u_refl < fres)[:, None]
    # The branch weights in float32 at least: in bfloat16 1 - 1e-6 rounds
    # to 1, and (1 - p) / (1 - p) would read 0 / 0.
    p = torch.clamp(fres.to(torch.promote_types(fres.dtype, torch.float32)),
                    1e-6, 1.0 - 1e-6)
    w_r = (p / p.detach()).to(fres.dtype)
    w_d = ((1.0 - p) / (1.0 - p).detach()).to(fres.dtype)
    diffuse = color * (torch.sum(cos_dir * n, dim=-1) * 2.0)[:, None]
    diff_dir = torch.where(take, _normalize(mirror, 1e-20), cos_dir)
    diff_mult = torch.where(take, spec * w_r[:, None], diffuse * w_d[:, None])
    if table is not None:
        brdf_mult = 24.0 * torch.clamp(
            merl_lookup(table, cos_dir, d, n, tangent), min=0.0)
    else:
        brdf_mult = diffuse
    is_spec = (kind == SPEC)[:, None]
    is_brdf = (kind == BRDF)[:, None]
    new_d = torch.where(is_spec, mirror, torch.where(is_brdf, cos_dir, diff_dir))
    mult = torch.where(is_spec, torch.ones_like(diff_mult),
                       torch.where(is_brdf, brdf_mult, diff_mult))
    return new_d, mult


def env_nearest(hdr, d):
    """The lat-long fetch: hdr [H,W,3], d [B,3] -> 2 * texel."""
    h, w = hdr.shape[0], hdr.shape[1]
    u = torch.atan2(d[:, 0], d[:, 2])
    u = torch.where(u < 0.0, u + 2.0 * math.pi, u) / (2.0 * math.pi)
    v = torch.arccos(torch.clamp(d[:, 1], -1.0, 1.0)) / math.pi
    addr = torch.clamp((u * w).to(torch.int32) + (v * h).to(torch.int32) * w,
                       0, w * h - 1)
    return hdr.reshape(-1, 3)[addr.long()] * ENV_SCALE


def tonemap(accum, frame: int, gamma: float = 2.2):
    return torch.pow(torch.clamp(accum / frame, 0.0, 1.0), 1.0 / gamma)


# --- FXAA 3.11, quality 29 (NVIDIA), green as luma --------------------------

QUALITY_STEPS = (1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0)
# How far FXAA reads from a pixel: the steps' sum, its half-texel tap, and
# the one-texel edge rows and resample.
FXAA_REACH = int(sum(QUALITY_STEPS)) + 3


def _shift(a, dy: int, dx: int):
    """out[y,x] = a[clip(y+dy), clip(x+dx)]."""
    h, w = a.shape[0], a.shape[1]
    ys = torch.clamp(torch.arange(h, device=a.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=a.device) + dx, 0, w - 1)
    return a[ys][:, xs]


def fxaa(img, subpix=0.75, edge_threshold=0.166, edge_threshold_min=0.0833):
    """img [H,W,3] in [0,1] -> [H,W,3], clamp-to-edge borders."""
    luma = img[..., 1]
    s = lambda a, dy, dx: _shift(a, dy, dx)  # noqa: E731
    l_m = luma
    l_n, l_s, l_w, l_e = s(luma, -1, 0), s(luma, 1, 0), s(luma, 0, -1), s(luma, 0, 1)
    l_nw, l_ne, l_sw, l_se = (s(luma, -1, -1), s(luma, -1, 1), s(luma, 1, -1),
                              s(luma, 1, 1))
    rmax = torch.maximum(l_m, torch.maximum(torch.maximum(l_n, l_s),
                                            torch.maximum(l_w, l_e)))
    rmin = torch.minimum(l_m, torch.minimum(torch.minimum(l_n, l_s),
                                            torch.minimum(l_w, l_e)))
    lrange = rmax - rmin
    early = lrange < torch.clamp(rmax * edge_threshold, min=edge_threshold_min)
    e_h = (torch.abs(l_nw - 2 * l_w + l_sw) + 2 * torch.abs(l_n - 2 * l_m + l_s)
           + torch.abs(l_ne - 2 * l_e + l_se))
    e_v = (torch.abs(l_nw - 2 * l_n + l_ne) + 2 * torch.abs(l_w - 2 * l_m + l_e)
           + torch.abs(l_sw - 2 * l_s + l_se))
    horz = e_h >= e_v
    luma1 = torch.where(horz, l_n, l_w)
    luma2 = torch.where(horz, l_s, l_e)
    g1, g2 = torch.abs(luma1 - l_m), torch.abs(luma2 - l_m)
    pair1 = g1 >= g2
    grad_scaled = 0.25 * torch.maximum(g1, g2)
    length_sign = torch.where(pair1, -1.0, 1.0).to(img.dtype)
    nn_half = (torch.where(pair1, luma1, luma2) + l_m) * 0.5
    p_n, p_s = 0.5 * (luma + l_n), 0.5 * (luma + l_s)
    p_w, p_e = 0.5 * (luma + l_w), 0.5 * (luma + l_e)

    def edge_luma(c: float, sign: int):
        m = int(c)
        frac = c - m

        def along(pa, pb, axis):
            dy, dx = (0, sign * m) if axis == 0 else (sign * m, 0)
            va, vb = s(pa, dy, dx), s(pb, dy, dx)
            if frac:
                dy2, dx2 = ((0, sign * (m + 1)) if axis == 0
                            else (sign * (m + 1), 0))
                va = 0.5 * (va + s(pa, dy2, dx2))
                vb = 0.5 * (vb + s(pb, dy2, dx2))
            return torch.where(pair1, va, vb)

        return torch.where(horz, along(p_n, p_s, 0), along(p_w, p_e, 1))

    cum = QUALITY_STEPS[0]
    end_n = edge_luma(cum, -1) - nn_half
    end_p = edge_luma(cum, 1) - nn_half
    done_n = torch.abs(end_n) >= grad_scaled
    done_p = torch.abs(end_p) >= grad_scaled
    dst_n = torch.full_like(luma, cum)
    dst_p = torch.full_like(luma, cum)
    for step in QUALITY_STEPS[1:]:
        cum += step
        adv_n, adv_p = ~done_n, ~done_p
        end_n = torch.where(adv_n, edge_luma(cum, -1) - nn_half, end_n)
        end_p = torch.where(adv_p, edge_luma(cum, 1) - nn_half, end_p)
        dst_n = torch.where(adv_n, torch.full_like(dst_n, cum), dst_n)
        dst_p = torch.where(adv_p, torch.full_like(dst_p, cum), dst_p)
        done_n = done_n | (torch.abs(end_n) >= grad_scaled)
        done_p = done_p | (torch.abs(end_p) >= grad_scaled)
    dir_n = dst_n < dst_p
    dst = torch.minimum(dst_n, dst_p)
    span = dst_p + dst_n
    m_lt = (l_m - nn_half) < 0.0
    good = torch.where(dir_n, (end_n < 0.0) != m_lt, (end_p < 0.0) != m_lt)
    offs = -dst / torch.clamp(span, min=1e-6) + 0.5
    offs = torch.where(good, offs, torch.zeros_like(offs))
    sa = 2.0 * (l_n + l_s + l_w + l_e) + (l_nw + l_sw + l_ne + l_se)
    sb = sa * (1.0 / 12.0) - l_m
    sc = torch.clamp(torch.abs(sb) / torch.clamp(lrange, min=1e-6), 0.0, 1.0)
    sf = (-2.0 * sc + 3.0) * sc * sc
    sh = sf * sf * subpix
    u = (torch.maximum(offs, sh) * length_sign)[..., None]
    hat = lambda k: torch.clamp(1.0 - torch.abs(u - k), min=0.0)  # noqa: E731
    rows = s(img, -1, 0) * hat(-1.0) + img * hat(0.0) + s(img, 1, 0) * hat(1.0)
    cols = s(img, 0, -1) * hat(-1.0) + img * hat(0.0) + s(img, 0, 1) * hat(1.0)
    out = torch.where(horz[..., None], rows, cols)
    return torch.where(early[..., None], img, out)
