"""Plain reference of the ``c5`` configuration: the displaced high-poly
mesh under the HDRI, shaded with the MERL table, beside the mirror and
Fresnel spheres; 4 bounces; FXAA on the displayed image.

The mesh's triangles come from the same seeded arrays the program's OBJ
holds (``c5_assets``); the normals, tangents and search tree are built
here again.  The search is a linear BVH over Morton-ordered triangles,
walked breadth first: every ray keeps every node whose box it enters
before its current bound, and the leaves' triangles are tested with the
Moller-Trumbore test, nearest hit wins.  That is slower than the
program's walk and independent of it.

``frame_region`` gives the displayed image and depth of a frame (after
``passes`` passes of ``spp`` samples, frames 1..passes) over a block of
pixels, with the FXAA reach around it traced too, so the block's FXAA
output is the whole frame's.
"""

from __future__ import annotations

import functools
import json

import numpy as np
import torch

from benchmark.reference import c5_assets
from benchmark.reference import plain as P

DEPTH_SCALE = 150.0
LEAF = 4


class Mesh:
    """The triangles (v0, e1, e2 float32), face normals and per-corner
    tangents, and the search tree, on ``device``."""

    def __init__(self, cfg, seed, device, dtype=torch.float32):
        pos, uv, faces = c5_assets.mesh(cfg, seed)
        loaded = c5_assets.as_loaded(pos)
        tan = _vertex_tangents(loaded.astype(np.float64),
                               c5_assets.as_read(uv).astype(np.float64), faces)
        f = dict(dtype=dtype, device=device)
        vt = torch.as_tensor(loaded, device=device)
        tri = torch.as_tensor(faces, device=device)
        a, b, c = vt[tri[:, 0]], vt[tri[:, 1]], vt[tri[:, 2]]
        self.v0 = a.to(dtype)
        self.e1 = (b - a).to(dtype)
        self.e2 = (c - a).to(dtype)
        self.tan = torch.as_tensor(tan[faces].astype(np.float32), **f)  # [T,3,3]
        self.n_tris = len(faces)
        self._build(a, b, c)

    def _build(self, a, b, c):
        lo = torch.minimum(torch.minimum(a, b), c)
        hi = torch.maximum(torch.maximum(a, b), c)
        cen = (lo + hi) * 0.5
        span = cen.amax(0) - cen.amin(0)
        q = ((cen - cen.amin(0)) / torch.clamp(span, min=1e-12) * 1023).long()
        code = torch.zeros_like(q[:, 0])
        for bit in range(10):
            for k in range(3):
                code |= ((q[:, k] >> bit) & 1) << (3 * bit + (2 - k))
        order = torch.argsort(code, stable=True)
        n_leaves = -(-self.n_tris // LEAF)
        depth = max(0, int(np.ceil(np.log2(n_leaves))))
        width = 1 << depth
        slots = torch.full((width * LEAF,), -1, dtype=torch.long, device=a.device)
        slots[:self.n_tris] = order
        self.slots = slots.reshape(width, LEAF)
        # Boxes padded by a millionth of the scene, so that rounding in the
        # slab test never drops a triangle the ray touches; a node with no
        # triangle is never entered.
        pad = 1e-6 * float((hi.amax(0) - lo.amin(0)).max())
        big = torch.tensor(3e38, device=a.device)
        ok = self.slots >= 0
        s = torch.clamp(self.slots, min=0)
        llo = torch.where(ok[..., None], lo[s], big).amin(1) - pad
        lhi = torch.where(ok[..., None], hi[s], -big).amax(1) + pad
        self.lo, self.hi, self.used = [llo], [lhi], [ok.any(1)]
        while self.lo[0].shape[0] > 1:
            self.lo.insert(0, torch.minimum(self.lo[0][0::2], self.lo[0][1::2]))
            self.hi.insert(0, torch.maximum(self.hi[0][0::2], self.hi[0][1::2]))
            self.used.insert(0, self.used[0][0::2] | self.used[0][1::2])

    def nearest(self, o, d, t_max, chunk=1 << 18):
        """(triangle [B] int64, -1 for none, t [B]) of the nearest hit with
        t in (TRI_EPS, t_max)."""
        tri = torch.full(o.shape[:1], -1, dtype=torch.long, device=o.device)
        best = t_max.clone()
        for c0 in range(0, o.shape[0], chunk):
            sl = slice(c0, c0 + chunk)
            tri[sl], best[sl] = self._nearest(o[sl], d[sl], t_max[sl])
        return tri, best

    def _nearest(self, o, d, t_max):
        n = o.shape[0]
        inv = 1.0 / torch.where(torch.abs(d) > 1e-12, d,
                                torch.where(d >= 0, 1e-12, -1e-12).to(d.dtype))
        ray = torch.arange(n, device=o.device)
        node = torch.zeros_like(ray)
        for level in range(len(self.lo)):
            lo, hi = self.lo[level][node], self.hi[level][node]
            t0 = (lo.to(o.dtype) - o[ray]) * inv[ray]
            t1 = (hi.to(o.dtype) - o[ray]) * inv[ray]
            near = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
            far = torch.minimum(torch.maximum(t0, t1).amin(-1), t_max[ray])
            keep = (near <= far) & self.used[level][node]
            ray, node = ray[keep], node[keep]
            if level + 1 < len(self.lo):
                ray = ray.repeat_interleave(2)
                node = (node * 2).repeat_interleave(2) + torch.arange(
                    2, device=o.device).repeat(node.shape[0])
        slot = self.slots[node].reshape(-1)
        ray = ray.repeat_interleave(LEAF)
        ok = slot >= 0
        ray, slot = ray[ok], slot[ok]
        t, _, _, hit = mt(o[ray], d[ray], self.v0[slot], self.e1[slot],
                          self.e2[slot])
        hit = hit & (t < t_max[ray])
        ray, slot, t = ray[hit], slot[hit], t[hit]
        best = t_max.clone().scatter_reduce(0, ray, t, "amin")
        win = t == best[ray]
        tri = torch.full((n,), -1, dtype=torch.long, device=o.device)
        tri = tri.scatter_reduce(0, ray[win], slot[win], "amax",
                                 include_self=True)
        return tri, best


def mt(o, d, v0, e1, e2):
    """Moller-Trumbore, double-sided: (t, u, v, hit) per lane."""
    p = torch.linalg.cross(d, e2)
    det = torch.sum(e1 * p, -1)
    big = torch.abs(det) > P.TRI_EPS
    inv = torch.where(big, 1.0 / det, torch.zeros_like(det))
    tv = o - v0
    u = torch.sum(tv * p, -1) * inv
    q = torch.linalg.cross(tv, e1)
    v = torch.sum(d * q, -1) * inv
    t = torch.sum(e2 * q, -1) * inv
    return t, u, v, big & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > P.TRI_EPS)


def _vertex_tangents(v, uv, faces):
    """Per-vertex tangents as a loader derives them from an OBJ without
    normals: area-weighted smooth normals, then Lengyel's UV tangents (v
    flipped), Gram-Schmidt against the normal."""
    uv = np.stack([uv[:, 0], 1.0 - uv[:, 1]], 1)
    i0, i1, i2 = faces[:, 0], faces[:, 1], faces[:, 2]
    fn = np.cross(v[i1] - v[i0], v[i2] - v[i0])
    nrm = np.zeros_like(v)
    for i in (i0, i1, i2):
        np.add.at(nrm, i, fn)
    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-30)
    e1, e2 = v[i1] - v[i0], v[i2] - v[i0]
    du1, dv1 = uv[i1, 0] - uv[i0, 0], uv[i1, 1] - uv[i0, 1]
    du2, dv2 = uv[i2, 0] - uv[i0, 0], uv[i2, 1] - uv[i0, 1]
    det = du1 * dv2 - du2 * dv1
    ok = np.abs(det) > 1e-20
    r = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    t = np.where(ok[:, None], (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None], e1)
    tan = np.zeros_like(v)
    for i in (i0, i1, i2):
        np.add.at(tan, i, t)
    tan = tan - nrm * np.sum(nrm * tan, 1, keepdims=True)
    ln = np.linalg.norm(tan, axis=1, keepdims=True)
    h = np.where((np.abs(nrm[:, :1]) < 0.9), [[1.0, 0, 0]], [[0, 1.0, 0]])
    alt = np.cross(h, nrm)
    alt /= np.maximum(np.linalg.norm(alt, axis=1, keepdims=True), 1e-30)
    return np.where(ln > 1e-12, tan / np.maximum(ln, 1e-30), alt)


class Scene:
    """Everything a c5 pass reads, on ``device`` in ``dtype``."""

    def __init__(self, cfg, seed, device, dtype=torch.float32):
        self.cfg, self.seed, self.dtype = cfg, seed, dtype
        self.mesh = Mesh(cfg, seed, device, dtype)
        self.hdr = torch.as_tensor(c5_assets.hdri(cfg, seed), device=device).to(dtype)
        self.brdf = torch.as_tensor(c5_assets.merl(cfg, seed), device=device).to(dtype)
        self.sph = P.Spheres(P.sphere_rows(False), device, dtype)
        f = dict(dtype=dtype, device=device)
        self.fc = torch.tensor(cfg["fresnel_coef"], **f)
        self.fp = torch.tensor(cfg["fresnel_pow"], **f)


def _shade_mesh(m: Mesh, tri, o, d):
    """Hit point, face normal and interpolated tangent of triangle ``tri``
    (recomputing t, u, v)."""
    v0, e1, e2 = m.v0[tri], m.e1[tri], m.e2[tri]
    t, u, v, _ = mt(o, d, v0, e1, e2)
    w = 1.0 - u - v
    point = o + d * t[:, None]
    tc = m.tan[tri]
    tangent = P._normalize(w[:, None] * tc[:, 0] + u[:, None] * tc[:, 1]
                           + v[:, None] * tc[:, 2], 1e-20)
    n = P._normalize(torch.linalg.cross(-e1, -e2), 1e-20)
    return t, point, n, tangent


def trace(sc: Scene, o, d, pix, samp, frame: int, bounces: int):
    """Radiance [B,3] and depth [B] of the lanes (live lanes only are
    searched at every bounce)."""
    dtype, dev = o.dtype, o.device
    nl = o.shape[0]
    mask = torch.ones_like(o)
    accum = torch.zeros_like(o)
    depth = torch.ones((nl,), dtype=dtype, device=dev)
    env_w = torch.zeros_like(o)
    env_dir = d.clone()
    live = torch.arange(nl, device=dev)
    for b in range(bounces):
        if live.numel() == 0:
            break
        lo, ld = o[live], d[live]
        t_s, row = P.intersect_spheres(sc.sph, lo, ld)
        tri, t_m = sc.mesh.nearest(lo, ld, t_s)
        on_mesh = tri >= 0
        hit = (t_s < P.INF) | on_mesh
        miss = ~hit
        env_w[live[miss]] = env_w[live[miss]] + mask[live[miss]]
        env_dir[live[miss]] = ld[miss]
        keep = hit
        lv, lo, ld, row, tri, t_s = (live[keep], lo[keep], ld[keep], row[keep],
                                     tri[keep], t_s[keep])
        on_mesh = on_mesh[keep]
        # Sphere record, then the mesh where it is nearer.
        point = lo + ld * t_s[:, None]
        n = P._normalize(point - sc.sph.pos[row], 1e-20)
        color, spec, kind = sc.sph.color[row], sc.sph.spec[row], sc.sph.kind[row]
        emis = sc.sph.emission[row]
        tangent = torch.zeros_like(n)
        if bool(on_mesh.any()):
            mi = on_mesh.nonzero().squeeze(1)
            _, mp, mn, mtan = _shade_mesh(sc.mesh, tri[mi], lo[mi], ld[mi])
            point[mi], n[mi], tangent[mi] = mp, mn, mtan
            color[mi] = torch.ones_like(mp)
            spec[mi] = torch.zeros_like(mp)
            emis[mi] = torch.zeros_like(mp)
            kind[mi] = P.BRDF
        if b == 0:
            depth[lv] = torch.linalg.norm(lo - point, dim=-1) / DEPTH_SCALE
        accum[lv] = accum[lv] + mask[lv] * emis
        u_refl, _ = P.uniform2(sc.seed, pix[lv], frame, samp[lv], b, 0, dtype)
        u_phi, u_r = P.uniform2(sc.seed, pix[lv], frame, samp[lv], b, 1, dtype)
        new_d, mult = P.scatter(ld, n, tangent, color, spec, kind, u_refl,
                                u_phi, u_r, sc.fc, sc.fp, sc.brdf)
        o[lv] = point + P.ORIGIN_OFFSET * n
        d[lv] = new_d
        mask[lv] = mask[lv] * mult
        live = lv
    ever = torch.any(env_w != 0.0, dim=-1)
    accum[ever] = accum[ever] + env_w[ever] * P.env_nearest(sc.hdr, env_dir[ever])
    return accum, depth


@torch.no_grad()
def frame_region(sc: Scene, view: dict, passes: int, spp: int, width: int,
                 height: int, y0: int, x0: int, size: int,
                 lanes: int = 1 << 21):
    """The displayed image [size,size,3] and depth [size,size] of the block
    at (y0, x0) of the frame shown after ``passes`` passes."""
    r = P.FXAA_REACH
    ya, yb = max(0, y0 - r), min(height, y0 + size + r)
    xa, xb = max(0, x0 - r), min(width, x0 + size + r)
    yy, xx = torch.meshgrid(torch.arange(ya, yb), torch.arange(xa, xb),
                            indexing="ij")
    dev = sc.hdr.device
    pix = (yy * width + xx).reshape(-1).to(dev)
    n = pix.shape[0]
    o1, d1 = P.camera_rays(view, width, height, pix, sc.dtype)
    acc = torch.zeros((n, 3), dtype=sc.dtype, device=dev)
    depth = None
    per = max(1, lanes // n)
    for f in range(1, passes + 1):
        tot = torch.zeros_like(acc)
        for s0 in range(0, spp, per):
            k = min(per, spp - s0)
            samp = torch.arange(s0, s0 + k, device=dev).repeat_interleave(n)
            rgb, dep = trace(sc, o1.repeat(k, 1), d1.repeat(k, 1),
                             pix.repeat(k), samp, f, sc.cfg["bounces"])
            tot = tot + rgb.reshape(k, n, 3).sum(0)
            depth = dep.reshape(k, n)[-1]
        acc = acc + tot / spp
    img = P.tonemap(acc, passes).reshape(yb - ya, xb - xa, 3)
    if sc.cfg.get("fxaa", False):
        img = P.fxaa(img)
    iy, ix = y0 - ya, x0 - xa
    return (img[iy:iy + size, ix:ix + size].float().cpu(),
            depth.reshape(yb - ya, xb - xa)[iy:iy + size, ix:ix + size].float().cpu())


@torch.no_grad()
def primary_hits(sc: Scene, view: dict, width: int, height: int,
                 band=None, rows: int = 128) -> int:
    """How many primary rays of the frame's row band ``band`` (default all
    rows) hit a sphere or the mesh: the width, per sample, of the
    program's compact bounce waves."""
    dev = sc.hdr.device
    y0, y1 = band or (0, height)
    total = 0
    for r0 in range(y0, y1, rows):
        pix = torch.arange(r0 * width, min(y1, r0 + rows) * width, device=dev)
        o, d = P.camera_rays(view, width, height, pix, sc.dtype)
        t_s, _ = P.intersect_spheres(sc.sph, o, d)
        tri, _ = sc.mesh.nearest(o, d, t_s)
        total += int(((t_s < P.INF) | (tri >= 0)).sum())
    return total


@torch.no_grad()
def primary_mesh_hits(cfg: dict, traffic: dict, seed: int, camera: dict, pix,
                      device):
    """Whether the primary ray through each pixel of ``pix`` hits the
    mesh before any sphere (the compared blocks are drawn from these)."""
    sc = scene(json.dumps(cfg, sort_keys=True), seed, str(device),
               torch.float32)
    o, d = P.camera_rays(camera, traffic["width"], traffic["height"],
                         pix.to(sc.hdr.device), sc.dtype)
    t_s, _ = P.intersect_spheres(sc.sph, o, d)
    tri, _ = sc.mesh.nearest(o, d, t_s)
    return tri >= 0


@functools.lru_cache(maxsize=1)
def scene(cfg_json: str, seed: int, device: str, dtype) -> Scene:
    """The reference scene of a run (its search tree takes seconds to
    build; the blocks of a run share it)."""
    return Scene(json.loads(cfg_json), seed, torch.device(device), dtype)


def frame(cfg: dict, traffic: dict, seed: int, camera: dict, passes: int,
          blocks, device, dtype=torch.float32):
    """(image, depth) of each (y0, x0, h, w) square block of the frame
    shown after ``passes`` passes of the traffic's samples from
    ``camera``."""
    sc = scene(json.dumps(cfg, sort_keys=True), seed, str(device), dtype)
    out = []
    for y0, x0, h, w in blocks:
        if h != w:
            raise ValueError("c5 compares square blocks")
        out.append(frame_region(sc, camera, passes, traffic["spp_per_pass"],
                                traffic["width"], traffic["height"], y0, x0, h))
    return out


def scene_of(run) -> Scene:
    """The reference scene of ``run`` in float32."""
    return scene(json.dumps(run.cfg, sort_keys=True), run.seed,
                 str(run.device), torch.float32)
