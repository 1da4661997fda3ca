"""Plain reference of the ``cornell`` configuration: the Cornell shells
with the mirror and Fresnel spheres, 4 bounces, a miss ending the path.

``render`` gives a frame as the viewer shows it (the tonemapped mean of
its passes, and the first-hit depth); ``train`` the loss, gradients and
Adam updates of the inverse-rendering steps, by autograd in blocks of
pixels; ``work`` counts what K1 and K2 must trace for a pass (the sphere
tests, hits, Fresnel hits, records and score terms), which the roofline
readers price.  Plain PyTorch only; nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import plain as P
from benchmark.reference import views

DEPTH_SCALE = 150.0


def trace(sph: P.Spheres, o, d, pix, samp, seed: int, frame: int,
          bounces: int, fc, fp, work=None):
    """Radiance [B,3] and depth [B] of the lanes; ``work``, when a dict,
    gains K1's and K2's counts of these lanes (``cornell_work``'s)."""
    dtype = o.dtype
    mask = torch.ones_like(o)
    accum = torch.zeros_like(o)
    depth = torch.ones(o.shape[:1], dtype=dtype, device=o.device)
    alive = torch.ones(o.shape[:1], dtype=torch.bool, device=o.device)
    killed = torch.zeros_like(alive)
    rec = torch.zeros(o.shape[:1], dtype=torch.int64, device=o.device)
    score = torch.zeros_like(rec)
    for b in range(bounces):
        t, row = P.intersect_spheres(sph, o, d)
        hit = t < P.INF
        killed = killed | (alive & ~hit)
        point = o + d * torch.where(hit, t, torch.zeros_like(t))[:, None]
        n = P._normalize(point - sph.pos[row], 1e-20)
        if b == 0:
            d0 = torch.linalg.norm(o - point, dim=-1) / DEPTH_SCALE
            depth = torch.where(alive & hit, d0, depth)
        lh = alive & hit
        lh3 = lh[:, None]
        accum = accum + torch.where(lh3, mask * P.pick(sph.emission, row),
                                    torch.zeros_like(mask))
        u_refl, _ = P.uniform2(seed, pix, frame, samp, b, 0, dtype)
        u_phi, u_r = P.uniform2(seed, pix, frame, samp, b, 1, dtype)
        spec = sph.spec[row]
        new_d, mult = P.scatter(d, n, torch.zeros_like(n), P.pick(sph.color, row),
                                spec, sph.kind[row], u_refl, u_phi, u_r, fc, fp)
        if work is not None:
            with torch.no_grad():
                kind = sph.kind[row]
                fres = lh & (kind == P.DIFF) & (spec[:, 0] != 0)
                n_alive, n_hit, n_fres = (int(alive.sum()), int(lh.sum()),
                                          int(fres.sum()))
                if b == 0 and int(samp.min()) == 0:
                    first = samp == samp.min()
                    work["hits0"] += int((lh & first).sum())
                    work["fres0"] += int((fres & first).sum())
                if b > 0:
                    work["tests"] += n_alive
                    work["hits"] += n_hit
                    work["fres"] += n_fres
                work["steps"] += n_hit
                work["fres_steps"] += n_fres
                aoi = torch.sum(n * -d, dim=-1)
                p = (torch.clamp(1.0 - aoi, min=0.0) ** fp * (1.0 - fc) + fc) * spec[:, 0]
                rec += lh.long()
                score += (fres & (p >= 1e-6) & (p <= 1.0 - 1e-6)).long()
        o = torch.where(lh3, point + P.ORIGIN_OFFSET * n, o)
        d = torch.where(lh3, new_d, d)
        mask = torch.where(lh3, mask * mult, mask)
        alive = lh
    if work is not None:
        work["records"] += int(rec[alive].sum())
        work["scores"] += int(score[alive].sum())
    accum = torch.where(killed[:, None], torch.zeros_like(accum), accum)
    depth = torch.where(killed, torch.zeros_like(depth), depth)
    return accum, depth


def _pass(sph, view, width, height, pix, seed, frame, spp, bounces, fc, fp,
          dtype, lanes=1 << 22, work=None):
    """One pass over pixels ``pix``: (mean rgb [n,3], depth [n]), samples
    in chunks of at most ``lanes`` lanes."""
    n = pix.shape[0]
    o1, d1 = P.camera_rays(view, width, height, pix, dtype)
    total = torch.zeros((n, 3), dtype=dtype, device=pix.device)
    depth = None
    per = max(1, lanes // max(n, 1))
    for s0 in range(0, spp, per):
        k = min(per, spp - s0)
        samp = torch.arange(s0, s0 + k, device=pix.device).repeat_interleave(n)
        rgb, dep = trace(sph, o1.repeat(k, 1), d1.repeat(k, 1), pix.repeat(k),
                         samp, seed, frame, bounces, fc, fp, work)
        total = total + rgb.reshape(k, n, 3).sum(dim=0)
        depth = dep.reshape(k, n)[-1]
    return total / spp, depth


def _sliders(cfg, device, dtype):
    f = dict(dtype=dtype, device=device)
    return (torch.tensor(cfg["fresnel_coef"], **f),
            torch.tensor(cfg["fresnel_pow"], **f))


@torch.no_grad()
def render(cfg: dict, view: dict, passes: int, spp: int, width: int,
           height: int, seed: int, device, dtype=torch.float32, rows=None):
    """The frame the viewer shows after ``passes`` passes of ``spp``
    samples from a fresh accumulation (frames 1..passes): (image [h,W,3]
    display values, depth [h,W]) over the row range ``rows`` (default all).
    """
    y0, y1 = rows or (0, height)
    sph = P.Spheres(P.sphere_rows(True), device, dtype)
    fc, fp = _sliders(cfg, device, dtype)
    img, depth = [], []
    band = max(1, (1 << 22) // (width * spp))
    for r0 in range(y0, y1, band):
        r1 = min(y1, r0 + band)
        pix = torch.arange(r0 * width, r1 * width, device=device)
        acc = torch.zeros((pix.shape[0], 3), dtype=dtype, device=device)
        for f in range(1, passes + 1):
            rgb, dep = _pass(sph, view, width, height, pix, seed, f, spp,
                             cfg["bounces"], fc, fp, dtype)
            acc = acc + rgb
        img.append(P.tonemap(acc, passes).float().cpu())
        depth.append(dep.float().cpu())
    return (torch.cat(img).reshape(y1 - y0, width, 3),
            torch.cat(depth).reshape(y1 - y0, width))


@torch.no_grad()
def work(cfg: dict, view: dict, frame: int, spp: int, width: int,
         height: int, seed: int, device, fc=None, fp=None, color=None,
         emission=None) -> dict:
    """What K1 and K2 trace for one pass of these inputs (counts)."""
    w = dict.fromkeys(("tests", "hits", "fres", "steps", "fres_steps",
                       "records", "scores", "hits0", "fres0"), 0)
    w["pixels"], w["spp"] = width * height, spp
    sph = P.Spheres(P.sphere_rows(True), device, torch.float32, color, emission)
    if fc is None:
        fc, fp = _sliders(cfg, device, torch.float32)
    w["spheres"] = sph.count
    band = max(1, (1 << 22) // (width * spp))
    for r0 in range(0, height, band):
        pix = torch.arange(r0 * width, min(height, r0 + band) * width,
                           device=device)
        _pass(sph, view, width, height, pix, seed, frame, spp, cfg["bounces"],
              fc, fp, torch.float32, work=w)
    return w


def train(cfg: dict, true_params: dict, start: dict, frames, target_frames,
          lr: float, spp: int, width: int, height: int, seed: int, device,
          dtype=torch.float32, betas=(0.9, 0.999), eps=1e-8,
          block_pixels=1 << 19):
    """The inverse-rendering steps from ``start``: the target is the mean
    of ``target_frames`` passes with ``true_params``; each step's loss is
    the mean squared error of a pass (frame ``frames[i]``) against it, its
    gradients by autograd (blocks of pixels), then Adam.  Returns a dict of
    per-step losses, the first step's gradients and every step's
    parameters (numpy float64)."""
    view = views.camera({"kind": "drag", "dx": 0, "dy": 0})
    n = width * height
    leaves = ("color", "emission", "fresnel_coef", "fresnel_pow")
    f = dict(dtype=dtype, device=device)
    tp = {k: torch.as_tensor(np.asarray(v), **f) for k, v in true_params.items()}
    sph_true = P.Spheres(P.sphere_rows(True), device, dtype, tp["color"],
                         tp["emission"])
    band = max(1, block_pixels // width)
    target = torch.zeros((n, 3), **f)
    with torch.no_grad():
        for r0 in range(0, height, band):
            pix = torch.arange(r0 * width, min(height, r0 + band) * width,
                               device=device)
            acc = torch.zeros((pix.shape[0], 3), **f)
            for fr in target_frames:
                rgb, _ = _pass(sph_true, view, width, height, pix, seed, fr,
                               spp, cfg["bounces"], tp["fresnel_coef"],
                               tp["fresnel_pow"], dtype)
                acc = acc + rgb
            target[pix] = acc / len(target_frames)
    params = [torch.as_tensor(np.asarray(start[k]), **f).clone() for k in leaves]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    out = {"loss": [], "grads": None, "params": []}
    for step, fr in enumerate(frames, start=1):
        ps = [p.detach().requires_grad_() for p in params]
        sph = P.Spheres(P.sphere_rows(True), device, dtype, ps[0], ps[1])
        loss = 0.0
        for r0 in range(0, height, band):
            pix = torch.arange(r0 * width, min(height, r0 + band) * width,
                               device=device)
            rgb, _ = _pass(sph, view, width, height, pix, seed, fr, spp,
                           cfg["bounces"], ps[2], ps[3], dtype)
            part = torch.sum((rgb - target[pix]) ** 2) * (1.0 / (n * 3))
            part.backward()
            loss += float(part.detach())
        grads = [p.grad for p in ps]
        out["loss"].append(loss)
        if step == 1:
            out["grads"] = [g.double().cpu().numpy() for g in grads]
        with torch.no_grad():
            b1, b2 = betas
            for i, g in enumerate(grads):
                m[i] = b1 * m[i] + (1 - b1) * g
                v[i] = b2 * v[i] + (1 - b2) * g * g
                mh = m[i] / (1 - b1 ** step)
                vh = v[i] / (1 - b2 ** step)
                params[i] = params[i] - lr * mh / (torch.sqrt(vh) + eps)
        out["params"].append([p.double().cpu().numpy() for p in params])
    return out


def frame(cfg: dict, traffic: dict, seed: int, camera: dict, passes: int,
          blocks, device, dtype=torch.float32):
    """(image, depth) of each (y0, x0, h, w) block of the frame shown after
    ``passes`` passes of the traffic's samples from ``camera``."""
    out = []
    for y0, x0, h, w in blocks:
        img, depth = render(cfg, camera, passes, traffic["spp_per_pass"],
                            traffic["width"], traffic["height"], seed, device,
                            dtype, rows=(y0, y0 + h))
        out.append((img[:, x0:x0 + w], depth[:, x0:x0 + w]))
    return out


def train_inputs(cfg: dict, seed: int):
    """The seeded true parameters and the start of the descent: the true
    albedos and emissions are the scene's times U(0.8, 1.2) (albedo at most
    1), the sliders the configuration's; the start moves each by U(-0.25,
    0.25), clipped at 0, with the sliders at 0.4 and 1.5 (the
    inverse-rendering example's start)."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 5])
    rows = P.sphere_rows(True)
    color = np.array([r[3] for r in rows], np.float32)
    emis = np.array([r[2] for r in rows], np.float32)
    truth = {"color": np.clip(color * rng.uniform(0.8, 1.2, color.shape), 0, 1),
             "emission": emis * rng.uniform(0.8, 1.2, emis.shape),
             "fresnel_coef": cfg["fresnel_coef"], "fresnel_pow": cfg["fresnel_pow"]}
    truth = {k: np.asarray(v, np.float32) for k, v in truth.items()}
    start = {"color": np.clip(truth["color"] + rng.uniform(-0.25, 0.25, color.shape), 0, None),
             "emission": np.clip(truth["emission"] + rng.uniform(-0.25, 0.25, emis.shape), 0, None),
             "fresnel_coef": 0.4, "fresnel_pow": 1.5}
    return truth, {k: np.asarray(v, np.float32) for k, v in start.items()}
