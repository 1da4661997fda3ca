"""Plain reference of the ``c5inverse`` configuration: config 5's inverse
rendering step, the HDRI and the MERL table recovered by Adam from images
of the scene.

The scene is ``c5.py``'s (its mesh and search tree, its spheres, its
``trace``); the two trained tables stand in for the true ones.  A step's
loss is the mean squared error of one pass's linear rgb (``spp`` samples a
pixel, the mean over them) against the view's target, over ``n_pixels *
3``.  The whole frame is computed in row blocks that hold every sample of
their pixels: each block's term of the loss is run backward on its own and
the tables' gradients add up over the blocks, which is the whole frame's
gradient.  Then Adam (written out, torch's defaults).  TF32 is off while
the reference runs.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from benchmark.reference import c5
from benchmark.reference import c5_assets
from benchmark.reference import plain as P

BETAS, EPS = (0.9, 0.999), 1e-8


class _NoTF32:
    """Float32 matrix products in float32 inside the block."""

    def __enter__(self):
        self.was = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.was


class _Tables:
    """A reference scene whose HDRI and MERL table are the trained ones."""

    def __init__(self, sc: c5.Scene, hdr, brdf):
        self.__dict__.update(sc.__dict__)
        self.hdr, self.brdf = hdr, brdf


def start(cfg: dict, seed: int) -> dict:
    """The start of the descent (float32 numpy): each trained table flat at
    the true table's per-channel mean, ``hdr`` [H,W,3] and ``brdf``
    [3, 90*90*180]."""
    hdr = c5_assets.hdri(cfg, seed)
    brdf = c5_assets.merl(cfg, seed)
    h_mean = hdr.reshape(-1, 3).astype(np.float64).mean(0)
    b_mean = brdf.astype(np.float64).mean(1)
    return {"hdr": np.broadcast_to(h_mean.astype(np.float32),
                                   hdr.shape).copy(),
            "brdf": np.broadcast_to(b_mean.astype(np.float32)[:, None],
                                    brdf.shape).copy()}


def scene_of(cfg: dict, seed: int, device, dtype=torch.float32) -> c5.Scene:
    """The reference scene with the true tables (shared with ``c5.py``'s
    cache: the configuration holds c5's scene keys verbatim)."""
    return c5.scene(json.dumps(cfg, sort_keys=True), seed, str(device), dtype)


def _lanes(sc, camera, width, height, pix, spp, frame):
    """The ``trace`` of every sample of pixels ``pix``: rgb [spp, n, 3]."""
    n = pix.shape[0]
    o, d = P.camera_rays(camera, width, height, pix, sc.dtype)
    samp = torch.arange(spp, device=pix.device).repeat_interleave(n)
    rgb, _ = c5.trace(sc, o.repeat(spp, 1), d.repeat(spp, 1), pix.repeat(spp),
                      samp, frame, sc.cfg["bounces"])
    return rgb.reshape(spp, n, 3)


@torch.no_grad()
def target_blocks(cfg: dict, traffic: dict, seed: int, camera: dict, blocks,
                  device, dtype=torch.float32) -> list:
    """The displayed value of each (y0, x0, h, w) block of a view's target:
    the mean linear rgb of frames 1..``target_passes`` with the true
    tables, tonemapped as one frame, [h, w, 3] float32 on the host."""
    t = traffic
    sc = scene_of(cfg, seed, device, dtype)
    out = []
    with _NoTF32():
        for y0, x0, h, w in blocks:
            yy, xx = torch.meshgrid(torch.arange(y0, y0 + h),
                                    torch.arange(x0, x0 + w), indexing="ij")
            pix = (yy * t["width"] + xx).reshape(-1).to(device)
            acc = torch.zeros((pix.shape[0], 3), dtype=dtype, device=device)
            for f in range(1, t["target_passes"] + 1):
                acc = acc + _lanes(sc, camera, t["width"], t["height"], pix,
                                   t["spp_per_pass"], f).mean(0)
            out.append(P.tonemap(acc, t["target_passes"]).reshape(h, w, 3)
                       .float().cpu())
    return out


def loss_and_grads(sc: c5.Scene, hdr, brdf, camera: dict, frame: int, target,
                   spp: int, width: int, height: int,
                   block_lanes: int = 1 << 21, rows=None):
    """(loss, d loss / d hdr, d loss / d brdf) of one step's pass, ``target``
    the view's [width*height, 3] linear rgb, over the rows ``rows`` (default
    all) in blocks of about ``block_lanes`` lanes."""
    hdr = hdr.detach().requires_grad_()
    brdf = brdf.detach().requires_grad_()
    sct = _Tables(sc, hdr, brdf)
    norm = 1.0 / (width * height * 3)
    band = max(1, block_lanes // (width * spp))
    y0, y1 = rows or (0, height)
    loss = 0.0
    with _NoTF32(), torch.enable_grad():
        for r0 in range(y0, y1, band):
            pix = torch.arange(r0 * width, min(y1, r0 + band) * width,
                               device=target.device)
            rgb = _lanes(sct, camera, width, height, pix, spp, frame).mean(0)
            part = torch.sum((rgb - target[pix].to(rgb.dtype)) ** 2) * norm
            part.backward()
            loss += float(part.detach())
    return loss, hdr.grad, brdf.grad


def train(cfg: dict, traffic: dict, seed: int, cameras, frames, targets,
          device, dtype=torch.float32, block_lanes: int = 1 << 21) -> dict:
    """The first steps of the descent from :func:`start`: step ``i`` renders
    frame ``frames[i]`` from ``cameras[i]`` against ``targets[i]``, then
    Adam (lr from the traffic).  Returns per-step losses, gradients
    ([hdr, brdf], float32 on the host) and the tables after each step."""
    t = traffic
    sc = scene_of(cfg, seed, device, dtype)
    s0 = start(cfg, seed)
    params = [torch.as_tensor(s0[k], device=device).to(dtype)
              for k in ("hdr", "brdf")]
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    out = {"loss": [], "grads": [], "params": []}
    b1, b2 = BETAS
    for step, (cam, fr, target) in enumerate(zip(cameras, frames, targets),
                                             start=1):
        loss, *grads = loss_and_grads(sc, *params, cam, fr, target,
                                      t["spp_per_pass"], t["width"],
                                      t["height"], block_lanes)
        out["loss"].append(loss)
        out["grads"].append([g.float().cpu() for g in grads])
        with torch.no_grad():
            for i, g in enumerate(grads):
                m[i] = b1 * m[i] + (1 - b1) * g
                v[i] = b2 * v[i] + (1 - b2) * g * g
                mh = m[i] / (1 - b1 ** step)
                vh = v[i] / (1 - b2 ** step)
                params[i] = params[i] - t["lr"] * mh / (torch.sqrt(vh) + EPS)
        out["params"].append([p.float().cpu() for p in params])
    return out


primary_mesh_hits = c5.primary_mesh_hits
