"""BASELINE config 5: a high-poly mesh, HDRI, MERL BRDF and FXAA at 1080p,
with gradients with respect to the material and the environment map.

The whole pipeline on one card: a ~500k-triangle mesh, paged, searched by
K5 (``csrc/paged.cu``) in the wavefront integrator with compact bounce
waves; the EXR environment light, measured-BRDF shading, the FXAA display
pass and progressive accumulation with checkpointing; then one gradient of
the L2 loss of a pass with respect to the MERL table and the HDRI, by
autograd through ``deferred_opt_step``'s loss with bounce remat
(``torch.utils.checkpoint``) bounding the backward pass's memory.  With
``--cpu`` the same path runs the plain paged search.

The mesh is paged whatever its size (``pack_mesh(paged=True)``), so a small
``--mesh`` or ``--sphere-theta`` takes the same path.  Defaults are 960x540
and 16 spp; ``--full`` is the 1920x1080 / 1024 spp headline shape.

    python -m vrenderer_pathtracer_tpu_torch.examples.config5 --out config5.png
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np


def sky_image(h: int = 128, w: int = 256) -> np.ndarray:
    """The gradient sky [h, w, 3] float32: red fading up, blue rising, a
    constant green."""
    v = np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
    img = np.concatenate(
        [1.2 * (1 - v), 0.7 * np.ones((h, 1, 1), np.float32), 1.2 * v], axis=2)
    return np.broadcast_to(img, (h, w, 3)).copy()


def synth_assets(tmp, n_theta=500):
    """Procedural stand-ins written into ``tmp``: a dense UV sphere OBJ
    (``2 * n_theta * (n_theta - 1)`` triangles), the :func:`sky_image` as
    an EXR, and a Lambertian MERL ``.binary``.  Returns their paths."""
    from vrenderer_pathtracer_tpu_torch.native import write_exr
    from vrenderer_pathtracer_tpu_torch.ops.brdf import TABLE_SIZE
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    obj = os.path.join(tmp, "mesh.obj")
    write_uv_sphere(obj, radius=12.0, n_theta=n_theta, n_phi=n_theta)

    hdr = os.path.join(tmp, "sky.exr")
    write_exr(hdr, sky_image())

    brdf = os.path.join(tmp, "lambert.binary")
    scales = np.array([1.0, 1.15, 1.66]) / 1500.0
    raw = (0.05 / scales)[:, None] * np.ones((3, TABLE_SIZE))
    with open(brdf, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        raw.reshape(-1).astype(np.float64).tofile(f)
    return obj, hdr, brdf


def env_material_grads(scene, settings, camera, target, fresnel_coef,
                       fresnel_pow):
    """``(loss, d loss / d brdf, d loss / d hdr)`` of one pass at frame 1:
    ``deferred_opt_step``'s loss (``parallel/sharding.py::_deferred_loss``,
    the mean squared error of the pass's rgb [N,3] against ``target``) with
    the MERL table and the HDRI as ``DeferredParams``, on ``settings`` (its
    traversal, compact waves and remat as resolved)."""
    import torch

    from vrenderer_pathtracer_tpu_torch.parallel.sharding import (
        DeferredParams, _deferred_loss)

    params = DeferredParams.from_scene(scene, hdr=True, brdf=True)
    for t in params.leaves():
        t.requires_grad_()
    with torch.enable_grad():
        loss = _deferred_loss(params, scene, settings, camera, target, 1,
                              fresnel_coef, fresnel_pow, 0)
        g_hdr, g_brdf = torch.autograd.grad(loss, params.leaves())
    return loss.detach(), g_brdf, g_hdr


def _parser():
    ap = argparse.ArgumentParser(prog="config5")
    ap.add_argument("--full", action="store_true",
                    help="1920x1080, 1024 spp (headline shape)")
    ap.add_argument("--size", type=int, nargs=2, metavar=("W", "H"),
                    help="image size (default 960x540, 1920x1080 with --full)")
    ap.add_argument("--mesh")
    ap.add_argument("--hdr")
    ap.add_argument("--brdf")
    ap.add_argument("--sphere-theta", type=int, default=500,
                    help="rings (and segments) of the synthesised sphere")
    ap.add_argument("--out", default="config5.png")
    ap.add_argument("--sort-rays", action="store_true",
                    help="Morton-sort bounce rays for coherence")
    ap.add_argument("--spp", type=int, default=None)
    ap.add_argument("--spp-per-pass", type=int, default=2,
                    help="samples per progressive pass (reference parity: 2 "
                         "per frame)")
    ap.add_argument("--checkpoint-dir")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    import torch

    from vrenderer_pathtracer_tpu_torch import Renderer, RenderSettings
    from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
    from vrenderer_pathtracer_tpu_torch.examples import device_of
    from vrenderer_pathtracer_tpu_torch.io import save_png
    from vrenderer_pathtracer_tpu_torch.native import load_mesh_file
    from vrenderer_pathtracer_tpu_torch.render.progressive import ProgressiveScheduler
    from vrenderer_pathtracer_tpu_torch.utils.profiling import synchronize

    device = device_of(args.cpu)
    w, h, spp = (1920, 1080, 1024) if args.full else (960, 540, 16)
    if args.size:
        w, h = args.size
    if args.spp:
        spp = args.spp

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        obj, hdr, brdf = args.mesh, args.hdr, args.brdf
        if not (obj and hdr and brdf):
            print("synthesizing assets (dense sphere / sky / lambert MERL)...",
                  file=sys.stderr)
            synth = synth_assets(tmp, args.sphere_theta)
            obj, hdr, brdf = (a or b for a, b in zip((obj, hdr, brdf), synth))

        r = Renderer(w, h, device=device, settings=RenderSettings(
            samples_per_pass=args.spp_per_pass, bounces=4, use_fxaa=True,
            use_brdf=True, remat_bounces=True, sort_rays=args.sort_rays))
        t0 = time.perf_counter()
        r.load_hdr(hdr)
        r.load_brdf(brdf)
        r.init_mesh(pack_mesh(load_mesh_file(obj), paged=True, device=device))
    out["load_s"] = time.perf_counter() - t0
    out["traversal"] = r.settings.traversal
    print(f"assets loaded+packed in {out['load_s']:.1f}s; "
          f"traversal={r.settings.traversal}, "
          f"{r.scene.mesh.paged.n_pages} pages", file=sys.stderr)

    t0 = time.perf_counter()
    sched = ProgressiveScheduler(
        r, target_spp=spp, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=64 if args.full else 0,
        on_pass=lambda i, s: print(
            f"pass {i}: {s} spp, {time.perf_counter() - t0:.1f}s",
            file=sys.stderr) if i % 2 == 0 else None,
    )
    img, depth = sched.run()
    render_s = time.perf_counter() - t0
    out["passes"] = r.frame - 1
    out["ms_per_pass"] = render_s / max(out["passes"], 1) * 1e3
    out["image_mean"] = float(img.mean())
    out["hit_frac"] = float((depth < 1).mean())
    save_png(args.out, img)
    print(f"wrote {args.out} ({w}x{h}, {r.samples_per_pixel} spp, "
          f"{render_s:.1f}s)", file=sys.stderr)

    # --- gradient w.r.t. material (MERL table) and environment map --------
    gset = r.settings.replace(use_fxaa=False)
    target = torch.as_tensor(np.clip(img.reshape(-1, 3) * 0.9, 0, 1),
                             device=device)
    t0 = time.perf_counter()
    loss, g_brdf, g_hdr = env_material_grads(r.scene, gset, r.camera, target,
                                             r.fresnel_coef, r.fresnel_pow)
    synchronize(device)
    out["grad_s"] = time.perf_counter() - t0
    out["loss"] = loss.item()
    out["g_brdf_abs"] = g_brdf.abs().sum().item()
    out["g_hdr_abs"] = g_hdr.abs().sum().item()
    print(f"grad step: loss={out['loss']:.5f}, |dL/dBRDF|={out['g_brdf_abs']:.4g}, "
          f"|dL/denv|={out['g_hdr_abs']:.4g} ({out['grad_s']:.1f}s)",
          file=sys.stderr)
    if not np.isfinite(out["loss"]):
        raise FloatingPointError(f"config-5 loss {out['loss']}")
    return out


if __name__ == "__main__":
    main()
