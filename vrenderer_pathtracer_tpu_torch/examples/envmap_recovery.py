"""Environment-map recovery through the fused mesh-scene kernel.

Renders a target image of the two analytic spheres under a known HDRI (a
smooth gradient with a bright sun disc), then recovers the environment
map from a flat guess with Adam.  The HDRI is a deferred table: on the
card each step runs K4 (``csrc/mesh.cu``) in records mode and the torch
``compose`` that fetches the tables, so the backward pass is only
``compose``'s gathers (``parallel/sharding.py::sharded_deferred_opt_step``),
not a differentiable re-render.  The target is rendered by the wavefront
integrator on the card and by the plain integrator with ``--cpu``.

    python -m vrenderer_pathtracer_tpu_torch.examples.envmap_recovery \\
        --steps 80 --out env.png
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def _parser():
    ap = argparse.ArgumentParser(prog="envmap_recovery")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--steps", type=int, default=80)
    ap.add_argument("--lr", type=float, default=0.2)
    ap.add_argument("--env", type=int, nargs=2, default=(16, 32),
                    metavar=("H", "W"))
    ap.add_argument("--out", default=None, help="recovered env map PNG")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def ground_truth(eh: int, ew: int):
    """The true HDRI [eh, ew, 3] and its sun-disc mask: a smooth gradient
    and a bright disc where the default camera's misses look (directions
    near -z map to u ~ 0/1, v ~ 0.5)."""
    yy, xx = np.mgrid[0:eh, 0:ew].astype(np.float32)
    truth = np.stack([
        0.3 + 0.7 * yy / eh,
        0.2 + 0.5 * xx / ew,
        0.6 - 0.4 * yy / eh,
    ], axis=-1)
    cy, cx = eh // 2, ew // 8
    mask = (yy - cy) ** 2 + (xx - cx) ** 2 < (eh / 6) ** 2
    truth[mask] = (6.0, 5.5, 5.0)
    return truth, mask


def main(argv=None) -> dict:
    """Run the recovery; its readings, with the target image and the first
    step's loss and HDRI gradient."""
    args = _parser().parse_args(argv)

    import torch

    from vrenderer_pathtracer_tpu_torch.config import RenderSettings
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.examples import device_of, process_group
    from vrenderer_pathtracer_tpu_torch.parallel import (
        DeferredParams, make_render_mesh, multihost, replicate, shard_pixels,
        sharded_deferred_opt_step)
    from vrenderer_pathtracer_tpu_torch.render.integrator import render_camera_pass
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene
    from vrenderer_pathtracer_tpu_torch.utils.profiling import synchronize

    device = device_of(args.cpu)
    eh, ew = args.env
    truth, mask = ground_truth(eh, ew)
    hdr_true = torch.as_tensor(truth, device=device)

    settings = RenderSettings(
        width=args.size, height=args.size, samples_per_pass=args.spp,
        bounces=3, use_cornell_box=False, has_hdr=True)
    scene = Scene.analytic(settings, device).replace(hdr=hdr_true)
    settings = settings_for_scene(scene, settings)
    cam = Camera.default(device)
    f32 = dict(dtype=torch.float32, device=device)
    fc, fp = torch.tensor(0.1, **f32), torch.tensor(3.0, **f32)
    out = {"backend": settings.radiance_kernel}
    with process_group(args.cpu) as world:
        writes = multihost.is_main_process()
        mesh = make_render_mesh(n_tiles=world, n_samples=1,
                                device_type=device.type)
        target_settings = settings.replace(
            radiance_kernel="wavefront" if device.type == "cuda" else "torch")
        target_rgb, _ = render_camera_pass(scene, target_settings, cam, 1, fc,
                                           fp)
        target = shard_pixels(mesh, target_rgb)
        out["target"] = target_rgb.cpu().numpy()

        p = DeferredParams(hdr=torch.full_like(hdr_true, 0.5).requires_grad_())
        step = sharded_deferred_opt_step(
            mesh, settings, torch.optim.Adam([p.hdr], lr=args.lr), scene=scene)
        scene_r, cam_r = replicate(mesh, (scene, cam))

        t0 = time.perf_counter()
        for i in range(args.steps):
            p, metrics = step(p, scene_r, cam_r, target, 2 + i, fc, fp)
            if i == 0:
                out["first_step"] = {"loss": metrics["loss"].item(),
                                     "grad": p.hdr.grad.cpu().numpy()}
                t1 = time.perf_counter()  # the first step loads the kernels
            if (i % 10 == 0 or i == args.steps - 1) and writes:
                print(f"step {i:4d}  loss {metrics['loss'].item():.6f}  "
                      f"|g| {metrics['grad_global_norm'].item():.4f}")
        synchronize(device)
        dt = time.perf_counter() - t0
        out["ms_per_step"] = dt / max(args.steps, 1) * 1e3
        if args.steps > 1:
            out["ms_per_step_after_first"] = (
                (time.perf_counter() - t1) / (args.steps - 1) * 1e3)
        out["loss"] = metrics["loss"].item()

    got = p.hdr.detach().cpu().numpy()
    err = np.abs(got - truth)
    # Texels are recovered in proportion to their visibility from the scene
    # (barely-visible ones only random-walk on sample noise), so report the
    # strongly-constrained region: the bright sun disc.
    out["sun_err"] = float(err[mask].mean())
    out["sun_err_init"] = float(np.abs(0.5 - truth)[mask].mean())
    if writes:
        print(f"{args.steps} steps in {dt:.1f}s "
              f"({out['ms_per_step']:.1f} ms/step, backend="
              f"{settings.radiance_kernel})")
        print(f"sun-disc mean |err|: {out['sun_err']:.3f} (init "
              f"{out['sun_err_init']:.3f}); final loss {out['loss']:.6f}")
    if args.out and writes:
        from PIL import Image

        disp = np.clip(got / max(truth.max(), 1e-6), 0, 1) ** (1 / 2.2)
        Image.fromarray((disp * 255).astype(np.uint8)).resize(
            (ew * 8, eh * 8), Image.NEAREST).save(args.out)
        print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
