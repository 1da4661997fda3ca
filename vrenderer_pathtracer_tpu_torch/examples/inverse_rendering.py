"""Inverse rendering: recover scene parameters from a target image.

Renders a Cornell box with known materials, then starts from perturbed
sphere albedos and emissions and Fresnel sliders and recovers them by
gradient descent (Adam) on the pixel L2 loss; every step differentiates the
whole path tracer.  On the card each step's loss and gradients come from
K2 (``csrc/grad.cu``) through ``sharded_opt_step``, and the target and the
converged renders from K1; with ``--cpu`` the same steps run the plain
autograd path.

The steps run over the ranks of a ``(tiles, 1)`` mesh: one process, or the
processes of a ``torchrun`` launch (one tile each).  Each step renders a
fresh sample batch (the frame id advances), so the optimiser sees unbiased
gradient estimates rather than one fixed noise realisation.

    python -m vrenderer_pathtracer_tpu_torch.examples.inverse_rendering \\
        --steps 60 --out recovered.png
"""

from __future__ import annotations

import argparse
import sys
import time

N_TARGET = 8  # passes averaged into the target and each converged render


def _parser():
    ap = argparse.ArgumentParser(prog="inverse_rendering")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4, help="samples per step")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.08)
    ap.add_argument("--out", default=None, help="PNG of the recovered render")
    ap.add_argument("--metrics", default=None, help="JSONL metrics log")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    return ap


def perturbed_params(true_params, rng):
    """The start of the descent: albedo and emission each moved by
    ``rng.uniform(-0.25, 0.25)`` and clipped at 0 (albedo first), the
    Fresnel sliders at 0.4 and 1.5."""
    import numpy as np
    import torch

    from vrenderer_pathtracer_tpu_torch.parallel import TrainParams

    def perturb(x):
        x = x.detach().cpu().numpy().astype(np.float32)
        x = np.clip(x + rng.uniform(-0.25, 0.25, x.shape), 0.0, None)
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    device = true_params.color.device
    f32 = dict(dtype=torch.float32, device=device)
    color = perturb(true_params.color)
    emission = perturb(true_params.emission)
    return TrainParams(color=color, emission=emission,
                       fresnel_coef=torch.tensor(0.4, **f32),
                       fresnel_pow=torch.tensor(1.5, **f32))


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from vrenderer_pathtracer_tpu_torch.config import RenderSettings
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.examples import device_of, process_group
    from vrenderer_pathtracer_tpu_torch.parallel import (
        TrainParams, make_render_mesh, multihost, replicate, shard_pixels,
        sharded_opt_step, sharded_render_step)
    from vrenderer_pathtracer_tpu_torch.parallel.sharding import apply_params
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
    from vrenderer_pathtracer_tpu_torch.utils.metrics import MetricsLogger
    from vrenderer_pathtracer_tpu_torch.utils.profiling import synchronize

    device = device_of(args.cpu)
    settings = RenderSettings(
        width=args.size, height=args.size, samples_per_pass=args.spp,
        bounces=4, use_cornell_box=True, has_hdr=False)
    out = {}
    with process_group(args.cpu) as world:
        writes = multihost.is_main_process()
        mesh = make_render_mesh(n_tiles=world, n_samples=1,
                                device_type=device.type)
        scene_true = replicate(mesh, Scene.analytic(settings, device))
        camera = replicate(mesh, Camera.default(device))
        f32 = dict(dtype=torch.float32, device=device)
        accum0 = shard_pixels(mesh, torch.zeros((settings.n_pixels, 3), **f32))

        def converged(scene, fc, fp, frame0):
            """This rank's tile of the mean of N_TARGET fresh passes, and
            the last pass's tonemapped tile."""
            step = sharded_render_step(mesh, settings, scene=scene)
            acc = accum0
            for i in range(N_TARGET):
                acc, img, _ = step(scene, camera, acc, frame0 + i, fc, fp)
            return acc / N_TARGET, img

        # The target: a converged render with the true parameters.  The loss
        # compares raw radiance (what a train step renders), so the target
        # is the linear accumulation mean, not the tonemapped image.
        fc_true, fp_true = (torch.tensor(v, **f32) for v in (0.1, 3.0))
        target, _ = converged(scene_true, fc_true, fp_true, 1)
        out["target"] = multihost.gather_image(target, mesh).cpu().numpy()

        true_params = TrainParams.from_scene(scene_true)
        params = replicate(mesh, perturbed_params(
            true_params, np.random.default_rng(0)))
        for leaf in params.leaves():
            leaf.requires_grad_()
        step = sharded_opt_step(mesh, settings,
                                torch.optim.Adam(params.leaves(), lr=args.lr))
        log = MetricsLogger(args.metrics) if args.metrics and writes else None

        losses = []
        t0 = time.perf_counter()
        for i in range(args.steps):
            params, metrics = step(params, scene_true, camera, target, 100 + i)
            if i == 0:
                out["first_step"] = {
                    "loss": metrics["loss"].item(),
                    "grads": [leaf.grad.detach().cpu().numpy()
                              for leaf in params.leaves()]}
                t1 = time.perf_counter()  # the first step loads the kernels
            if i % 10 == 0 or i == args.steps - 1:
                loss = metrics["loss"].item()
                gn = metrics["grad_global_norm"].item()
                losses.append((i, loss))
                if writes:
                    print(f"step {i:3d}  loss {loss:.6f}  |g| {gn:.4f}",
                          file=sys.stderr)
                if log:
                    log.log("train_step", step=i, loss=loss, grad_norm=gn)
        synchronize(device)
        dt = time.perf_counter() - t0
        out["ms_per_step"] = dt / max(args.steps, 1) * 1e3
        if args.steps > 1:
            out["ms_per_step_after_first"] = (
                (time.perf_counter() - t1) / (args.steps - 1) * 1e3)
        if writes:
            print(f"{args.steps} steps in {dt:.1f}s "
                  f"({out['ms_per_step']:.0f} ms/step)", file=sys.stderr)

        # Success metric: converged renders (fresh frames) with the
        # recovered and the true parameters, both against the target.
        # Per-step losses on single noisy passes are not comparable across
        # parameter sets (MSE on a noisy estimate rewards variance
        # reduction); converged means are.  The recovered MSE can come out
        # below the true-params one: E||R(p)-t||^2 = bias^2 + Var R(p).
        # Parameters the image cannot see (the light's albedo under its own
        # emission) may drift.
        got = TrainParams(*(leaf.detach() for leaf in params.leaves()))

        def converged_mse(p, fc, fp, frame0):
            mean, _ = converged(apply_params(scene_true, p), fc, fp, frame0)
            sq = torch.sum((mean - target) ** 2)
            if world > 1:
                torch.distributed.all_reduce(sq)
            return sq.item() / (settings.n_pixels * 3)

        out["rec_mse"] = converged_mse(got, got.fresnel_coef, got.fresnel_pow,
                                       200)
        out["true_mse"] = converged_mse(true_params, fc_true, fp_true, 300)
        out["err_fc"] = abs(got.fresnel_coef.item() - 0.1)
        out["losses"] = losses
        if writes:
            print(f"converged-render MSE: recovered {out['rec_mse']:.5f} vs "
                  f"true-params {out['true_mse']:.5f}; |fresnel_coef error| "
                  f"{out['err_fc']:.4f}", file=sys.stderr)

        if args.out:
            # Render with the recovered parameters for a visual check.
            _, img = converged(apply_params(scene_true, got), got.fresnel_coef,
                               got.fresnel_pow, 1)
            img = multihost.gather_image(img, mesh)
            if writes:
                from vrenderer_pathtracer_tpu_torch.io import save_png

                save_png(args.out, img.cpu().numpy().reshape(
                    args.size, args.size, 3))
                print(f"wrote {args.out}", file=sys.stderr)
        if log:
            log.close()
    return out


if __name__ == "__main__":
    main()
