"""K1 and K2 with each mix of the Cornell loop's inexact cuts, timed in turns
on one card.

    python3 cornell_cuts.py [--rounds 4]

``csrc/common.cuh``'s ``kCornellFast`` is the set of inexact cuts that K1
(``csrc/radiance.cu``) and K2 (``csrc/grad.cu``) run: bit 1 one reciprocal
a normalisation, bit 2 ``sincospif(2u)`` for ``sincosf(2 pi u)``, bit 4
``exp2f(p log2f(x))`` for ``powf``.  A mix is a build of both sources with
``-DVPT_CORNELL_FAST=<bits>``, into a library of its own (one ``nvcc`` a
library, all started together).  The script holds each mix to the
kernels' contracts against the plain versions on the Cornell scene at
1024x1024, 2 spp, 4 bounces (K1: under 1% of rgb elements off by more
than 1e-5; K2: the loss within 1e-5 of the L2 loss of the mix's own K1
image, and every gradient leaf within 1e-2 of the plain one, as
``chip_smoke.py`` holds them), then times K1 and K2 of every mix from CUDA
events in turns: every mix in order, then in reverse, ``--rounds`` times.
It prints the card's name and power limit, each turn, per mix the means
and their ratio to the rcp-only mix, and a JSON line of the means.
Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

MIXES = {"exact": 0, "rcp": 1, "rcp + sincospif": 3, "rcp + exp2 pow": 5,
         "rcp + sincospif + exp2 pow": 7}
RGB_ATOL, OUTLIER_FRAC, LOSS_RTOL, GRAD_RTOL = 1e-5, 0.01, 1e-5, 1e-2


def mix_target(name: str, bits: int):
    return name, (f"-DVPT_CORNELL_FAST={bits}u",)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("cornell_cuts: no CUDA device", file=sys.stderr)
        return 1
    from vrenderer_pathtracer_tpu_torch import RenderSettings
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.kernels import build
    from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    targets = [mix_target(n, b) for b in MIXES.values() for n in ("radiance", "grad")]
    libs = build.build_all(targets)

    dev = torch.device("cuda")
    s = RenderSettings(use_cornell_box=True, has_hdr=False, width=1024,
                       height=1024)
    scene, cam = Scene.analytic(s, dev), Camera.default(dev)
    fc, fp = 0.1, 3.0
    cam_t = k1.pack_camera(cam, s, fc, fp)
    sph = k1.pack_spheres(scene.spheres)
    bright = scene.spheres.emission.clone()
    bright[0] *= 1.5
    target, _ = k1.render_pass_cuda(scene.replace_spheres(emission=bright), s,
                                    cam, 1, fc, fp)
    n, ns = s.n_pixels, sph.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint

    def k1_fn(bits):
        fn = ctypes.CDLL(str(libs[mix_target("radiance", bits)])).vpt_radiance
        fn.argtypes = [ptr, ptr, i32, u32, u32, u32, i32, i32, i32, i32,
                       ctypes.c_float, i32, u32, i32, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        depth = torch.empty((n,), dtype=torch.float32, device=dev)

        def run():
            err = fn(cam_t.data_ptr(), sph.data_ptr(), ns, 0, 0, 1, s.width,
                     s.height, s.samples_per_pass, s.bounces, s.depth_scale,
                     0, 0, n, rgb.data_ptr(), depth.data_ptr(), stream)
            assert err == 0, f"K1 launch failed: {err}"
            return rgb

        return run

    def k2_fn(bits):
        lib = ctypes.CDLL(str(libs[mix_target("grad", bits)]))
        lib.vpt_grad_workspace_floats.argtypes = [i32, i32]
        lib.vpt_grad_workspace_floats.restype = ctypes.c_longlong
        fn = lib.vpt_grad
        fn.argtypes = [ptr, ptr, i32, u32, u32, u32, i32, i32, i32, i32, i32,
                       i32, i32, ptr, ptr, ptr, i32, ptr]
        fn.restype = ctypes.c_int
        k = k2.n_partials(ns, False)
        work = torch.empty((lib.vpt_grad_workspace_floats(n, k),),
                           dtype=torch.float32, device=dev)
        row = torch.empty((k,), dtype=torch.float32, device=dev)

        def run():
            err = fn(cam_t.data_ptr(), sph.data_ptr(), ns, 0, 0, 1, s.width,
                     s.height, s.samples_per_pass, s.bounces, 0, 0, n,
                     target.data_ptr(), work.data_ptr(), row.data_ptr(), 0,
                     stream)
            assert err == 0, f"K2 launch failed: {err}"
            return row

        return run

    fns = {name: {"K1": k1_fn(bits), "K2": k2_fn(bits)}
           for name, bits in MIXES.items()}

    # Each mix against the plain versions.
    plain_rgb, _ = k1.render_pass_reference(scene, s, cam, 1, fc, fp)
    want = k2.cornell_loss_grads_reference(scene, s, cam, target, 1, fc, fp)
    checks = {}
    for name, f in fns.items():
        rgb = f["K1"]().clone()
        out = k2.unpack(f["K2"]().clone(), ns, n)[0]
        frac = ((rgb - plain_rgb).abs() > RGB_ATOL).float().mean().item()
        img_loss = torch.mean((rgb.double() - target.double()) ** 2).item()
        loss_rel = abs(out[0].item() - img_loss) / img_loss
        leaves = {leaf: ((g.double() - w.double()).norm() / w.double().norm()).item()
                  for leaf, g, w in zip(("dcolor", "demission", "dfresnel_coef",
                                         "dfresnel_pow"), out[1:5], want[1:5])}
        checks[name] = {"k1_outliers": frac, "k2_loss_rel": loss_rel, **leaves}
        print(f"{name}: K1 rgb outliers {frac:.5%}; K2 loss vs its K1 image's "
              f"{loss_rel:.3g}, leaves " + ", ".join(
                  f"{k} {v:.4g}" for k, v in leaves.items()))
        assert frac < OUTLIER_FRAC, f"{name}: K1 breaks its contract"
        assert loss_rel <= LOSS_RTOL, f"{name}: K2's loss"
        assert max(leaves.values()) <= GRAD_RTOL, f"{name}: K2's gradients"

    # Turns: every mix in order, then in reverse, per round.
    times = {name: {"K1": [], "K2": []} for name in MIXES}
    order = list(MIXES)
    for r in range(args.rounds):
        for name in order + order[::-1]:
            for kern, iters in (("K1", 50), ("K2", 30)):
                times[name][kern].append(
                    cuda_time_ms(fns[name][kern], dev, iters=iters))
        print(f"round {r}: " + "; ".join(
            f"{name} K1 {times[name]['K1'][-1]:.4f} K2 {times[name]['K2'][-1]:.4f}"
            for name in order), flush=True)
    means = {name: {kern: float(np.mean(v)) for kern, v in t.items()}
             for name, t in times.items()}
    base = next(name for name, bits in MIXES.items() if bits == 1)
    for name, m in means.items():
        print(f"{name}: K1 {m['K1']:.4f} ms ({m['K1'] / means[base]['K1']:.4f} of "
              f"{base}), K2 {m['K2']:.4f} ms ({m['K2'] / means[base]['K2']:.4f}); "
              f"turn spread K1 {min(times[name]['K1']):.4f}-"
              f"{max(times[name]['K1']):.4f}, K2 {min(times[name]['K2']):.4f}-"
              f"{max(times[name]['K2']):.4f}, {card}")
    print(json.dumps({"card": card, "means_ms": means, "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
