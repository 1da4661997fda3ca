"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Card: print ``nvidia-smi``'s name and power limit.
2. Build: compile K1 (``vrenderer_pathtracer_tpu_torch/csrc/radiance.cu``)
   from the sources with ``nvcc``; print the seconds and ptxas' report.
3. Kernel vs plain: K1 against its plain PyTorch version on the card at
   256x256 (frames 1 and 3) and at the main path's 1024x1024, 2 spp,
   4 bounces; the port's ``Renderer`` on the card against the same
   ``Renderer`` on the CPU at 64x32.
4. Main path: ``Renderer(1024, 1024, device="cuda")`` for 1 warm-up and 10
   timed passes; K1's launch count must rise by one per pass; the image must
   be finite and of plausible Cornell brightness.
5. Times per pass at 1024x1024 from CUDA events: K1 alone, its wrapper
   (table packing + K1) and the plain version.

The last lines are the kernel table as one JSON object and then
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH = HEIGHT = 1024
PASSES = 10
# Parity contract of the kernel against its plain version (two differently
# compiled programs flip discrete branches on grazing rays): fewer than 1%
# of rgb elements off by more than 1e-5, and depth within 1e-3.  At the full
# 1024x1024 a flipped Cornell kill can land on a pixel of the last sample
# (depth 0 in one program, the hit distance in the other; measured: 1 pixel
# of 1M), so there depth is held to the outlier form of the repo's golden
# contract instead: fewer than 1% of pixels off by more than 1e-3.
RGB_ATOL, OUTLIER_FRAC, DEPTH_ATOL = 1e-5, 0.01, 1e-3


def _compare(name, got, want, depth_outliers=False):
    (rgb_k, dep_k), (rgb_p, dep_p) = got, want
    assert rgb_k.shape == rgb_p.shape and dep_k.shape == dep_p.shape, name
    assert torch.isfinite(rgb_k).all() and torch.isfinite(dep_k).all(), name
    d = (rgb_k - rgb_p).abs()
    frac = (d > RGB_ATOL).float().mean().item()
    dd = (dep_k - dep_p).abs()
    dfrac = (dd > DEPTH_ATOL).float().mean().item()
    print(f"  {name}: rgb outliers {frac:.5%} (max abs {d.max().item():.6g}), "
          f"depth max abs {dd.max().item():.6g}, depth >{DEPTH_ATOL}: "
          f"{dfrac:.5%}")
    assert frac < OUTLIER_FRAC, f"{name}: {frac:.4%} rgb elements differ"
    if depth_outliers:
        assert dfrac < OUTLIER_FRAC, f"{name}: {dfrac:.4%} depth pixels differ"
    else:
        assert dd.max().item() < DEPTH_ATOL, f"{name}: depth error {dd.max().item()}"
    return d.max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vrenderer_pathtracer_tpu_torch import Renderer, RenderSettings
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.kernels import build
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms

    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    # 1. Card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    # 2. Build.
    t0 = time.perf_counter()
    lib = build.build("radiance", verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")

    # 3. Kernel vs plain.
    base = RenderSettings(use_cornell_box=True, has_hdr=False)
    cam = Camera.default(dev)
    for w, h, frames in ((256, 256, (1, 3)), (WIDTH, HEIGHT, (1,))):
        s = base.replace(width=w, height=h)
        scene = Scene.analytic(s, dev)
        for frame in frames:
            got = k1.render_pass_cuda(scene, s, cam, frame, 0.1, 3.0, 0)
            torch.cuda.synchronize()
            want = k1.render_pass_reference(scene, s, cam, frame, 0.1, 3.0, 0)
            max_err = _compare(f"K1 {w}x{h} frame {frame}", got, want,
                               depth_outliers=w == WIDTH)
    small = [Renderer(64, 32, settings=base, device=d).render_frames(2)
             for d in (dev, "cpu")]
    img_err = np.abs(small[0][0] - small[1][0])
    print(f"  Renderer 64x32 cuda vs cpu: {(img_err > 1e-3).mean():.4%} "
          f"pixels off by >1e-3, max {img_err.max():.4g}")
    assert (img_err > 1e-3).any(axis=-1).mean() <= 0.02
    assert img_err.mean() <= 2e-3

    # 4. Main path.
    k1.launch.count = 0
    r = Renderer(WIDTH, HEIGHT, settings=base, device=dev)
    assert r.settings.radiance_kernel == "cuda", r.settings.radiance_kernel
    r.render()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PASSES):
        img, depth = r.render()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / PASSES
    launches = k1.launch.count
    assert launches == PASSES + 1, f"K1 launched {launches} times"
    assert r.get_frame_count() == PASSES + 2
    assert img.shape == (HEIGHT, WIDTH, 3) and depth.shape == (HEIGHT, WIDTH)
    assert torch.isfinite(img).all() and torch.isfinite(depth).all()
    mean = img.mean().item()
    assert 0.2 < mean < 0.7, f"implausible Cornell image mean {mean}"
    rays = WIDTH * HEIGHT * base.samples_per_pass * base.bounces
    print(f"main path: {WIDTH}x{HEIGHT}, {base.samples_per_pass} spp, "
          f"{base.bounces} bounces: {wall * 1e3:.3f} ms/pass wall, "
          f"{rays / wall / 1e6:.1f} Mrays/s, image mean {mean:.4f}, "
          f"K1 launches {launches}")

    # 5. Times per pass at the main path's shape (CUDA events), in turns:
    # kernel, wrapper, plain, plain, wrapper, kernel.  The kernel alone runs
    # on tables packed once; the wrapper also packs them on every pass (a
    # few dozen small launches the host must enqueue).
    s = r.settings
    args = (r.scene, s, r.camera, 1, r.fresnel_coef, r.fresnel_pow, 0)
    tables = (k1.pack_camera(r.camera, s, r.fresnel_coef, r.fresnel_pow),
              k1.pack_spheres(r.scene.spheres), s, 1, 0)
    timed = {"kernel": lambda: k1.launch(*tables),
             "wrapper": lambda: k1.render_pass_cuda(*args),
             "plain": lambda: k1.render_pass_reference(*args)}
    iters = {"kernel": 50, "wrapper": 50, "plain": 5}
    t = {name: [] for name in timed}
    for name in ("kernel", "wrapper", "plain", "plain", "wrapper", "kernel"):
        t[name].append(cuda_time_ms(timed[name], dev, iters=iters[name]))
    ms, wrapper_ms, plain_ms = (sum(v) / len(v) for v in t.values())
    for name, v in t.items():
        print(f"{name}: {', '.join(f'{x:.4f}' for x in v)} ms/pass "
              f"({rays / (sum(v) / len(v)) / 1e3:.1f} Mrays/s)")
    print(f"K1 {ms:.4f} ms/pass, wrapper {wrapper_ms:.4f}, plain "
          f"{plain_ms:.4f}, {card}")

    print(json.dumps({"kernels": [{
        "name": "K1 radiance",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/radiance.cu",
        "replaces": "vrenderer_pathtracer_tpu/render/pallas_radiance.py:212",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
