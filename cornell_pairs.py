"""Cornell wall time of two checkouts of the port, in alternating pairs on
one card.

    python3 cornell_pairs.py OTHER [--pairs 10]

OTHER is another checkout of the repository (an earlier commit unpacked
with ``git archive`` into a git-ignored directory such as ``.chipwork/``).
For each pair the script runs, in a fresh process each, the Cornell
``Renderer`` pass and the ``train_step`` (SGD) step at 1024x1024, 2 spp, 4
bounces from this checkout and from OTHER; the side that runs first
alternates from pair to pair.  A run times ``BATCHES`` batches of ``ITERS``
calls on the host clock, each ending in ``torch.cuda.synchronize``, and
reports their median.  The script prints every run, then per metric both
sides' medians over the pairs, OTHER's interquartile range and the pairs
this checkout won; the card's name and power limit come first.  Without a
CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

BATCHES, ITERS = 5, 40
METRICS = ("pass_ms", "step_ms")


def measure() -> dict:
    """One side's run, in the current directory's checkout."""
    sys.path.insert(0, os.getcwd())
    import torch

    from vrenderer_pathtracer_tpu_torch import (
        Renderer, RenderSettings, TrainParams, train_step)
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

    dev = torch.device("cuda")
    r = Renderer(1024, 1024, settings=RenderSettings(use_cornell_box=True,
                                                     has_hdr=False))
    s = r.settings
    scene, cam = Scene.analytic(s, dev), Camera.default(dev)
    bright = scene.spheres.emission.clone()
    bright[0] *= 1.5
    target, _ = k1.render_pass_cuda(scene.replace_spheres(emission=bright), s,
                                    cam, 1, 0.1, 3.0)
    sgd = train_step(s)
    params = [TrainParams.from_scene(scene)]

    def step():
        params[0] = sgd(params[0], scene, cam, target, 1)[0]

    def batch(fn):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / ITERS * 1e3

    runs = {"pass_ms": [], "step_ms": []}
    for _ in range(BATCHES):
        runs["pass_ms"].append(batch(r.render))
        runs["step_ms"].append(batch(step))
    return {k: statistics.median(v) for k, v in runs.items()}


def run_side(tree: str) -> dict:
    out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child"],
                         cwd=tree, capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="the other checkout's directory")
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("cornell_pairs: no CUDA device", file=sys.stderr)
        return 1
    if args.child:
        print(json.dumps(measure()))
        return 0
    if not args.other:
        ap.error("the other checkout's directory is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    here = os.path.dirname(os.path.abspath(__file__))
    sides = {"this": here, "other": os.path.abspath(args.other)}
    got = {"this": [], "other": []}
    for i in range(args.pairs):
        order = ("other", "this") if i % 2 == 0 else ("this", "other")
        for side in order:
            got[side].append(run_side(sides[side]))
            print(f"pair {i} {side}: {json.dumps(got[side][-1])}", flush=True)
    for m in METRICS:
        this = [g[m] for g in got["this"]]
        other = [g[m] for g in got["other"]]
        q = statistics.quantiles(other, n=4)
        wins = sum(t < o for t, o in zip(this, other))
        print(f"{m}: this median {statistics.median(this):.4f}, other median "
              f"{statistics.median(other):.4f} (interquartile {q[0]:.4f}-"
              f"{q[2]:.4f}), this faster in {wins} of {args.pairs} pairs")
    return 0


if __name__ == "__main__":
    sys.exit(main())
