"""K1's share of its roofline: the least time of the work a pass's inputs
need (``roofline.cornell_least_s`` over the plain reference's count of
that pass) over K1's device time for the pass, summed over two passes of
the window drawn from the seed.  The n-th K1 launch of the window is its
n-th pass."""

import numpy as np

from benchmark import roofline
from benchmark.reference import views


def read(run):
    t = run.traffic
    frames = run.state.get("frames")
    if not frames or run.trace is None:
        return None
    ops = run.trace.named(lambda n: roofline.kernel_is(n, "K1"))
    ppf = t["passes_per_frame"]
    if len(ops) != len(frames) * ppf:
        return None
    rng = np.random.default_rng([run.seed & 0xFFFFFFFFFFFFFFFF, 11])
    least = spent = 0.0
    fpv = t["frames_per_view"]
    for j in rng.choice(len(ops), size=min(2, len(ops)), replace=False):
        i = int(j) // ppf
        view = views.camera(views.spec(t["views"], run.seed, i // fpv))
        frame = (i % fpv) * ppf + int(j) % ppf + 1
        w = run.reference.work(run.cfg, view, frame, t["spp_per_pass"],
                               t["width"], t["height"], run.seed, run.device)
        least += roofline.cornell_least_s(w, "k1")
        spent += ops[int(j)][2] - ops[int(j)][1]
    return 100.0 * least / spent
