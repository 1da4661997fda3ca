"""K5's share of its roofline, bytes only: every ray of every search wave
read once and its hit written once, and the triangles read once a wave
(``roofline.search_bytes``), over K5's device time in the window.

A pass searches its primary rays (this rank's pixels times the samples),
then, at each later bounce, the lanes whose primary ray hit something
(the compact wave), whether still alive or not.  The plain reference
counts those hits for each view of the window."""

from benchmark import roofline
from benchmark.reference import views


def read(run):
    t = run.traffic
    frames = run.state.get("frames")
    if not frames or run.trace is None:
        return None
    ops = run.trace.named(lambda n: roofline.kernel_is(n, "K5"))
    bounces, spp = run.cfg["bounces"], t["spp_per_pass"]
    fpv, ppf = t["frames_per_view"], t["passes_per_frame"]
    if not ops or len(ops) != len(frames) * ppf * bounces:
        return None
    sc = run.reference.scene_of(run)
    rows = t["height"] // t.get("tiles", 1)
    band = (run.rank * rows, (run.rank + 1) * rows)
    n_bytes = 0
    for v in range(-(-len(frames) // fpv)):
        passes = min(fpv, len(frames) - v * fpv) * ppf
        cam = views.camera(views.spec(t["views"], run.seed, v))
        hits = run.reference.primary_hits(sc, cam, t["width"], t["height"],
                                          band=band)
        waves = [rows * t["width"] * spp] + [hits * spp] * (bounces - 1)
        n_bytes += passes * roofline.search_bytes(waves, sc.mesh.n_tris)
    spent = sum(b - a for _, a, b in ops)
    return 100.0 * n_bytes / roofline.HBM_BYTES_PER_S / spent
