"""Device milliseconds a frame of the collectives (NCCL kernels) on rank 0:
the gathers of the image and depth, and the scene's broadcast at each new
view."""

from benchmark import roofline


def read(run):
    frames = run.state.get("frames")
    if not frames or run.trace is None:
        return None
    ops = run.trace.named(roofline.is_collective)
    if not ops:
        return None
    return sum(b - a for _, a, b in ops) / len(frames) * 1e3
