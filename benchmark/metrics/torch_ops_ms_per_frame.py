"""Device milliseconds a frame of every operation that is neither one of
the port's own kernels nor a collective: the wavefront's torch ops, the
accumulation, tonemap and FXAA, and the copies."""

from benchmark import roofline


def read(run):
    frames = run.state.get("frames")
    if not frames or run.trace is None or not run.trace.ops:
        return None
    s = sum(b - a for n, a, b in run.trace.in_window()
            if not roofline.is_port_kernel(n) and not roofline.is_collective(n))
    return s / len(frames) * 1e3
