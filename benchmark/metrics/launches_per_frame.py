"""Device operations (kernels, copies, fills) a frame, counted in the
traced window by the profiler."""


def read(run):
    frames = run.state.get("frames")
    if not frames or run.trace is None or not run.trace.ops:
        return None
    return len(run.trace.in_window()) / len(frames)
