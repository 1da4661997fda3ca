"""Device operations (kernels, copies, fills) a training step, counted in
the traced window by the profiler."""


def read(run):
    steps = run.state.get("steps")
    if not steps or run.trace is None or not run.trace.ops:
        return None
    return len(run.trace.in_window()) / steps
