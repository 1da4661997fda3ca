"""Millions of lanes a step whose gradient the backward pass scatters into
the trained tables: the program's gather counters
(``ops/brdf.py::lookup_brdf.grad_lanes``, the MERL table's, and
``ops/envmap.py::sample_env.grad_lanes``, the HDRI's) over the window,
summed; None where the program has neither."""


def read(run):
    steps = run.state.get("steps")
    lanes = [x for x in run.state.get("grad_lanes") or () if x is not None]
    if not steps or not lanes:
        return None
    return sum(lanes) / steps / 1e6
