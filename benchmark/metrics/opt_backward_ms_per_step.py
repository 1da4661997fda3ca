"""Host milliseconds a step inside the program's ``opt.backward`` range
(``parallel/sharding.py::_optimise``: the backward pass with its remat
recompute), summed over the traced window and taken a step; None where
the program has no such range."""


def read(run):
    steps = run.state.get("steps")
    if not steps or run.trace is None:
        return None
    tr = run.trace
    spans = [(max(a, tr.start), min(b, tr.end)) for name, a, b in tr.ranges
             if name == "opt.backward" and b > tr.start and a < tr.end]
    if not spans:
        return None
    return sum(b - a for a, b in spans) / steps * 1e3
