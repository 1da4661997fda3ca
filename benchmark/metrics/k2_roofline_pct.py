"""K2's share of its roofline: the least time of the work the window's
first step needs (``roofline.cornell_least_s`` over the plain reference's
count, at the parameters the reference reached after the checked steps)
over K2's device time for that step."""

import numpy as np

from benchmark import roofline
from benchmark.reference import views


def read(run):
    t = run.traffic
    ref = run.state.get("reference")
    if run.trace is None or ref is None:
        return None
    ops = run.trace.named(lambda n: roofline.kernel_is(n, "K2"))
    if len(ops) != run.state["steps"]:
        return None
    import torch

    p = [torch.as_tensor(np.asarray(x), dtype=torch.float32, device=run.device)
         for x in ref["params"][-1]]
    w = run.reference.work(run.cfg, views.camera({"kind": "drag", "dx": 0, "dy": 0}),
                           t["first_frame"] + t["check_steps"],
                           t["spp_per_pass"], t["width"], t["height"], run.seed,
                           run.device, fc=p[2], fp=p[3], color=p[0],
                           emission=p[1])
    return 100.0 * roofline.cornell_least_s(w, "k2") / (ops[0][2] - ops[0][1])
