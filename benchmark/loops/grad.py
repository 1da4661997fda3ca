"""The inverse-rendering loop of a table-valued scene: one Adam step after
another on the HDRI and the MERL table, each step one pass of a new frame
from the next of the traffic's views.

Set-up builds the configuration's training object (``scenes/<scene>.py``
``trainer``: the scene, each view's target, the tables, Adam and
``deferred_opt_step``) and drives it through its first ``check_steps``
steps, as the window's own calls, keeping each step's loss, the gradients
Adam took and the tables; those steps also load every kernel.  The window
goes on from there, copying the loss to the host every ``loss_every``
steps, as a training loop logs it, and ends with a synchronize.  The host
seconds of each step's call and the trained tables' gather counters of
the program (``lookup_brdf.grad_lanes``, ``sample_env.grad_lanes``; None
where the program has none) are kept in ``run.state``.

End to end: ``mrays_per_s``, the forward rays of every step of the window
(pixels x spp x bounces, the repository's "Mrays/s/chip fwd+bwd") over the
window's seconds.

``correct`` (limits in ``benchmark/limits/<cell>.json``): the plain
reference renders two blocks of the first step's target (one on the mesh,
one anywhere: ``render.blocks``) and follows the first steps from the same
start with the program's targets, the whole frame in row blocks.  Compared:

* ``target_off_share``: the share of the blocks' displayed target values
  off by more than ``image_tol``;
* ``loss_gap``: the largest relative gap of the steps' losses;
* ``grad_err``: the worst of ``|g - g_ref| / |g_ref|`` (L2 norms over every
  entry) over the trained tables and the steps, the gradients as Adam took
  them;
* ``step_err``: the same measure of the tables' change over the steps, on
  the entries where each step's reference gradient is either 0 or at least
  ``step_floor`` times that step's largest (Adam's first steps move an
  entry by about ``lr`` whatever its gradient's size, so round-off flips
  the sign of an entry whose gradient is near 0).
"""

from __future__ import annotations

import time

import torch

from benchmark import harness
from benchmark.loops import render
from benchmark.reference import views


def _counters() -> list:
    """The program's trained-table gather counters (MERL, HDRI), None for
    one it does not have."""
    from vrenderer_pathtracer_tpu_torch.ops import brdf, envmap

    return [getattr(getattr(m, fn, None), "grad_lanes", None)
            for m, fn in ((brdf, "lookup_brdf"), (envmap, "sample_env"))]


def _step(run, i: int):
    st = run.state
    m = st["trainer"].step(i, run.traffic["first_frame"] + i)
    st["i"] = i + 1
    return m


def _shown_blocks(run, target) -> list:
    """((y0, x0, h, w), displayed [h, w, 3] on the host) of each compared
    block of the first step's view's ``target`` (linear rgb [N, 3]),
    tonemapped by the program as one frame."""
    from vrenderer_pathtracer_tpu_torch.ops.tonemap import tonemap

    t = run.traffic
    view = views.spec(t["views"], run.seed, run.state["views"][0])
    img = target.reshape(t["height"], t["width"], 3)
    return [((y0, x0, h, w),
             tonemap(img[y0:y0 + h, x0:x0 + w].reshape(-1, 3), 1)
             .reshape(h, w, 3).float().cpu())
            for y0, x0, h, w in render.blocks(run, view)]


def setup(run):
    t = run.traffic
    harness.note(run, "imports done")
    tr = run.scene.trainer(run)
    harness.note(run, "trainer built")
    st = run.state
    st.update(trainer=tr, i=0, losses=[], grads=[], params=[tr.leaves()])
    for i in range(t["check_steps"]):
        m = _step(run, i)
        st["losses"].append(float(m["loss"].item()))
        st["grads"].append(tr.grads())
        st["params"].append(tr.leaves())
    st["views"] = [tr.view_of(i) for i in range(t["check_steps"])]
    st["target_blocks"] = _shown_blocks(run, tr.targets[st["views"][0]])
    # The targets stay on the device for the check (the reference's steps
    # take them as their inputs).
    st["targets"] = [tr.targets[k] for k in st["views"]]
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    harness.note(run, "first steps done")


def body(run):
    st = run.state
    every = run.traffic["loss_every"]
    host, n = [], 0
    lanes0 = _counters()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        a = time.perf_counter()
        with torch.profiler.record_function("step.dispatch"):
            m = _step(run, st["i"])
        host.append(time.perf_counter() - a)
        n += 1
        if n % every == 0:
            with torch.profiler.record_function("step.loss_read"):
                m["loss"].item()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    st.update(t0=t0, t1=time.perf_counter(), steps=n, host=host,
              grad_lanes=[None if a is None else b - a
                          for a, b in zip(lanes0, _counters())])


def _step_rays(run) -> int:
    t = run.traffic
    return t["width"] * t["height"] * t["spp_per_pass"] * run.cfg["bounces"]


def results(run) -> dict:
    st = run.state
    return {"mrays_per_s": st["steps"] * _step_rays(run)
            / (st["t1"] - st["t0"]) / 1e6}


def attempted(run) -> int:
    return run.state["steps"]


def free(run):
    run.state.pop("trainer", None)


def _err(got, want, mask=None) -> float:
    """|got - want| / |want| over the entries (of ``mask``)."""
    d = got.double() - want.double()
    w = want.double()
    if mask is not None:
        d, w = d[mask], w[mask]
    return float(torch.linalg.norm(d) / max(float(torch.linalg.norm(w)),
                                            1e-30))


def reference_steps(run, dtype=torch.float32) -> dict:
    t, st = run.traffic, run.state
    n = t["check_steps"]
    cams = [views.camera(views.spec(t["views"], run.seed, k))
            for k in st["views"]]
    return run.reference.train(
        run.cfg, t, run.seed, cams, [t["first_frame"] + i for i in range(n)],
        st["targets"], run.device, dtype,
        block_lanes=t["check"]["block_lanes"])


def reference_targets(run, dtype=torch.float32) -> list:
    t, st = run.traffic, run.state
    view = views.camera(views.spec(t["views"], run.seed, st["views"][0]))
    blocks = [b for b, _ in st["target_blocks"]]
    return run.reference.target_blocks(run.cfg, t, run.seed, view, blocks,
                                       run.device, dtype)


def compare(run, ref: dict, ref_blocks: list, got: dict,
            limits: dict) -> dict:
    """The compared numbers of ``got`` (target blocks, losses, grads,
    params) against the reference's."""
    tol = run.traffic["check"]["image_tol"]
    off = 0.0
    for (_, shown), rb in zip(got["target_blocks"], ref_blocks):
        off = max(off, 1.0 - float(((shown - rb).abs() <= tol)
                                   .double().mean()))
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["loss"]))
    grad = max(_err(g, w) for gs, ws in zip(got["grads"], ref["grads"])
               for g, w in zip(gs, ws))
    floor = limits["step_floor"]
    step = 0.0
    for leaf in range(len(got["params"][0])):
        keep = None
        for ws in ref["grads"]:
            w = ws[leaf].abs()
            k = (w == 0) | (w >= floor * float(w.max()))
            keep = k if keep is None else keep & k
        p0 = got["params"][0][leaf]
        step = max(step, _err(got["params"][-1][leaf] - p0,
                              ref["params"][-1][leaf] - p0, keep))
    return {"target_off_share": off, "loss_gap": loss, "grad_err": grad,
            "step_err": step}


def check(run, limits: dict):
    ref = reference_steps(run)
    ref_blocks = reference_targets(run)
    got = compare(run, ref, ref_blocks, run.state, limits)
    run.checks = {k: (v, limits[k]) for k, v in got.items()}


def control(run, dtype):
    """The reference computed in ``dtype`` in the program's place: its
    target blocks, losses, gradients and tables become what
    :func:`compare` judges.  The steps' inputs, the targets, are the
    program's (its set-up renders them; no step is taken)."""
    t = run.traffic
    st = run.state
    tr = run.scene.trainer(run)
    n = t["check_steps"]
    st["views"] = [tr.view_of(i) for i in range(n)]
    st["targets"] = [tr.targets[k] for k in st["views"]]
    p0 = tr.leaves()
    st["target_blocks"] = _shown_blocks(run, st["targets"][0])
    del tr
    c = reference_steps(run, dtype)
    shown = reference_targets(run, dtype)
    st["target_blocks"] = [(b, x) for (b, _), x in
                           zip(st["target_blocks"], shown)]
    st.update(losses=c["loss"], grads=c["grads"],
              params=[p0] + c["params"])
