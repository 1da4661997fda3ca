"""The training loop: inverse rendering, one optimiser step after another.

Set-up builds the configuration's training object (``scenes/<scene>.py``
``trainer``: the true scene and its target, the trainable parameters, the
optimiser and its step) and drives it through its first ``check_steps``
steps, each on a new frame, as the window's own calls; those steps also
load every kernel.  The window goes on from there with the same object,
copying the loss to the host every ``loss_every`` steps, as a training
loop logs it.

End to end: ``train_step_ms``, the window's seconds over the steps it
completed (the window ends with a synchronize).

``correct``: the plain reference follows the first steps from the same
start and target inputs; compared are each step's loss, the norm of each
parameter leaf's first gradient as the optimiser took it, and of each
leaf's change over the steps, by the worst leaf (``_gap``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import harness


def setup(run):
    t = run.traffic
    harness.note(run, "imports done")
    tr = run.scene.trainer(run)
    harness.note(run, "trainer built")
    st = run.state
    st["trainer"] = tr
    st["p0"] = tr.leaves()
    st["losses"] = []
    for i in range(t["check_steps"]):
        m = tr.step(t["first_frame"] + i)
        st["losses"].append(float(m["loss"].item()))
        if i == 0:
            st["g1"] = tr.first_grads()
    st["p_end"] = tr.leaves()
    st["frame"] = t["first_frame"] + t["check_steps"]
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    harness.note(run, "first steps done")


def body(run):
    st = run.state
    tr = st["trainer"]
    every = run.traffic["loss_every"]
    host, n = [], 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < run.seconds:
        a = time.perf_counter()
        with torch.profiler.record_function("step.dispatch"):
            m = tr.step(st["frame"])
        host.append(time.perf_counter() - a)
        st["frame"] += 1
        n += 1
        if n % every == 0:
            with torch.profiler.record_function("step.loss_read"):
                m["loss"].item()
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    st.update(t0=t0, t1=time.perf_counter(), steps=n, host=host)


def results(run) -> dict:
    st = run.state
    return {"train_step_ms": (st["t1"] - st["t0"]) / st["steps"] * 1e3}


def attempted(run) -> int:
    return run.state["steps"]


def free(run):
    run.state.pop("trainer", None)


def _gap(got, want, skip=()) -> float:
    """The worst leaf's |norm(got) - norm(want)| over the larger of
    norm(want) and the median leaf's norm(want)."""
    ng = [float(np.linalg.norm(g)) for g in got]
    nw = [float(np.linalg.norm(w)) for w in want]
    med = float(np.median(nw))
    return max(abs(a - b) / max(b, med, 1e-30)
               for i, (a, b) in enumerate(zip(ng, nw)) if i not in skip)


def reference_steps(run, dtype=torch.float32) -> dict:
    t = run.traffic
    truth, start = run.reference.train_inputs(run.cfg, run.seed)
    return run.reference.train(
        run.cfg, truth, start,
        frames=[t["first_frame"] + i for i in range(t["check_steps"])],
        target_frames=range(1, t["target_passes"] + 1), lr=t["lr"],
        spp=t["spp_per_pass"], width=t["width"], height=t["height"],
        seed=run.seed, device=run.device, dtype=dtype)


def compare(run, ref: dict, got: dict) -> dict:
    """The compared numbers of ``got`` (losses, g1, p0, p_end) against the
    reference's steps.  Leaves whose reference gradient is under a
    thousandth of the median leaf's move by round-off alone under Adam,
    and are left out of the change."""
    g_ref = ref["grads"]
    norms = [float(np.linalg.norm(g)) for g in g_ref]
    med = float(np.median(norms))
    still = {i for i, x in enumerate(norms) if x < 1e-3 * med}
    d_ref = [a - b for a, b in zip(ref["params"][-1], got["p0"])]
    d_got = [a - b for a, b in zip(got["p_end"], got["p0"])]
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["loss"]))
    return {"loss_gap": loss, "grad_gap": _gap(got["g1"], g_ref),
            "step_gap": _gap(d_got, d_ref, skip=still)}


def check(run, limits: dict):
    ref = reference_steps(run)
    run.state["reference"] = ref
    got = compare(run, ref, run.state)
    run.checks = {k: (v, limits[k]) for k, v in got.items()}


def control(run, dtype):
    """The reference computed in ``dtype``, standing in the program's
    place: its losses, first gradients and changes become what
    :func:`compare` judges."""
    c = reference_steps(run, dtype)
    truth, start = run.reference.train_inputs(run.cfg, run.seed)
    p0 = [np.asarray(start[k], np.float64) for k in
          ("color", "emission", "fresnel_coef", "fresnel_pow")]
    run.state.update(losses=c["loss"], g1=c["grads"], p0=p0,
                     p_end=c["params"][-1])
