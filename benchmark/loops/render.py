"""The render loop: one client in a closed loop asks for frames.

A frame is ``passes_per_frame`` passes of the ``Renderer`` and then its
displayed image and depth copied to the client's host buffers.  Every
``frames_per_view`` frames the client moves the camera to the next view
of the traffic's ``views`` (which clears the accumulation), so the n-th
frame of a view shows ``n * passes_per_frame`` passes.  A frame's latency
runs from the client asking for it until its image and depth are on the
host.

With ``tiles`` > 1 the renderer is sharded over that many ranks, one card
each, in row bands; every rank runs the loop and rank 0 copies the frame.

End to end: ``mrays_per_s`` (pixels x spp x bounces of every pass of the
window over the window's seconds) and ``frame_ms_p95``.

``correct``: a sample of the window's frames, drawn from the seed, is
rendered again by the configuration's plain reference (the whole frame,
or blocks of it drawn from the seed: one at least in each rank's band,
and where the traffic asks, centred on the mesh) and compared element by
element: the share of image values off by more than ``image_tol`` and of
depth values off by more than ``depth_tol`` must stay under the cell's
limits (``benchmark/limits/<cell>.json``).
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import views


def _frame_rays(run) -> int:
    t = run.traffic
    return (t["width"] * t["height"] * t["spp_per_pass"] * run.cfg["bounces"]
            * t["passes_per_frame"])


def setup(run):
    harness.note(run, "imports done")
    r = run.scene.renderer(run)
    harness.note(run, "renderer built")
    run.state["renderer"] = r
    # Warm up: the first view's first two frames, every kernel and shape
    # the window uses.
    for i in range(2):
        _frame(run, i, keep=False)
    if r.device.type == "cuda":
        torch.cuda.synchronize(r.device)
    harness.note(run, "warmed up")
    run.state.update(frames=[], kept=[], seen=0,
                     pick=random.Random(f"{run.seed}:frames"))


def _frame(run, i: int, keep: bool = True):
    """Frame ``i`` of the loop: (t_start, t_dispatched, t_done)."""
    t = run.traffic
    r = run.state["renderer"]
    fpv = t["frames_per_view"]
    ts = time.perf_counter()
    if i % fpv == 0:
        with torch.profiler.record_function("frame.view"):
            run.scene.apply_view(run, r, views.spec(t["views"], run.seed,
                                                    i // fpv))
    with torch.profiler.record_function("frame.dispatch"):
        for _ in range(t["passes_per_frame"]):
            img, depth = r.render()
    td = time.perf_counter()
    if run.main:
        with torch.profiler.record_function("frame.copy"):
            img_h, depth_h = _to_host(run, img, depth)
    te = time.perf_counter()
    if run.main and keep:
        _reservoir(run, i, img_h, depth_h)
    return ts, td, te


def _to_host(run, img, depth):
    """The frame's image and depth copied into the client's own host
    buffers (page-locked on the card, as a viewer keeps them; made at the
    first frame, which is a warm-up frame), as numpy views."""
    bufs = run.state.get("host")
    if bufs is None:
        pin = img.device.type == "cuda"
        bufs = run.state["host"] = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
            for t in (img, depth))
    bufs[0].copy_(img)
    bufs[1].copy_(depth)
    return bufs[0].numpy(), bufs[1].numpy()


def _reservoir(run, i, img, depth):
    """Keep ``check.frames`` frames, each frame of the window equally
    likely (algorithm R, seeded); a kept frame is copied out of the
    client's buffers."""
    t = run.traffic
    st = run.state
    k = t["check"]["frames"]
    st["seen"] += 1
    j = len(st["kept"]) if len(st["kept"]) < k else st["pick"].randrange(st["seen"])
    if j >= k:
        return
    fpv = t["frames_per_view"]
    item = (i, views.spec(t["views"], run.seed, i // fpv),
            (i % fpv + 1) * t["passes_per_frame"], img.copy(), depth.copy())
    if j == len(st["kept"]):
        st["kept"].append(item)
    else:
        st["kept"][j] = item


def body(run):
    st = run.state
    t0 = time.perf_counter()
    i = 0
    while not harness.stop_together(run, time.perf_counter() - t0 >= run.seconds):
        st["frames"].append(_frame(run, i))
        i += 1
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    st["t0"], st["t1"] = t0, time.perf_counter()


def results(run) -> dict:
    st = run.state
    n = len(st["frames"])
    return {"mrays_per_s": n * _frame_rays(run) / (st["t1"] - st["t0"]) / 1e6,
            "frame_ms_p95": harness.p95([(te - ts) * 1e3
                                         for ts, _, te in st["frames"]])}


def attempted(run) -> int:
    return len(run.state["frames"])


def free(run):
    run.state.pop("renderer", None)
    run.state.pop("host", None)


def _bands(t) -> list:
    """(first, last + 1) of the whole rows of each rank's band: a band is
    the rank's share of the frame's pixels, in order (the program's
    ``--tiles`` split)."""
    n, w, tiles = t["width"] * t["height"], t["width"], t.get("tiles", 1)
    return [(-(-(k * n // tiles) // w), (k + 1) * n // tiles // w)
            for k in range(tiles)]


def blocks(run, view: dict) -> list:
    """(y0, x0, h, w) of the blocks compared in a frame of ``view``: the
    whole frame, or squares of ``region`` pixels drawn from the seed, at
    least ``regions`` and at least one inside each band.  The first
    ``on_mesh`` of them are centred where the reference's primary rays hit
    the mesh, where the band has such a place."""
    t = run.traffic
    c = t["check"]
    if not c.get("region"):
        return [(0, 0, t["height"], t["width"])]
    s, step = c["region"], 8    # block corners on an 8-pixel grid
    bands = _bands(t)
    rng = np.random.default_rng([run.seed & 0xFFFFFFFFFFFFFFFF, 7])
    hit = None
    if c.get("on_mesh"):
        ys = np.arange(0, t["height"] - s + 1, step)
        xs = np.arange(0, t["width"] - s + 1, step)
        cy, cx = np.meshgrid(ys + s // 2, xs + s // 2, indexing="ij")
        pix = torch.as_tensor((cy * t["width"] + cx).reshape(-1))
        hit = run.reference.primary_mesh_hits(
            run.cfg, t, run.seed, views.camera(view), pix,
            run.device).reshape(len(ys), len(xs)).cpu().numpy()
    out = []
    for i in range(max(c["regions"], len(bands))):
        b0, b1 = bands[i % len(bands)]
        if hit is not None and i < c["on_mesh"]:
            rows = (ys >= b0) & (ys + s <= b1)
            cand = np.argwhere(hit & rows[:, None])
            if len(cand):
                iy, ix = cand[int(rng.integers(len(cand)))]
                out.append((int(ys[iy]), int(xs[ix]), s, s))
                continue
        out.append((int(rng.integers(b0, b1 - s + 1)),
                    int(rng.integers(0, t["width"] - s + 1)), s, s))
    return out


def compare(run, dtype=torch.float32) -> dict:
    """The compared numbers of the kept frames against the reference
    computed in ``dtype``: the largest share over the frames."""
    t = run.traffic
    c = t["check"]
    out = {"image_off_share": 0.0, "depth_off_share": 0.0}
    for _, view, passes, img, depth in run.state["kept"]:
        bl = blocks(run, view)
        ref = run.reference.frame(run.cfg, t, run.seed, views.camera(view),
                                  passes, bl, run.device, dtype)
        for (y0, x0, h, w), (ri, rd) in zip(bl, ref):
            gi = img[y0:y0 + h, x0:x0 + w]
            gd = depth[y0:y0 + h, x0:x0 + w]
            ok_i = np.abs(gi - ri.numpy()) <= c["image_tol"]
            ok_d = np.abs(gd - rd.numpy()) <= c["depth_tol"]
            out["image_off_share"] = max(out["image_off_share"],
                                         1.0 - float(ok_i.mean()))
            out["depth_off_share"] = max(out["depth_off_share"],
                                         1.0 - float(ok_d.mean()))
    return out


def check(run, limits: dict):
    got = compare(run)
    run.checks = {k: (v, limits[k]) for k, v in got.items()}


def control(run, dtype, n_frames: int, view_index: int = 0):
    """Stand the reference computed in ``dtype`` in the program's place:
    ``n_frames`` frames of view ``view_index`` (seeded pass counts within
    the view), over the compared blocks, become the kept frames that
    :func:`compare` judges."""
    t = run.traffic
    fpv = t["frames_per_view"]
    rng = np.random.default_rng([run.seed & 0xFFFFFFFFFFFFFFFF, 9])
    view = views.spec(t["views"], run.seed, view_index)
    bl = blocks(run, view)
    run.state["kept"] = []
    for _ in range(n_frames):
        passes = (int(rng.integers(0, fpv)) + 1) * t["passes_per_frame"]
        img = np.full((t["height"], t["width"], 3), np.nan, np.float32)
        depth = np.full((t["height"], t["width"]), np.nan, np.float32)
        got = run.reference.frame(run.cfg, t, run.seed, views.camera(view),
                                  passes, bl, run.device, dtype)
        for (y0, x0, h, w), (gi, gd) in zip(bl, got):
            img[y0:y0 + h, x0:x0 + w] = gi.numpy()
            depth[y0:y0 + h, x0:x0 + w] = gd.numpy()
        run.state["kept"].append((0, view, passes, img, depth))
