"""Scaling harness: rays/s against the number of ranks (port of the
repository's ``bench_scaling.py``).

The measure is BASELINE's north star, rays/s scaling efficiency from one
device to many.  Each rank runs the port's sharded Cornell steps
(``parallel/sharding.py``: ``sharded_render_step``, and
``sharded_train_step`` for ``train``) on its tile of a ``(n, 1)`` mesh, in
strong scaling (a fixed frame) and weak scaling (``base_h`` rows a rank).
On cards a render step is K1 and a train step K2; CPU ranks run their
plain versions.  The ranks run on the card (``--device cuda``, the
default, which fails without one) unless ``--device cpu`` is given.  Two
ways to run it:

* default: for each count n, spawn n rank processes in a fresh gloo group
  (each with a time limit).  With ``--device cpu`` the ranks share one
  host's cores, so the "efficiency" bounds the sharding and collective
  overhead, not real scaling.  On the card every rank works on card 0:
  that checks the harness on a card, and says nothing of scaling across
  cards;
* ``--real``: the world this process was launched in, one rank a card
  over NCCL (``torchrun --nproc-per-node n``, or one process alone), one
  count a launch.  ``--records FILE`` keeps each launch's records, and the
  summary covers every count in the file.  ``--real --device cpu`` runs
  the same launch on gloo CPU ranks.

Output: one JSON line per (mode, train, n), then a summary with the
efficiency tables::

    python -m vrenderer_pathtracer_tpu_torch.bench_scaling --device cpu \\
        --counts 1,2,4
    for n in 1 2 4; do
        torchrun --nproc-per-node $n -m vrenderer_pathtracer_tpu_torch.bench_scaling \\
            --real --records scaling.jsonl
    done
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

CASES = (("strong", False), ("strong", True), ("weak", False), ("weak", True))
RANK_TIMEOUT_S = 600  # a spawned group's time limit

VIRTUAL_CAVEAT = (
    "gloo ranks on one host's CPU cores: this sweep validates the harness and "
    "bounds the sharding and collective overhead; real efficiency needs one "
    "card a rank (rerun with --real on the cards under torchrun)")
SHARED_CARD_CAVEAT = (
    "gloo ranks sharing one card: a harness check on the card, not scaling "
    "across cards (rerun with --real under torchrun on several cards)")


def _worker(n: int, mode: str, train: bool, width: int, base_h: int,
            spp: int, bounces: int, iters: int, device) -> dict:
    """One case in the current process group (its world is the ``n``
    ranks): its record, the same on every rank; ``pass_ms`` is the slowest
    rank's mean."""
    import torch
    import torch.distributed as dist

    from vrenderer_pathtracer_tpu_torch.config import RenderSettings
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.parallel import (
        TrainParams, make_render_mesh, replicate, shard_pixels,
        sharded_render_step, sharded_train_step)
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
    from vrenderer_pathtracer_tpu_torch.utils.profiling import synchronize

    if dist.get_world_size() != n:
        raise ValueError(f"{n} ranks wanted, the group has "
                         f"{dist.get_world_size()}")
    height = base_h * n if mode == "weak" else base_h
    settings = RenderSettings(
        width=width, height=height, samples_per_pass=spp, bounces=bounces,
        use_cornell_box=True, has_hdr=False)
    mesh = make_render_mesh(n_tiles=n, n_samples=1, device_type=device.type)
    scene = replicate(mesh, Scene.analytic(settings, device))
    camera = replicate(mesh, Camera.default(device))
    f32 = dict(dtype=torch.float32, device=device)
    zeros = shard_pixels(mesh, torch.zeros((settings.n_pixels, 3), **f32))

    if train:
        step = sharded_train_step(mesh, settings)
        params = TrainParams.from_scene(scene)

        def run(frame):
            nonlocal params
            params, loss = step(params, scene, camera, zeros, frame)
        ray_mult = 2  # forward + backward
    else:
        step = sharded_render_step(mesh, settings, scene=scene)
        fc, fp = torch.tensor(0.1, **f32), torch.tensor(3.0, **f32)
        accum = zeros

        def run(frame):
            nonlocal accum
            accum, _, _ = step(scene, camera, accum, frame, fc, fp)
        ray_mult = 1

    run(1)
    synchronize(device)
    dist.barrier()
    t0 = time.perf_counter()
    for i in range(iters):
        run(2 + i)
    synchronize(device)
    dt = torch.tensor((time.perf_counter() - t0) / iters, dtype=torch.float64,
                      device=device)
    dist.all_reduce(dt, op=dist.ReduceOp.MAX)
    dt = dt.item()
    rays = settings.n_pixels * spp * bounces * ray_mult
    return {
        "n_devices": n, "mode": mode, "train": train,
        "width": width, "height": height, "spp": spp, "bounces": bounces,
        "pass_ms": dt * 1e3, "mrays_per_s": rays / dt / 1e6,
        "platform": device.type, "backend": dist.get_backend(),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }


def _cases(n, args, device) -> list[dict]:
    return [_worker(n, mode, train, args.width, args.base_h, args.spp,
                    args.bounces, args.iters, device)
            for mode, train in CASES]


def _on_card(args) -> bool:
    """Whether the ranks run on the card (not ``--device cpu``); without a
    card that raises."""
    import torch

    if args.device == "cpu":
        return False
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available (pass --device cpu "
                           "to run the ranks on the CPU)")
    return True


def _rank_main(args) -> None:
    """A spawned rank (``--as-rank``): join the gloo group, run the cases,
    rank 0 prints a record a line."""
    import torch
    import torch.distributed as dist

    from vrenderer_pathtracer_tpu_torch.parallel import multihost

    device = torch.device("cpu")
    if _on_card(args):
        torch.cuda.set_device(0)
        device = torch.device("cuda", 0)
    multihost.initialize(args.init, args.world, args.rank, backend="gloo")
    try:
        recs = _cases(args.world, args, device)
    finally:
        dist.destroy_process_group()
    if args.rank == 0:
        for rec in recs:
            print(json.dumps(rec), flush=True)


def _spawn(n: int, args) -> list[dict]:
    """Run the cases on ``n`` spawned gloo ranks; rank 0's records.  The
    group is killed if it outlives ``RANK_TIMEOUT_S``."""
    root = pathlib.Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root),
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or 1) // n)))
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        env.pop(key, None)
    tail = ["--device", args.device, "--width", str(args.width),
            "--base-h", str(args.base_h), "--spp", str(args.spp),
            "--bounces", str(args.bounces), "--iters", str(args.iters)]
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "vrenderer_pathtracer_tpu_torch.bench_scaling",
             "--as-rank", "--init", f"file://{tmp}/store", "--world", str(n),
             "--rank", str(rank), *tail],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for rank in range(n)]
        deadline = time.monotonic() + RANK_TIMEOUT_S
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1)))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    for rank, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} of {n} failed:\n{err[-2000:]}")
    return [json.loads(line) for line in outs[0][0].strip().splitlines()]


def _real(args) -> list[dict] | None:
    """The cases on the world this process was launched in (``torchrun``'s,
    else one process): rank 0's records, None on the other ranks.  On
    cards the group is NCCL's, each rank on card ``LOCAL_RANK``."""
    import torch
    import torch.distributed as dist

    from vrenderer_pathtracer_tpu_torch.examples import process_group

    on_cpu = not _on_card(args)
    with process_group(on_cpu) as world:
        device = (torch.device("cpu") if on_cpu else
                  torch.device("cuda", torch.cuda.current_device()))
        recs = _cases(world, args, device)
        return recs if dist.get_rank() == 0 else None


def _merge_records(path: pathlib.Path, recs: list[dict]) -> list[dict]:
    """This launch's records with those an earlier launch kept in ``path``
    for other counts; the file is rewritten with all of them."""
    def sweep(r):
        base_h = r["height"] // (r["n_devices"] if r["mode"] == "weak" else 1)
        return (base_h, *(r[k] for k in ("width", "spp", "bounces",
                                          "platform", "backend", "device")))

    n = recs[0]["n_devices"]
    old = ([json.loads(line) for line in path.read_text().splitlines()]
           if path.exists() else [])
    for r in old:
        if sweep(r) != sweep(recs[0]):
            raise ValueError(f"{path} holds records of another sweep ({r}); "
                             "give another --records file")
    recs = sorted([r for r in old if r["n_devices"] != n] + recs,
                  key=lambda r: r["n_devices"])
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    return recs


def summarize(results: dict, counts, args) -> dict:
    """Add ``efficiency_pct`` to every record (strong: t1 / (n * tn); weak:
    t1 / tn, against the smallest count) and build the summary."""
    for mode_rows in results.values():
        mode_rows.sort(key=lambda r: r["n_devices"])
        t1 = mode_rows[0]["pass_ms"]
        mode = mode_rows[0]["mode"]
        for r in mode_rows:
            n, tn = r["n_devices"], r["pass_ms"]
            r["efficiency_pct"] = 100.0 * (
                t1 / (n * tn) if mode == "strong" else t1 / tn)
    shared_card = not args.real and args.device == "cuda"
    on_cpu = args.device == "cpu"
    return {
        "metric": "scaling_efficiency",
        "unit": "%",
        "counts": counts,
        "virtual_cpu_sweep": on_cpu,
        "harness_check": shared_card,
        "caveat": (VIRTUAL_CAVEAT if on_cpu else
                   SHARED_CARD_CAVEAT if shared_card else None),
        "tables": {
            k: [{kk: r[kk] for kk in
                 ("n_devices", "pass_ms", "mrays_per_s", "efficiency_pct")}
                for r in v]
            for k, v in results.items()
        },
    }


def _parser():
    ap = argparse.ArgumentParser(prog="bench_scaling")
    ap.add_argument("--counts", type=str, default="1,2,4",
                    help="the spawned sweep's rank counts")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cuda",
                    help="where the ranks run (default: the card; the "
                         "spawned ranks all on card 0, a harness check)")
    ap.add_argument("--real", action="store_true",
                    help="the launched world alone: one rank a card over "
                         "NCCL (torchrun --nproc-per-node n)")
    ap.add_argument("--records", default=None,
                    help="--real: a JSON-lines file that keeps each "
                         "launch's records; the summary covers them all")
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--base-h", type=int, default=None,
                    help="height (strong) and height a rank (weak); default "
                         "256")
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--iters", type=int, default=6)
    # A spawned rank's arguments.
    ap.add_argument("--as-rank", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--init", help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> dict | None:
    """Run the sweep; print and return the summary (None on the ranks of
    a ``torchrun`` launch other than 0)."""
    args = _parser().parse_args(argv)
    args.base_h = args.base_h or 256
    if args.as_rank:
        _rank_main(args)
        return None
    _on_card(args)  # fail before any rank starts
    if args.real:
        recs = _real(args)
        if recs is None:
            return None
        for rec in recs:
            print(json.dumps(rec), flush=True)
        if args.records:
            recs = _merge_records(pathlib.Path(args.records), recs)
    else:
        recs = []
        for n in (int(c) for c in args.counts.split(",")):
            got = _spawn(n, args)
            for rec in got:
                print(json.dumps(rec), flush=True)
            recs += got
    results = {}
    for rec in recs:
        key = f"{rec['mode']}{'_train' if rec['train'] else '_render'}"
        results.setdefault(key, []).append(rec)
    counts = sorted({rec["n_devices"] for rec in recs})
    summary = summarize(results, counts, args)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
