"""Readings that set a cell's limits: the program's compared numbers on
many seeds, the lower-precision control's, and planted faults'.

    python3 benchmark/controls.py --workload <cell> --seeds 1 2 3 \\
        [--mode sound|control|<fault>] [--seconds 2]

``sound`` runs the cell as a benchmark run does (set-up, a short window,
the check) and prints the numbers; ``control`` puts the plain reference,
computed in bfloat16, in the program's place (the configurations state
float32); a fault name (``faults.FAULTS``) plants it in the program and
runs as ``sound`` does.  For a cell of several chips, ``sound`` and a
fault start one process a card for each seed, each planting the fault,
as ``run.py`` starts its ranks.  One JSON line per seed.  The benchmark's
own runs never run this; it needs a card, as they do.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults, harness  # noqa: E402


def reading(bench, cell, seed, mode, seconds, device, frames=1) -> dict:
    import torch

    run = harness.open_run(bench, cell, seed, seconds, False, device,
                           time.perf_counter())
    limits = harness.limits(run)
    t0 = time.perf_counter()
    if mode == "control":
        if run.traffic["loop"] == "render":
            run.loop.control(run, torch.bfloat16, frames)
        else:
            run.loop.control(run, torch.bfloat16)
    else:
        with faults.patcher() as patch:
            if mode != "sound":
                faults.FAULTS[mode](patch)
            run.loop.setup(run)
            harness.window(run, run.loop.body)
            run.loop.free(run)
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    run.loop.check(run, limits)
    return {"cell": cell, "seed": seed, "mode": mode,
            "seconds": time.perf_counter() - t0,
            "numbers": {k: v for k, (v, _) in run.checks.items()},
            "correct": harness.correct(run)}


def rank_reading(bench, cell, seed, mode, seconds, rank, port, device=None,
                 base=harness.HERE) -> dict:
    """This rank's part of a sound or faulted run of a cell of several
    chips (on card ``rank`` unless ``device`` is given); rank 0 returns
    the reading."""
    import torch

    from benchmark import run as runner

    chips = harness.cell_of(bench, cell)["chips"]
    if device is None:
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
    args = argparse.Namespace(workload=cell, seed=seed, seconds=seconds,
                              trace=0, rank=rank, port=port)
    t0 = time.perf_counter()
    with faults.patcher() as patch:
        if mode != "sound":
            faults.FAULTS[mode](patch)
        out = runner.run_cell(bench, args, device, chips, t0, base=base)
    if out is None:
        return None
    return {"cell": cell, "seed": seed, "mode": mode,
            "seconds": time.perf_counter() - t0,
            "numbers": {k: c["value"] for k, c in out["checks"].items()},
            "correct": out["correct"], "device": out["device"]}


def ranks(cell, seed, mode, seconds, chips) -> str:
    """One seed of a cell of several chips: a process a card; rank 0's
    reading line."""
    from benchmark import run as runner

    port = runner._free_port()
    cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
           "--workload", cell, "--mode", mode, "--seeds", str(seed),
           "--seconds", str(seconds), "--port", str(port)]
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], text=True,
                              stdout=subprocess.PIPE if r == 0 else None)
             for r in range(chips)]
    line = procs[0].communicate()[0]
    codes = [p.wait() for p in procs]
    if any(codes):
        raise RuntimeError(f"ranks exited {codes}")
    return line.strip().splitlines()[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/controls.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--mode", default="sound",
                    choices=["sound", "control", *faults.FAULTS])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--frames", type=int, default=1,
                    help="frames a control renders (render cells)")
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.spec()
    chips = harness.cell_of(bench, args.workload)["chips"]
    if args.rank >= 0:
        got = rank_reading(bench, args.workload, args.seeds[0], args.mode,
                           args.seconds, args.rank, args.port)
        if got is not None:
            print(json.dumps(got), flush=True)
        return 0
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        if chips > 1 and args.mode != "control":
            print(ranks(args.workload, seed, args.mode, args.seconds, chips),
                  flush=True)
            continue
        print(json.dumps(reading(bench, args.workload, seed, args.mode,
                                 args.seconds, device, args.frames)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
