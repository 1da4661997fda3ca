"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the card, the kernels' libraries from the checkout's
build directory, the scene and its warm-up), then a window of
``--seconds`` seconds, then the check of what the window produced against
the plain reference.  With ``--trace 0`` the line holds the cell's
end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the line holds the per-layer metrics, the device's
busy and window seconds and a breakdown.  The compared numbers and their
limits end the standard error and the line (``checks``).

A cell of several chips starts its other ranks itself, one process a card
(NCCL, on a free localhost port); rank 0 prints the line.  Without enough
cards the run fails; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

CACHE = ROOT / "benchmark" / ".cache"


def _parser():
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # The other ranks of a cell of several chips (started by rank 0).
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _card() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""


def _metric(entries, values) -> dict:
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in entries if values.get(m["name"]) is not None}


def run_cell(bench, args, device, world: int, t_start: float,
             base=harness.HERE):
    """Set-up, window and check of one cell on this rank; returns the
    result line's dict on rank 0 (None on the others).  ``base``: the
    benchmark's directory (its files are found there by name)."""
    import torch

    run = harness.open_run(bench, args.workload, args.seed, args.seconds,
                           bool(args.trace), device, t_start, base=base,
                           rank=args.rank, world=world)
    on_card = device.type == "cuda"
    if world > 1:
        import torch.distributed as dist

        from vrenderer_pathtracer_tpu_torch.parallel import multihost

        os.environ["LOCAL_RANK"] = str(args.rank)
        multihost.initialize(f"tcp://localhost:{args.port}", world, args.rank)
        run.control_group = dist.new_group(backend="gloo")
    limits = harness.limits(run)

    run.loop.setup(run)
    run.setup_s = time.perf_counter() - t_start
    t_window = time.perf_counter()
    harness.window(run, run.loop.body)
    t_after = time.perf_counter()
    e2e = run.loop.results(run)
    e2e["setup_s"] = run.setup_s
    peak = torch.tensor([torch.cuda.max_memory_allocated(device)
                         if on_card else 0], dtype=torch.float64)
    busy = torch.tensor([run.trace.busy_s() if run.trace else 0.0],
                        dtype=torch.float64)
    if world > 1:
        import torch.distributed as dist

        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=run.control_group)
        dist.all_reduce(busy, group=run.control_group)
    attempted = run.loop.attempted(run)
    run.loop.free(run)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    if world > 1:
        import torch.distributed as dist

        dist.barrier(group=run.control_group)
        dist.destroy_process_group()
    if not run.main:
        return None

    run.loop.check(run, limits)
    t_checked = time.perf_counter()
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": world, "memory_peak_bytes": int(peak.item())}
    out = {"correct": harness.correct(run), "attempted": attempted,
           "failed": 0}
    if run.traced:
        values = {}
        for m in harness.metrics_of(bench, args.workload, "per_layer"):
            values[m["name"]] = harness.module("metrics", m["name"],
                                               base).read(run)
        out["metrics"] = _metric(harness.metrics_of(bench, args.workload,
                                                     "per_layer"), values)
        dev.update(busy_s=busy.item() / world, window_s=run.trace.window_s)
        out["device"] = dev
        out["breakdown"] = run.trace.breakdown()
    else:
        out["metrics"] = _metric(harness.metrics_of(bench, args.workload,
                                                     "end_to_end"), e2e)
        out["device"] = dev
    out["card"] = _card() if on_card else ""
    print(f"benchmark: set-up {run.setup_s:.2f} s, window and its trace "
          f"{t_after - t_window:.2f} s, check {t_checked - t_after:.2f} s, "
          f"per-layer readers {time.perf_counter() - t_checked:.2f} s",
          file=sys.stderr)
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    bench = harness.spec()
    cell = harness.cell_of(bench, args.workload)
    chips = cell["chips"]

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {chips} CUDA card(s), this "
              f"machine has {have}", file=sys.stderr)
        return 2
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    device = torch.device("cuda", args.rank)
    torch.cuda.set_device(device)

    children = []
    if chips > 1 and args.rank == 0:
        args.port = _free_port()
        for r in range(1, chips):
            cmd = [sys.executable, str(pathlib.Path(__file__).resolve()),
                   "--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", str(args.trace),
                   "--rank", str(r), "--port", str(args.port)]
            children.append(subprocess.Popen(cmd))
    try:
        out = run_cell(bench, args, device, chips, T_START)
    except BaseException:
        for c in children:
            c.kill()
        raise
    finally:
        codes = [c.wait() for c in children]
    if any(codes):
        print(f"benchmark: ranks exited {codes}", file=sys.stderr)
        return 1
    if out is None:
        return 0
    bad = harness.forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}", file=sys.stderr)
        return 1
    for k, c in out["checks"].items():
        print(f"check {k}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
