"""What every cell's run shares: finding the cell's files by name, the
run's state, the timed window and its trace, and the result line.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a traffic mix.  The configuration is
``benchmark/configs/<config>.json``: its sizes, the scene builder that
makes it in the program (``benchmark/scenes/<scene>.py``) and its plain
reference (``benchmark/reference/<reference>.py``).  The traffic mix is
``benchmark/traffic/<traffic>.json``: the loop that drives the window
(``benchmark/loops/<loop>.py``) and its parameters.  A per-layer metric
``<name>`` is read by ``benchmark/metrics/<name>.py``.  New cells,
configurations, mixes and metrics are new files; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import statistics
import sys
import time
from dataclasses import dataclass, field
from typing import Any

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "vrenderer_pathtracer_tpu")


def load_json(path) -> Any:
    with open(path) as f:
        return json.load(f)


def spec(root=ROOT) -> dict:
    return load_json(pathlib.Path(root) / "BENCHMARK.json")


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def module(kind: str, name: str, base=HERE):
    """``<base>/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = pathlib.Path(base) / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(path)
    key = f"benchmark.{kind}.{name.replace('.', '_')}"
    if pathlib.Path(base) != HERE:
        key += f"@{base}"
    if key in sys.modules:
        return sys.modules[key]
    sp = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(sp)
    sys.modules[key] = mod
    sp.loader.exec_module(mod)
    return mod


def metrics_of(bench: dict, cell: str, group: str) -> list:
    """The entries of ``end_to_end`` or ``per_layer`` this cell reports:
    those that list it, and those with no list whose end-to-end metric it
    reports."""
    e2e = {m["name"] for m in bench["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]}
    out = []
    for m in bench[group]:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif group == "end_to_end" or m["moves"] in e2e:
            out.append(m)
    return out


@dataclass
class Run:
    """One run of one cell: its files, arguments and what it measured."""

    cell: dict
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: Any
    t_start: float
    rank: int = 0
    world: int = 1
    control_group: Any = None      # gloo group that ends the window together
    base: Any = HERE               # the benchmark's directory
    scene: Any = None              # the configuration's scene builder
    reference: Any = None          # the configuration's plain reference
    loop: Any = None
    state: dict = field(default_factory=dict)    # the loop's own
    trace: Any = None
    setup_s: float = 0.0
    checks: dict = field(default_factory=dict)   # name -> (value, limit)

    @property
    def main(self) -> bool:
        return self.rank == 0


def open_run(bench: dict, cell_name: str, seed: int, seconds: float,
             traced: bool, device, t_start: float, base=HERE, **kw) -> Run:
    base = pathlib.Path(base)
    cell = cell_of(bench, cell_name)
    cfg = load_json(base / "configs" / f"{cell['config']}.json")
    traffic = load_json(base / "traffic" / f"{cell['traffic']}.json")
    run = Run(cell=cell, cfg=cfg, traffic=traffic, seed=seed, seconds=seconds,
              traced=traced, device=device, t_start=t_start, base=base, **kw)
    run.scene = module("scenes", cfg["scene"], base)
    run.reference = module("reference", cfg["reference"], base)
    run.loop = module("loops", traffic["loop"], base)
    return run


def limits(run: Run) -> dict:
    """The cell's limits on its compared numbers
    (``limits/<cell>.json``)."""
    return load_json(run.base / "limits" / f"{run.cell['name']}.json")


def stop_together(run: Run, stop: bool) -> bool:
    """Whether to end the window: any rank's clock says so (one small
    all-reduce on a CPU group per frame when there are several ranks)."""
    if run.world == 1:
        return stop
    import torch
    import torch.distributed as dist

    flag = torch.tensor([1 if stop else 0])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=run.control_group)
    return bool(flag.item())


def window(run: Run, body):
    """Run ``body(run)`` as the measured window, under ``torch.profiler``
    when the run is traced; the trace is read into ``run.trace``."""
    import torch

    from benchmark import trace

    if not run.traced:
        with torch.profiler.record_function(trace.WINDOW):
            return body(run)
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if run.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.profiler.record_function(trace.WINDOW):
            out = body(run)
    run.trace = trace.read(prof)
    return out


def p95(values) -> float:
    """The 95th percentile (inclusive method) of ``values``."""
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    return statistics.quantiles(vals, n=100, method="inclusive")[94]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def correct(run: Run) -> bool:
    return bool(run.checks) and all(v <= lim for v, lim in run.checks.values())


def note(run: Run, what: str) -> None:
    """A line on standard error: ``what`` and the seconds since the
    process started (where set-up time goes)."""
    print(f"benchmark: {time.perf_counter() - run.t_start:8.2f} s  {what}",
          file=sys.stderr, flush=True)
