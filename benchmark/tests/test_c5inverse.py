"""CPU tests of the ``c5inverse.grad8`` cell: its loop and check at a tiny
size (the configuration's mesh and HDRI and the traffic's size, views and
target passes shrunk), the bfloat16 control and the planted faults of
``benchmark/grad_faults.py`` failing it, and the cell's per-layer readers
on a synthetic trace.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import json
import pathlib
import sys
import time
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults, grad_faults, harness  # noqa: E402
from benchmark import run as runner  # noqa: E402
from benchmark.trace import WINDOW, Trace  # noqa: E402
from test_benchmark_harness import KEYS, tiny_copy  # noqa: E402

CELL = "c5inverse.grad8"
# A seed whose tiny scene has paths that reach the sky after three hits, so
# that the MERL gradient of the last bounce that counts is not 0 (in most
# tiny scenes no path does; at the cell's size they carry ~40% of it).
SEED = 2 ** 31 + 11
READERS = ("opt_loss_ms_per_step", "opt_backward_ms_per_step",
           "table_grad_ms_per_step", "table_grad_mlanes_per_step",
           "device_idle_pct.grad")


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    base = tiny_copy(tmp_path_factory.mktemp("bench"))
    p = base / "configs" / "c5inverse.json"
    d = json.loads(p.read_text())
    d["mesh"].update(n_theta=16, n_phi=16)
    d["hdri"].update(height=16, width=32)
    p.write_text(json.dumps(d))
    p = base / "traffic" / "grad8.json"
    d = json.loads(p.read_text())
    d.update(width=40, height=32, spp_per_pass=2, n_views=2, target_passes=2)
    d["check"].update(region=8, block_lanes=1024)
    p.write_text(json.dumps(d))
    return base


def _open(base):
    return harness.open_run(harness.spec(), CELL, SEED, 0.3, False,
                            torch.device("cpu"), time.perf_counter(),
                            base=base)


@pytest.mark.parametrize("trace", [0, 1])
def test_the_loop_runs_and_prints_the_contract(tiny, trace):
    args = types.SimpleNamespace(workload=CELL, seed=SEED, seconds=0.5,
                                 trace=trace, rank=0, port=0)
    out = runner.run_cell(harness.spec(), args, torch.device("cpu"), 1,
                          time.perf_counter(), base=tiny)
    assert KEYS <= set(out)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == {"target_off_share", "loss_gap", "grad_err",
                                  "step_err"}
    assert out["attempted"] > 0
    if not trace:
        assert set(out["metrics"]) == {"mrays_per_s", "setup_s"}
    else:
        # On the CPU: the program's spans and counters; no device trace.
        assert set(out["metrics"]) == {"opt_loss_ms_per_step",
                                       "opt_backward_ms_per_step",
                                       "table_grad_mlanes_per_step"}
        lanes = out["metrics"]["table_grad_mlanes_per_step"]["value"]
        # Full width, not paged: the MERL lookups of 4 bounces and the
        # HDRI fetch, over every lane.
        assert lanes == pytest.approx(40 * 32 * 2 * 5 / 1e6)


@pytest.mark.parametrize("mode", ["control", *grad_faults.FAULTS])
def test_the_control_and_each_fault_are_not_correct(tiny, mode):
    run = _open(tiny)
    limits = harness.limits(run)
    if mode == "control":
        run.loop.control(run, torch.bfloat16)
    else:
        with faults.patcher() as patch:
            grad_faults.FAULTS[mode](patch)
            run.loop.setup(run)
            harness.window(run, run.loop.body)
            run.loop.free(run)
    run.loop.check(run, limits)
    assert not harness.correct(run), (mode, run.checks)


def _module(name):
    return harness.module("metrics", name)


def test_the_readers_on_a_synthetic_trace():
    tr = Trace(start=10.0, end=20.0)
    tr.ranges = [(WINDOW, 10.0, 20.0), ("opt.loss", 10.0, 11.0),
                 ("opt.backward", 11.0, 13.0), ("opt.loss", 14.0, 15.5),
                 ("opt.backward", 15.5, 18.5), ("opt.loss", 19.5, 21.0)]
    tr.ops = [("void at::native::(anonymous namespace)::"
               "indexing_backward_kernel_small_stride<float>(...)", 12.0, 12.5),
              ("void cub::DeviceRadixSortOnesweepKernel<...>(...)", 16.0, 16.25),
              ("void (anonymous namespace)::paged_kernel<0>(...)", 10.5, 11.0),
              ("Memcpy DtoH (Device -> Pageable)", 19.0, 19.5)]
    run = types.SimpleNamespace(trace=tr, state={"steps": 2,
                                                 "grad_lanes": [3e6, 1e6]})
    assert _module("opt_loss_ms_per_step").read(run) == pytest.approx(
        (1.0 + 1.5 + 0.5) / 2 * 1e3)
    assert _module("opt_backward_ms_per_step").read(run) == pytest.approx(
        (2.0 + 3.0) / 2 * 1e3)
    assert _module("table_grad_ms_per_step").read(run) == pytest.approx(
        0.75 / 2 * 1e3)
    assert _module("table_grad_mlanes_per_step").read(run) == pytest.approx(2.0)
    assert _module("device_idle_pct.grad").read(run) == pytest.approx(
        100 * (1 - 1.75 / 10))


@pytest.mark.parametrize("name", READERS)
def test_each_reader_returns_none_without_its_input(name):
    """No trace, no steps, a program without the spans, kernels or
    counters (the parent of the change that added them)."""
    read = _module(name).read
    empty = Trace(start=0.0, end=1.0, ranges=[(WINDOW, 0.0, 1.0)])
    for trace, state in ((None, {"steps": 3}),
                         (empty, {"steps": 3, "grad_lanes": [None, None]}),
                         (empty, {})):
        assert read(types.SimpleNamespace(trace=trace, state=state)) is None
