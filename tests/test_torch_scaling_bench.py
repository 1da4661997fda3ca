"""PyTorch port: the scaling harness (``bench_scaling.py``) on gloo ranks.

Mirrors tests/test_scaling_bench.py: the harness spawns a 1-rank and a
2-rank gloo group on the CPU (64x64, 2 spp, 2 bounces, 2 iterations) and
each runs the sharded render and train steps in strong and weak scaling.
The records are well-formed, strong scaling keeps the frame, weak scaling
grows it with the ranks, the train step counts its backward pass, and the
summary carries the efficiency tables and the virtual sweep's caveat.
``--real`` runs the world it is launched in: one process alone, then two
ranks under torchrun's environment, each launch keeping its records in one
file whose summary covers both counts.  Without ``--device cpu`` the
harness needs a card.  The times are the CPU's: what is checked is the
harness.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from vrenderer_pathtracer_tpu_torch import bench_scaling

SHAPE = ["--width", "64", "--base-h", "64", "--spp", "2", "--bounces", "2",
         "--iters", "2", "--device", "cpu"]
ARGV = ["--counts", "1,2", *SHAPE]
# The --real launches', smaller: what they check is the launch.
REAL = ["--real", "--width", "32", "--base-h", "16", "--spp", "2",
        "--bounces", "2", "--iters", "1", "--device", "cpu"]
KEYS = {"n_devices", "mode", "train", "width", "height", "spp", "bounces",
        "pass_ms", "mrays_per_s", "platform", "backend", "device"}


@pytest.fixture(scope="module")
def run():
    """The sweep's summary and the lines it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        summary = bench_scaling.main(ARGV)
    return summary, out.getvalue().strip().splitlines()


@pytest.fixture
def sweep(run):
    return run[0]


def _rows(summary, key):
    return summary["tables"][key]


def test_worker_strong_1_and_2_ranks(sweep):
    rows = _rows(sweep, "strong_render")
    assert [r["n_devices"] for r in rows] == [1, 2]
    for r in rows:
        assert r["pass_ms"] > 0 and r["mrays_per_s"] > 0
    assert rows[0]["efficiency_pct"] == 100.0


def test_records_are_well_formed(run):
    summary, lines = run
    recs = [json.loads(x) for x in lines[:-1]]
    assert json.loads(lines[-1]) == summary
    assert len(recs) == 2 * len(bench_scaling.CASES)   # two counts
    for r in recs:
        assert set(r) == KEYS
        assert (r["platform"], r["backend"], r["device"]) == ("cpu", "gloo", "cpu")
        assert r["width"] == 64 and r["spp"] == 2 and r["bounces"] == 2
        assert r["height"] == (64 * r["n_devices"] if r["mode"] == "weak" else 64)
    assert {(r["mode"], r["train"]) for r in recs} == set(bench_scaling.CASES)


def test_worker_weak_scales_pixels(sweep):
    rows = _rows(sweep, "weak_render")
    assert [r["n_devices"] for r in rows] == [1, 2]
    ms = [r["pass_ms"] for r in rows]
    assert all(x > 0 for x in ms)
    # Weak: the frame grows with the ranks (height = base_h * n), so the
    # rays a pass double; strong keeps them.
    weak = [r["mrays_per_s"] * r["pass_ms"] for r in rows]
    strong = [r["mrays_per_s"] * r["pass_ms"] for r in _rows(sweep, "strong_render")]
    assert weak[1] == pytest.approx(2 * weak[0])
    assert strong[1] == pytest.approx(strong[0])


def test_worker_train_step(sweep):
    train = _rows(sweep, "strong_train")
    render = _rows(sweep, "strong_render")
    assert all(r["pass_ms"] > 0 for r in train)
    # A train step counts its forward and backward rays.
    for t, r in zip(train, render):
        assert t["mrays_per_s"] * t["pass_ms"] == pytest.approx(
            2 * r["mrays_per_s"] * r["pass_ms"])


def test_summary_of_the_virtual_sweep(sweep):
    assert sweep["metric"] == "scaling_efficiency" and sweep["counts"] == [1, 2]
    assert sweep["virtual_cpu_sweep"] and not sweep["harness_check"]
    assert sweep["caveat"] == bench_scaling.VIRTUAL_CAVEAT
    assert set(sweep["tables"]) == {"strong_render", "strong_train",
                                    "weak_render", "weak_train"}


def _torchrun_ranks(world: int, argv: list[str]) -> str:
    """Run the harness on ``world`` processes under torchrun's environment
    (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR/PORT``); rank
    0's standard output."""
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "vrenderer_pathtracer_tpu_torch.bench_scaling",
         *argv],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2",
                 WORLD_SIZE=str(world), RANK=str(r), LOCAL_RANK=str(r),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port)))
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (r, err[-2000:])
    assert outs[1][0] == ""   # only rank 0 reports
    return outs[0][0]


def test_real_runs_the_launched_world_and_keeps_its_records(tmp_path,
                                                            monkeypatch):
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    records = tmp_path / "scaling.jsonl"
    argv = [*REAL, "--records", str(records)]
    with contextlib.redirect_stdout(io.StringIO()):
        one = bench_scaling.main(argv)
    assert not torch.distributed.is_initialized()
    assert one["counts"] == [1]
    lines = _torchrun_ranks(2, argv).strip().splitlines()
    recs = [json.loads(x) for x in lines[:-1]]
    assert [r["n_devices"] for r in recs] == [2] * len(bench_scaling.CASES)
    assert all(r["backend"] == "gloo" and r["platform"] == "cpu" for r in recs)
    both = json.loads(lines[-1])
    assert both["counts"] == [1, 2] and both["virtual_cpu_sweep"]
    assert not both["harness_check"]
    for key, rows in both["tables"].items():
        assert [r["n_devices"] for r in rows] == [1, 2]
        assert rows[0] == one["tables"][key][0]
        assert all(r["pass_ms"] > 0 for r in rows)
    kept = [json.loads(x) for x in records.read_text().splitlines()]
    assert sorted(r["n_devices"] for r in kept) == [1] * 4 + [2] * 4
    # A record file of another sweep is refused, not mixed in.
    with pytest.raises(ValueError, match="another sweep"):
        bench_scaling.main([*argv, "--spp", "1"])


@pytest.mark.parametrize("mode", [[], ["--real"]])
def test_the_card_is_the_default(mode, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_scaling.main([*mode, "--counts", "1"])
