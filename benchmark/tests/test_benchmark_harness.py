"""CPU tests of the benchmark harness (``benchmark/``).

Each cell's loop runs here at a tiny size on the CPU, through the port's
plain versions, from a copy of the benchmark whose traffic and
configuration files are shrunk; the card tests (marked ``cuda``) run the
controls at a larger size and skip without a card.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import ast
import json
import pathlib
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults, harness, roofline  # noqa: E402
from benchmark import run as runner  # noqa: E402

BENCH = ROOT / "benchmark"
SEED = 2 ** 31 + 11  # more than 32 signed bits hold
CHECK_REGION = {"frames": 1, "region": 8, "regions": 2, "on_mesh": 1,
                "image_tol": 1 / 255, "depth_tol": 1e-4}
TINY = {
    "render64": dict(width=32, height=24, spp_per_pass=2),
    "train1k": dict(width=24, height=24, spp_per_pass=2),
    "progressive": dict(width=40, height=32, spp_per_pass=2,
                        frames_per_view=3, check=CHECK_REGION),
    "progressive.x4": dict(width=40, height=32, spp_per_pass=2,
                           frames_per_view=3, tiles=2,
                           check=dict(CHECK_REGION, on_mesh=2)),
}


# The training cell that waits in PERF.md's open questions (its host-paced
# step spreads too widely for a bound): its entries, as BENCHMARK.json
# would take them.  Its loop, traffic, limits and readers are in place.
TRAINING = {
    "workloads": [{"name": "cornell.train1k", "config": "cornell",
                   "traffic": "train1k", "chips": 1,
                   "why": "Adam steps at the fwd+bwd headline shape"}],
    "end_to_end": [{"name": "train_step_ms", "unit": "ms", "better": "lower",
                    "bound": 0.25, "source": "host_clock",
                    "workloads": ["cornell.train1k"]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": source,
         "layer": layer, "moves": "train_step_ms",
         "workloads": ["cornell.train1k"]}
        for name, unit, better, source, layer in (
            ("host_ms_per_step", "ms", "lower", "host_clock", "Train step"),
            ("launches_per_step", "launches", "lower", "device_trace",
             "Train step"),
            ("k2_roofline_pct", "%", "higher", "device_trace", "Kernel K2"),
            ("device_idle_pct.train", "%", "lower", "device_trace",
             "Device"))],
}


def spec() -> dict:
    """BENCHMARK.json with the waiting training cell's entries added."""
    bench = harness.spec()
    for key, entries in TRAINING.items():
        bench[key] = bench[key] + entries
    return bench


def tiny_copy(dst: pathlib.Path) -> pathlib.Path:
    """A copy of the benchmark with its traffic and configuration shrunk."""
    base = dst / "benchmark"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns(
        "__pycache__", ".cache", "tests"))
    for name, kw in TINY.items():
        p = base / "traffic" / f"{name}.json"
        d = json.loads(p.read_text())
        d.update(kw)
        p.write_text(json.dumps(d))
    p = base / "configs" / "c5.json"
    d = json.loads(p.read_text())
    d["mesh"].update(n_theta=16, n_phi=16)
    d["hdri"].update(height=16, width=32)
    p.write_text(json.dumps(d))
    return base


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


def run_tiny(base, cell, trace=0, seconds=0.5, seed=SEED):
    args = types.SimpleNamespace(workload=cell, seed=seed, seconds=seconds,
                                 trace=trace, rank=0, port=0)
    return runner.run_cell(spec(), args, torch.device("cpu"), 1,
                           time.perf_counter(), base=base)


# --- what the benchmark imports ---------------------------------------------

def _imports(path: pathlib.Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module)
    return out


def test_nothing_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), (path, tops)


def test_the_reference_imports_nothing_of_the_port():
    allowed = {"__future__", "functools", "json", "math", "numpy", "torch",
               "benchmark"}
    for path in (BENCH / "reference").glob("*.py"):
        for mod in _imports(path):
            assert mod.split(".")[0] in allowed, (path, mod)
            if mod.startswith("benchmark"):
                assert mod.startswith("benchmark.reference"), (path, mod)


def test_a_run_loads_no_jax(tmp_path):
    """A whole cell, in a process of its own, leaves no forbidden module in
    ``sys.modules`` (top-level names compared whole)."""
    base = tiny_copy(tmp_path)
    code = (f"import sys, time, types, torch; sys.path.insert(0, {str(ROOT)!r});"
            "from benchmark import harness, run as R;"
            "a = types.SimpleNamespace(workload='cornell.render64', seed=3,"
            " seconds=0.2, trace=0, rank=0, port=0);"
            f"R.run_cell(harness.spec(), a, torch.device('cpu'), 1,"
            f" time.perf_counter(), base={str(base)!r});"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# --- driven by data -----------------------------------------------------------

def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix, limits and a per-layer metric added
    as new files join a new cell with no file edited."""
    base = tiny_copy(tmp_path)
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    cfg = json.loads((base / "configs" / "cornell.json").read_text())
    cfg.update(name="cornell_dim", fresnel_coef=0.3)
    (base / "configs" / "cornell_dim.json").write_text(json.dumps(cfg))
    tr = json.loads((base / "traffic" / "render64.json").read_text())
    tr.update(passes_per_frame=2)
    (base / "traffic" / "render2.json").write_text(json.dumps(tr))
    (base / "limits" / "cornell_dim.render2.json").write_text(
        json.dumps({"image_off_share": 0.01, "depth_off_share": 0.01}))
    (base / "metrics" / "frames_seen.py").write_text(
        "def read(run):\n    return float(len(run.state['frames']))\n")
    bench = harness.spec()
    bench["workloads"].append({"name": "cornell_dim.render2",
                               "config": "cornell_dim", "traffic": "render2",
                               "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "frames_seen", "unit": "frames",
                               "better": "higher", "source": "program_counter",
                               "layer": "Renderer and display",
                               "moves": "mrays_per_s",
                               "workloads": ["cornell_dim.render2"]})
    args = types.SimpleNamespace(workload="cornell_dim.render2", seed=5,
                                 seconds=0.3, trace=1, rank=0, port=0)
    out = runner.run_cell(bench, args, torch.device("cpu"), 1,
                          time.perf_counter(), base=base)
    assert out["correct"]
    assert out["metrics"]["frames_seen"]["value"] == out["attempted"]
    for p, data in before.items():
        assert p.read_bytes() == data, p


def test_metrics_follow_their_cells():
    bench = spec()
    for cell in bench["workloads"]:
        e2e = {m["name"] for m in harness.metrics_of(bench, cell["name"],
                                                     "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_of(bench, cell["name"], "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (cell["name"], m["name"])
            assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert (BENCH / "limits" / f"{cell['name']}.json").is_file()


# --- each loop on the CPU ---------------------------------------------------

KEYS = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", ["cornell.render64", "cornell.train1k",
                                  "c5.progressive"])
@pytest.mark.parametrize("trace", [0, 1])
def test_each_loop_runs_and_prints_the_contract(tiny, cell, trace):
    out = run_tiny(tiny, cell, trace)
    assert KEYS <= set(out)
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {m["name"] for m in harness.metrics_of(
        spec(), cell, "per_layer" if trace else "end_to_end")}
    assert set(out["metrics"]) <= want
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    if not trace:
        assert set(out["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.loads(json.dumps(out))


def test_the_sharded_cell_on_two_cpu_ranks(tiny, tmp_path):
    """``c5.progressive.x4``'s path (row bands, the gathered frame, the
    window ended together) on two gloo ranks."""
    out = _two_ranks(tiny, tmp_path, "sound")
    assert out["correct"] is True, out["numbers"]
    assert out["device"]["count"] == 2


def _two_ranks(base, tmp_path, fault: str) -> dict:
    """A reading of ``c5.progressive.x4`` on two gloo ranks, through
    ``controls.rank_reading`` (``fault``: a planted fault, or "sound")."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    prog = f"""
import sys, json, torch
sys.path.insert(0, {str(ROOT)!r})
from benchmark import controls, harness
bench = harness.spec()
bench["workloads"] = [dict(w, chips=2) if w["name"] == "c5.progressive.x4"
                      else w for w in bench["workloads"]]
out = controls.rank_reading(bench, "c5.progressive.x4", 9, {fault!r}, 0.5,
                            int(sys.argv[1]), {port}, torch.device("cpu"),
                            {str(base)!r})
if out is not None:
    print(json.dumps(out))
"""
    path = tmp_path / "rank.py"
    path.write_text(prog)
    procs = [subprocess.Popen([sys.executable, str(path), str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=tmp_path) for r in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-3000:] for o in outs]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.mark.parametrize("cell", ["c5.progressive", "c5.progressive.x4"])
def test_compared_blocks_take_each_band_and_the_mesh(tiny, cell):
    """Each rank's band holds a compared block, and the first blocks sit
    on the mesh, whatever the seed and view."""
    from benchmark.loops import render
    from benchmark.reference import views

    bench = harness.spec()
    for seed in range(8):
        run = harness.open_run(bench, cell, SEED + seed, 0.1, False,
                               torch.device("cpu"), time.perf_counter(),
                               base=tiny)
        t, c = run.traffic, run.traffic["check"]
        view = views.spec(t["views"], run.seed, seed)
        got = render.blocks(run, view)
        bands = render._bands(t)
        assert len(got) == max(c["regions"], len(bands))
        for k, (b0, b1) in enumerate(bands):
            assert any(b0 <= y0 and y0 + h <= b1 for y0, _, h, _ in got), k
        for y0, x0, h, w in got[:c["on_mesh"]]:
            centre = torch.tensor([(y0 + h // 2) * t["width"] + x0 + w // 2])
            assert bool(run.reference.primary_mesh_hits(
                run.cfg, t, run.seed, views.camera(view), centre,
                run.device)[0])


# --- the roofline yardstick --------------------------------------------------

def _hand_work(view, frame, spp, w, h, seed, cfg):
    """cornell_work's count, lane by lane, with the port's own plain
    pieces (an independent count of the same work)."""
    from vrenderer_pathtracer_tpu_torch.core import rng
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera, generate_rays
    from vrenderer_pathtracer_tpu_torch.ops.shading import ORIGIN_OFFSET, scatter
    from vrenderer_pathtracer_tpu_torch.render.integrator import _intersect_sphere_set
    from vrenderer_pathtracer_tpu_torch.scene.spheres import DIFF, build_sphere_set

    dev = torch.device("cpu")
    f32 = dict(dtype=torch.float32, device=dev)
    cam = Camera(torch.tensor(view["origin"], **f32), torch.tensor(view["yaw"], **f32),
                 torch.tensor(view["pitch"], **f32), torch.tensor(view["fov_deg"], **f32))
    scene = types.SimpleNamespace(spheres=build_sphere_set(True, dev))
    fc, fp = torch.tensor(cfg["fresnel_coef"]), torch.tensor(cfg["fresnel_pow"])
    o0, d0 = generate_rays(cam, w, h)
    keys = ("tests", "hits", "fres", "steps", "fres_steps", "records",
            "scores", "hits0", "fres0")
    c = dict.fromkeys(keys, 0)
    for px in range(w * h):
        for s in range(spp):
            o, d = o0[px:px + 1], d0[px:px + 1]
            alive, rec, score = True, 0, 0
            ids, sid = torch.tensor([px]), torch.tensor([s])
            for b in range(cfg["bounces"]):
                if not alive:
                    break
                if b > 0:
                    c["tests"] += 1
                hd = _intersect_sphere_set(scene, o, d)
                if not bool(hd.hit[0]):
                    alive = False
                    break
                fres = int(hd.hit_type[0]) == DIFF and float(hd.spec_color[0, 0]) != 0
                if b == 0 and s == 0:
                    c["hits0"] += 1
                    c["fres0"] += int(fres)
                if b > 0:
                    c["hits"] += 1
                    c["fres"] += int(fres)
                c["steps"] += 1
                c["fres_steps"] += int(fres)
                aoi = float((hd.normal * -d).sum())
                p = ((max(1 - aoi, 0.0) ** float(fp)) * (1 - float(fc)) + float(fc)) \
                    * float(hd.spec_color[0, 0])
                rec += 1
                score += int(fres and 1e-6 <= p <= 1 - 1e-6)
                u0, _ = rng.uniform2(seed, ids, rng.make_stream(frame, sid, b, 0))
                u1, u2 = rng.uniform2(seed, ids, rng.make_stream(frame, sid, b, 1))
                nd, _ = scatter(d, hd.normal, hd.tangent, hd.color, hd.spec_color,
                                hd.hit_type, u0, u1, u2, fc, fp)
                o, d = hd.point + ORIGIN_OFFSET * hd.normal, nd
            if alive:
                c["records"] += rec
                c["scores"] += score
    return c


def test_the_frozen_counts_match_a_hand_count():
    from benchmark.reference import cornell, views

    cfg = json.loads((BENCH / "configs" / "cornell.json").read_text())
    view = views.camera({"kind": "drag", "dx": 7, "dy": -3})
    w = cornell.work(cfg, view, 2, 3, 6, 5, SEED, torch.device("cpu"))
    hand = _hand_work(view, 2, 3, 6, 5, SEED, cfg)
    assert {k: w[k] for k in hand} == hand
    assert w["pixels"] == 30 and w["spp"] == 3 and w["spheres"] == 8
    # The least time is the work's alone: the same for any kernel that
    # does it, and priced by fixed costs a piece.
    ops = roofline.cornell_ops(w, "k1")
    fp32 = (29 * (30 + w["tests"]) * 8 + 71 * (w["hits0"] + w["hits"])
            + 17 * (w["fres0"] + w["fres"]) + 106 * w["steps"]
            + 3 * w["fres_steps"] + 80 * 30)
    assert ops["fp32"] == fp32
    t, by = roofline.least_s(ops, 30 * roofline.RENDER_PIXEL_BYTES)
    assert t == pytest.approx(max(ops[k] / r for k, r in roofline.RATES.items()))
    assert by == "operations"


def test_the_reference_draws_the_ports_numbers():
    """The reference's Threefry (int32 words) gives the port's draws for
    the same seed, pixel, frame, sample, bounce and slot."""
    from vrenderer_pathtracer_tpu_torch.core import rng

    from benchmark.reference import plain

    pix = torch.arange(50000) * 37 + 5
    samp = torch.arange(50000) % 13
    for seed in (0, 5, SEED, 2 ** 33 + 7):
        for frame, bounce, slot in ((1, 0, 0), (7, 3, 1), (300, 2, 2)):
            got = plain.uniform2(seed, pix, frame, samp, bounce, slot,
                                 torch.float32)
            want = rng.uniform2(seed, pix, rng.make_stream(frame, samp,
                                                           bounce, slot))
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_search_bytes_count_rays_hits_and_triangles():
    assert roofline.search_bytes([10, 4], 100) == (10 + 4) * 36 + 2 * 100 * 36


# --- correct: the control and planted faults ----------------------------------

def _kept_frames_run(base, cell, seed=SEED):
    """A run of ``cell`` whose window ran (program state freed)."""
    bench = spec()
    run = harness.open_run(bench, cell, seed, 0.3, False, torch.device("cpu"),
                           time.perf_counter(), base=base)
    run.loop.setup(run)
    harness.window(run, run.loop.body)
    run.loop.free(run)
    return run


@pytest.mark.parametrize("cell", ["cornell.render64", "c5.progressive",
                                  "cornell.train1k"])
def test_the_bfloat16_control_is_not_correct(tiny, cell):
    """The reference in bfloat16, in the program's place, fails the cell's
    limits; the program passes them."""
    run = _kept_frames_run(tiny, cell)
    limits = harness.limits(run)
    run.loop.check(run, limits)
    assert harness.correct(run), run.checks
    if run.traffic["loop"] == "render":
        run.loop.control(run, torch.bfloat16, 1)
    else:
        run.loop.control(run, torch.bfloat16)
    run.loop.check(run, limits)
    assert not harness.correct(run), run.checks


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
@pytest.mark.parametrize("cell", ["cornell.render64", "c5.progressive",
                                  "cornell.train1k"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    faults.FAULTS[fault](monkeypatch.setattr)
    out = run_tiny(tiny, cell)
    assert out["correct"] is False, (fault, out["checks"])


def test_a_left_out_exchange_is_not_correct(tiny, tmp_path):
    out = _two_ranks(tiny, tmp_path, "exchange_left_out")
    assert out["correct"] is False, out["numbers"]


@pytest.mark.cuda
def test_the_control_fails_on_the_card(tmp_path):
    """On the card, at a size a test run holds: the program passes and the
    bfloat16 control fails each render cell's and the train cell's limits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    base = tiny_copy(tmp_path)
    for name, kw in (("render64", dict(width=256, height=256, spp_per_pass=8)),
                     ("train1k", dict(width=256, height=256, spp_per_pass=4))):
        p = base / "traffic" / f"{name}.json"
        d = json.loads(p.read_text())
        d.update(kw)
        p.write_text(json.dumps(d))
    for cell in ("cornell.render64", "cornell.train1k"):
        bench = spec()
        run = harness.open_run(bench, cell, SEED, 0.5, False,
                               torch.device("cuda", 0), time.perf_counter(),
                               base=base)
        run.loop.setup(run)
        harness.window(run, run.loop.body)
        run.loop.free(run)
        limits = harness.limits(run)
        run.loop.check(run, limits)
        assert harness.correct(run), (cell, run.checks)
        if run.traffic["loop"] == "render":
            run.loop.control(run, torch.bfloat16, 1)
        else:
            run.loop.control(run, torch.bfloat16)
        run.loop.check(run, limits)
        assert not harness.correct(run), (cell, run.checks)
