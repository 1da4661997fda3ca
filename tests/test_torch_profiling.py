"""PyTorch port: the timing helpers of ``utils/profiling.py`` on the CPU.

``timeit`` calls its function warm-up + iters times and returns a mean of
seconds; ``measure_renderer`` runs warm-up + iters ``Renderer`` passes and
returns ``RenderStats`` of the renderer's shape; ``profiler_trace`` writes
a Chrome/Perfetto JSON trace into its directory and yields the profiler.
The numbers are the CPU's: what is checked is the bookkeeping.
"""

import json

import torch

import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch import utils
from vrenderer_pathtracer_tpu_torch.utils.profiling import (
    RenderStats, measure_renderer, profiler_trace, timeit)


def test_exports_match_the_jax_package():
    assert {"RenderStats", "measure_renderer", "profiler_trace",
            "timeit"} <= set(utils.__all__)
    assert utils.timeit is timeit and utils.profiler_trace is profiler_trace


def test_timeit_counts_calls_and_returns_seconds():
    calls = []

    def fn(x, scale=1.0):
        calls.append(1)
        return {"y": [x * scale]}   # nested outputs: synchronised on x's device

    s = timeit(fn, torch.ones(8), warmup=2, iters=3, scale=2.0)
    assert len(calls) == 5 and 0 < s < 10
    assert timeit(lambda: None, iters=1) >= 0   # no tensor: nothing to wait on


def _renderer():
    return vpt.Renderer(16, 8, device="cpu", settings=vpt.RenderSettings(
        use_cornell_box=True, has_hdr=False, samples_per_pass=1, bounces=2))


def test_measure_renderer_runs_passes_and_counts_rays():
    r = _renderer()
    stats = measure_renderer(r, warmup=1, iters=2)
    assert isinstance(stats, RenderStats)
    assert r.get_frame_count() == 4     # 3 passes
    assert (stats.width, stats.height, stats.samples_per_pass,
            stats.bounces) == (16, 8, 1, 2)
    assert stats.rays_per_pass == 16 * 8 * 2
    assert stats.seconds_per_pass > 0 and stats.mrays_per_s > 0
    assert "spp" in stats.hud_line(r.samples_per_pixel)


def test_profiler_trace_writes_a_trace(tmp_path):
    r = _renderer()
    with profiler_trace(tmp_path / "trace") as prof:
        r.render()
    files = list((tmp_path / "trace").glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    assert len(prof.key_averages()) > 0
