"""Timing and throughput bookkeeping (port of ``utils/profiling.py``).

Rays are counted as pixels x spp x bounces per pass.  Wall time is taken on
the host clock around work that ends in ``torch.cuda.synchronize``
(:func:`timeit`, :func:`measure_renderer`); device time comes from CUDA
events (:func:`cuda_time_ms`) or from the profiler's device events
(:func:`device_ms_per_call`); :func:`profiler_trace` writes a
``torch.profiler`` timeline for Perfetto or ``chrome://tracing``.  None of
them is a device number when the work ran on the CPU, and
:func:`cuda_time_ms` and :func:`device_ms_per_call` refuse CPU work.

:func:`plain_version` marks a kernel's plain PyTorch version: each call is
a ``plain_version:<name>`` range on the profiler's timeline, so a trace
shows whether a plain version ran on the card.

:func:`count_grad_lanes` keeps the table gathers' counters
(``ops/brdf.py::lookup_brdf.grad_lanes``,
``ops/envmap.py::sample_env.grad_lanes``): the lanes whose gradient a
backward pass scatters into a trained table, from shapes alone.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import pathlib
import time
from typing import Callable

import torch


def synchronize(device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _first_device(tree):
    """The device of the first tensor in ``tree`` (nested tuples, lists,
    dicts), or None."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    items = tree.values() if isinstance(tree, dict) else (
        tree if isinstance(tree, (tuple, list)) else ())
    for x in items:
        device = _first_device(x)
        if device is not None:
            return device
    return None


def _wait(out) -> None:
    device = _first_device(out)
    if device is not None:
        synchronize(device)


def timeit(fn: Callable, *args, warmup: int = 1, iters: int = 5, **kw) -> float:
    """Mean host seconds per call of ``fn(*args, **kw)`` over ``iters``
    calls after ``warmup``, each run ending in a synchronize on the device
    of the outputs' first tensor."""
    for _ in range(warmup):
        _wait(fn(*args, **kw))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = fn(*args, **kw)
    _wait(out)
    return (time.perf_counter() - t0) / iters


@dataclasses.dataclass
class RenderStats:
    """Throughput of one pass size, from a measured time per pass."""

    width: int
    height: int
    samples_per_pass: int
    bounces: int
    seconds_per_pass: float

    @property
    def rays_per_pass(self) -> int:
        return self.width * self.height * self.samples_per_pass * self.bounces

    @property
    def mrays_per_s(self) -> float:
        return self.rays_per_pass / self.seconds_per_pass / 1e6

    @property
    def mpaths_per_s(self) -> float:
        return (self.width * self.height * self.samples_per_pass
                / self.seconds_per_pass / 1e6)

    @property
    def ms_per_pass(self) -> float:
        return self.seconds_per_pass * 1e3

    def hud_line(self, spp_total: int) -> str:
        """The reference HUD, one line: fps / ms / spp / Mrays/s."""
        fps = 1.0 / self.seconds_per_pass
        return (f"{fps:6.1f} fps  {self.ms_per_pass:7.2f} ms/frame  "
                f"{spp_total} spp  {self.mrays_per_s:8.1f} Mrays/s")


def cuda_time_ms(fn: Callable[[], object], device, iters: int = 10,
                 warmup: int = 1) -> float:
    """Mean device milliseconds per call of ``fn``, from CUDA events on the
    current stream around ``iters`` calls after ``warmup`` calls."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"CUDA event timing needs a CUDA device, not {device}")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.device(device):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


PLAIN_VERSION = "plain_version:"


def plain_version(fn: Callable) -> Callable:
    """Run ``fn`` inside a ``plain_version:<name>`` profiler range (a user
    annotation on the timeline; ``chip_smoke.py`` reads the bench's traces
    for it).  Attributes set on the returned function after decoration,
    such as a call count, are the ones ``fn``'s body reads by its name."""
    name = PLAIN_VERSION + fn.__name__

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    return wrapped


def count_grad_lanes(fn: Callable, table: torch.Tensor, lanes: int) -> None:
    """Add ``lanes`` to ``fn.grad_lanes`` when a forward pass gathers them
    from ``table`` for a gradient: grad mode on and ``table`` requiring
    grad, outside a backward pass, whose remat recompute
    (``torch.utils.checkpoint``) gathers the same lanes again.  The count is
    then the lanes whose gradient the backward pass scatters into the
    table.  It reads a shape the host holds: no sync."""
    if (lanes and table.requires_grad and torch.is_grad_enabled()
            and torch._C._current_graph_task_id() == -1):
        fn.grad_lanes += lanes


def _export(prof, log_dir, label: str = "trace") -> pathlib.Path:
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{label}_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    return path


def device_ms_per_call(fn: Callable[[int], object], calls: int, device, *,
                       trace_dir=None, label: str = "trace") -> dict:
    """Device milliseconds per call of every kernel, copy and fill that
    ``fn(0), ..., fn(calls - 1)`` put on the card, keyed by the profiler's
    name for each (a kernel's symbol): ``torch.profiler``'s device events
    over the calls, which end in a synchronize.

    The twin of a wall time where CUDA events cannot stand in for device
    time, because the host waits on the card within a call (K4's launch
    reads the sphere table back: ``render/cuda_mesh.py::supports``).  With
    ``trace_dir`` the timeline is also written there, as
    ``<label>_<pid>_<ns>.json``.  Raises on a CPU device and when the
    trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device time needs a CUDA device, not {device}")
    if calls <= 0:
        raise ValueError(f"calls must be positive, not {calls}")
    synchronize(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        synchronize(device)
    if trace_dir is not None:
        _export(prof, trace_dir, label)
    out: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key] = out.get(e.key, 0.0) + e.self_device_time_total / 1e3 / calls
    if not any(out.values()):
        raise RuntimeError("the profiler saw no device time (CUPTI tracing "
                           "unavailable?)")
    return out


@contextlib.contextmanager
def profiler_trace(log_dir):
    """``torch.profiler`` over the block (CPU activity, and CUDA activity
    where there is a card); on exit the timeline is written into
    ``log_dir`` as a Chrome/Perfetto JSON trace, ``trace_<pid>_<ns>.json``.
    Yields the profiler, whose ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    pathlib.Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    _export(prof, log_dir)


def measure_renderer(renderer, warmup: int = 1, iters: int = 5) -> RenderStats:
    """Time progressive passes of a Renderer on the host clock, each run
    ending in a synchronize on the renderer's device."""
    for _ in range(warmup):
        renderer.render()
    synchronize(renderer.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        renderer.render()
    synchronize(renderer.device)
    s = renderer.settings
    return RenderStats(
        width=s.width, height=s.height, samples_per_pass=s.samples_per_pass,
        bounces=s.bounces,
        seconds_per_pass=(time.perf_counter() - t0) / iters,
    )
