"""Timing and throughput bookkeeping (port of ``utils/profiling.py``).

Rays are counted as pixels x spp x bounces per pass.  Wall time is taken on
the host clock around work that ends in ``torch.cuda.synchronize``; device
time comes from CUDA events.  Neither is a device number when the work ran
on the CPU, and :func:`cuda_time_ms` refuses CPU work.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def synchronize(device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
