"""Progressive-sample scheduler with checkpoint/resume (port of
``render/progressive.py``).

The progressive state is the accumulation buffer and the frame counter;
with the seed, the camera and the Fresnel sliders it fixes the rest of the
render, because every random draw is keyed by (pixel, sample, bounce), so
a render resumed from a checkpoint is bitwise the one that was not
stopped, on the same device.

Checkpoints are ``torch.save`` files of host tensors, read back with
``torch.load(weights_only=True)``, under the JAX package's keys.  They are
not the JAX package's orbax checkpoints, and neither package reads the
other's.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib
import sys
import time
from typing import Callable, Optional

import torch

from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.render.renderer import Renderer
from vrenderer_pathtracer_tpu_torch.utils.metrics import MetricsLogger
from vrenderer_pathtracer_tpu_torch.utils.profiling import synchronize


def checkpoint_state(renderer: Renderer) -> dict:
    """The state that fixes the rest of the render, as host tensors: the
    accumulation buffer (the whole frame's, gathered over the tiles of a
    sharded renderer, so every rank must call this), frame, seed, camera,
    the Fresnel sliders and the last depth, under the JAX
    ``checkpoint_state``'s keys."""
    r = renderer
    state = {
        "accum": r.accumulation(),
        "frame": torch.tensor(r.frame, dtype=torch.int64),
        "seed": torch.tensor(r.seed, dtype=torch.int64),
        "camera": {f.name: getattr(r.camera, f.name)
                   for f in dataclasses.fields(Camera)},
        "fresnel_coef": r.fresnel_coef,
        "fresnel_pow": r.fresnel_pow,
    }
    if r._last_depth is not None:
        state["depth"] = r._last_depth

    def host(x):
        if isinstance(x, dict):
            return {k: host(v) for k, v in x.items()}
        return x.detach().cpu().clone()

    return host(state)


def save_checkpoint(renderer: Renderer, path) -> None:
    """Write :func:`checkpoint_state` to ``path``, atomically: a stopped
    write leaves the previous checkpoint in place.  Every rank of a sharded
    renderer calls it; rank 0 writes."""
    from vrenderer_pathtracer_tpu_torch.parallel.multihost import is_main_process

    state = checkpoint_state(renderer)
    if not is_main_process():
        return
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    torch.save(state, tmp)
    os.replace(tmp, path)


def restore_checkpoint(renderer: Renderer, path) -> Renderer:
    """Restore the progressive state in place; the scene and settings must
    be those of the saved render."""
    state = torch.load(pathlib.Path(path), map_location="cpu",
                       weights_only=True)
    r = renderer
    dev = r.device
    r.set_accumulation(state["accum"])
    r.frame = int(state["frame"])
    r.seed = int(state["seed"])
    r.camera = Camera(**{k: v.to(dev) for k, v in state["camera"].items()})
    r.fresnel_coef = state["fresnel_coef"].to(dev)
    r.fresnel_pow = state["fresnel_pow"].to(dev)
    depth = state.get("depth")
    r._last_depth = None if depth is None else depth.to(dev)
    r._sharded = None  # a sharded step takes the restored camera and sliders
    return r


@dataclasses.dataclass
class ProgressiveScheduler:
    """Drive a renderer to a target sample count, with a checkpoint every
    ``checkpoint_every`` passes, a per-pass callback ``on_pass(pass, spp)``
    and a JSONL event log (``metrics_path``)."""

    renderer: Renderer
    target_spp: int
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0  # passes between checkpoints; 0 = off
    on_pass: Optional[Callable[[int, int], None]] = None  # (pass_idx, spp)
    metrics_path: Optional[str] = None  # JSONL event log

    def __post_init__(self):
        self._met = MetricsLogger(self.metrics_path) if self.metrics_path else None

    def resume_if_possible(self) -> bool:
        """Restore ``checkpoint_dir/latest`` if it exists.  A corrupt or
        unreadable checkpoint is logged and the render starts afresh."""
        if not self.checkpoint_dir:
            return False
        path = pathlib.Path(self.checkpoint_dir) / "latest"
        if not path.exists():
            return False
        try:
            restore_checkpoint(self.renderer, path)
        except Exception as e:  # a corrupt or partial checkpoint: start afresh
            msg = f"{type(e).__name__}: {e}"
            if self._met:
                self._met.log("resume_failed", path=str(path), error=msg)
            print(f"checkpoint restore failed ({msg}); starting fresh",
                  file=sys.stderr)
            return False
        if self._met:
            self._met.log("resumed", path=str(path), frame=self.renderer.frame,
                          spp=self.renderer.samples_per_pixel)
        return True

    def run(self):
        """Render until ``target_spp``; returns (image01, depth) as host
        numpy arrays."""
        r, met = self.renderer, self._met
        img = depth = None
        i = 0
        while r.samples_per_pixel < self.target_spp:
            t0 = time.perf_counter()
            img, depth = r.render()
            i += 1
            if met or self.on_pass:
                # Wait for the pass, so that the times read are the pass's.
                synchronize(r.device)
            if met:
                dt = time.perf_counter() - t0
                rays = (r.settings.n_pixels * r.settings.samples_per_pass
                        * r.settings.bounces)
                met.log("pass", idx=i, spp=r.samples_per_pixel,
                        ms=round(dt * 1e3, 3),
                        mrays_per_s=round(rays / dt / 1e6, 5))
            if self.on_pass:
                self.on_pass(i, r.samples_per_pixel)
            if (self.checkpoint_dir and self.checkpoint_every
                    and i % self.checkpoint_every == 0):
                save_checkpoint(r, pathlib.Path(self.checkpoint_dir) / "latest")
                if met:
                    met.log("checkpoint", spp=r.samples_per_pixel)
        if img is None:
            # Already at the target (a restored render): show the
            # accumulation without another pass.
            img, depth = r.current_frame()
        if met:
            met.log("done", spp=r.samples_per_pixel)
        return img.cpu().numpy(), depth.cpu().numpy()
