"""Renderer façade (port of ``render/renderer.py``), Cornell slice.

Progressive accumulation state is the reference's: an accumulation buffer
and a frame counter; every scene or camera edit resets ``frame=1`` and
zeroes the buffer.  One pass is: the radiance kernel (its plain version on
the CPU), the accumulation, and the tonemap.

Parts of the JAX ``Renderer`` that the port has not reached raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.ops.tonemap import tonemap
from vrenderer_pathtracer_tpu_torch.render.cuda_radiance import (
    render_pass_cuda, render_pass_reference)
from vrenderer_pathtracer_tpu_torch.scene.scene import (
    MESH_SLICE, Scene, settings_for_scene)
from vrenderer_pathtracer_tpu_torch.utils.profiling import RenderStats, synchronize

FXAA_ITEM = "ROADMAP Queue 1 item 8 (ops/fxaa.py)"
SHARDING_ITEM = "ROADMAP Queue 1 item 13 (parallel/sharding.py)"


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: {item}")


def _render_step(scene, camera, accum, frame, fresnel_coef, fresnel_pow,
                 settings, seed):
    if settings.radiance_kernel == "cuda":
        rgb, depth = render_pass_cuda(scene, settings, camera, frame,
                                      fresnel_coef, fresnel_pow, seed)
    else:
        rgb, depth = render_pass_reference(scene, settings, camera, frame,
                                           fresnel_coef, fresnel_pow, seed)
    accum.add_(rgb)  # in place: the buffer is the renderer's own state
    img = tonemap(accum, frame, settings.gamma)
    return img, depth


class Renderer:
    """Stateful progressive renderer with the reference API surface."""

    def __init__(self, width: int = 512, height: int = 512, *,
                 settings: Optional[RenderSettings] = None, seed: int = 0,
                 device="cuda", device_mesh=None):
        if device_mesh is not None:
            _not_ported("device_mesh (sharded rendering)", SHARDING_ITEM)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} but no CUDA device is "
                               "available")
        base = settings or RenderSettings()
        if not base.use_cornell_box:
            _not_ported("scenes without the Cornell box", MESH_SLICE)
        if base.use_fxaa:
            _not_ported("FXAA", FXAA_ITEM)
        self._radiance_request = base.radiance_kernel
        self.settings = base.replace(width=width, height=height)
        self.scene = Scene.analytic(self.settings, self.device)
        self.camera = Camera.default(self.device)
        self.seed = seed
        f32 = dict(dtype=torch.float32, device=self.device)
        self.fresnel_coef = torch.tensor(0.1, **f32)
        self.fresnel_pow = torch.tensor(3.0, **f32)
        self.settings = settings_for_scene(
            self.scene, self.settings.replace(
                radiance_kernel=self._radiance_request))
        self.last_stats: Optional[RenderStats] = None
        self.clear_buffer()

    # -- state management ---------------------------------------------------

    def clear_buffer(self):
        """frame=1 and a zeroed accumulation buffer."""
        self.frame = 1
        self._accum = torch.zeros((self.settings.n_pixels, 3),
                                  dtype=torch.float32, device=self.device)
        self._last_depth = None

    # -- reference API ------------------------------------------------------

    def set_camera(self, camera: Camera):
        if camera.device != self.device:
            raise ValueError(f"camera on {camera.device}, renderer on "
                             f"{self.device}")
        self.camera = camera.with_pitch_clamped()
        self.clear_buffer()

    def update_camera(self, *, origin=None, yaw=None, pitch=None, fov_deg=None):
        f32 = dict(dtype=torch.float32, device=self.device)
        kw = {}
        if origin is not None:
            kw["origin"] = torch.as_tensor(origin, **f32)
        if yaw is not None:
            kw["yaw"] = torch.as_tensor(yaw, **f32)
        if pitch is not None:
            kw["pitch"] = torch.as_tensor(pitch, **f32)
        if fov_deg is not None:
            kw["fov_deg"] = torch.as_tensor(fov_deg, **f32)
        self.set_camera(self.camera.replace(**kw))

    def set_fresnel_coef(self, value: float):
        self.fresnel_coef = torch.tensor(value, dtype=torch.float32,
                                         device=self.device)
        self.clear_buffer()

    def set_fresnel_power(self, value: float):
        self.fresnel_pow = torch.tensor(value, dtype=torch.float32,
                                        device=self.device)
        self.clear_buffer()

    def get_frame_count(self) -> int:
        return self.frame

    @property
    def samples_per_pixel(self) -> int:
        """HUD 'spp': samples accumulated so far."""
        return (self.frame - 1) * self.settings.samples_per_pass

    def load_hdr(self, hdr):
        _not_ported("load_hdr", MESH_SLICE)

    def load_texture(self, image, gamma: float = 2.2, texture_type: int = 0):
        _not_ported("load_texture", MESH_SLICE)

    def load_brdf(self, table):
        _not_ported("load_brdf", MESH_SLICE)

    def init_mesh(self, mesh):
        _not_ported("init_mesh", MESH_SLICE)

    def load_mesh(self, path: str):
        _not_ported("load_mesh", MESH_SLICE)

    def use_brdf(self, enable: bool):
        _not_ported("use_brdf", MESH_SLICE)

    def use_example_sphere(self, enable: bool):
        _not_ported("use_example_sphere", MESH_SLICE)

    def use_cornell_box(self, enable: bool):
        if not enable:
            _not_ported("use_cornell_box(False)", MESH_SLICE)
        self.clear_buffer()

    def toggle_fxaa(self, enable: bool):
        _not_ported("toggle_fxaa", FXAA_ITEM)

    # -- the frame loop -----------------------------------------------------

    def render(self, sync: bool = False):
        """One progressive pass; returns (image01 [H,W,3], depth [H,W]).

        ``sync=True`` waits for the device and records the pass's wall time
        in ``self.last_stats``; the default returns as soon as the work is
        queued.
        """
        t0 = time.perf_counter() if sync else 0.0
        img, depth = _render_step(
            self.scene, self.camera, self._accum, self.frame,
            self.fresnel_coef, self.fresnel_pow, self.settings, self.seed)
        self.frame += 1
        self._last_depth = depth
        if sync:
            synchronize(self.device)
            s = self.settings
            self.last_stats = RenderStats(
                width=s.width, height=s.height,
                samples_per_pass=s.samples_per_pass, bounces=s.bounces,
                seconds_per_pass=time.perf_counter() - t0,
            )
        h, w = self.settings.height, self.settings.width
        return img.reshape(h, w, 3), depth.reshape(h, w)

    def current_frame(self):
        """The existing accumulation as (image01 [H,W,3], depth [H,W]),
        without running a pass."""
        h, w = self.settings.height, self.settings.width
        img = tonemap(self._accum, max(self.frame - 1, 1), self.settings.gamma)
        depth = self._last_depth
        if depth is None:
            depth = torch.ones((self.settings.n_pixels,), dtype=torch.float32,
                               device=self.device)
        return img.reshape(h, w, 3), depth.reshape(h, w)

    def hud_line(self) -> str:
        """fps / ms / spp / Mrays one-liner; needs a prior ``render(sync=True)``."""
        if self.last_stats is None:
            return "no synced frame yet - call render(sync=True)"
        return self.last_stats.hud_line(self.samples_per_pixel)

    def render_frames(self, n: int):
        """Run n progressive passes; return the final image as host numpy."""
        img = depth = None
        for _ in range(n):
            img, depth = self.render()
        return img.cpu().numpy(), depth.cpu().numpy()
