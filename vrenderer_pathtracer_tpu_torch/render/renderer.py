"""Renderer façade (port of ``render/renderer.py``).

Progressive accumulation state is the reference's: an accumulation buffer
and a frame counter; every scene or camera edit resets ``frame=1`` and
zeroes the buffer.  One pass is :func:`render_pass` on the resolved backend
(``scene.settings_for_scene``): K1 for Cornell sphere scenes on the card,
K4 for the general scenes it covers, the wavefront integrator
(``render/integrator.py``, whose mesh search is K3/K3b, or K5 for a paged
mesh, on the card) for the rest and the plain integrator on the CPU; then
the accumulation, the tonemap and, with ``use_fxaa``, FXAA on the
tonemapped image.

With a ``device_mesh`` (``parallel/sharding.py::make_render_mesh``) each
rank holds its tile of the accumulation and renders it through
``sharded_render_step``; ``render`` gathers the image and depth over the
tiles (``parallel/multihost.py::gather_image``), so every rank returns the
whole frame, and applies FXAA to the gathered frame.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.ops.fxaa import fxaa
from vrenderer_pathtracer_tpu_torch.ops.tonemap import tonemap
from vrenderer_pathtracer_tpu_torch.render import integrator
from vrenderer_pathtracer_tpu_torch.render.cuda_mesh import render_pass_mesh
from vrenderer_pathtracer_tpu_torch.render.cuda_radiance import render_pass_cuda
from vrenderer_pathtracer_tpu_torch.scene.scene import (
    MeshData, Scene, settings_for_scene)
from vrenderer_pathtracer_tpu_torch.scene.spheres import build_sphere_set
from vrenderer_pathtracer_tpu_torch.utils.profiling import RenderStats, synchronize

DIFFUSE, NORMAL, SPECULAR = 0, 1, 2  # texture types (reference vTextureType)


def render_pass(scene, settings, camera, frame, fresnel_coef, fresnel_pow,
                seed=0, pixel_offset=0, sample_offset=0, n_local_pixels=None):
    """One pass on the backend ``settings.radiance_kernel`` names (resolved
    by ``settings_for_scene``): ``(rgb_mean [n,3], depth [n])`` of the raster
    range ``[pixel_offset, pixel_offset + n_local_pixels)`` (default the
    whole frame) with the samples from ``sample_offset``."""
    args = (scene, settings, camera, frame, fresnel_coef, fresnel_pow, seed,
            pixel_offset, sample_offset, n_local_pixels)
    if settings.radiance_kernel == "cuda":
        return render_pass_cuda(*args)
    if settings.radiance_kernel == "cuda_mesh":
        return render_pass_mesh(*args)
    if settings.radiance_kernel in ("wavefront", "torch"):
        return integrator.render_camera_pass(*args)
    raise ValueError(f"unresolved radiance_kernel {settings.radiance_kernel!r}"
                     " (settings_for_scene resolves it)")


def _render_step(scene, camera, accum, frame, fresnel_coef, fresnel_pow,
                 fxaa_params, settings, seed):
    rgb, depth = render_pass(scene, settings, camera, frame, fresnel_coef,
                             fresnel_pow, seed)
    accum.add_(rgb)  # in place: the buffer is the renderer's own state
    img = tonemap(accum, frame, settings.gamma)
    if settings.use_fxaa:
        h, w = settings.height, settings.width
        img = fxaa(img.reshape(h, w, 3), *fxaa_params).reshape(-1, 3)
    return img, depth


class Renderer:
    """Stateful progressive renderer with the reference API surface."""

    def __init__(self, width: int = 512, height: int = 512, *,
                 settings: Optional[RenderSettings] = None, seed: int = 0,
                 device="cuda", device_mesh=None):
        """``device_mesh``: an optional ``(tiles, samples)`` mesh
        (``parallel.make_render_mesh``) of ``device``'s type; passes then
        run sharded over it.  None: one device."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device={device!r} but no CUDA device is "
                               "available")
        if self.device.type == "cuda" and self.device.index is None:
            # The tensors' own device, so that device checks compare equal.
            self.device = torch.device("cuda", torch.cuda.current_device())
        if device_mesh is not None:
            from torch.distributed.device_mesh import DeviceMesh

            if not isinstance(device_mesh, DeviceMesh):
                raise TypeError("device_mesh must be a torch.distributed "
                                "DeviceMesh (parallel.make_render_mesh), not "
                                f"{type(device_mesh).__name__}")
            if device_mesh.device_type != self.device.type:
                raise ValueError(f"device_mesh of {device_mesh.device_type!r} "
                                 f"devices, renderer on {self.device}")
        self.device_mesh = device_mesh
        self._sharded = None  # (step, scene, camera, sliders) of the mesh
        base = settings or RenderSettings()
        # The requested backends and compact waves: every scene edit
        # re-resolves them from the current scene (settings_for_scene), so
        # compact waves do not stay on after a paged mesh is replaced.
        self._radiance_request = base.radiance_kernel
        self._traversal_request = base.traversal
        self._compact_request = base.compact_waves
        self.settings = base.replace(width=width, height=height)
        self.scene = Scene.analytic(self.settings, self.device)
        self.camera = Camera.default(self.device)
        self.seed = seed
        f32 = dict(dtype=torch.float32, device=self.device)
        self.fresnel_coef = torch.tensor(0.1, **f32)
        self.fresnel_pow = torch.tensor(3.0, **f32)
        # FXAA sliders (the reference UI's defaults).
        self.fxaa_subpix_quality = 0.75
        self.fxaa_edge_threshold = 0.166
        self.last_stats: Optional[RenderStats] = None
        self._mutate()

    # -- state management ---------------------------------------------------

    def clear_buffer(self):
        """frame=1 and a zeroed accumulation buffer (this rank's tile of it
        with a ``device_mesh``); a sharded renderer rebuilds its step."""
        self.frame = 1
        n = self.settings.n_pixels
        if self.device_mesh is not None:
            from vrenderer_pathtracer_tpu_torch.parallel.sharding import _check_divisible

            _check_divisible(self.settings, self.device_mesh)
            n //= self.device_mesh.size(0)
        self._accum = torch.zeros((n, 3), dtype=torch.float32,
                                  device=self.device)
        self._last_depth = None
        self._sharded = None

    def _mutate(self, **scene_updates):
        """Apply scene edits, re-resolve the backends, reset the frame."""
        if scene_updates:
            self.scene = self.scene.replace(**scene_updates)
        self.settings = settings_for_scene(self.scene, self.settings.replace(
            radiance_kernel=self._radiance_request,
            traversal=self._traversal_request,
            compact_waves=self._compact_request))
        self.clear_buffer()

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
        """Set the lat-long environment map: an [H,W,3] float array or the
        path of an EXR (reference ``loadHDR``)."""
        if isinstance(hdr, (str, bytes)) or hasattr(hdr, "__fspath__"):
            from vrenderer_pathtracer_tpu_torch.native import load_exr

            hdr = load_exr(hdr)
        self._mutate(hdr=self._asset(hdr))

    def load_texture(self, image, gamma: float = 2.2,
                     texture_type: int = DIFFUSE):
        """Set a surface map.  Diffuse maps are stored as ``c**(1/gamma)``,
        the reference's load-time contract (display gamma re-applies it)."""
        img = self._asset(image)
        if texture_type == DIFFUSE:
            self._mutate(diffuse_map=torch.pow(img, 1.0 / gamma))
        elif texture_type == NORMAL:
            self._mutate(normal_map=img)
        elif texture_type == SPECULAR:
            self._mutate(specular_map=img)
        else:
            raise ValueError(f"unknown texture type {texture_type}")

    def load_brdf(self, table):
        """Set a MERL table: a [3, 90*90*180] array or the path of a MERL
        ``.binary`` (reference ``loadBRDF``)."""
        if isinstance(table, (str, bytes)) or hasattr(table, "__fspath__"):
            from vrenderer_pathtracer_tpu_torch.native import load_merl

            table = load_merl(table)
        self._mutate(brdf=self._asset(table))

    def init_mesh(self, mesh: MeshData):
        """Set a packed mesh (``accel/mesh.py::pack_mesh``) on this device."""
        if mesh.device != self.device:
            raise ValueError(f"mesh on {mesh.device}, renderer on {self.device}")
        self._mutate(mesh=mesh)

    def load_mesh(self, path: str):
        """Load an OBJ/PLY, build the SBVH and its 8-wide collapse, paged
        above ``accel/mesh.py::PAGED_MIN_TRIS`` triangles, and upload it
        (reference ``loadMesh``)."""
        from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
        from vrenderer_pathtracer_tpu_torch.native import load_mesh_file

        self.init_mesh(pack_mesh(load_mesh_file(path), paged=None,
                                 device=self.device))

    def use_brdf(self, enable: bool):
        """Shade the example sphere and the mesh with the MERL table
        (without a table: the diffuse weight, on the wavefront)."""
        self.settings = self.settings.replace(use_brdf=enable)
        self._mutate()

    def use_example_sphere(self, enable: bool):
        self.settings = self.settings.replace(use_example_sphere=enable)
        self._mutate()

    def use_cornell_box(self, enable: bool):
        self.settings = self.settings.replace(use_cornell_box=enable)
        self._mutate(spheres=build_sphere_set(enable, self.device))

    def toggle_fxaa(self, enable: bool):
        """Display-time toggle: keeps the accumulation (the reference only
        switches its display shader)."""
        self.settings = self.settings.replace(use_fxaa=enable)

    def set_fxaa_params(self, *, subpix_quality=None, edge_threshold=None):
        if subpix_quality is not None:
            self.fxaa_subpix_quality = float(subpix_quality)
        if edge_threshold is not None:
            self.fxaa_edge_threshold = float(edge_threshold)

    # -- the frame loop -----------------------------------------------------

    def render(self, sync: bool = False):
        """One progressive pass; returns (image01 [H,W,3], depth [H,W]).

        ``sync=True`` waits for the device and records the pass's wall time
        in ``self.last_stats``; the default returns as soon as the work is
        queued.
        """
        t0 = time.perf_counter() if sync else 0.0
        if self.device_mesh is not None:
            img, depth = self._render_sharded()
        else:
            img, depth = _render_step(
                self.scene, self.camera, self._accum, self.frame,
                self.fresnel_coef, self.fresnel_pow,
                (self.fxaa_subpix_quality, self.fxaa_edge_threshold),
                self.settings, self.seed)
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

    def _render_sharded(self):
        """A pass through the sharded step: the tiles' image and depth
        gathered into the frame, then FXAA on the gathered image (it reads
        across tile edges).  The step, and the scene, camera and sliders
        replicated from rank 0, are rebuilt after every edit."""
        from vrenderer_pathtracer_tpu_torch.parallel.multihost import gather_image
        from vrenderer_pathtracer_tpu_torch.parallel.sharding import (
            replicate, sharded_render_step)

        mesh = self.device_mesh
        if self._sharded is None:
            self._sharded = (
                sharded_render_step(mesh, self.settings, seed=self.seed),
                *replicate(mesh, (self.scene, self.camera, self.fresnel_coef,
                                  self.fresnel_pow)))
        step, scene, camera, fc, fp = self._sharded
        self._accum, img, depth = step(scene, camera, self._accum, self.frame,
                                       fc, fp)
        img, depth = gather_image(img, mesh), gather_image(depth, mesh)
        if self.settings.use_fxaa:
            h, w = self.settings.height, self.settings.width
            img = fxaa(img.reshape(h, w, 3), self.fxaa_subpix_quality,
                       self.fxaa_edge_threshold).reshape(-1, 3)
        return img, depth

    def accumulation(self) -> torch.Tensor:
        """The whole frame's accumulation buffer [N,3] (gathered over the
        tiles with a ``device_mesh``; the buffer itself otherwise)."""
        if self.device_mesh is None:
            return self._accum
        from vrenderer_pathtracer_tpu_torch.parallel.multihost import gather_image

        return gather_image(self._accum, self.device_mesh)

    def set_accumulation(self, accum: torch.Tensor) -> None:
        """Set the whole frame's accumulation buffer [N,3] (with a
        ``device_mesh``, this rank keeps its tile of it)."""
        if tuple(accum.shape) != (self.settings.n_pixels, 3):
            raise ValueError(f"accumulation {tuple(accum.shape)} does not fit "
                             f"a {self.settings.width}x{self.settings.height} "
                             "renderer")
        accum = accum.to(self.device, dtype=torch.float32, copy=True)
        if self.device_mesh is not None:
            from vrenderer_pathtracer_tpu_torch.parallel.sharding import shard_pixels

            accum = shard_pixels(self.device_mesh, accum)
        self._accum = accum

    def current_frame(self):
        """The existing accumulation as (image01 [H,W,3], depth [H,W]),
        without running a pass."""
        h, w = self.settings.height, self.settings.width
        img = tonemap(self.accumulation(), max(self.frame - 1, 1),
                      self.settings.gamma)
        if self.settings.use_fxaa:
            img = fxaa(img.reshape(h, w, 3), self.fxaa_subpix_quality,
                       self.fxaa_edge_threshold)
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

    def _asset(self, array) -> torch.Tensor:
        return torch.as_tensor(array, dtype=torch.float32,
                               device=self.device).contiguous()

    def render_frames(self, n: int):
        """Run n progressive passes; return the final image as host numpy."""
        img = depth = None
        for _ in range(n):
            img, depth = self.render()
        return img.cpu().numpy(), depth.cpu().numpy()
