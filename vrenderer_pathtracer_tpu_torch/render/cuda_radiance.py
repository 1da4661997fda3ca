"""K1, the Cornell radiance kernel: wrapper, packing and plain version.

Port of ``vrenderer_pathtracer_tpu/render/pallas_radiance.py``.  The kernel
itself is hand-written CUDA C++ in ``csrc/radiance.cu``; its header says
what it computes and what bounds it on the card.  This module:

* ``supports`` — the kernel's scope (Cornell sphere scenes, no assets);
* ``pack_camera`` / ``pack_spheres`` — the small tables the kernel reads;
* ``render_pass_reference`` — the plain PyTorch version of the kernel,
  ``integrator.render_camera_pass`` (``.count`` counts its calls; the
  wavefront calls ``render_camera_pass`` itself, not this);
* ``render_pass_cuda`` — the wrapper.  Tensors on the CPU take the plain
  version; tensors on a CUDA device launch the kernel (built at first use)
  or raise;
* ``launch`` — the launch itself on packed tables; ``launch.count``
  counts kernel launches.

Every pass takes a shard's place in the frame (``parallel/sharding.py``):
``pixel_offset`` and ``n_local_pixels`` name the raster range
``[pixel_offset, pixel_offset + n_local_pixels)`` it renders, and
``sample_offset`` its first sample id; the defaults are the whole frame
and sample 0.  The kernel takes them as launch arguments, beside the
packed tables.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.render import integrator
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import SphereSet
from vrenderer_pathtracer_tpu_torch.utils.profiling import plain_version

# Spheres the kernel stages in shared memory (csrc/common.cuh
# kSmemSpheres, 14 floats each); a larger table is read from global memory.
SMEM_SPHERES = 512


def supports(scene: Scene, settings: RenderSettings) -> bool:
    """Kernel scope: Cornell sphere scenes with no gathered assets."""
    return (
        settings.use_cornell_box
        and not settings.use_example_sphere
        and not settings.has_mesh
        and not settings.has_hdr
        and not settings.has_brdf
        and not (settings.has_diffuse_map or settings.has_normal_map
                 or settings.has_specular_map)
    )


def pack_camera(camera: Camera, settings: RenderSettings, fresnel_coef,
                fresnel_pow) -> torch.Tensor:
    """[14] float32: origin, view dir, cx, cy, fresnel coef, fresnel pow,
    where ``cx``/``cy`` are the basis vectors scaled as in ``generate_rays``."""
    origin, view_dir, up, right, fov_scale = camera.basis()
    cx = (fov_scale * (settings.width / settings.height)) * right
    cy = fov_scale * up
    f32 = dict(dtype=torch.float32, device=origin.device)
    sliders = torch.stack([torch.as_tensor(fresnel_coef, **f32).reshape(()),
                           torch.as_tensor(fresnel_pow, **f32).reshape(())])
    return torch.cat([origin, view_dir, cx, cy, sliders]).contiguous()


def pack_spheres(spheres: SphereSet) -> torch.Tensor:
    """[Ns, 14] float32 rows: pos xyz, radius, color, emission, spec color,
    reflection type."""
    return torch.cat([
        spheres.pos, spheres.radius[:, None], spheres.color, spheres.emission,
        spheres.spec_color, spheres.refl[:, None].to(torch.float32),
    ], dim=1).contiguous()


@plain_version
def render_pass_reference(scene: Scene, settings: RenderSettings,
                          camera: Camera, frame, fresnel_coef, fresnel_pow,
                          seed: int = 0, pixel_offset: int = 0,
                          sample_offset: int = 0, n_local_pixels=None):
    """The plain PyTorch version of K1, ``integrator.render_camera_pass``:
    ``(rgb_mean [n,3], depth [n])``."""
    render_pass_reference.count += 1
    return integrator.render_camera_pass(
        scene, settings, camera, frame, fresnel_coef, fresnel_pow, seed,
        pixel_offset, sample_offset, n_local_pixels)


render_pass_reference.count = 0


@functools.lru_cache(maxsize=None)
def _k1():
    from vrenderer_pathtracer_tpu_torch.kernels import build

    fn = build.load("radiance").vpt_radiance
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = [ptr, ptr, i32, u32, u32, u32, i32, i32, i32, i32,
                   ctypes.c_float, i32, u32, i32, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    return fn


def launch(cam: torch.Tensor, sph: torch.Tensor, settings: RenderSettings,
           frame: int, seed: int = 0, pixel_offset: int = 0,
           sample_offset: int = 0, n_local_pixels=None):
    """Launch K1 on packed tables (:func:`pack_camera`,
    :func:`pack_spheres`) on the current stream over the pixels
    ``[pixel_offset, pixel_offset + n)`` (``n = n_local_pixels``, default
    the rest of the frame) with the samples from ``sample_offset``;
    ``(rgb [n,3], depth [n])``.
    """
    device = cam.device
    for name, t, shape in (("cam", cam, (14,)), ("spheres", sph, None)):
        if t.device != device or device.type != "cuda":
            raise ValueError(f"K1 {name} table on {t.device}, want one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"K1 {name} table must be contiguous float32")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"K1 {name} table has shape {tuple(t.shape)}")
    if sph.dim() != 2 or sph.shape[1] != 14 or not 0 < sph.shape[0] < 2 ** 24:
        raise ValueError(f"K1 spheres table has shape {tuple(sph.shape)}")
    if not 0 < settings.n_pixels < 2 ** 31:
        raise ValueError(f"{settings.n_pixels} pixels is out of the kernel's range")
    off, n = integrator.pixel_range(settings, pixel_offset, n_local_pixels)
    if not 0 <= sample_offset < 2 ** 32 - settings.samples_per_pass:
        raise ValueError(f"sample_offset {sample_offset} is out of range")

    rgb = torch.empty((n, 3), dtype=torch.float32, device=device)
    depth = torch.empty((n,), dtype=torch.float32, device=device)
    fn = _k1()
    with torch.cuda.device(device):
        err = fn(cam.data_ptr(), sph.data_ptr(), sph.shape[0],
                 seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
                 int(frame) & 0xFFFFFFFF, settings.width, settings.height,
                 settings.samples_per_pass, settings.bounces,
                 settings.depth_scale, off, sample_offset, n, rgb.data_ptr(),
                 depth.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError_t {err}")
    launch.count += 1
    return rgb, depth


launch.count = 0


def render_pass_cuda(scene: Scene, settings: RenderSettings, camera: Camera,
                     frame: int, fresnel_coef, fresnel_pow, seed: int = 0,
                     pixel_offset: int = 0, sample_offset: int = 0,
                     n_local_pixels=None):
    """One progressive pass through K1: ``(rgb_mean [n,3], depth [n])``
    over the pixel range and samples the offsets name (module docstring).

    CPU tensors take :func:`render_pass_reference`.  CUDA tensors launch
    the kernel on the current stream; a failed build or launch raises.
    """
    device = scene.device
    if device.type == "cpu":
        return render_pass_reference(scene, settings, camera, frame,
                                     fresnel_coef, fresnel_pow, seed,
                                     pixel_offset, sample_offset,
                                     n_local_pixels)
    if device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA devices, not {device}")
    if not supports(scene, settings):
        raise NotImplementedError(
            "K1 covers Cornell sphere scenes with no assets")
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    return launch(pack_camera(camera, settings, fresnel_coef, fresnel_pow),
                  pack_spheres(scene.spheres), settings, frame, seed,
                  pixel_offset, sample_offset, n_local_pixels)
