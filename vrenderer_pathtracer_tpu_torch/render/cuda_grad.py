"""K2, the Cornell loss + gradient kernel: wrapper, autograd Function and
plain version.

Port of ``vrenderer_pathtracer_tpu/render/pallas_grad.py``.  The kernel
itself is hand-written CUDA C++ in ``csrc/grad.cu``; its header says what it
computes and what bounds it on the card.  The loss is the L2 train loss of
one progressive pass, ``sum((rgb - target)**2) / (N*3)`` (the JAX
package's ``parallel/sharding.py`` loss on one device).  This module:

* ``cornell_loss_grads_reference`` — the plain version: torch autograd of
  ``generate_rays`` + ``integrator.render_pass`` under that loss;
* ``launch`` — K2 on packed tables, returning its reduced row of sums;
  ``launch.count`` counts kernel launches; ``unpack`` reads the row;
* ``cornell_loss_grads`` — the wrapper.  CPU tensors take the plain
  version; CUDA tensors launch K2 (built at first use) or raise;
* ``CornellLoss`` / ``cornell_loss`` — the loss as an autograd node:
  ``cornell_loss(params, ...).backward()`` fills ``.grad`` of each
  ``TrainParams`` leaf that requires it, through K2 on the card and plain
  autograd on the CPU.

Every gradient function returns ``(loss, dcolor [Ns,3], demission [Ns,3],
dfresnel_coef, dfresnel_pow)`` and, with ``with_camera``, a sixth element:
a ``Camera`` whose leaves are the gradients with respect to ``origin``,
``yaw``, ``pitch`` and ``fov_deg``.

Each takes a tile of the frame (``parallel/sharding.py``): the raster
range ``[pixel_offset, pixel_offset + n_local_pixels)``, whose target is
the tile's ``[n_local_pixels, 3]``.  The loss and the gradients keep the
frame's normaliser ``1 / (N*3)``, so the tiles' values add up to the
frame's.  K2 takes no sample offset: the loss is of the sample-mean image,
so a sample shard cannot form its own residual (the sharded steps take the
wavefront there).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.render import cuda_radiance, integrator
from vrenderer_pathtracer_tpu_torch.render.cuda_radiance import (
    pack_camera, pack_spheres, render_pass_reference)
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

# Each block keeps K + 6 columns of 128 floats in shared memory, K = 3 +
# 6*Ns (+12); 64 spheres (206 KiB with the camera) fit the 227 KiB a block
# may take.  A launch takes at most 16 (sample, bounce) steps a pixel
# (csrc/grad.cu kMaxRecords); a thread keeps one sample's records at a time.
MAX_SPHERES = 64
MAX_RECORDS = 16


def supports(scene: Scene, settings: RenderSettings) -> bool:
    """K2's scope: K1's (Cornell sphere scenes, no assets), at most
    ``MAX_SPHERES`` spheres and ``MAX_RECORDS`` samples x bounces."""
    return (cuda_radiance.supports(scene, settings)
            and scene.spheres.count <= MAX_SPHERES
            and 0 < settings.samples_per_pass * settings.bounces <= MAX_RECORDS)


def n_partials(n_spheres: int, with_camera: bool) -> int:
    """Width K of K2's partials row."""
    return 3 + 6 * n_spheres + (12 if with_camera else 0)


def _camera_leaves(camera: Camera):
    return [camera.origin, camera.yaw, camera.pitch, camera.fov_deg]


def _plain_loss(scene, settings, camera, target, frame, fresnel_coef,
                fresnel_pow, seed, pixel_offset=0, n_local_pixels=None):
    rgb, _ = render_pass_reference(scene, settings, camera, frame,
                                   fresnel_coef, fresnel_pow, seed,
                                   pixel_offset, 0, n_local_pixels)
    return torch.sum((rgb - target) ** 2) * (1.0 / (settings.n_pixels * 3))


def cornell_loss_grads_reference(scene: Scene, settings: RenderSettings,
                                 camera: Camera, target, frame, fresnel_coef,
                                 fresnel_pow, seed: int = 0,
                                 with_camera: bool = False,
                                 pixel_offset: int = 0, n_local_pixels=None):
    """The plain PyTorch version of K2: loss and gradients by autograd."""
    f32 = dict(dtype=torch.float32, device=scene.device)
    leaves = [scene.spheres.color, scene.spheres.emission,
              torch.as_tensor(fresnel_coef, **f32).reshape(()),
              torch.as_tensor(fresnel_pow, **f32).reshape(())]
    if with_camera:
        leaves += _camera_leaves(camera)
    leaves = [t.detach().requires_grad_() for t in leaves]
    color, emission, fc, fp = leaves[:4]
    if with_camera:
        camera = Camera(*leaves[4:])
    with torch.enable_grad():
        loss = _plain_loss(scene.replace_spheres(color=color, emission=emission),
                           settings, camera, target, frame, fc, fp, seed,
                           pixel_offset, n_local_pixels)
        grads = torch.autograd.grad(loss, leaves)
    out = (loss.detach(), *grads[:4])
    return out + (Camera(*grads[4:]),) if with_camera else out


@functools.lru_cache(maxsize=None)
def _k2():
    from vrenderer_pathtracer_tpu_torch.kernels import build

    lib = build.load("grad")
    workspace = lib.vpt_grad_workspace_floats
    workspace.argtypes = [ctypes.c_int, ctypes.c_int]
    workspace.restype = ctypes.c_longlong
    fn = lib.vpt_grad
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = [ptr, ptr, i32, u32, u32, u32, i32, i32, i32, i32, i32,
                   i32, i32, ptr, ptr, ptr, i32, ptr]
    fn.restype = ctypes.c_int
    return fn, workspace


def launch(cam: torch.Tensor, sph: torch.Tensor, settings: RenderSettings,
           target: torch.Tensor, frame: int, seed: int = 0,
           with_camera: bool = False, fault: bool = False,
           pixel_offset: int = 0, n_local_pixels=None) -> torch.Tensor:
    """Launch K2 on packed tables (``cuda_radiance.pack_camera`` /
    ``pack_spheres``) on the current stream over the pixels
    ``[pixel_offset, pixel_offset + n)`` (``n = n_local_pixels``, default the
    rest of the frame; ``target`` is their ``[n, 3]``); returns the reduced
    row ``[K]`` of sums (see ``csrc/grad.cu`` for the layout and
    :func:`unpack`).
    ``fault`` launches the instance with a planted fault (channel 1's
    unit-g sums scaled by channel 0's g; material-only), for
    ``chip_smoke.py``'s check that the contract catches it."""
    device = cam.device
    if not 0 < settings.n_pixels < 2 ** 31:
        raise ValueError(f"{settings.n_pixels} pixels is out of the kernel's range")
    off, n = integrator.pixel_range(settings, pixel_offset, n_local_pixels)
    for name, t, shape in (("cam", cam, (14,)), ("spheres", sph, None),
                           ("target", target, (n, 3))):
        if t.device != device or device.type != "cuda":
            raise ValueError(f"K2 {name} on {t.device}, want one CUDA device")
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"K2 {name} must be contiguous float32")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"K2 {name} has shape {tuple(t.shape)}, want {shape}")
    if sph.dim() != 2 or sph.shape[1] != 14 or not 0 < sph.shape[0] <= MAX_SPHERES:
        raise ValueError(f"K2 spheres table has shape {tuple(sph.shape)}")
    records = settings.samples_per_pass * settings.bounces
    if not 0 < records <= MAX_RECORDS:
        raise ValueError(f"K2 takes 1..{MAX_RECORDS} samples x bounces, not {records}")
    if fault and with_camera:
        raise ValueError("K2's planted fault is material-only")

    fn, workspace = _k2()
    k = n_partials(sph.shape[0], with_camera)
    work = torch.empty((workspace(n, k),), dtype=torch.float32, device=device)
    row = torch.empty((k,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = fn(cam.data_ptr(), sph.data_ptr(), sph.shape[0],
                 seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF,
                 int(frame) & 0xFFFFFFFF, settings.width, settings.height,
                 settings.samples_per_pass, settings.bounces, int(with_camera),
                 off, n, target.data_ptr(), work.data_ptr(), row.data_ptr(),
                 int(fault), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError_t {err}")
    launch.count += 1
    return row


launch.count = 0


def unpack(row: torch.Tensor, n_spheres: int, n_pixels: int):
    """K2's row of sums as ``((loss, dcolor [Ns,3], demission [Ns,3],
    dfresnel_coef, dfresnel_pow), dcam)``: ``dcam`` is the [12] cotangent
    of (origin, view dir, cx, cy) when the row has the camera's sums, else
    None."""
    ns = n_spheres
    if row.shape[0] not in (n_partials(ns, False), n_partials(ns, True)):
        raise ValueError(f"a row of {row.shape[0]} sums is not K2's for {ns} spheres")
    rows = row[1:1 + 6 * ns].reshape(ns, 6)
    out = (row[0] * (1.0 / (n_pixels * 3)), rows[:, :3], rows[:, 3:],
           row[1 + 6 * ns], row[2 + 6 * ns])
    return out, (row[3 + 6 * ns:] if row.shape[0] == n_partials(ns, True)
                 else None)


def _camera_pullback(camera: Camera, settings: RenderSettings,
                     dvec: torch.Tensor) -> Camera:
    """Pull the cotangents of (origin, view dir, cx, cy) back to the
    camera's leaves through ``Camera.basis`` (the twin of ``jax.vjp`` in
    ``pallas_grad.py``)."""
    leaves = [t.detach().requires_grad_() for t in _camera_leaves(camera)]
    with torch.enable_grad():
        vec = pack_camera(Camera(*leaves), settings, 0.0, 0.0)[:12]
        grads = torch.autograd.grad(vec, leaves, grad_outputs=dvec)
    return Camera(*grads)


def cornell_loss_grads(scene: Scene, settings: RenderSettings, camera: Camera,
                       target, frame, fresnel_coef, fresnel_pow,
                       seed: int = 0, with_camera: bool = False,
                       pixel_offset: int = 0, n_local_pixels=None):
    """L2 loss and gradients of one pass through K2.

    CPU tensors take :func:`cornell_loss_grads_reference`.  CUDA tensors
    launch the kernel on the current stream; a failed build or launch
    raises.
    """
    device = scene.device
    if device.type == "cpu":
        return cornell_loss_grads_reference(scene, settings, camera, target,
                                            frame, fresnel_coef, fresnel_pow,
                                            seed, with_camera, pixel_offset,
                                            n_local_pixels)
    if device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA devices, not {device}")
    if not supports(scene, settings):
        raise NotImplementedError(
            "K2 covers Cornell sphere scenes with at most "
            f"{MAX_SPHERES} spheres, {MAX_RECORDS} samples x bounces and no "
            "assets")
    if camera.device != device:
        raise ValueError(f"camera on {camera.device}, scene on {device}")
    with torch.no_grad():
        cam = pack_camera(camera, settings, fresnel_coef, fresnel_pow)
        sph = pack_spheres(scene.spheres)
    out, dcam = unpack(launch(cam, sph, settings, target, frame, seed,
                              with_camera, pixel_offset=pixel_offset,
                              n_local_pixels=n_local_pixels),
                       scene.spheres.count, settings.n_pixels)
    if not with_camera:
        return out
    return out + (_camera_pullback(camera, settings, dcam),)


class CornellLoss(torch.autograd.Function):
    """The L2 train loss as an autograd node over K2.

    ``forward`` launches K2 once, saves the gradients it returns, and
    returns the loss; ``backward`` scales the saved gradients by the
    incoming ``grad_output``.
    """

    @staticmethod
    def forward(ctx, color, emission, fresnel_coef, fresnel_pow, origin, yaw,
                pitch, fov_deg, scene, settings, target, frame, seed,
                with_camera, pixel_offset=0, n_local_pixels=None):
        out = cornell_loss_grads(
            scene.replace_spheres(color=color, emission=emission), settings,
            Camera(origin, yaw, pitch, fov_deg), target, frame, fresnel_coef,
            fresnel_pow, seed, with_camera, pixel_offset, n_local_pixels)
        grads = list(out[1:5])
        grads += _camera_leaves(out[5]) if with_camera else [None] * 4
        ctx.save_for_backward(*grads)
        return out[0]

    @staticmethod
    def backward(ctx, grad_output):
        grads = [grad_output * g if need and g is not None else None
                 for g, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        return (*grads, None, None, None, None, None, None, None, None)


def cornell_loss(params, scene: Scene, settings: RenderSettings,
                 camera: Camera, target, frame, seed: int = 0,
                 pixel_offset: int = 0, n_local_pixels=None):
    """The L2 train loss of ``params`` (a ``parallel.sharding.TrainParams``)
    grafted into ``scene``; differentiable in every leaf of ``params``
    (``params.hdr`` aside: K2 has none).  A tile's loss with the offsets.

    ``params.camera``, when given, replaces ``camera`` and receives
    gradients.  On the card this is :class:`CornellLoss` (one K2 launch);
    on the CPU it is plain autograd through the integrator.
    """
    with_camera = params.camera is not None
    cam = params.camera if with_camera else camera
    if scene.device.type == "cpu":
        return _plain_loss(
            scene.replace_spheres(color=params.color, emission=params.emission),
            settings, cam, target, frame, params.fresnel_coef,
            params.fresnel_pow, seed, pixel_offset, n_local_pixels)
    return CornellLoss.apply(params.color, params.emission, params.fresnel_coef,
                             params.fresnel_pow, *_camera_leaves(cam), scene,
                             settings, target, frame, seed, with_camera,
                             pixel_offset, n_local_pixels)
