"""Sharded execution and inverse rendering (port of ``parallel/sharding.py``).

The work decomposition is the JAX package's: a 2-D ``(tiles, samples)``
mesh of processes (``torch.distributed.device_mesh.DeviceMesh``; ranks laid
out as ``reshape(n_tiles, n_samples)``):

* ``tiles`` — the flattened pixel axis is cut into contiguous tiles, one a
  mesh row; a tile renders its own raster range and needs no communication;
* ``samples`` — each sample shard draws its own samples (the counter-based
  threefry keys them by global pixel and sample id), and the partial means
  are averaged over the group with an all-reduce.

Every rank holds the whole scene (``replicate`` makes the copies equal) and
its tile of the accumulation (``shard_pixels``).  The passes take the
shard's place in the frame through the kernels' offsets: K1
(``render/cuda_radiance.py``), K4 (``render/cuda_mesh.py``) and the
wavefront (``render/integrator.py::render_camera_pass``) take
``pixel_offset``, ``sample_offset`` and ``n_local_pixels``, K2
(``render/cuda_grad.py``) the pixel range.  The same code runs on one card
(a 1x1 mesh), on gloo ranks on the CPU and on several cards over NCCL.

* ``make_render_mesh``, ``sharded_render_step``, ``replicate``,
  ``shard_pixels`` — the sharded forward pass;
* ``TrainParams`` / ``apply_params`` — the differentiable scene parameters
  (sphere albedo and emission, the Fresnel sliders, optionally the camera
  and the HDRI);
* ``train_step`` / ``opt_step`` — an SGD step and a ``torch.optim`` step on
  one device; ``sharded_train_step`` / ``sharded_opt_step`` their twins
  over a mesh, with ``allreduce_grads_in_bwd`` reducing each gradient in
  the backward pass;
* ``DeferredParams`` / ``apply_deferred`` / ``deferred_opt_step`` /
  ``sharded_deferred_opt_step`` — the table-valued parameters (HDRI,
  diffuse map, MERL table), trained through K4's epilogue.

The loss of every step is ``sum((rgb - target)^2) / (n_pixels * 3)`` of
one pass, and its route is chosen from the parameters and the group's
shape, never from a failure:

* **K2** (``cuda_grad.cornell_loss``: the kernel on the card, plain
  autograd on the CPU) where ``cuda_grad.supports`` holds, ``params.hdr``
  is None and the group has one sample shard.  A tile's K2 sums keep the
  frame's normaliser, so they add up over the tiles;
* **the differentiable wavefront** (``integrator.render_camera_pass``,
  ``radiance_kernel="wavefront"`` on the card, with K3 for a mesh's
  search; ``"torch"`` on the CPU) otherwise.  The loss is of the
  *sample-mean* image, so with several sample shards each shard's image
  is the group's mean in the forward pass (an all-reduce) and its own in
  the backward pass; the gradients are then averaged over the samples and
  summed over the tiles (``allreduce_grads_in_bwd``), which is the
  gradient of the mean (JAX's ``pmean`` under an unchecked ``shard_map``).

``deferred_opt_step`` and its twin keep the scene's resolved backend (K4's
records and ``compose`` on the card) with the same sample-mean form.  The
JAX steps return new arrays and thread optax's state; the optimiser steps
here update the leaves the optimiser holds in place and keep its state in
the optimiser, as ``torch.optim`` does.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.ops.tonemap import tonemap
from vrenderer_pathtracer_tpu_torch.render import cuda_grad, integrator
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene
from vrenderer_pathtracer_tpu_torch.utils.tree import map_tensors

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"


# --- the mesh ---------------------------------------------------------------

def make_render_mesh(n_tiles: Optional[int] = None, n_samples: int = 1,
                     device_type: str = "cuda"):
    """A 2-D ``(tiles, samples)`` ``DeviceMesh`` over the process group's
    ranks, laid out as ``reshape(n_tiles, n_samples)``.

    ``n_tiles`` defaults to ``world_size // n_samples``; a shape that does
    not multiply to the world size raises ``ValueError``.  The process
    group must exist: ``multihost.initialize`` starts it, for one process
    too (``initialize("file:///path", 1, 0)``).
    """
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("no process group: call multihost.initialize "
                           "before make_render_mesh")
    n = dist.get_world_size()
    if n_tiles is None:
        n_tiles = n // n_samples
    if n_tiles * n_samples != n:
        raise ValueError(f"{n_tiles}x{n_samples} mesh != {n} processes")
    return init_device_mesh(device_type, (n_tiles, n_samples),
                            mesh_dim_names=(TILE_AXIS, SAMPLE_AXIS))


def _check_divisible(settings: RenderSettings, mesh):
    n_tiles = mesh.size(0)
    n_samp = mesh.size(1)
    if settings.n_pixels % n_tiles:
        raise ValueError(f"{settings.n_pixels} pixels not divisible by {n_tiles} tiles")
    if settings.samples_per_pass % n_samp and settings.samples_per_pass != 0:
        # each sample-shard renders samples_per_pass/n_samp estimates
        raise ValueError(
            f"samples_per_pass={settings.samples_per_pass} not divisible by "
            f"{n_samp} sample shards"
        )


class _Shard(NamedTuple):
    """This rank's place in a mesh, for one settings' frame."""

    n_tiles: int
    n_samples: int
    tile: int              # my tile index
    sample: int            # my sample-shard index
    tile_px: int           # pixels a tile
    local_spp: int         # samples a shard
    tiles_group: object    # the ranks of my sample index (one a tile)
    samples_group: object  # the ranks of my tile (one a sample shard)
    last_sample: int       # the global rank of my tile's last sample shard

    @property
    def pixel_offset(self) -> int:
        return self.tile * self.tile_px

    @property
    def sample_offset(self) -> int:
        return self.sample * self.local_spp


def _shard(mesh, settings: RenderSettings) -> _Shard:
    _check_divisible(settings, mesh)
    n_tiles, n_samp = mesh.size(0), mesh.size(1)
    tile = mesh.get_local_rank(TILE_AXIS)
    return _Shard(
        n_tiles=n_tiles, n_samples=n_samp, tile=tile,
        sample=mesh.get_local_rank(SAMPLE_AXIS),
        tile_px=settings.n_pixels // n_tiles,
        local_spp=max(settings.samples_per_pass // n_samp, 1),
        tiles_group=mesh.get_group(TILE_AXIS),
        samples_group=mesh.get_group(SAMPLE_AXIS),
        last_sample=int(mesh.mesh[tile, n_samp - 1]))


class _SampleMean(torch.autograd.Function):
    """The mean of a shard's image over its sample group in the forward
    pass; the identity in the backward pass (every shard takes the whole
    cotangent, as JAX's ``pmean`` transposes under an unchecked
    ``shard_map``): averaging the parameter gradients over the samples
    afterwards gives the gradient of the mean."""

    @staticmethod
    def forward(ctx, rgb, group, n):
        total = rgb.detach().clone()
        dist.all_reduce(total, group=group)
        return total / n

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _sample_mean(rgb, sh: Optional[_Shard]):
    if sh is None or sh.n_samples == 1:
        return rgb
    return _SampleMean.apply(rgb, sh.samples_group, sh.n_samples)


def _last_shard_depth(depth, sh: _Shard):
    """Depth from the LAST sample shard only (the single-device pass keeps
    the last sample's depth, and a Cornell kill zeroes it on some shards
    but not others, so a mean would not do): broadcast over the samples."""
    if sh.n_samples == 1:
        return depth
    depth = depth.detach().contiguous().clone()
    dist.broadcast(depth, src=sh.last_sample, group=sh.samples_group)
    return depth


def _tile_sum(x, sh: Optional[_Shard]):
    """A per-tile scalar summed over the tiles (replicated over samples)."""
    if sh is None or sh.n_tiles == 1:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, group=sh.tiles_group)
    return x


def _shard_pass(scene, camera, frame, fresnel_coef, fresnel_pow,
                settings: RenderSettings, seed: int, sh: _Shard):
    """My pixel tile with my sample sub-batch, on the resolved backend:
    ``(rgb [tile_px,3], depth [tile_px])``, rgb the group's sample mean."""
    from vrenderer_pathtracer_tpu_torch.render.renderer import render_pass

    rgb, depth = render_pass(
        scene, settings.replace(samples_per_pass=sh.local_spp), camera, frame,
        fresnel_coef, fresnel_pow, seed, pixel_offset=sh.pixel_offset,
        sample_offset=sh.sample_offset, n_local_pixels=sh.tile_px)
    return _sample_mean(rgb, sh), _last_shard_depth(depth, sh)


def _resolved(scene: Scene, settings: RenderSettings) -> RenderSettings:
    return (settings_for_scene(scene, settings)
            if settings.radiance_kernel == "auto" else settings)


def _check_tile(name, t, sh: _Shard, width: int):
    if tuple(t.shape) != (sh.tile_px, width):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, want this "
                         f"rank's tile ({sh.tile_px}, {width}) "
                         "(shard_pixels)")


def sharded_render_step(mesh, settings: RenderSettings, seed: int = 0,
                        scene: Optional[Scene] = None):
    """Build a progressive-pass function sharded over ``mesh``.

    ``step(scene, camera, accum, frame, fresnel_coef, fresnel_pow) ->
    (accum', img, depth)``, where ``accum`` is this rank's tile of the
    accumulation (``shard_pixels``: ``[n_pixels / n_tiles, 3]``) and
    ``accum'``, ``img`` and ``depth`` are the tile's after the pass, the
    same on every sample shard of the tile.  Each rank renders its tile
    with its samples through the resolved backend (K1, K4 or the
    wavefront, with their offsets); rgb is averaged over the samples and
    depth is the last sample shard's.  Pass ``scene`` to resolve ``"auto"``
    here; otherwise each call resolves it from the scene it is given.
    """
    if scene is not None:
        settings = settings_for_scene(scene, settings)
    sh = _shard(mesh, settings)

    def step(scene, camera, accum, frame, fresnel_coef, fresnel_pow):
        _check_tile("accum", accum, sh, 3)
        rgb, depth = _shard_pass(scene, camera, frame, fresnel_coef,
                                 fresnel_pow, _resolved(scene, settings),
                                 seed, sh)
        accum = accum + rgb
        return accum, tonemap(accum, frame, settings.gamma), depth

    return step


def replicate(mesh, tree):
    """Rank 0's copy of every tensor of ``tree`` on every rank (the scene
    upload: each rank holds the whole scene).  Returns new tensors."""
    del mesh  # the copies are the whole group's
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return tree

    def bcast(_, t):
        t = t.detach().contiguous().clone()
        dist.broadcast(t, src=0)
        return t

    return map_tensors(bcast, tree)


def shard_pixels(mesh, tree):
    """This rank's tile of every tensor of ``tree`` along its leading
    (pixel) axis: rows ``[tile * n / n_tiles, (tile + 1) * n / n_tiles)``."""
    n_tiles, tile = mesh.size(0), mesh.get_local_rank(TILE_AXIS)

    def take(_, t):
        if t.shape[0] % n_tiles:
            raise ValueError(f"{t.shape[0]} rows not divisible by {n_tiles} tiles")
        rows = t.shape[0] // n_tiles
        return t[tile * rows:(tile + 1) * rows].clone()

    return map_tensors(take, tree)


# --- inverse rendering ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrainParams:
    """Differentiable scene parameters; every leaf a float32 tensor.
    ``camera`` and ``hdr`` are optional: None trains neither."""

    color: torch.Tensor          # [N_spheres, 3] albedo
    emission: torch.Tensor       # [N_spheres, 3]
    fresnel_coef: torch.Tensor   # []
    fresnel_pow: torch.Tensor    # []
    camera: Optional[Camera] = None     # optimise the camera too
    hdr: Optional[torch.Tensor] = None  # optimise the environment map

    @classmethod
    def from_scene(cls, scene: Scene, fresnel_coef=0.1, fresnel_pow=3.0,
                   camera: Optional[Camera] = None,
                   optimize_hdr: bool = False) -> "TrainParams":
        f32 = dict(dtype=torch.float32, device=scene.device)
        hdr = scene.hdr if optimize_hdr else None
        return cls(color=scene.spheres.color.clone(),
                   emission=scene.spheres.emission.clone(),
                   fresnel_coef=torch.tensor(fresnel_coef, **f32),
                   fresnel_pow=torch.tensor(fresnel_pow, **f32),
                   camera=camera,
                   hdr=None if hdr is None else hdr.detach().clone())

    def leaves(self) -> list:
        """color, emission, fresnel_coef, fresnel_pow, then the camera's
        origin, yaw, pitch, fov_deg when it is present, then the HDRI when
        it is present."""
        out = [self.color, self.emission, self.fresnel_coef, self.fresnel_pow]
        if self.camera is not None:
            c = self.camera
            out += [c.origin, c.yaw, c.pitch, c.fov_deg]
        if self.hdr is not None:
            out.append(self.hdr)
        return out

    def with_leaves(self, leaves) -> "TrainParams":
        """The same structure holding ``leaves`` (in :meth:`leaves` order)."""
        leaves = list(leaves)
        n_cam = 4 if self.camera is not None else 0
        camera = Camera(*leaves[4:4 + n_cam]) if n_cam else None
        hdr = leaves[4 + n_cam] if self.hdr is not None else None
        return TrainParams(*leaves[:4], camera=camera, hdr=hdr)


def apply_params(scene: Scene, params: TrainParams) -> Scene:
    """``scene`` with the albedo and emission of ``params``, and its HDRI
    when ``params.hdr`` is set."""
    scene = scene.replace_spheres(color=params.color, emission=params.emission)
    return scene if params.hdr is None else scene.replace(hdr=params.hdr)


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but no CUDA device is "
                           "available")
    return device


def _check_on(device: torch.device, scene: Scene, target) -> None:
    for name, dev in (("scene", scene.device), ("target", target.device)):
        if dev.type != device.type or (
                device.index is not None and dev.index != device.index):
            raise ValueError(f"{name} on {dev}, step on {device}")


def _global_norm(grads) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def _uses_k2(params: TrainParams, scene: Scene, settings: RenderSettings,
            n_samples: int = 1) -> bool:
    """Whether a train step's loss takes K2 (module docstring): K2 covers
    the scene, no HDRI is trained, and the group has one sample shard."""
    flags = settings_for_scene(scene, settings.replace(
        radiance_kernel="auto", traversal="auto"))
    return (n_samples == 1 and params.hdr is None
            and cuda_grad.supports(scene, flags))


def _wavefront_settings(scene: Scene, settings: RenderSettings):
    """The differentiable integrator's settings for ``scene``: the
    wavefront on the card (K3/K3b/K5 as its mesh search), the plain
    integrator on the CPU."""
    on_cuda = scene.device.type == "cuda"
    return settings_for_scene(scene, settings.replace(
        radiance_kernel="wavefront" if on_cuda else "auto"))


def _train_loss(params: TrainParams, scene: Scene, settings: RenderSettings,
                camera: Camera, target, frame, seed: int,
                sh: Optional[_Shard] = None):
    """The L2 train loss of ``params`` on ``scene`` (this rank's tile's,
    with ``sh``), on the route :func:`_uses_k2` names."""
    n = settings.n_pixels
    off, n_local, samples = 0, n, 1
    if sh is not None:
        off, n_local, samples = sh.pixel_offset, sh.tile_px, sh.n_samples
    if _uses_k2(params, scene, settings, samples):
        return cuda_grad.cornell_loss(params, scene, settings, camera, target,
                                      frame, seed, off, n_local)
    s = _wavefront_settings(scene, settings)
    if sh is not None:
        s = s.replace(samples_per_pass=sh.local_spp)
    rgb, _ = integrator.render_camera_pass(
        apply_params(scene, params), s,
        params.camera if params.camera is not None else camera, frame,
        params.fresnel_coef, params.fresnel_pow, seed, off,
        0 if sh is None else sh.sample_offset, n_local)
    rgb = _sample_mean(rgb, sh)
    return torch.sum((rgb - target) ** 2) * (1.0 / (n * 3))


def train_step(settings: RenderSettings, *, seed: int = 0, lr: float = 0.05,
               with_metrics: bool = False, device="cuda"):
    """Build an inverse-rendering SGD step on one device.

    ``step(params, scene, camera, target, frame) -> (params', loss)``:
    renders with ``params`` grafted into ``scene`` (and ``params.camera``
    in place of ``camera`` when it is set), takes the L2 loss against
    ``target`` [N,3] and its gradients (K2 or the wavefront: module
    docstring), and returns ``p - lr * g`` for every leaf.  With
    ``with_metrics=True`` the second element is a dict of ``loss``,
    ``grad_global_norm`` and ``update_norm``.
    """
    device = _device(device)

    def step(params: TrainParams, scene: Scene, camera: Camera, target, frame):
        _check_on(device, scene, target)
        return _sgd(params, lambda p: _train_loss(p, scene, settings, camera,
                                                  target, frame, seed),
                    lr, with_metrics)

    return step


def _sgd(params, loss_fn, lr, with_metrics, mesh=None, sh=None):
    leaves = [t.detach().requires_grad_() for t in params.leaves()]
    with torch.enable_grad():
        p = params.with_leaves(leaves)
        if mesh is not None:
            p = allreduce_grads_in_bwd(p, mesh)
        loss = loss_fn(p)
        grads = torch.autograd.grad(loss, leaves)
    new = params.with_leaves(
        [(x - lr * g).detach() for x, g in zip(leaves, grads)])
    loss = _tile_sum(loss.detach(), sh)
    if not with_metrics:
        return new, loss
    gnorm = _global_norm(grads)
    return new, {"loss": loss, "grad_global_norm": gnorm,
                 "update_norm": lr * gnorm}


def _optimise(optimizer, params, loss_fn, mesh=None, sh=None):
    """Zero the optimiser's gradients, run ``loss_fn(params)`` backward
    (each gradient reduced over ``mesh`` in the backward pass), step."""
    optimizer.zero_grad(set_to_none=True)
    with torch.enable_grad():
        p = params if mesh is None else allreduce_grads_in_bwd(params, mesh)
        loss = loss_fn(p)
        loss.backward()
    grads = [t.grad for t in params.leaves() if t.grad is not None]
    metrics = {"loss": _tile_sum(loss.detach(), sh),
               "grad_global_norm": _global_norm(grads)}
    optimizer.step()
    return params, metrics


def opt_step(settings: RenderSettings, optimizer: torch.optim.Optimizer, *,
             seed: int = 0, device="cuda"):
    """Build a step of ``optimizer`` on one device.

    The optimiser holds the leaves of a ``TrainParams`` that require grad
    (e.g. ``torch.optim.Adam([params.emission], lr=0.1)`` after
    ``params.emission.requires_grad_()``).  ``step(params, scene, camera,
    target, frame) -> (params, metrics)`` zeroes their gradients, runs the
    loss backward (filling ``.grad``), and lets the optimiser update them in
    place.  ``metrics`` holds ``loss`` and ``grad_global_norm`` over the
    leaves that received a gradient.
    """
    device = _device(device)

    def step(params: TrainParams, scene: Scene, camera: Camera, target, frame):
        _check_on(device, scene, target)
        return _optimise(optimizer, params, lambda p: _train_loss(
            p, scene, settings, camera, target, frame, seed))

    return step


class _AllReduceGrad(torch.autograd.Function):
    """The identity whose backward reduces the gradient over the mesh: the
    mean over the samples, summed over the tiles."""

    @staticmethod
    def forward(ctx, x, n_samples):
        ctx.n_samples = n_samples
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return reduce_grad(g, ctx.n_samples), None


def reduce_grad(g, n_samples: int):
    """A gradient summed over every rank of the group and divided by the
    sample shards: the mean over the samples, summed over the tiles."""
    g = g.contiguous().clone()
    dist.all_reduce(g)
    return g / n_samples if n_samples != 1 else g


def allreduce_grads_in_bwd(params, mesh):
    """Identity on ``params`` (a ``TrainParams`` or ``DeferredParams``)
    whose backward all-reduces each leaf's gradient over ``mesh`` (the
    mean over the samples, summed over the tiles) where the backward pass
    finalises it, instead of in one reduction after it.  Wrap the
    parameters at the top of the loss.  The values are those of
    :func:`reduce_grad` applied after the backward pass; every rank must
    take the same backward (the steps here do: their graphs do not depend
    on the data)."""
    n_samp = mesh.size(1)
    return params.with_leaves([
        _AllReduceGrad.apply(t, n_samp) if t.requires_grad else t
        for t in params.leaves()])


def _check_mesh(mesh, scene: Scene, target, sh: _Shard):
    if scene.device.type != mesh.device_type:
        raise ValueError(f"scene on {scene.device}, mesh on {mesh.device_type}")
    if target.device != scene.device:
        raise ValueError(f"target on {target.device}, scene on {scene.device}")
    _check_tile("target", target, sh, 3)


def sharded_train_step(mesh, settings: RenderSettings, seed: int = 0,
                       lr: float = 0.05, with_metrics: bool = False):
    """Build an inverse-rendering SGD step sharded over ``mesh``.

    ``step(params, scene, camera, target, frame) -> (params', loss)``:
    ``target`` is this rank's tile (``shard_pixels``); every rank renders
    its tile with its samples, takes its share of the L2 loss (K2 or the
    wavefront: module docstring), and the gradients are all-reduced in the
    backward pass (:func:`allreduce_grads_in_bwd`), so every rank takes the
    same SGD update.  The loss is summed over the tiles.  With
    ``with_metrics=True`` the second element is a dict of ``loss``,
    ``grad_global_norm`` and ``update_norm``.
    """
    sh = _shard(mesh, settings)

    def step(params: TrainParams, scene: Scene, camera: Camera, target, frame):
        _check_mesh(mesh, scene, target, sh)
        return _sgd(params, lambda p: _train_loss(
            p, scene, settings, camera, target, frame, seed, sh),
            lr, with_metrics, mesh, sh)

    return step


def sharded_opt_step(mesh, settings: RenderSettings,
                     optimizer: torch.optim.Optimizer, seed: int = 0):
    """Like :func:`sharded_train_step`, with a ``torch.optim`` optimiser
    holding the parameters' leaves (as :func:`opt_step`).

    ``step(params, scene, camera, target, frame) -> (params, metrics)``:
    the gradients are reduced over the mesh in the backward pass, so every
    rank's optimiser takes the same update; ``metrics`` holds ``loss``
    (summed over the tiles) and ``grad_global_norm``.
    """
    sh = _shard(mesh, settings)

    def step(params: TrainParams, scene: Scene, camera: Camera, target, frame):
        _check_mesh(mesh, scene, target, sh)
        return _optimise(optimizer, params, lambda p: _train_loss(
            p, scene, settings, camera, target, frame, seed, sh), mesh, sh)

    return step


@dataclasses.dataclass(frozen=True)
class DeferredParams:
    """Table-valued scene parameters whose gradients bypass the kernels: the
    HDRI, the diffuse map and the MERL table, each None (not trained) or a
    float32 tensor."""

    hdr: Optional[torch.Tensor] = None          # [H,W,3] environment map
    diffuse_map: Optional[torch.Tensor] = None  # [H,W,3] linearised texture
    brdf: Optional[torch.Tensor] = None         # [3, TABLE_SIZE] MERL table

    @classmethod
    def from_scene(cls, scene: Scene, hdr=True, diffuse_map=False,
                   brdf=False) -> "DeferredParams":
        """Copies of the chosen tables of ``scene``."""
        def take(on, t):
            return t.detach().clone() if on and t is not None else None

        return cls(hdr=take(hdr, scene.hdr),
                   diffuse_map=take(diffuse_map, scene.diffuse_map),
                   brdf=take(brdf, scene.brdf))

    def leaves(self) -> list:
        """The tables that are set, in field order."""
        return [t for t in (self.hdr, self.diffuse_map, self.brdf)
                if t is not None]

    def with_leaves(self, leaves) -> "DeferredParams":
        """The same structure holding ``leaves`` (in :meth:`leaves` order)."""
        it = iter(leaves)
        return DeferredParams(**{
            f.name: None if getattr(self, f.name) is None else next(it)
            for f in dataclasses.fields(self)})


def apply_deferred(scene: Scene, params: DeferredParams) -> Scene:
    """``scene`` with the tables of ``params`` that are set."""
    kw = {f.name: getattr(params, f.name) for f in dataclasses.fields(params)
          if getattr(params, f.name) is not None}
    return scene.replace(**kw) if kw else scene


def _deferred_loss(params, scene, settings, camera, target, frame,
                   fresnel_coef, fresnel_pow, seed, sh=None):
    from vrenderer_pathtracer_tpu_torch.render.renderer import render_pass

    s = _resolved(scene, settings)
    shard = {}
    if sh is not None:
        s = s.replace(samples_per_pass=sh.local_spp)
        shard = dict(pixel_offset=sh.pixel_offset,
                     sample_offset=sh.sample_offset, n_local_pixels=sh.tile_px)
    rgb, _ = render_pass(apply_deferred(scene, params), s, camera, frame,
                         fresnel_coef, fresnel_pow, seed, **shard)
    rgb = _sample_mean(rgb, sh)
    return torch.sum((rgb - target) ** 2) * (1.0 / (settings.n_pixels * 3))


def deferred_opt_step(settings: RenderSettings,
                      optimizer: torch.optim.Optimizer, *,
                      scene: Optional[Scene] = None, seed: int = 0,
                      device="cuda"):
    """Build a step of ``optimizer`` on :class:`DeferredParams`.

    The optimiser holds the params' tables (each ``requires_grad_()``).
    ``step(params, scene, camera, target, frame, fresnel_coef, fresnel_pow)
    -> (params, metrics)`` renders ``scene`` with the tables grafted in on
    the resolved backend (``settings_for_scene`` of ``scene``, given here or
    at each step), takes ``sum((rgb - target)^2) / (n_pixels * 3)``, runs it
    backward and lets the optimiser update the tables in place.
    ``metrics`` holds ``loss`` and ``grad_global_norm``.
    """
    device = _device(device)
    if scene is not None:
        settings = settings_for_scene(scene, settings)

    def step(params: DeferredParams, scene: Scene, camera: Camera, target,
             frame, fresnel_coef, fresnel_pow):
        _check_on(device, scene, target)
        return _optimise(optimizer, params, lambda p: _deferred_loss(
            p, scene, settings, camera, target, frame, fresnel_coef,
            fresnel_pow, seed))

    return step


def sharded_deferred_opt_step(mesh, settings: RenderSettings,
                              optimizer: torch.optim.Optimizer,
                              scene: Optional[Scene] = None, seed: int = 0):
    """:func:`deferred_opt_step` sharded over ``mesh``: the resolved backend
    (K4's records and ``compose`` on the card) on this rank's tile and
    samples, the sample-mean image, the gradients reduced over the mesh in
    the backward pass.

    ``step(params, scene, camera, target, frame, fresnel_coef, fresnel_pow)
    -> (params, metrics)``, ``target`` this rank's tile; ``metrics`` holds
    ``loss`` (summed over the tiles) and ``grad_global_norm``.
    """
    if scene is not None:
        settings = settings_for_scene(scene, settings)
    sh = _shard(mesh, settings)

    def step(params: DeferredParams, scene: Scene, camera: Camera, target,
             frame, fresnel_coef, fresnel_pow):
        _check_mesh(mesh, scene, target, sh)
        return _optimise(optimizer, params, lambda p: _deferred_loss(
            p, scene, settings, camera, target, frame, fresnel_coef,
            fresnel_pow, seed, sh), mesh, sh)

    return step
