"""Inverse rendering on one device (port of ``parallel/sharding.py``).

* ``TrainParams`` — the differentiable scene parameters: sphere albedo and
  emission, the two Fresnel sliders and, optionally, the camera;
* ``apply_params`` — graft them into a scene;
* ``train_step`` — an SGD step ``p - lr * g``, the twin of
  ``sharded_train_step``;
* ``opt_step`` — a step of a ``torch.optim`` optimiser, the twin of
  ``sharded_opt_step`` (optax there);
* ``DeferredParams`` / ``apply_deferred`` / ``deferred_opt_step`` — the
  table-valued parameters (HDRI, diffuse map, MERL table) and an optimiser
  step on them, the twin of ``sharded_deferred_opt_step``.

``train_step`` and ``opt_step`` take their loss and gradients from
``render/cuda_grad.py::cornell_loss``: K2 on the card, plain autograd on
the CPU.  ``deferred_opt_step`` keeps the scene's resolved backend (K4 on
the card where it covers the scene): the tables enter only K4's epilogue
(``render/cuda_mesh.py::compose``), so autograd through it gives their
gradients without a backward kernel.  The steps run on one device; the ``torch.distributed`` sharding of the
JAX module (tile x sample, gradient all-reduce) is ROADMAP Queue 1 item 13
and comes into this module later.  The JAX steps return new arrays; the
optimiser step here updates the leaves it holds in place, as ``torch.optim``
does.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.render.cuda_grad import cornell_loss
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene


@dataclasses.dataclass(frozen=True)
class TrainParams:
    """Differentiable scene parameters; every leaf a float32 tensor."""

    color: torch.Tensor          # [N_spheres, 3] albedo
    emission: torch.Tensor       # [N_spheres, 3]
    fresnel_coef: torch.Tensor   # []
    fresnel_pow: torch.Tensor    # []
    camera: Optional[Camera] = None  # optimise the camera too

    @classmethod
    def from_scene(cls, scene: Scene, fresnel_coef=0.1, fresnel_pow=3.0,
                   camera: Optional[Camera] = None) -> "TrainParams":
        f32 = dict(dtype=torch.float32, device=scene.device)
        return cls(color=scene.spheres.color.clone(),
                   emission=scene.spheres.emission.clone(),
                   fresnel_coef=torch.tensor(fresnel_coef, **f32),
                   fresnel_pow=torch.tensor(fresnel_pow, **f32),
                   camera=camera)

    def leaves(self) -> list:
        """color, emission, fresnel_coef, fresnel_pow, then the camera's
        origin, yaw, pitch, fov_deg when it is present."""
        out = [self.color, self.emission, self.fresnel_coef, self.fresnel_pow]
        if self.camera is not None:
            c = self.camera
            out += [c.origin, c.yaw, c.pitch, c.fov_deg]
        return out

    def with_leaves(self, leaves) -> "TrainParams":
        """The same structure holding ``leaves`` (in :meth:`leaves` order)."""
        leaves = list(leaves)
        camera = Camera(*leaves[4:]) if self.camera is not None else None
        return TrainParams(*leaves[:4], camera=camera)


def apply_params(scene: Scene, params: TrainParams) -> Scene:
    """``scene`` with the albedo and emission of ``params``."""
    return scene.replace_spheres(color=params.color, emission=params.emission)


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


def train_step(settings: RenderSettings, *, seed: int = 0, lr: float = 0.05,
               with_metrics: bool = False, device="cuda"):
    """Build an inverse-rendering SGD step on one device.

    ``step(params, scene, camera, target, frame) -> (params', loss)``:
    renders with ``params`` grafted into ``scene`` (and ``params.camera``
    in place of ``camera`` when it is set), takes the L2 loss against
    ``target`` [N,3] and its gradients, and returns ``p - lr * g`` for every
    leaf.  With ``with_metrics=True`` the second element is a dict of
    ``loss``, ``grad_global_norm`` and ``update_norm``.
    """
    device = _device(device)

    def step(params: TrainParams, scene: Scene, camera: Camera, target, frame):
        _check_on(device, scene, target)
        leaves = [t.detach().requires_grad_() for t in params.leaves()]
        with torch.enable_grad():
            loss = cornell_loss(params.with_leaves(leaves), scene, settings,
                                camera, target, frame, seed)
            grads = torch.autograd.grad(loss, leaves)
        new = params.with_leaves(
            [(p - lr * g).detach() for p, g in zip(leaves, grads)])
        loss = loss.detach()
        if not with_metrics:
            return new, loss
        gnorm = _global_norm(grads)
        return new, {"loss": loss, "grad_global_norm": gnorm,
                     "update_norm": lr * gnorm}

    return step


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
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss = cornell_loss(params, scene, settings, camera, target,
                                frame, seed)
            loss.backward()
        grads = [t.grad for t in params.leaves() if t.grad is not None]
        metrics = {"loss": loss.detach(), "grad_global_norm": _global_norm(grads)}
        optimizer.step()
        return params, metrics

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


def apply_deferred(scene: Scene, params: DeferredParams) -> Scene:
    """``scene`` with the tables of ``params`` that are set."""
    kw = {f.name: getattr(params, f.name) for f in dataclasses.fields(params)
          if getattr(params, f.name) is not None}
    return scene.replace(**kw) if kw else scene


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
    from vrenderer_pathtracer_tpu_torch.render.renderer import render_pass

    device = _device(device)
    if scene is not None:
        settings = settings_for_scene(scene, settings)
    inv_n = 1.0 / (settings.n_pixels * 3)

    def step(params: DeferredParams, scene: Scene, camera: Camera, target,
             frame, fresnel_coef, fresnel_pow):
        _check_on(device, scene, target)
        s = (settings_for_scene(scene, settings)
             if settings.radiance_kernel == "auto" else settings)
        optimizer.zero_grad(set_to_none=True)
        with torch.enable_grad():
            rgb, _ = render_pass(apply_deferred(scene, params), s, camera,
                                 frame, fresnel_coef, fresnel_pow, seed)
            loss = torch.sum((rgb - target) ** 2) * inv_n
            loss.backward()
        grads = [t.grad for t in params.leaves() if t.grad is not None]
        metrics = {"loss": loss.detach(), "grad_global_norm": _global_norm(grads)}
        optimizer.step()
        return params, metrics

    return step
