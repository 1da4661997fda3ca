"""Convert the JAX package's scene, camera, sliders and train parameters
into the port's.

The functions take plain numpy leaves, ``{name: np.asarray(leaf)}`` of a
JAX ``SphereSet``, ``Camera`` or ``TrainParams`` (``obj._asdict()``), so
this module imports neither package's JAX code.  Both packages then render,
and differentiate, the same scene.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.parallel.sharding import TrainParams
from vrenderer_pathtracer_tpu_torch.scene.scene import MESH_SLICE, Scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import SphereSet


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def scene_from_numpy(spheres: Mapping[str, np.ndarray], *, device) -> Scene:
    """A sphere-only port ``Scene`` from a JAX ``SphereSet``'s leaves."""
    return Scene(spheres=SphereSet(
        pos=_f32(spheres["pos"], device),
        radius=_f32(spheres["radius"], device),
        emission=_f32(spheres["emission"], device),
        color=_f32(spheres["color"], device),
        refl=torch.tensor(np.asarray(spheres["refl"], np.int32),
                          device=device),
        spec_color=_f32(spheres["spec_color"], device),
    ))


def camera_from_numpy(camera: Mapping[str, np.ndarray], *, device) -> Camera:
    """A port ``Camera`` from a JAX ``Camera``'s leaves."""
    return Camera(**{k: _f32(camera[k], device)
                     for k in ("origin", "yaw", "pitch", "fov_deg")})


def sliders_from_numpy(fresnel_coef, fresnel_pow, *, device):
    """The Fresnel sliders as float32 scalar tensors on ``device``."""
    return _f32(fresnel_coef, device), _f32(fresnel_pow, device)


def train_params_from_numpy(params: Mapping, *, device) -> TrainParams:
    """A port ``TrainParams`` from a JAX ``TrainParams``'s leaves.

    ``camera`` is None or a JAX ``Camera``'s leaves, as for
    :func:`camera_from_numpy`.  A trainable environment map (``hdr``)
    belongs to the mesh slice.
    """
    if params.get("hdr") is not None:
        raise NotImplementedError(f"trainable hdr: {MESH_SLICE}")
    camera = params.get("camera")
    return TrainParams(
        color=_f32(params["color"], device),
        emission=_f32(params["emission"], device),
        fresnel_coef=_f32(params["fresnel_coef"], device),
        fresnel_pow=_f32(params["fresnel_pow"], device),
        camera=None if camera is None else camera_from_numpy(camera,
                                                             device=device),
    )
