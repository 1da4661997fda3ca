"""Convert the JAX package's scene, camera and sliders into the port's.

The functions take plain numpy leaves, ``{name: np.asarray(leaf)}`` of a
JAX ``SphereSet`` or ``Camera`` (``obj._asdict()``), so this module imports
neither package's JAX code.  Both packages then render the same scene.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
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
