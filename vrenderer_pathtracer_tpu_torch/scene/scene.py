"""Scene container and backend resolution (port of ``scene/scene.py``).

The port's slice holds analytic spheres only.  The asset fields of the JAX
``Scene`` (HDR map, textures, MERL table, mesh) are kept by name and must be
``None``: each belongs to the mesh slice, ROADMAP Queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.scene.spheres import SphereSet, build_sphere_set

MESH_SLICE = "ROADMAP Queue 1 item 9 (mesh slice: mesh, HDRI, textures, MERL)"

_ASSETS = ("hdr", "diffuse_map", "normal_map", "specular_map", "brdf", "mesh")


@dataclasses.dataclass(frozen=True)
class Scene:
    spheres: SphereSet
    hdr: Optional[torch.Tensor] = None
    diffuse_map: Optional[torch.Tensor] = None
    normal_map: Optional[torch.Tensor] = None
    specular_map: Optional[torch.Tensor] = None
    brdf: Optional[torch.Tensor] = None
    mesh: Optional[object] = None

    def __post_init__(self):
        present = [a for a in _ASSETS if getattr(self, a) is not None]
        if present:
            raise NotImplementedError(
                f"scene assets {present} are not ported yet: {MESH_SLICE}")

    @classmethod
    def analytic(cls, settings: RenderSettings, device) -> "Scene":
        """Sphere-only scene matching the settings' Cornell flag."""
        return cls(spheres=build_sphere_set(settings.use_cornell_box, device))

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    def replace_spheres(self, **kw) -> "Scene":
        """The same scene with some sphere fields replaced (e.g. the
        trainable ``color``/``emission``)."""
        return dataclasses.replace(
            self, spheres=dataclasses.replace(self.spheres, **kw))


def settings_for_scene(scene: Scene, settings: RenderSettings) -> RenderSettings:
    """Derive the ``has_*`` flags from the scene and resolve the radiance
    backend from where the sphere tensors live.

    ``"auto"`` becomes ``"cuda"`` (the hand-written kernel) for a CUDA scene
    in the kernel's scope, and ``"torch"`` (the plain integrator) for a CPU
    scene.  A CUDA scene never resolves to the plain path: out of the
    kernel's scope it raises, and so does a request that does not match the
    scene's device.
    """
    from vrenderer_pathtracer_tpu_torch.render.cuda_radiance import supports

    resolved = settings.replace(
        has_diffuse_map=False, has_normal_map=False, has_specular_map=False,
        has_brdf=False, has_mesh=False, has_hdr=False,
    )
    on_cuda = scene.device.type == "cuda"
    want = "cuda" if on_cuda else "torch"
    request = settings.radiance_kernel
    if request not in ("auto", want):
        raise ValueError(
            f"radiance_kernel={request!r} cannot run a scene on "
            f"{scene.device}; use 'auto' or {want!r}")
    if on_cuda and not supports(scene, resolved):
        raise NotImplementedError(
            "the CUDA radiance kernel covers Cornell sphere scenes only; "
            f"other scenes on the card wait for {MESH_SLICE}")
    return resolved.replace(radiance_kernel=want)
