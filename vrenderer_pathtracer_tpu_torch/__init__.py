"""vrenderer_pathtracer_tpu_torch — the PyTorch + CUDA port of the path tracer.

A second package beside ``vrenderer_pathtracer_tpu`` (the JAX reference,
which stays as it is).  It keeps the reference's module layout and names.
This slice covers the analytic Cornell scene's progressive forward render:
``Renderer(..., device="cuda")`` runs one hand-written CUDA kernel per pass
(``csrc/radiance.cu``); on the CPU the same API runs the plain PyTorch
integrator.  The package never imports jax.
"""

__version__ = "0.1.0"

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
from vrenderer_pathtracer_tpu_torch.render.renderer import Renderer

__all__ = ["RenderSettings", "Camera", "Scene", "Renderer", "__version__"]
