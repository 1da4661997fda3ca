"""vrenderer_pathtracer_tpu_torch — the PyTorch + CUDA port of the path tracer.

A second package beside ``vrenderer_pathtracer_tpu`` (the JAX reference,
which stays as it is).  It keeps the reference's module layout and names.
It covers the analytic Cornell scene: the progressive forward render
(``Renderer``: one hand-written CUDA kernel per pass, ``csrc/radiance.cu``)
and the training step (``parallel/sharding.py``: ``train_step`` and
``opt_step``, whose loss and gradients come from one hand-written CUDA
kernel, ``csrc/grad.cu``).  Entry points run on the card unless the caller
passes ``device="cpu"``; on the CPU the same API runs the plain PyTorch
integrator and autograd.  The package never imports jax.
"""

__version__ = "0.1.0"

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
from vrenderer_pathtracer_tpu_torch.render.renderer import Renderer
from vrenderer_pathtracer_tpu_torch.parallel.sharding import (
    TrainParams, opt_step, train_step)

__all__ = ["RenderSettings", "Camera", "Scene", "Renderer", "TrainParams",
           "train_step", "opt_step", "__version__"]
