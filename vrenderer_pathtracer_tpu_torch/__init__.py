"""vrenderer_pathtracer_tpu_torch — the PyTorch + CUDA port of the path tracer.

A second package beside ``vrenderer_pathtracer_tpu`` (the JAX reference,
which stays as it is).  It keeps the reference's module layout and names.
It covers the progressive forward render (``Renderer``): the analytic
Cornell scene through one hand-written CUDA kernel a pass
(``csrc/radiance.cu``), general mesh, example-sphere, HDRI, texture and
MERL scenes through the fused kernel ``csrc/mesh.cu`` and its torch
epilogue, and the rest through the torch wavefront with the BVH kernels of
``csrc/traverse.cu``, or, for a paged mesh (BASELINE config 5's
~499k-triangle class), the paged kernel ``csrc/paged.cu`` with compact
bounce waves, ray sorting, bounce remat and FXAA; the Cornell training step (``parallel/sharding.py``:
``train_step`` and ``opt_step``, whose loss and gradients come from
``csrc/grad.cu``); and the deferred-table step ``deferred_opt_step`` (HDRI,
diffuse map and MERL table, by autograd through the fused kernel's
epilogue).  Assets load from files (OBJ, PLY, FBX, EXR, images: ``io/``),
progressive renders checkpoint and resume (``render/progressive.py``),
``python -m vrenderer_pathtracer_tpu_torch render`` is the command line
(``cli.py``) and ``... view`` the terminal viewer (``view.py``); the
example scripts are ``examples/`` and the scaling harness
``bench_scaling.py``.  Entry points run on the card unless the caller
passes ``device="cpu"``; on the CPU the same API runs the plain PyTorch
integrator and autograd.  The package never imports jax.
"""

__version__ = "0.1.0"

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
from vrenderer_pathtracer_tpu_torch.render.renderer import Renderer
from vrenderer_pathtracer_tpu_torch.parallel.sharding import (
    DeferredParams, TrainParams, deferred_opt_step, opt_step, train_step)

__all__ = ["RenderSettings", "Camera", "Scene", "Renderer", "TrainParams",
           "DeferredParams", "train_step", "opt_step", "deferred_opt_step",
           "__version__"]
