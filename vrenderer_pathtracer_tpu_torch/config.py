"""Static render configuration (PyTorch port).

Same fields, names and defaults as ``vrenderer_pathtracer_tpu/config.py``,
kept as a separate copy because importing the JAX package imports jax.  In
the port the settings select code paths at call time (PyTorch runs
eagerly); nothing is recompiled when they change.

``captured_attrs`` selects the forward-only win-time attribute capture
of the mesh search (K3c, ``accel/traverse.py::mesh_hit``).
``compact_capacity_frac`` and ``compact_mode`` size and switch the JAX
package's static-capacity compact chain; the port compacts with the exact
count and accepts them with no effect (``render/integrator.py::radiance``).
``bounce_block_rows`` and ``pre_tiled`` are TPU kernel block options with
no effect here.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Hashable static render settings.

    * ``width/height``     — framebuffer size
    * ``samples_per_pass`` — samples per pixel per progressive pass
    * ``bounces``          — fixed bounce budget
    * ``use_cornell_box``  — Cornell walls + light; a miss kills the path
    * ``use_example_sphere`` / ``use_brdf`` / ``has_*`` — scene feature flags
    * ``gamma``            — display gamma
    * ``depth_scale``      — depth normalisation (first-hit distance / 150)
    * ``radiance_kernel``  — forward backend: ``"auto"`` resolves in
      ``scene.settings_for_scene``, for a CUDA-resident scene, to
      ``"cuda"`` (K1, ``render/cuda_radiance.py``) for Cornell sphere
      scenes, else ``"cuda_mesh"`` (K4, ``render/cuda_mesh.py``) for the
      general scenes it covers, else ``"wavefront"`` (the integrator with
      the K3/K3b mesh search); and to ``"torch"`` (the plain integrator)
      for a CPU-resident scene.  An explicit value must be the one the
      scene resolves to.
    * ``traversal``        — mesh search: ``"auto"`` resolves to ``"cuda"``
      (K3/K3b), ``"cuda_paged"`` (K5, a paged mesh) or ``"torch"`` (the
      plain searches, CPU scenes)
    * ``compact_waves``    — compact bounce waves; always on for a paged mesh
    * ``sort_rays``        — coherence-sort rays before each mesh search
    * ``remat_bounces``    — recompute each bounce in the backward pass
    * ``captured_attrs``   — shade mesh hits from attributes the search
      captures at win time (K3c; forward only; no compact waves)
    * ``use_fxaa``         — FXAA on the displayed image
    """

    width: int = 512
    height: int = 512
    samples_per_pass: int = 2
    bounces: int = 4
    use_cornell_box: bool = False
    use_example_sphere: bool = False
    use_brdf: bool = False
    has_diffuse_map: bool = False
    has_normal_map: bool = False
    has_specular_map: bool = False
    has_brdf: bool = False
    has_mesh: bool = False
    has_hdr: bool = True
    use_fxaa: bool = False
    traversal: str = "auto"
    remat_bounces: bool = False
    sort_rays: bool = False
    bounce_block_rows: int = 0
    captured_attrs: bool = False
    pre_tiled: bool = False
    radiance_kernel: str = "auto"
    brdf_importance_sampling: bool = False
    compact_waves: bool = False
    compact_capacity_frac: float = 0.125
    compact_mode: str = "cond"
    texture_filter: str = "nearest"
    gamma: float = 2.2
    depth_scale: float = 150.0
    samples_per_chunk: int = 0  # 0 => all samples in one chunk

    def replace(self, **kw) -> "RenderSettings":
        return dataclasses.replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height
