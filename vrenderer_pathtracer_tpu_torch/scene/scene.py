"""Scene container and backend resolution (port of ``scene/scene.py``).

A ``Scene`` holds the analytic spheres and the optional assets of the JAX
``Scene``: the lat-long HDRI, the diffuse, normal and specular maps, the
MERL-100 BRDF table and the mesh (:class:`MeshData`).  Every tensor lives on
the spheres' device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.scene.spheres import SphereSet, build_sphere_set

_MAPS = ("hdr", "diffuse_map", "normal_map", "specular_map")


@dataclasses.dataclass(frozen=True)
class PagedNodes:
    """The two-level tree of a paged mesh (``accel/paged.py``).

    Triangles are Morton-ordered into pages of ``page_tris`` slots, each
    page with its own object-split SBVH collapsed to 8 wide.  The nodes of
    all pages and a small 8-wide top-level tree over the page boxes share
    one node space: nodes ``[0, n_top)`` are the top tree (root 0), whose
    inner children of index ``>= n_top`` are the page roots;
    every ref is global, and leaf rows of ``tri_pack`` record global slots
    (``page * page_tris + local``), so the shading arrays of ``MeshData``
    are the JAX package's flat page-blocked slot arrays.  The plain
    version walks the whole tree.  K5 (``accel/cuda_paged.py``) walks it as
    one tree too, on the compressed copy (``nodes8_c``, ``leaf_rows``:
    ``accel/wide.py::compress_wide``, over the top tree and every page),
    in which the page roots are the nodes ``[n_top, n_top + n_pages)``.
    """

    bbox: torch.Tensor        # [P,8] float32 page box: lo xyz, hi xyz, 0, 0
    nodes8_f: torch.Tensor    # [N*8,8] child boxes (lo3, hi3, 0, 0)
    nodes8_i: torch.Tensor    # [N,16] 8 x (ref, count), global refs
    nodes8_ax: torch.Tensor   # [N] build-time sort axis
    tri_pack: torch.Tensor    # [T8,16] (v0, e1, e2, global slot, uv corners)
    nodes8_c: torch.Tensor    # [M,20] int32 compressed nodes (the kernels' copy)
    leaf_rows: torch.Tensor   # [R,12] compact leaf rows (v0, e1, e2, slot, last)
    n_top: int                # nodes of the top-level tree
    page_tris: int            # slots per page

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    @property
    def n_pages(self) -> int:
        return self.bbox.shape[0]


@dataclasses.dataclass(frozen=True)
class MeshData:
    """Flattened SBVH + leaf-ordered triangle streams (see accel/mesh.py),
    with the JAX ``MeshData``'s field names.

    Node encoding (``nodes_i[n] = (c0, n0, c1, n1)``): count 0 -> child is
    inner node ``c``; count > 0 -> leaf of ``n`` tri slots starting at ``c``;
    count < 0 -> empty child (its AABB is inverted so slab tests miss).
    Triangle slots are duplicated per leaf (spatial splits), stored in
    Möller–Trumbore (v0, e1, e2) form with per-corner attributes.

    The 8-wide collapse of the same tree (``nodes8_*``, ``tri_*pack``) is
    what K3 traverses; without it (``nodes8_f`` None) the card runs K3b on
    the binary nodes.  Only the sparse layout exists here: ``nodes8_f``
    [N*8,8], ``tri_pack`` [T8,16].  Those are the JAX package's arrays; the
    CUDA walk (K3, K3c, K4) reads its own compressed copy of the same tree,
    built beside them at pack time (``nodes8_c``, ``leaf_rows``:
    ``accel/wide.py::compress_wide``).  K3b reads its own copy of the
    binary tree in the same way (``nodes_c``, ``tri_rows``:
    ``accel/binary.py::compress_binary``); :meth:`without_wide` keeps it.

    A paged mesh (``paged`` set, ``accel/paged.py``) carries its trees in
    :class:`PagedNodes`; its ``nodes_f``/``nodes_i`` are one empty binary
    root and its ``nodes8_*`` None, and its slot arrays are the JAX
    package's page-blocked ones (no padding slack).
    """

    nodes_f: torch.Tensor   # [M,12] float32 — child AABBs (lo0,hi0,lo1,hi1)
    nodes_i: torch.Tensor   # [M,4]  int32   — (ref,count) per child
    tri_v0: torch.Tensor    # [T,3] float32
    tri_e1: torch.Tensor    # [T,3]
    tri_e2: torch.Tensor    # [T,3]
    tri_n: torch.Tensor     # [T,3,3] per-corner normals
    tri_t: torch.Tensor     # [T,3,3] per-corner tangents
    tri_uv: torch.Tensor    # [T,3,2] per-corner uvs
    tri_count: torch.Tensor  # [] int32 — valid slots (rest is padding)
    paged: Optional[PagedNodes] = None
    nodes8_f: Optional[torch.Tensor] = None    # [N*8,8] child boxes (lo3,hi3,0,0)
    nodes8_i: Optional[torch.Tensor] = None    # [N,16] 8 x (ref,count)
    nodes8_ax: Optional[torch.Tensor] = None   # [N] build-time sort axis
    tri_pack: Optional[torch.Tensor] = None      # [T8,16] (v0,e1,e2,slot,uv corners)
    nodes8_c: Optional[torch.Tensor] = None    # [M,20] int32 compressed nodes
    leaf_rows: Optional[torch.Tensor] = None   # [R,12] compact leaf rows
    nodes_c: Optional[torch.Tensor] = None     # [M,16] int32 K3b's binary nodes
    tri_rows: Optional[torch.Tensor] = None    # [T,12] K3b's rows (v0, e1, e2)

    def __post_init__(self):
        if self.paged is not None and not isinstance(self.paged, PagedNodes):
            raise TypeError(f"paged must be PagedNodes, got {type(self.paged)}")
        devices = {t.device for t in self.tensors()}
        if len(devices) != 1:
            raise ValueError(f"mesh tensors on several devices: {devices}")

    def tensors(self):
        own = [getattr(self, f.name) for f in dataclasses.fields(self)
               if isinstance(getattr(self, f.name), torch.Tensor)]
        return own + ([] if self.paged is None else self.paged.tensors())

    @property
    def device(self) -> torch.device:
        return self.tri_v0.device

    def without_wide(self) -> "MeshData":
        """The same mesh with the 8-wide tree dropped: the card traverses
        it with K3b (the binary kernel), on the binary copy it keeps."""
        return dataclasses.replace(self, nodes8_f=None, nodes8_i=None,
                                   nodes8_ax=None, tri_pack=None,
                                   nodes8_c=None, leaf_rows=None)


@dataclasses.dataclass(frozen=True)
class Scene:
    spheres: SphereSet
    hdr: Optional[torch.Tensor] = None           # [H,W,3] float32 lat-long env map
    diffuse_map: Optional[torch.Tensor] = None   # [H,W,3] linearised
    normal_map: Optional[torch.Tensor] = None    # [H,W,3] raw
    specular_map: Optional[torch.Tensor] = None  # [H,W,3] raw
    brdf: Optional[torch.Tensor] = None          # [3, 90*90*180] MERL table
    mesh: Optional[MeshData] = None

    def __post_init__(self):
        if self.brdf is not None:
            from vrenderer_pathtracer_tpu_torch.ops.brdf import TABLE_SIZE

            b = self.brdf
            if (b.dim() != 2 or tuple(b.shape) != (3, TABLE_SIZE)
                    or b.dtype != torch.float32):
                raise ValueError(f"brdf must be a float32 [3, {TABLE_SIZE}] "
                                 f"MERL table, got {b.dtype} {tuple(b.shape)}")
            if b.device != self.device:
                raise ValueError(f"brdf on {b.device}, spheres on {self.device}")
        for name in _MAPS:
            t = getattr(self, name)
            if t is None:
                continue
            if t.device != self.device:
                raise ValueError(f"{name} on {t.device}, spheres on {self.device}")
            if t.dim() != 3 or t.dtype != torch.float32:
                raise ValueError(f"{name} must be a float32 [H,W,C] tensor")
        if self.mesh is not None and self.mesh.device != self.device:
            raise ValueError(f"mesh on {self.mesh.device}, spheres on "
                             f"{self.device}")

    @classmethod
    def analytic(cls, settings: RenderSettings, device) -> "Scene":
        """Sphere-only scene matching the settings' Cornell flag."""
        return cls(spheres=build_sphere_set(settings.use_cornell_box, device))

    @property
    def device(self) -> torch.device:
        return self.spheres.device

    def replace(self, **kw) -> "Scene":
        return dataclasses.replace(self, **kw)

    def replace_spheres(self, **kw) -> "Scene":
        """The same scene with some sphere fields replaced (e.g. the
        trainable ``color``/``emission``)."""
        return dataclasses.replace(
            self, spheres=dataclasses.replace(self.spheres, **kw))


def _resolve(request: str, want: str, what: str, device, also=()) -> str:
    if request not in ("auto", want, *also):
        raise ValueError(f"{what}={request!r} cannot run this scene on "
                         f"{device}; use 'auto' or {want!r}")
    return want if request == "auto" else request


def settings_for_scene(scene: Scene, settings: RenderSettings) -> RenderSettings:
    """Derive the ``has_*`` flags from the scene's assets and resolve the
    radiance and traversal backends from the scene's device.

    Radiance, in the JAX package's order: a CPU scene runs the plain
    integrator (``"torch"``).  A CUDA scene runs K1 (``"cuda"``,
    ``render/cuda_radiance.py``) where it covers the scene (Cornell spheres,
    no assets); otherwise K4 (``"cuda_mesh"``, ``render/cuda_mesh.py``)
    where ``cuda_mesh.supports`` holds; otherwise the wavefront integrator
    on the card (``"wavefront"``), whose mesh search is K3 or K3b.
    Traversal: ``"cuda"`` (K3/K3b, ``accel/cuda_traverse.py``) for a CUDA
    scene, ``"torch"`` (the plain lockstep ``traverse``) for a CPU scene.  A
    CUDA scene never resolves to a plain version, and a request that does
    not match the device or the scene raises, except ``"wavefront"`` on
    the card, which runs any CUDA scene (the comparison pass of a kernel's
    scene).  Inside ``utils.debug.interpret_kernels()`` (the plain
    versions, on CPU tensors) a CUDA scene raises.
    """
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh, cuda_radiance
    from vrenderer_pathtracer_tpu_torch.utils.debug import interpreting

    resolved = settings.replace(
        has_diffuse_map=scene.diffuse_map is not None,
        has_normal_map=scene.normal_map is not None,
        has_specular_map=scene.specular_map is not None,
        has_brdf=scene.brdf is not None,
        has_mesh=scene.mesh is not None,
        has_hdr=scene.hdr is not None,
    )
    on_cuda = scene.device.type == "cuda"
    if on_cuda and interpreting():
        raise ValueError(
            "interpret_kernels() runs the plain versions, which take CPU "
            "tensors: build the scene with device='cpu' (a CUDA scene runs "
            "the kernels)")
    if not on_cuda:
        radiance = "torch"
    elif cuda_radiance.supports(scene, resolved):
        radiance = "cuda"
    elif cuda_mesh.supports(scene, resolved):
        radiance = "cuda_mesh"
    else:
        radiance = "wavefront"
    paged = scene.mesh is not None and scene.mesh.paged is not None
    traversal = ("torch" if not on_cuda else
                 "cuda_paged" if paged else "cuda")
    return resolved.replace(
        radiance_kernel=_resolve(settings.radiance_kernel, radiance,
                                 "radiance_kernel", scene.device,
                                 ("wavefront",) if on_cuda else ()),
        traversal=_resolve(settings.traversal, traversal, "traversal",
                           scene.device),
        # The captured shading runs at full width, as in the JAX
        # integrator, which never compacts under captured_attrs.
        compact_waves=(settings.compact_waves or paged)
        and not settings.captured_attrs,
    )
