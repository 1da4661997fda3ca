"""Convert the JAX package's scene, mesh, camera, sliders and train
parameters into the port's.

The functions take plain numpy leaves, ``{name: np.asarray(leaf)}`` of a
JAX ``SphereSet``, ``MeshData``, ``Camera``, ``TrainParams`` or
``DeferredParams`` (``obj._asdict()``), and numpy arrays for the HDRI, the
maps and the MERL table, so this
module imports neither package's JAX code.  Both packages then render, and
differentiate, the same scene.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.parallel.sharding import DeferredParams, TrainParams
from vrenderer_pathtracer_tpu_torch.scene.scene import MeshData, Scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import SphereSet


def _f32(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _opt_f32(x, device):
    return None if x is None else _f32(x, device)


def mesh_from_numpy(mesh: Mapping[str, np.ndarray], *, device) -> MeshData:
    """A port ``MeshData`` from a JAX ``MeshData``'s leaves.

    The sparse single-level layout converts as it is, and the kernels'
    compressed copy is built from it (``accel/mesh.py::with_copy``); a
    lane-dense JAX mesh is a TPU layout and raises.  K3b's copy of the
    binary tree is built too.  The 8-wide tree is held to K3's stack
    bound, as ``accel/mesh.py::pack_from_bvh`` holds the port's own.  The
    TPU kernel's win-time capture packs (``tri_aux_pack``,
    ``tri_nrm_pack``) are not carried: K3c and K4 read tangents, normals
    and uvs by slot.

    A paged JAX mesh (``paged`` a ``PagedNodes`` or its leaves as a
    mapping) carries its flat slot arrays, ``tri_count`` and page ``bbox``
    across; its dense page layout is a TPU layout and is not read: the
    port builds its own page trees over each page's slots
    (``accel/paged.py::paged_from_slots``), so a slot names the same
    triangle in both packages.
    """
    from vrenderer_pathtracer_tpu_torch.accel.mesh import (
        _check_stack_bound, _check_wide_stack_bound, binary_depth, wide_depth,
        with_copy)

    paged = mesh.get("paged")
    if paged is not None:
        from vrenderer_pathtracer_tpu_torch.accel.paged import paged_from_slots

        if hasattr(paged, "_asdict"):
            paged = paged._asdict()
        if not isinstance(paged, Mapping) or "bbox" not in paged:
            raise ValueError("a paged mesh's 'paged' must be a PagedNodes or "
                             "a mapping holding its page 'bbox'")
        return paged_from_slots(mesh, np.asarray(paged["bbox"]),
                                int(np.asarray(mesh["tri_count"])),
                                device=device)
    n8f = mesh.get("nodes8_f")
    if n8f is not None and np.shape(n8f)[-1] == 128:
        raise ValueError("a lane-dense JAX mesh is a TPU layout; pack the "
                         "mesh with the port's accel/mesh.py::pack_mesh")
    if n8f is not None:
        _check_wide_stack_bound(wide_depth(mesh["nodes8_i"]))

    def i32(x):
        return None if x is None else torch.tensor(np.asarray(x, np.int32),
                                                   device=device)

    out = MeshData(
        nodes_f=_f32(mesh["nodes_f"], device),
        nodes_i=i32(mesh["nodes_i"]),
        tri_v0=_f32(mesh["tri_v0"], device),
        tri_e1=_f32(mesh["tri_e1"], device),
        tri_e2=_f32(mesh["tri_e2"], device),
        tri_n=_f32(mesh["tri_n"], device),
        tri_t=_f32(mesh["tri_t"], device),
        tri_uv=_f32(mesh["tri_uv"], device),
        tri_count=i32(mesh["tri_count"]),
        nodes8_f=_opt_f32(n8f, device),
        nodes8_i=i32(mesh.get("nodes8_i")),
        nodes8_ax=i32(None if mesh.get("nodes8_ax") is None
                      else np.reshape(mesh["nodes8_ax"], -1)),
        tri_pack=_opt_f32(mesh.get("tri_pack"), device),
    )
    _check_stack_bound(binary_depth(mesh["nodes_i"]))
    return with_copy(out)


def scene_from_numpy(spheres: Mapping[str, np.ndarray], *, device, hdr=None,
                     diffuse_map=None, normal_map=None, specular_map=None,
                     brdf=None,
                     mesh: Mapping[str, np.ndarray] | None = None) -> Scene:
    """A port ``Scene`` from a JAX ``SphereSet``'s leaves, the JAX scene's
    HDRI, maps and MERL table as arrays, and its mesh's leaves
    (:func:`mesh_from_numpy`).
    """
    return Scene(
        spheres=SphereSet(
            pos=_f32(spheres["pos"], device),
            radius=_f32(spheres["radius"], device),
            emission=_f32(spheres["emission"], device),
            color=_f32(spheres["color"], device),
            refl=torch.tensor(np.asarray(spheres["refl"], np.int32),
                              device=device),
            spec_color=_f32(spheres["spec_color"], device),
        ),
        hdr=_opt_f32(hdr, device),
        diffuse_map=_opt_f32(diffuse_map, device),
        normal_map=_opt_f32(normal_map, device),
        specular_map=_opt_f32(specular_map, device),
        brdf=_opt_f32(brdf, device),
        mesh=None if mesh is None else mesh_from_numpy(mesh, device=device),
    )


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
    :func:`camera_from_numpy`; ``hdr`` is None or the trainable
    environment map [H,W,3].
    """
    camera = params.get("camera")
    return TrainParams(
        color=_f32(params["color"], device),
        emission=_f32(params["emission"], device),
        fresnel_coef=_f32(params["fresnel_coef"], device),
        fresnel_pow=_f32(params["fresnel_pow"], device),
        camera=None if camera is None else camera_from_numpy(camera,
                                                             device=device),
        hdr=_opt_f32(params.get("hdr"), device),
    )


def deferred_params_from_numpy(params: Mapping, *, device) -> DeferredParams:
    """A port ``DeferredParams`` from a JAX ``DeferredParams``'s leaves
    (``hdr``, ``diffuse_map``, ``brdf``; each None or an array)."""
    return DeferredParams(**{k: _opt_f32(params.get(k), device)
                             for k in ("hdr", "diffuse_map", "brdf")})
