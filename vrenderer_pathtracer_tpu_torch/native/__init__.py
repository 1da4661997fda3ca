"""ctypes bindings for the port's host library (SBVH builder + loaders).

The same C ABI and the same Python surface as the JAX package's ``native``
module: OBJ, PLY and FBX import, the SBVH build, the MERL-100 binary reader,
and EXR read and write.  The library is built from ``native/csrc`` at first
use (``native/build.py``).  The dense paged builder is not bound: the dense
page layout is a TPU VMEM artifact (the port pages with ``accel/paged.py``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np

from vrenderer_pathtracer_tpu_torch.native import build as _build

_c_fp = ctypes.POINTER(ctypes.c_float)
_c_ip = ctypes.POINTER(ctypes.c_int)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build()))
    lib.vt_build_sbvh.restype = ctypes.c_int
    lib.vt_build_sbvh.argtypes = [
        _c_fp, ctypes.c_int, _c_ip, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_c_fp), ctypes.POINTER(_c_ip), _c_ip,
        ctypes.POINTER(_c_ip), _c_ip, _c_ip,
    ]
    loader_args = [
        ctypes.c_char_p,
        ctypes.POINTER(_c_fp), ctypes.POINTER(_c_fp), ctypes.POINTER(_c_fp),
        ctypes.POINTER(_c_fp), _c_ip, ctypes.POINTER(_c_ip), _c_ip,
    ]
    for fn in (lib.vt_load_obj, lib.vt_load_ply, lib.vt_load_fbx):
        fn.restype = ctypes.c_int
        fn.argtypes = loader_args
    lib.vt_load_merl.restype = ctypes.c_int
    lib.vt_load_merl.argtypes = [ctypes.c_char_p, ctypes.POINTER(_c_fp), _c_ip]
    lib.vt_load_exr.restype = ctypes.c_int
    lib.vt_load_exr.argtypes = [ctypes.c_char_p, ctypes.POINTER(_c_fp), _c_ip,
                                _c_ip]
    lib.vt_write_exr_c.restype = ctypes.c_int
    lib.vt_write_exr_c.argtypes = [ctypes.c_char_p, _c_fp, ctypes.c_int,
                                   ctypes.c_int, ctypes.c_int]
    lib.vt_free.restype = None
    lib.vt_free.argtypes = [ctypes.c_void_p]
    return lib


# Native return codes -> reasons, so loader failures name the cause.
_OBJ_ERRORS = {
    1: "cannot open file",
    2: "no geometry found (empty or not an OBJ)",
}
_PLY_ERRORS = {
    1: "cannot open file",
    2: "truncated or invalid geometry",
    3: "unsupported PLY flavour (need ascii or binary_little_endian 1.0 "
       "with x/y/z vertex properties)",
}
_FBX_ERRORS = {
    1: "cannot open file",
    2: "corrupt container or no mesh geometry",
    3: "not an FBX file (foreign format: convert to FBX, OBJ or PLY)",
}
_MERL_ERRORS = {
    1: "cannot open file",
    2: "truncated header (expected 3 int32 dims)",
    3: "wrong dimensions (MERL tables must be 90x90x180)",
    4: "truncated data (expected 3*90*90*180 doubles)",
}
_EXR_ERRORS = {
    1: "cannot open file",
    2: "not an EXR (bad magic/version)",
    3: "bad header (missing/invalid channels or dataWindow)",
    4: "unsupported feature (deep data, compression beyond "
       "NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A/DWAA/DWAB, UINT channels, "
       "or no R/G/B/Y channels; multipart files read their first "
       "regular-image part)",
    5: "truncated or corrupt pixel data",
}
# write_exr's compressions -> the C codes of vt_write_exr_c (csrc/exr.cc).
EXR_COMPRESSIONS = {"none": 0, "rle": 1, "zips": 2, "zip": 3, "piz": 4,
                    "pxr24": 5, "b44": 6, "dwaa": 8, "dwab": 9}


def _take(ptr, shape, dtype, lib):
    """Copy a malloc'd C array into numpy and free the C side."""
    n = int(np.prod(shape))
    ctype = ctypes.c_float if dtype == np.float32 else ctypes.c_int
    arr = np.ctypeslib.as_array(ctypes.cast(ptr, ctypes.POINTER(ctype)), (n,))
    out = np.array(arr, dtype=dtype).reshape(shape)
    lib.vt_free(ptr)
    return out


class HostMesh(NamedTuple):
    """Indexed triangle mesh as loaded (pre-BVH)."""

    verts: np.ndarray     # [V,3] float32, centered at centroid
    normals: np.ndarray   # [V,3]
    tangents: np.ndarray  # [V,3]
    uvs: np.ndarray       # [V,2] (v flipped, reference parity)
    tris: np.ndarray      # [T,3] int32


class FlatBVH(NamedTuple):
    """Binary SBVH as flat arrays (see csrc/sbvh.cc's header comment)."""

    nodes_f: np.ndarray    # [M,12] float32 — child AABBs (lo0,hi0,lo1,hi1)
    nodes_i: np.ndarray    # [M,4]  int32   — (ref,count) per child
    tri_order: np.ndarray  # [R] int32 — original tri index per leaf slot
    max_depth: int = 0     # deepest inner node (root = 0): stack-bound proof


def _load_with(fn_name: str, errors: dict, path: str) -> HostMesh:
    lib = _load()
    pv, pn, pt, puv = _c_fp(), _c_fp(), _c_fp(), _c_fp()
    ptris = _c_ip()
    nv, nt = ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, fn_name)(
        str(path).encode(), ctypes.byref(pv), ctypes.byref(pn),
        ctypes.byref(pt), ctypes.byref(puv), ctypes.byref(nv),
        ctypes.byref(ptris), ctypes.byref(nt),
    )
    if rc != 0:
        kind = fn_name.removeprefix("vt_")
        raise IOError(f"{kind}({path}): {errors.get(rc, f'unknown error {rc}')}"
                      f" (code {rc})")
    v, t = nv.value, nt.value
    return HostMesh(
        verts=_take(pv, (v, 3), np.float32, lib),
        normals=_take(pn, (v, 3), np.float32, lib),
        tangents=_take(pt, (v, 3), np.float32, lib),
        uvs=_take(puv, (v, 2), np.float32, lib),
        tris=_take(ptris, (t, 3), np.int32, lib),
    )


def load_obj(path: str) -> HostMesh:
    """Wavefront OBJ import: centroid recentering, v-flip, smooth normals and
    UV tangents where the file has none (csrc/loaders.cc)."""
    return _load_with("vt_load_obj", _OBJ_ERRORS, path)


def load_ply(path: str) -> HostMesh:
    """PLY import (ascii / binary_little_endian) with the same
    post-processing contract as :func:`load_obj`."""
    return _load_with("vt_load_ply", _PLY_ERRORS, path)


def load_fbx(path: str) -> HostMesh:
    """FBX import, binary or ascii (csrc/fbx.cc): the last Mesh geometry,
    layer-0 normals and UVs, the post-processing contract of
    :func:`load_obj`."""
    return _load_with("vt_load_fbx", _FBX_ERRORS, path)


def load_mesh_file(path: str) -> HostMesh:
    """Extension-dispatching mesh import (.obj, .ply, .fbx)."""
    p = str(path).lower()
    if p.endswith(".obj"):
        return load_obj(path)
    if p.endswith(".ply"):
        return load_ply(path)
    if p.endswith(".fbx"):
        return load_fbx(path)
    raise IOError(f"load_mesh_file({path}): unknown mesh format")


def load_exr(path: str) -> np.ndarray:
    """An EXR (scanline or tiled, half or float, every compression of
    :data:`EXR_COMPRESSIONS` and B44A) as [H,W,3] float32, top row first."""
    lib = _load()
    pd = _c_fp()
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.vt_load_exr(str(path).encode(), ctypes.byref(pd), ctypes.byref(w),
                         ctypes.byref(h))
    if rc != 0:
        raise IOError(f"load_exr({path}): "
                      f"{_EXR_ERRORS.get(rc, f'unknown error {rc}')} (code {rc})")
    return _take(pd, (h.value, w.value, 3), np.float32, lib)


def write_exr(path: str, rgb: np.ndarray, compression: str = "none") -> None:
    """Write [H,W,3] float32 as a half-float EXR, ``compression`` one of
    :data:`EXR_COMPRESSIONS` (b44, dwaa and dwab are lossy)."""
    rgb = np.ascontiguousarray(rgb, np.float32)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected [H,W,3], got {rgb.shape}")
    if compression not in EXR_COMPRESSIONS:
        raise ValueError(f"unsupported compression {compression!r}")
    rc = _load().vt_write_exr_c(str(path).encode(), rgb.ctypes.data_as(_c_fp),
                                rgb.shape[1], rgb.shape[0],
                                EXR_COMPRESSIONS[compression])
    if rc != 0:
        raise IOError(f"write_exr({path}) failed with code {rc}")


def load_merl(path: str) -> np.ndarray:
    """A MERL-100 ``.binary`` as a [3, 90*90*180] float32 table (the
    per-channel scales are applied by ``ops/brdf.py``, not here)."""
    lib = _load()
    pd, n = _c_fp(), ctypes.c_int()
    rc = lib.vt_load_merl(str(path).encode(), ctypes.byref(pd), ctypes.byref(n))
    if rc != 0:
        raise IOError(f"load_merl({path}): "
                      f"{_MERL_ERRORS.get(rc, f'unknown error {rc}')} (code {rc})")
    return _take(pd, (3, n.value), np.float32, lib)


def build_sbvh(verts: np.ndarray, tris: np.ndarray,
               allow_spatial: bool = True) -> FlatBVH:
    """SBVH over the mesh; ``allow_spatial=False`` builds object splits only
    (no reference duplication)."""
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    pf, pi, po = _c_fp(), _c_ip(), _c_ip()
    n_nodes, n_refs, max_depth = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.vt_build_sbvh(
        verts.ctypes.data_as(_c_fp), len(verts),
        tris.ctypes.data_as(_c_ip), len(tris), int(allow_spatial),
        ctypes.byref(pf), ctypes.byref(pi), ctypes.byref(n_nodes),
        ctypes.byref(po), ctypes.byref(n_refs), ctypes.byref(max_depth),
    )
    if rc != 0:
        reason = {1: "no triangles", 2: "out of memory"}.get(rc, "unknown")
        raise RuntimeError(f"vt_build_sbvh failed with code {rc} ({reason})")
    m, r = n_nodes.value, n_refs.value
    return FlatBVH(
        nodes_f=_take(pf, (m, 12), np.float32, lib),
        nodes_i=_take(pi, (m, 4), np.int32, lib),
        tri_order=_take(po, (r,), np.int32, lib),
        max_depth=max_depth.value,
    )
