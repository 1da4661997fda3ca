"""Mesh packing: host SBVH output -> device tensors (port of ``accel/mesh.py``).

Triangles are stored per leaf slot in Möller–Trumbore form (v0, e1, e2)
plus per-corner normals/tangents/uvs for barycentric interpolation.  Arrays
are padded with degenerate triangles (zero edges -> zero determinant ->
never hit) so leaf reads of ``MAX_LEAF`` slots never run out of bounds.
The 8-wide collapse (``accel/wide.py``) is always built, in the sparse
layout only: the JAX package's VMEM budgets, lane-dense switch and 20-bit
record check are TPU artifacts.  Beside it, every pack holds the kernels'
compressed copy of the same tree (``nodes8_c``, ``leaf_rows``:
``accel/wide.py::compress_wide``), which is what the CUDA walk reads, and
K3b's copy of the binary tree (``nodes_c``, ``tri_rows``:
``accel/binary.py::compress_binary``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from vrenderer_pathtracer_tpu_torch.accel.binary import compress_binary
from vrenderer_pathtracer_tpu_torch.accel.wide import (
    build_leaf_packs, collapse_bvh8, compress_wide)
from vrenderer_pathtracer_tpu_torch.native import FlatBVH, HostMesh, build_sbvh
from vrenderer_pathtracer_tpu_torch.scene.scene import MeshData

# Leaf capacity: the builder (csrc/sbvh.cc kMaxLeaf) forces splits above this,
# giving the traversal loop a static triangle-test bound.
MAX_LEAF = 8
# Binary traversal stack depth (the plain ``traverse`` and K3b, whose walk
# stacks at most one entry a level: csrc/traverse.cu).  The builder
# switches to index-balanced median splits at depth 48 (kSahDepthLimit),
# bounding total depth by 48 + ceil(log2(T)) < 80 for any
# T < 2^31, so 96 entries never overflow; ``_check_stack_bound`` raises if
# the builder's reported depth ever says otherwise.
STACK_DEPTH = 96
# K3's per-thread stack (csrc/traverse.cu kWideStack).  One visit pops one
# node and pushes at most 7 of its 8 children on top of the entries below
# it, so a tree of ``d`` wide levels needs at most 7 * d + 1 entries
# (``wide_stack_need``); 256 entries take trees up to 36 wide levels.
WIDE_STACK_DEPTH = 256
# pack_mesh's automatic choice: meshes of more triangles than this are
# paged (accel/paged.py).  The JAX package decides by its VMEM budget, which
# puts its single-level ceiling near 300k-440k triangles; a count between
# the nm sphere (28,560) and BASELINE config 5's sphere (~499k) keeps both
# on the JAX package's side.  An H100 holds either layout in device memory;
# chip_smoke.py times K3 on a single-level pack of the config-5 mesh beside
# K5 on its pages (PERF.md), the reading that would move this line.
PAGED_MIN_TRIS = 1 << 18


def wide_stack_need(max_depth8: int) -> int:
    """K3 stack entries needed for a tree of ``max_depth8`` wide levels."""
    return 7 * max_depth8 + 1


def _check_stack_bound(max_depth: int):
    if max_depth + 2 > STACK_DEPTH:
        raise ValueError(
            f"SBVH depth {max_depth} would overflow the traversal stack "
            f"(STACK_DEPTH={STACK_DEPTH}); rebuild with a shallower tree"
        )


def _check_wide_stack_bound(max_depth8: int):
    if wide_stack_need(max_depth8) > WIDE_STACK_DEPTH:
        raise ValueError(
            f"8-wide BVH depth {max_depth8} needs {wide_stack_need(max_depth8)}"
            f" stack entries > WIDE_STACK_DEPTH={WIDE_STACK_DEPTH}; rebuild "
            "with a shallower tree")


def wide_depth(nodes8_i: np.ndarray) -> int:
    """Wide levels of an 8-wide tree (root = level 1), from its records."""
    recs = np.asarray(nodes8_i).reshape(-1, 16)
    depth, level = 0, [0]
    while level:
        depth += 1
        r = recs[level]
        level = r[:, 0::2][r[:, 1::2] == 0].tolist()
    return depth


def binary_depth(nodes_i: np.ndarray) -> int:
    """Deepest inner node of a binary tree (root = 0), from its records."""
    recs = np.asarray(nodes_i).reshape(-1, 4)
    depth, level = -1, [0]
    while level:
        depth += 1
        r = recs[level]
        level = r[:, 0::2][r[:, 1::2] == 0].tolist()
    return depth


def with_copy(mesh: MeshData) -> MeshData:
    """``mesh`` with the kernels' copies built anew, on the mesh's device:
    K3b's from the binary arrays (``nodes_f``, ``nodes_i``, ``tri_v0``,
    ``tri_e1``, ``tri_e2``) and, where the mesh has its 8-wide tree, the
    walk's compressed copy from ``nodes8_f``, ``nodes8_i``, ``tri_pack``."""
    def arrays(*names):
        return (getattr(mesh, f).cpu().numpy() for f in names)

    def t(a):
        return torch.from_numpy(a).to(mesh.device)

    nodes_c, tri_rows = compress_binary(*arrays(
        "nodes_f", "nodes_i", "tri_v0", "tri_e1", "tri_e2"))
    mesh = dataclasses.replace(mesh, nodes_c=t(nodes_c), tri_rows=t(tri_rows))
    if mesh.nodes8_f is None:
        return mesh
    nodes, rows, _ = compress_wide(*arrays("nodes8_f", "nodes8_i", "tri_pack"))
    return dataclasses.replace(mesh, nodes8_c=t(nodes), leaf_rows=t(rows))


def auto_paged(n_tris: int) -> bool:
    """``pack_mesh``'s automatic rule: page a mesh of more than
    ``PAGED_MIN_TRIS`` triangles."""
    return n_tris > PAGED_MIN_TRIS


def pack_mesh(mesh: HostMesh, pad_to: int = 128, paged: bool | None = None,
              *, device) -> MeshData:
    """Build the SBVH and gather triangle data into leaf-slot order, as
    tensors on ``device``.

    ``paged``: True builds the two-level paged layout (``accel/paged.py``),
    False the single-level one; None (auto) pages a mesh of more than
    ``PAGED_MIN_TRIS`` (262,144) triangles (:func:`auto_paged`), so
    BASELINE config 5's ~499k-triangle sphere is paged and the nm scene's
    28,560-triangle sphere is not, as in the JAX package.
    """
    if paged is None:
        paged = auto_paged(len(mesh.tris))
    if paged:
        from vrenderer_pathtracer_tpu_torch.accel.paged import pack_mesh_paged

        return pack_mesh_paged(mesh, device=device)
    return pack_from_bvh(mesh, build_sbvh(mesh.verts, mesh.tris), pad_to,
                         device=device)


def pack_from_bvh(mesh: HostMesh, bvh: FlatBVH, pad_to: int = 128, *,
                  device) -> MeshData:
    _check_stack_bound(bvh.max_depth)
    order = bvh.tri_order  # [R] original tri index per leaf slot
    tri = mesh.tris[order]  # [R,3] vertex ids
    v0 = mesh.verts[tri[:, 0]]
    v1 = mesh.verts[tri[:, 1]]
    v2 = mesh.verts[tri[:, 2]]

    def corners(attr):
        return np.stack([attr[tri[:, 0]], attr[tri[:, 1]], attr[tri[:, 2]]], axis=1)

    r = len(order)
    t_pad = -(-max(r, 1) // pad_to) * pad_to + MAX_LEAF  # slack for leaf reads

    def pad(a, fill=0.0):
        out = np.full((t_pad,) + a.shape[1:], fill, a.dtype)
        out[:r] = a
        return out

    # 8-wide collapse + 8-aligned leaf blocks for K3 (accel/wide.py):
    # nodes8_i leaf refs index the pack, whose rows record the original
    # slot, so K3 returns slots of the contiguous arrays as traverse does.
    n8f, n8i, n8ax, depth8 = collapse_bvh8(bvh.nodes_f, bvh.nodes_i)
    _check_wide_stack_bound(depth8)
    # K4's tangent pack (the third value) is not kept until K4 reads it.
    n8i, tri_pack, _ = build_leaf_packs(
        n8i, v0, v1 - v0, v2 - v0,
        corners(mesh.uvs).reshape(-1, 6),
        corners(mesh.tangents).reshape(-1, 9))

    nodes8_c, leaf_rows, _ = compress_wide(n8f, n8i, tri_pack)
    tv0, te1, te2 = pad(v0), pad(v1 - v0), pad(v2 - v0)
    nodes_c, tri_rows = compress_binary(bvh.nodes_f, bvh.nodes_i, tv0, te1, te2)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return MeshData(
        nodes_f=t(bvh.nodes_f),
        nodes_i=t(bvh.nodes_i),
        tri_v0=t(tv0),
        tri_e1=t(te1),
        tri_e2=t(te2),
        tri_n=t(pad(corners(mesh.normals))),
        tri_t=t(pad(corners(mesh.tangents))),
        tri_uv=t(pad(corners(mesh.uvs))),
        tri_count=torch.tensor(r, dtype=torch.int32, device=device),
        nodes8_f=t(n8f),
        nodes8_i=t(n8i),
        nodes8_ax=t(n8ax),
        tri_pack=t(tri_pack),
        nodes8_c=t(nodes8_c),
        leaf_rows=t(leaf_rows),
        nodes_c=t(nodes_c),
        tri_rows=t(tri_rows),
    )
