"""Paged mesh packing: the two-level layout of large meshes (port of
``accel/paged.py``).

Triangles are Morton-sorted by centroid and cut into pages of
``page_tris`` slots; each page gets its own object-split SBVH (no spatial
splits, so a page never holds more references than triangles).  The flat
shading arrays are the JAX package's, bit for bit: slot
``page * page_tris + local`` holds the page's ``local``-th triangle in its
SBVH's leaf order, the rest of a page is zero (degenerate, never hit).

The traversal layout is the port's own (``scene.PagedNodes``).  Each
page's SBVH is collapsed to 8 wide with 8-aligned leaf blocks
(``accel/wide.py``, the layout K3 walks), and a small 8-wide top-level tree
groups the Morton-ordered page boxes eight at a time.  All of it shares one
node space with global refs, and the plain version walks the whole tree as
one.  So does K5 (``accel/cuda_paged.py``), on the kernels' compressed copy
of the whole node space (``accel/wide.py::compress_wide``), whose page
roots are the nodes just past the top tree.  The JAX package's dense lane
tiles, one-word 20-bit records and 128-lane padding are Mosaic/VMEM
artifacts and are not built.
"""

from __future__ import annotations

import numpy as np
import torch

from vrenderer_pathtracer_tpu_torch.accel.wide import (
    _EMPTY_BOX, build_leaf_packs, collapse_bvh8, compress_wide)
from vrenderer_pathtracer_tpu_torch.native import HostMesh, build_sbvh
from vrenderer_pathtracer_tpu_torch.scene.scene import MeshData, PagedNodes

PAGE_TRIS = 4096  # triangles per page
# Slots are recorded as float32 in the leaf blocks: exact below 2^24.
MAX_SLOTS = 1 << 24


def _morton3(x: np.ndarray) -> np.ndarray:
    """30-bit Morton codes from [N,3] coordinates normalized to [0,1)."""
    q = np.clip((x * 1024.0).astype(np.uint64), 0, 1023)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def _page_tree(bvh, v0, e1, e2, uv6, slots):
    """One page's 8-wide tree and leaf blocks, page-local refs: ``v0/e1/e2``
    and ``uv6`` in the SBVH's leaf order, ``slots`` the global slot of each
    (padding rows of the blocks record ``slots[0]``; they never hit)."""
    from vrenderer_pathtracer_tpu_torch.accel.mesh import _check_wide_stack_bound

    n8f, n8i, n8ax, depth8 = collapse_bvh8(bvh.nodes_f, bvh.nodes_i)
    _check_wide_stack_bound(depth8)
    n8i, pack, _ = build_leaf_packs(n8i, v0, e1, e2, uv6,
                                    np.zeros((len(v0), 9), np.float32))
    pack[:, 9] = np.asarray(slots, np.float32)[pack[:, 9].astype(np.int64)]
    return n8f, n8i, n8ax, depth8, pack


def _top_tree(bbox: np.ndarray):
    """8-wide tree over the page boxes: pages (Morton-ordered, so
    neighbours in id are neighbours in space) eight to a node, then those
    nodes eight to a node, up to one root.  Returns the levels top down,
    each a list of nodes, each a list of (kind, index, lo, hi) children
    with kind "page" or "node" (an index into the next level down)."""
    level = [("page", p, bbox[p, 0:3], bbox[p, 3:6])
             for p in range(bbox.shape[0])]
    levels = []
    while True:
        groups = [level[i:i + 8] for i in range(0, len(level), 8)]
        levels.append(groups)
        if len(groups) == 1:
            return levels[::-1]
        level = [("node", k, np.min([c[2] for c in g], axis=0),
                  np.max([c[3] for c in g], axis=0))
                 for k, g in enumerate(groups)]


def _assemble(bbox, pages, page_tris, total_refs, flat, *, device) -> MeshData:
    """A paged ``MeshData`` from the page boxes, each page's tree
    (``_page_tree``) and the flat slot arrays."""
    from vrenderer_pathtracer_tpu_torch.accel.mesh import _check_wide_stack_bound

    levels = _top_tree(bbox)
    offsets = np.cumsum([0] + [len(lv) for lv in levels])
    n_top = int(offsets[-1])
    node_base = n_top + np.cumsum([0] + [p[1].shape[0] for p in pages])[:-1]
    rows = np.cumsum([0] + [p[4].shape[0] for p in pages])
    top_f = np.zeros((n_top * 8, 8), np.float32)
    top_i = np.zeros((n_top, 16), np.int32)
    top_ax = np.zeros((n_top,), np.int32)
    for depth, groups in enumerate(levels):
        for k, children in enumerate(groups):
            w = offsets[depth] + k
            lo = np.min([c[2] for c in children], axis=0)
            hi = np.max([c[3] for c in children], axis=0)
            top_ax[w] = int(np.argmax(hi - lo))
            for c in range(8):
                row = top_f[w * 8 + c]
                if c >= len(children):
                    row[0:6] = _EMPTY_BOX
                    top_i[w, 2 * c:2 * c + 2] = (0, -1)
                    continue
                kind, idx, clo, chi = children[c]
                row[0:3], row[3:6] = clo, chi
                ref = (node_base[idx] if kind == "page"
                       else offsets[depth + 1] + idx)
                top_i[w, 2 * c:2 * c + 2] = (ref, 0)
    nodes8_f, nodes8_i, nodes8_ax, packs = [top_f], [top_i], [top_ax], []
    depth_pages = 0
    for p, (n8f, n8i, n8ax, depth8, pack) in enumerate(pages):
        n8i = n8i.copy()
        ref, cnt = n8i[:, 0::2], n8i[:, 1::2]
        ref[cnt == 0] += node_base[p]
        ref[cnt > 0] += rows[p]
        nodes8_f.append(n8f)
        nodes8_i.append(n8i)
        nodes8_ax.append(n8ax)
        packs.append(pack)
        depth_pages = max(depth_pages, depth8)
    # The plain version and K5 walk the whole tree with the wide stack.
    _check_wide_stack_bound(len(levels) + depth_pages)
    all_f, all_i = np.concatenate(nodes8_f), np.concatenate(nodes8_i)
    all_pack = np.concatenate(packs)
    nodes8_c, leaf_rows, order = compress_wide(all_f, all_i, all_pack)
    # Breadth first, the page roots (one level below the top tree, in page
    # order) are the copy's nodes [n_top, n_top + pages): K5 counts them.
    n_pages = bbox.shape[0]
    if not (np.array_equal(order[:n_top], np.arange(n_top)) and
            np.array_equal(order[n_top:n_top + n_pages], node_base)):
        raise AssertionError("the copy's page roots are not the nodes past "
                             "its top tree")

    def t(a):
        return torch.from_numpy(np.array(a)).to(device)  # a writable copy

    paged = PagedNodes(
        bbox=t(bbox),
        nodes8_f=t(all_f),
        nodes8_i=t(all_i),
        nodes8_ax=t(np.concatenate(nodes8_ax)),
        tri_pack=t(all_pack),
        nodes8_c=t(nodes8_c),
        leaf_rows=t(leaf_rows),
        n_top=n_top,
        page_tris=page_tris,
    )
    return MeshData(
        # One empty binary root: the binary traversals find nothing here.
        nodes_f=t(np.tile(np.asarray(_EMPTY_BOX, np.float32), 2)[None]),
        nodes_i=t(np.array([[0, -1, 0, -1]], np.int32)),
        tri_count=torch.tensor(total_refs, dtype=torch.int32, device=device),
        paged=paged,
        **{k: t(v) for k, v in flat.items()},
    )


def pack_mesh_paged(mesh: HostMesh, page_tris: int = PAGE_TRIS, *,
                    device, seconds: dict | None = None) -> MeshData:
    """Build a paged ``MeshData`` on ``device``: the JAX package's flat
    page-blocked slot arrays, page boxes and ``tri_count``, and the port's
    two-level 8-wide tree (``scene.PagedNodes``).  ``seconds``, if given,
    receives the host time of the pages' SBVHs (``"sbvh"``), their 8-wide
    collapse and leaf blocks (``"collapse"``) and the top tree, assembly
    and copy to ``device`` (``"upload"``)."""
    import time

    from vrenderer_pathtracer_tpu_torch.accel.mesh import _check_stack_bound

    clock = dict(sbvh=0.0, collapse=0.0)

    tris = mesh.tris
    centroids = mesh.verts[tris].mean(axis=1)
    lo = centroids.min(axis=0)
    span = np.maximum(centroids.max(axis=0) - lo, 1e-12)
    order = np.argsort(_morton3((centroids - lo) / span), kind="stable")

    n_pages = -(-len(tris) // page_tris)
    if n_pages * page_tris > MAX_SLOTS:
        raise ValueError(f"{n_pages * page_tris} slots exceed the float32 "
                         f"slot field ({MAX_SLOTS})")
    bboxes, pages = [], []
    slot_v0 = np.zeros((n_pages * page_tris, 3), np.float32)
    slot_e1 = np.zeros_like(slot_v0)
    slot_e2 = np.zeros_like(slot_v0)
    slot_n = np.zeros((n_pages * page_tris, 3, 3), np.float32)
    slot_t = np.zeros_like(slot_n)
    slot_uv = np.zeros((n_pages * page_tris, 3, 2), np.float32)

    total_refs = 0
    for p in range(n_pages):
        sel = order[p * page_tris: (p + 1) * page_tris]
        page_tri = tris[sel]
        t0 = time.perf_counter()
        bvh = build_sbvh(mesh.verts, page_tri, allow_spatial=False)
        clock["sbvh"] += time.perf_counter() - t0
        _check_stack_bound(bvh.max_depth)
        ref = page_tri[bvh.tri_order]  # [R,3] vertex ids, page-local order
        r = len(ref)
        assert r == len(page_tri), "object-only BVH must not duplicate refs"
        base = p * page_tris
        v0 = mesh.verts[ref[:, 0]]
        e1 = mesh.verts[ref[:, 1]] - v0
        e2 = mesh.verts[ref[:, 2]] - v0
        slot_v0[base: base + r] = v0
        slot_e1[base: base + r] = e1
        slot_e2[base: base + r] = e2
        for k in range(3):
            slot_n[base: base + r, k] = mesh.normals[ref[:, k]]
            slot_t[base: base + r, k] = mesh.tangents[ref[:, k]]
            slot_uv[base: base + r, k] = mesh.uvs[ref[:, k]]
        total_refs += r
        pv = mesh.verts[page_tri.reshape(-1)]
        bb = np.concatenate([pv.min(axis=0), pv.max(axis=0), [0.0, 0.0]])
        bboxes.append(bb.astype(np.float32))
        t0 = time.perf_counter()
        pages.append(_page_tree(bvh, v0, e1, e2,
                                slot_uv[base: base + r].reshape(r, 6),
                                base + np.arange(r)))
        clock["collapse"] += time.perf_counter() - t0
    t0 = time.perf_counter()
    out = _assemble(np.stack(bboxes), pages, page_tris, total_refs, dict(
        tri_v0=slot_v0, tri_e1=slot_e1, tri_e2=slot_e2, tri_n=slot_n,
        tri_t=slot_t, tri_uv=slot_uv), device=device)
    if seconds is not None:
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
        seconds.update(clock, upload=time.perf_counter() - t0)
    return out


def paged_from_slots(flat, bbox, tri_count: int, *, device) -> MeshData:
    """A paged ``MeshData`` over given page-blocked slot arrays (``flat``:
    ``tri_v0/e1/e2/n/t/uv`` as numpy, ``bbox`` [P,8]), keeping every slot
    number: each page's tree is built anew over the page's slots, with the
    vertices recovered as v0, v0 + e1, v0 + e2.  A page's slots end at its
    last non-degenerate row (the rest is padding, never hit)."""
    bbox = np.asarray(bbox, np.float32)
    n_pages = bbox.shape[0]
    n_slots = len(flat["tri_v0"])
    if n_pages == 0 or n_slots % n_pages:
        raise ValueError(f"{n_slots} slots do not split into {n_pages} pages")
    page_tris = n_slots // n_pages
    pages = []
    for p in range(n_pages):
        base = p * page_tris
        page = slice(base, base + page_tris)
        v0, e1, e2 = (np.asarray(flat[k][page], np.float32)
                      for k in ("tri_v0", "tri_e1", "tri_e2"))
        real = np.flatnonzero((e1 != 0).any(axis=1) | (e2 != 0).any(axis=1))
        r = int(real[-1]) + 1 if len(real) else 1
        v0, e1, e2 = v0[:r], e1[:r], e2[:r]
        verts = np.concatenate([v0, v0 + e1, v0 + e2])
        tris = np.arange(3 * r, dtype=np.int32).reshape(3, r).T.copy()
        bvh = build_sbvh(verts, tris, allow_spatial=False)
        o = bvh.tri_order
        uv6 = np.asarray(flat["tri_uv"][page], np.float32)[:r].reshape(r, 6)
        pages.append(_page_tree(bvh, v0[o], e1[o], e2[o], uv6[o], base + o))
    return _assemble(bbox, pages, page_tris, int(tri_count),
                     {k: np.asarray(flat[k], np.float32) for k in
                      ("tri_v0", "tri_e1", "tri_e2", "tri_n", "tri_t",
                       "tri_uv")}, device=device)
