"""PyTorch port: the CUDA walk's compressed copy of the 8-wide tree.

``accel/wide.py::compress_wide`` builds, beside the JAX-parity arrays
(``nodes8_f``, ``nodes8_i``, ``tri_pack``, which ``tests/test_torch_mesh.py``
and ``tests/test_torch_paged.py`` hold to the JAX package), the copy K3,
K3c, K4 and K5 read: 80-byte nodes with 8-bit child bounds rounded outward
and 48-byte unpadded leaf rows.  Here, through the plain decode
(``decode_compressed``), on a 1,472-triangle sphere and a 3,120-triangle
sphere paged at 512: every decoded child box holds its float box and empty
children stay empty; each child maps to the same subtree and the same leaf
triangles as ``nodes8_i``; the leaf rows are ``tri_pack``'s unpadded rows,
in order, bit for bit; the paged copy reaches every page root exactly
once, at the ids the kernel counts.  The copy is the card's alone, so its
kernels' tests are in ``tests/test_torch_cuda.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vrenderer_pathtracer_tpu_torch.accel import wide
from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh, with_copy
from vrenderer_pathtracer_tpu_torch.accel.paged import pack_mesh_paged
from vrenderer_pathtracer_tpu_torch.native import load_obj
from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """(mesh arrays, copy) of a single-level and a paged pack: the arrays
    are ``nodes8_f``, ``nodes8_i``, ``tri_pack``, the copy
    ``compress_wide``'s ``(nodes, rows, order)``."""
    d = tmp_path_factory.mktemp("cw")
    write_uv_sphere(d / "a.obj", 14.0, 24, 32)
    write_uv_sphere(d / "b.obj", 12.0, 40, 40)
    flat = pack_mesh(load_obj(str(d / "a.obj")), device="cpu")
    paged = pack_mesh_paged(load_obj(str(d / "b.obj")), 512, device="cpu")
    out = {}
    for name, src in (("flat", flat), ("paged", paged.paged)):
        arrays = tuple(getattr(src, f).numpy()
                       for f in ("nodes8_f", "nodes8_i", "tri_pack"))
        out[name] = (src, arrays, wide.compress_wide(*arrays))
    return out


KINDS = ["flat", "paged"]


@pytest.mark.parametrize("kind", KINDS)
def test_pack_holds_the_copy_of_its_arrays(trees, kind):
    src, _, (nodes, rows, _) = trees[kind]
    np.testing.assert_array_equal(src.nodes8_c.numpy(), nodes)
    np.testing.assert_array_equal(src.leaf_rows.numpy().view(np.int32),
                                  rows.view(np.int32))
    assert nodes.shape[1] * 4 == 80 and rows.shape[1] * 4 == 48


@pytest.mark.parametrize("kind", KINDS)
def test_decoded_boxes_hold_the_float_boxes(trees, kind):
    _, (n8f, n8i, _), (nodes, _, order) = trees[kind]
    dec = wide.decode_compressed(nodes)
    cnt = n8i.reshape(-1, 8, 2)[order, :, 1]
    box = n8f.reshape(-1, 8, 8)[order]
    full = cnt >= 0
    assert (dec["lo"][full] <= box[..., 0:3][full]).all()
    assert (dec["hi"][full] >= box[..., 3:6][full]).all()
    # In exact arithmetic a margin of 1/128 quantum outside each plane (the
    # walk's plane test may err by 1/512 of one near the ray's origin), and
    # not loose either:
    # within the margin and a quantum, a quantum being 1/254-1/127 of the
    # node's extent.
    s = np.broadcast_to(dec["scale"][:, None, :], dec["lo"].shape)[full]
    p = np.broadcast_to(dec["origin"][:, None, :], dec["lo"].shape)[full]
    lo = p.astype(np.float64) + dec["q_lo"][full] * s.astype(np.float64)
    hi = p.astype(np.float64) + dec["q_hi"][full] * s.astype(np.float64)
    assert (lo <= box[..., 0:3][full] - s * wide.MARGIN).all()
    assert (hi >= box[..., 3:6][full] + s * wide.MARGIN).all()
    assert (box[..., 0:3][full] - lo <= (1 + wide.MARGIN) * s).all()
    assert (hi - box[..., 3:6][full] <= (1 + wide.MARGIN) * s).all()
    empty = ~full
    assert empty.any() and (dec["kind"][empty] == 0).all()
    assert (dec["lo"][empty] > dec["hi"][empty]).all()
    assert (dec["child"][empty] == -1).all() and (dec["row"][empty] == -1).all()


@pytest.mark.parametrize("kind", KINDS)
def test_topology_matches_the_records(trees, kind):
    _, (_, n8i, pack), (nodes, rows, order) = trees[kind]
    dec = wide.decode_compressed(nodes)
    ref = n8i.reshape(-1, 8, 2)[order, :, 0]
    cnt = n8i.reshape(-1, 8, 2)[order, :, 1]
    np.testing.assert_array_equal(dec["kind"],
                                  np.where(cnt == 0, 1, np.where(cnt > 0, 2, 0)))
    imask = ((cnt == 0) << np.arange(8)).sum(axis=1)
    np.testing.assert_array_equal(dec["imask"], imask)
    inner = dec["kind"] == 1
    # Each inner child is the copy of the same subtree's root ...
    np.testing.assert_array_equal(order[dec["child"][inner]], ref[inner])
    # ... and a node's inner children are contiguous, in child order.
    for m in np.flatnonzero(inner.any(axis=1))[:200]:
        kids = dec["child"][m][inner[m]]
        np.testing.assert_array_equal(kids, kids[0] + np.arange(kids.size))
    # Each leaf's rows are its triangles' rows, the last one marked.
    words = rows.view(np.int32)
    for m, c in zip(*np.nonzero(dec["kind"] == 2)):
        first, n = dec["row"][m, c], cnt[m, c]
        got = words[first:first + n]
        want = pack[ref[m, c]:ref[m, c] + n]
        np.testing.assert_array_equal(got[:, 0:9], want[:, 0:9].view(np.int32))
        np.testing.assert_array_equal(got[:, 9], want[:, 9].astype(np.int32))
        np.testing.assert_array_equal(got[:, 10], (np.arange(n) == n - 1) * 1)


@pytest.mark.parametrize("kind", KINDS)
def test_leaf_rows_are_the_unpadded_pack_rows_in_order(trees, kind):
    _, (_, n8i, pack), (nodes, rows, order) = trees[kind]
    rec = n8i.reshape(-1, 8, 2)[order]
    spans = [np.arange(r, r + c) for r, c in rec.reshape(-1, 2) if c > 0]
    src = np.concatenate(spans)
    words = rows.view(np.int32)
    assert rows.shape[0] == src.size < pack.shape[0]
    np.testing.assert_array_equal(words[:, 0:9], pack[src, 0:9].view(np.int32))
    np.testing.assert_array_equal(words[:, 9], pack[src, 9].astype(np.int32))
    assert (words[:, 11] == 0).all()
    assert words[:, 10].sum() == sum(1 for _ in spans)  # one last row a leaf
    # Every triangle of the mesh has one row (the flat pack's spatial splits
    # may repeat a slot; the paged pages are object splits).
    real = (pack[:, 3:9] != 0).any(axis=1)
    assert sorted(words[:, 9].tolist()) == sorted(pack[real, 9].astype(np.int64).tolist())


def test_paged_copy_reaches_every_page_root_once(trees):
    pg, (_, n8i, _), (nodes, _, order) = trees["paged"]
    dec = wide.decode_compressed(nodes)
    seen = np.zeros(nodes.shape[0], np.int64)
    level = np.array([0])
    while level.size:
        seen[level] += 1
        kids = dec["child"][level]
        level = kids[kids >= 0]
    assert (seen == 1).all()  # a tree: every node reached once
    roots = np.arange(pg.n_top, pg.n_top + pg.n_pages)
    assert pg.n_pages == 7
    top = n8i.reshape(-1, 8, 2)[:pg.n_top]
    page_roots = top[..., 0][(top[..., 1] == 0) & (top[..., 0] >= pg.n_top)]
    np.testing.assert_array_equal(order[roots], page_roots)
    np.testing.assert_array_equal(order[:pg.n_top], np.arange(pg.n_top))
    # The top tree reaches the page roots, and only them, past itself.
    top_kids = dec["child"][:pg.n_top]
    np.testing.assert_array_equal(np.sort(top_kids[top_kids >= pg.n_top]), roots)
    # Each page's leaf rows hold only its own slots.
    words = pg.leaf_rows.numpy().view(np.int32)
    for p, root in enumerate(roots):
        level, slots = np.array([root]), []
        while level.size:
            for m in level:
                for c in np.flatnonzero(dec["kind"][m] == 2):
                    r = dec["row"][m, c]
                    end = r + np.argmax(words[r:, 10] == 1) + 1
                    slots += words[r:end, 9].tolist()
            kids = dec["child"][level]
            level = kids[kids >= 0]
        assert slots and all(s // pg.page_tris == p for s in slots)


def test_with_copy_rebuilds_from_edited_records(trees):
    """A mesh whose records change (as chip_smoke.py's planted faults
    change them) gets its copy built anew from them."""
    mesh, (_, n8i, _), (_, rows, _) = trees["flat"]
    short = n8i.reshape(-1, 8, 2).copy()
    cnt = short[..., 1]
    cnt[cnt >= 2] -= 1
    edited = with_copy(dataclasses.replace(
        mesh, nodes8_i=torch.from_numpy(short.reshape(n8i.shape))))
    assert edited.leaf_rows.shape[0] == int(np.maximum(cnt, 0).sum()) < rows.shape[0]
    assert not torch.equal(edited.nodes8_c, mesh.nodes8_c)
