"""8-wide BVH collapse and leaf blocks for K3 (port of ``accel/wide.py``).

Host-side numpy, copied from the JAX package (which the port does not
import): the SAH-optimal 8-wide grouping of the binary SBVH
(:func:`_sah_wide_forest`, :func:`collapse_bvh8`) and the 8-aligned leaf
blocks (:func:`build_leaf_packs`).  The JAX module's greedy collapse, lane-
dense layouts and dense paged builder are not carried: they are TPU VMEM
artifacts.  The port's paged layout (``accel/paged.py``) is built from
these same functions, one tree a page.

Children are sorted at build time by box centroid along the widest axis of
their union, and that axis is stored per node: K3 visits and pushes the
children in the ray's direction along it.

Encoding (``nodes8_i[n] = 8 x (ref, count)``): count 0 -> inner child,
``ref`` is a wide-node id; count > 0 -> leaf of ``count`` tri slots at
``ref`` (a row of the leaf pack); count < 0 -> empty slot.  Empty slots are
excluded by count in every consumer, not by their inverted box.

Those arrays are the JAX package's layout, bit for bit: the plain versions
and K3b's tests read them.  The CUDA walk (K3, K3c, K4, K5) reads a copy of
the same tree of its own, built from them by :func:`compress_wide`: the
compressed 8-wide nodes of Ylitie, Karras and Laine ("Efficient Incoherent
Ray Traversal on GPUs Through Compressed Wide BVHs", HPG 2017), 80 bytes a
node, and compact leaf rows, 48 bytes a triangle (layout below).
"""

from __future__ import annotations

import numpy as np

_EMPTY_BOX = (np.float32(3e38), np.float32(3e38), np.float32(3e38),
              np.float32(-3e38), np.float32(-3e38), np.float32(-3e38))


def _area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]


def _sah_wide_forest(nodes_f, nodes_i, c_node=1.0, c_leaf=0.25):
    """SAH-optimal 8-wide grouping (Ylitie et al. 2017 style DP).

    For every binary node ``b`` and slot budget ``i`` in 1..8, compute the
    minimum expected traversal cost of representing subtree(b) as a forest
    of at most ``i`` wide-node child slots:

      CC(leaf entity, i)  = A(leaf) * c_leaf            (one slot)
      D(b, j)             = min_k CC(left, k) + CC(right, j-k)
      CC(inner b, 1)      = A(b) * c_node + D(b, 8)     (close: a wide node)
      CC(inner b, i > 1)  = min(CC(b, 1), D(b, i))

    ``c_node`` is the cost of one wide-node visit, ``c_leaf`` that of one
    leaf block (MAX_LEAF = 8: every leaf is one block).

    Returns ``slots_of[b]`` — for each binary node that becomes a wide
    node, its list of (lo, hi, ref, cnt) child slots — keyed by binary id.
    """
    m = nodes_i.shape[0]
    area_b = np.empty(m, np.float64)
    for b in range(m):
        f = nodes_f[b]
        lo = np.minimum(f[0:3], f[6:9])
        hi = np.maximum(f[3:6], f[9:12])
        # An empty child carries an inverted box; union with the live one.
        if nodes_i[b, 1] < 0:
            lo, hi = f[6:9], f[9:12]
        elif nodes_i[b, 3] < 0:
            lo, hi = f[0:3], f[3:6]
        area_b[b] = _area(lo, hi)

    # Bottom-up DP, vectorised by tree level (children have larger ids than
    # parents, so the levels come out of one reverse pass; all nodes of a
    # level are independent).
    cc = np.full((m, 9), np.inf)      # cc[b, i] for inner subtree b
    dd = np.full((m, 9), np.inf)
    split_k = np.zeros((m, 9), np.int8)

    level = np.zeros(m, np.int32)
    for b in range(m - 1, -1, -1):
        lv = 0
        if nodes_i[b, 1] == 0:
            lv = max(lv, level[nodes_i[b, 0]] + 1)
        if nodes_i[b, 3] == 0:
            lv = max(lv, level[nodes_i[b, 2]] + 1)
        level[b] = lv

    # Per-child leaf costs (cnt > 0): area * c_leaf.
    refs = nodes_i[:, [0, 2]].astype(np.int64)
    cnts = nodes_i[:, [1, 3]]
    lo01 = np.stack([nodes_f[:, 0:3], nodes_f[:, 6:9]], axis=1)
    hi01 = np.stack([nodes_f[:, 3:6], nodes_f[:, 9:12]], axis=1)
    d01 = np.maximum(hi01 - lo01, 0.0).astype(np.float64)
    area01 = (d01[..., 0] * d01[..., 1] + d01[..., 1] * d01[..., 2]
              + d01[..., 2] * d01[..., 0])                   # [m, 2]
    for lv in range(int(level.max()) + 1 if m else 0):
        ids = np.nonzero(level == lv)[0]
        if ids.size == 0:
            continue
        # Child cost tables [n, 2, 9]: leaf children broadcast their leaf
        # cost; inner children read cc[ref] (already final: deeper level).
        ch = np.empty((ids.size, 2, 9))
        for s in range(2):
            is_leaf = cnts[ids, s] > 0
            ch[:, s, :] = np.where(
                is_leaf[:, None], (area01[ids, s] * c_leaf)[:, None],
                cc[refs[ids, s] * (cnts[ids, s] == 0)])
        have0 = cnts[ids, 0] >= 0
        have1 = cnts[ids, 1] >= 0
        both = have0 & have1
        single_side = np.where(have0, 0, 1)
        for j in range(2, 9):
            ks = np.arange(1, j)
            vals = ch[:, 0, ks] + ch[:, 1, j - ks]          # [n, j-1]
            k = np.argmin(vals, axis=1)
            dd[ids, j] = np.where(both, vals[np.arange(ids.size), k],
                                  ch[np.arange(ids.size), single_side, j])
            split_k[ids, j] = np.where(both, k + 1, 0)
        dd[ids, 1] = np.where(both, np.inf,
                              ch[np.arange(ids.size), single_side, 1])
        split_k[ids, 1] = 0
        close = area_b[ids] * c_node + dd[ids, 8]
        cc[ids, 1] = close
        for i in range(2, 9):
            cc[ids, i] = np.minimum(close, dd[ids, i])

    # Reconstruction: collect the slots of each wide node.
    def collect(b, budget, out):
        """Slots for subtree(b) under ``budget`` (distribute or close)."""
        if budget == 1 or cc[b, 1] <= dd[b, budget]:
            # Close: b is ONE wide-node slot (parent records an inner ref).
            out.append(("inner", b))
            return
        _distribute(b, budget, out)

    def _distribute(b, budget, out):
        have0 = nodes_i[b, 1] >= 0
        have1 = nodes_i[b, 3] >= 0
        k = int(split_k[b, budget])
        sides = ((0, k), (1, budget - k)) if (have0 and have1) else \
            (((0 if have0 else 1), budget),)
        for side, bud in sides:
            ref = int(nodes_i[b, 2 * side])
            cnt = int(nodes_i[b, 2 * side + 1])
            f = nodes_f[b]
            lo, hi = (f[0:3], f[3:6]) if side == 0 else (f[6:9], f[9:12])
            if cnt > 0:
                out.append(("leaf", (lo, hi, ref, cnt)))
            else:
                sub = []
                collect(ref, bud, sub)
                # Tag inner slots with the box stored in THEIR parent when
                # they close exactly here.
                for kind, val in sub:
                    if kind == "inner" and val == ref:
                        out.append(("inner_box", (lo, hi, ref)))
                    else:
                        out.append((kind, val))

    slots_of = {}
    boxes_of_inner = {}

    def box_of(b):
        """Box of binary node b as stored in its parent (fallback: union
        of its children boxes)."""
        if b in boxes_of_inner:
            return boxes_of_inner[b]
        f = nodes_f[b]
        lo = np.minimum(f[0:3], f[6:9])
        hi = np.maximum(f[3:6], f[9:12])
        if nodes_i[b, 1] < 0:
            lo, hi = f[6:9], f[9:12]
        elif nodes_i[b, 3] < 0:
            lo, hi = f[0:3], f[3:6]
        return lo, hi

    work = [0]
    seen = {0}
    while work:
        b = work.pop()
        out = []
        _distribute(b, 8, out)
        slots = []
        for kind, val in out:
            if kind == "leaf":
                slots.append(val)
            else:
                if kind == "inner_box":
                    lo, hi, ref = val
                    boxes_of_inner[ref] = (lo, hi)
                else:
                    ref = val
                    lo, hi = box_of(ref)
                slots.append((lo, hi, int(ref), 0))
                if ref not in seen:
                    seen.add(ref)
                    work.append(int(ref))
        slots_of[b] = slots
    return slots_of


def collapse_bvh8(nodes_f: np.ndarray, nodes_i: np.ndarray):
    """Collapse a binary SBVH into 8-wide nodes by the SAH-optimal grouping
    (:func:`_sah_wide_forest`).

    ``nodes_f``: [M,12] two child AABBs (lo0,hi0,lo1,hi1) per binary node.
    ``nodes_i``: [M,4] (c0,n0,c1,n1) child records (see scene.MeshData).

    Returns ``(nodes8_f [N*8,8], nodes8_i [N,16], nodes8_ax [N],
    max_depth)``: row ``w*8+c`` of ``nodes8_f`` is child c's (lo3, hi3, 0,
    0); empty slots carry an inverted box (cosmetic: exclusion is by count).
    ``max_depth`` counts wide levels, the root being level 1.
    """
    nodes_f = np.asarray(nodes_f, np.float32)
    nodes_i = np.asarray(nodes_i, np.int64)

    sah_slots = _sah_wide_forest(nodes_f, nodes_i)
    # Emit wide nodes in DFS order.
    wide_children = [None]
    wide_of_bin = {0: 0}
    order = [0]
    depth_of = {0: 1}
    max_depth = 1
    while order:
        b = order.pop()
        w = wide_of_bin[b]
        slots = sah_slots[b]
        for lo, hi, ref, cnt in slots:
            if cnt == 0:
                wid = len(wide_children)
                wide_of_bin[ref] = wid
                wide_children.append(None)
                depth_of[wid] = depth_of[w] + 1
                max_depth = max(max_depth, depth_of[wid])
                order.append(ref)
        wide_children[w] = slots

    n = len(wide_children)
    nodes8_f = np.empty((n * 8, 8), np.float32)
    nodes8_f[:, 6:8] = 0.0
    nodes8_i = np.empty((n, 16), np.int32)
    nodes8_ax = np.empty((n,), np.int32)
    for w, slots in enumerate(wide_children):
        lo_all = np.min([s[0] for s in slots], axis=0)
        hi_all = np.max([s[1] for s in slots], axis=0)
        ax = int(np.argmax(hi_all - lo_all))
        nodes8_ax[w] = ax
        slots = sorted(slots, key=lambda s: float(s[0][ax] + s[1][ax]))
        for c in range(8):
            if c < len(slots):
                lo, hi, ref, cnt = slots[c]
                nodes8_f[w * 8 + c, 0:3] = lo
                nodes8_f[w * 8 + c, 3:6] = hi
                nodes8_i[w, 2 * c] = wide_of_bin[ref] if cnt == 0 else ref
                nodes8_i[w, 2 * c + 1] = cnt
            else:
                nodes8_f[w * 8 + c, 0:6] = _EMPTY_BOX
                nodes8_i[w, 2 * c] = 0
                nodes8_i[w, 2 * c + 1] = -1
    return nodes8_f, nodes8_i, nodes8_ax, max_depth


def build_leaf_packs(n8i, v0, e1, e2, uvs6, tans9, slot_base=0, nrms9=None):
    """8-aligned leaf blocks for K3.

    Rewrites the leaf refs of ``n8i`` (returned as a copy) to index a
    freshly-built pack where every leaf's MAX_LEAF slots start at a
    multiple of 8.  Pack row = (v0[3], e1[3], e2[3], slot_base+slot,
    uv corners[6]); aux row = (tangent corners[9], zeros).  Zero padding
    rows are degenerate (det 0) and never hit.

    ``v0/e1/e2`` are [R,3] leaf-ordered triangle data, ``uvs6`` [R,6] uv
    corners, ``tans9`` [R,9] tangent corners; ``slot_base`` offsets the
    recorded winner slots.  With ``nrms9`` ([R,9] per-corner normals) a
    third pack of normal corners is returned.
    """
    pack_rows = []
    aux_rows = []
    nrm_rows = []
    n8i = n8i.copy()
    for w in range(n8i.shape[0]):
        for c in range(8):
            ref, cnt = n8i[w, 2 * c], n8i[w, 2 * c + 1]
            if cnt > 0:
                n8i[w, 2 * c] = len(pack_rows)
                for j in range(cnt):
                    s = ref + j
                    row = np.zeros(16, np.float32)
                    row[0:3] = v0[s]
                    row[3:6] = e1[s]
                    row[6:9] = e2[s]
                    row[9] = float(slot_base + s)
                    row[10:16] = uvs6[s]
                    pack_rows.append(row)
                    arow = np.zeros(16, np.float32)
                    arow[0:9] = tans9[s]
                    aux_rows.append(arow)
                    if nrms9 is not None:
                        nrow = np.zeros(16, np.float32)
                        nrow[0:9] = nrms9[s]
                        nrm_rows.append(nrow)
                while len(pack_rows) % 8:
                    pack_rows.append(np.zeros(16, np.float32))
                    aux_rows.append(np.zeros(16, np.float32))
                    if nrms9 is not None:
                        nrm_rows.append(np.zeros(16, np.float32))
    tri_pack = (np.stack(pack_rows) if pack_rows
                else np.zeros((8, 16), np.float32))
    aux_pack = (np.stack(aux_rows) if aux_rows
                else np.zeros((8, 16), np.float32))
    if nrms9 is None:
        return n8i, tri_pack, aux_pack
    nrm_pack = (np.stack(nrm_rows) if nrm_rows
                else np.zeros((8, 16), np.float32))
    return n8i, tri_pack, aux_pack, nrm_pack


# -- The compressed 8-wide copy (the CUDA walk's layout) ----------------------
#
# Node: 20 int32 words (80 bytes, five 16-byte loads), little-endian bytes:
#   0-11   origin p (float32 x, y, z): 1/128 quantum below the lo corner of
#          the union of the node's non-empty child boxes, rounded down
#   12-14  exponents E_x, E_y, E_z (bytes): the quantum of axis k is
#          s_k = 2^(E_k - 127), the float32 whose bit pattern is E_k << 23
#   15     imask: bit c set where child c is an inner node
#   16-19  child base (int32): the copy's id of the node's first inner
#          child; its inner children are the ids base, base + 1, ...
#   20-23  row base (int32): the first row of the node's leaf triangles;
#          the leaves' rows follow one another in child order
#   24-31  meta[c], one byte a child: 0 empty; 0x40 | r an inner child,
#          child base + r; 0x80 | o a leaf whose rows start at row base + o
#   32-79  quantised child bounds, one byte a child each, in eight-byte
#          groups: lo x, lo y, lo z, hi x, hi y, hi z.  Child c's box is
#          lo_k = p_k + q_lo[k][c] * s_k, hi_k = p_k + q_hi[k][c] * s_k in
#          float32 (q * s is exact), rounded outward at build time with a
#          margin of 1/128 quantum: the decoded box always contains the
#          float box, with room for the 1/512 quantum the walk's one-FMA
#          plane test may err by on a node within about 2^15 quanta of the
#          ray's origin (csrc/traverse.cuh).  Farther off, the test errs by
#          the float slab test's order.  Empty children hold q_lo 255 and
#          q_hi 0.
# Leaf row: 12 words (48 bytes, three 16-byte loads): v0, e1, e2 (float32),
# the slot (int32), 1 on the last row of a leaf and 0 elsewhere, and 0.
# Leaves are not padded.  Nodes are numbered breadth first from the root
# (id 0), so a paged tree's page roots, all one level below its top tree,
# get the ids just past it.
CW_WORDS = 20
ROW_WORDS = 12
META_INNER, META_LEAF = 0x40, 0x80
_EMPTY_Q = (255, 0)
MARGIN = 1.0 / 128  # of a quantum, outside each float plane


def _bfs_order(ref, cnt):
    """Old node ids in the copy's order (breadth first from node 0, each
    node's inner children in child order, so they are contiguous) and the
    copy's id of each old node's first inner child."""
    n = ref.shape[0]
    base = np.zeros(n, np.int64)
    level, order, nxt = np.zeros(1, np.int64), [np.zeros(1, np.int64)], 1
    while level.size:
        inner = cnt[level] == 0
        kids = ref[level][inner]
        k = inner.sum(axis=1)
        base[level] = nxt + np.cumsum(k) - k
        nxt += kids.size
        order.append(kids)
        level = kids
    order = np.concatenate(order)
    if np.unique(order).size != order.size:
        raise ValueError("the 8-wide records are not a tree")
    return order, base


def _quantise(lo, hi, valid):
    """Origin [M,3], biased exponents [M,3] and child bounds (q_lo, q_hi
    [M,8,3] uint8) of the child boxes ``lo``/``hi`` [M,8,3] where
    ``valid``: in exact arithmetic p + q_lo * s <= lo - MARGIN * s and
    p + q_hi * s >= hi + MARGIN * s."""
    big = np.float32(np.inf)
    plo = np.where(valid[..., None], lo, big).min(axis=1)
    phi = np.where(valid[..., None], hi, -big).max(axis=1)
    none = ~valid.any(axis=1)
    plo[none], phi[none] = 0.0, 0.0
    lo64, hi64 = lo.astype(np.float64), hi.astype(np.float64)
    # 254 quanta for the extent leave room for the margins and roundings.
    ext = (phi.astype(np.float64) - plo.astype(np.float64)) / 254.0
    with np.errstate(divide="ignore"):
        e = np.where(ext > 0, np.ceil(np.log2(np.where(ext > 0, ext, 1.0))), -126)
    e = np.clip(e, -126, 127).astype(np.int64)
    while True:
        s = ((e + 127).astype(np.uint32) << 23).view(np.float32).astype(np.float64)
        # The origin: the margin below the lo corner, rounded down to float32.
        p64 = plo.astype(np.float64) - MARGIN * s
        p = p64.astype(np.float32)
        p = np.where(p.astype(np.float64) > p64, np.nextafter(p, -big), p)
        pe, se = p.astype(np.float64)[:, None, :], s[:, None, :]
        q_lo = np.floor((lo64 - pe) / se - MARGIN)
        q_hi = np.ceil((hi64 - pe) / se + MARGIN)
        over = (valid[..., None] & (q_hi > 255)).any(axis=1)
        if not over.any():
            break
        if (e[over] >= 127).any():
            raise ValueError("a node's extent overflows the float32 quanta")
        e[over] += 1
    if (valid[..., None] & (q_lo < 0)).any():
        raise AssertionError("a child bound below the node's origin")
    q_lo = np.where(valid[..., None], q_lo, _EMPTY_Q[0]).astype(np.uint8)
    q_hi = np.where(valid[..., None], q_hi, _EMPTY_Q[1]).astype(np.uint8)
    return p, (e + 127).astype(np.uint8), q_lo, q_hi


def compress_wide(nodes8_f, nodes8_i, tri_pack):
    """The compressed copy of an 8-wide tree (layout above) from the
    JAX-parity arrays: ``nodes8_f`` [N*8,8] child boxes, ``nodes8_i``
    [N,16] records (root 0) and ``tri_pack`` [T8,16] leaf blocks.

    Returns ``(nodes [M,20] int32, rows [R,12] float32, order [M])``:
    ``order[m]`` is the ``nodes8_i`` id of the copy's node ``m`` (only the
    nodes reachable from the root are copied), and ``rows`` holds each
    leaf's unpadded rows, in the copy's node order and child order."""
    ref = np.asarray(nodes8_i, np.int64).reshape(-1, 8, 2)[..., 0]
    cnt = np.asarray(nodes8_i, np.int64).reshape(-1, 8, 2)[..., 1]
    boxes = np.asarray(nodes8_f, np.float32).reshape(-1, 8, 8)
    pack = np.asarray(tri_pack, np.float32)
    order, base = _bfs_order(ref, cnt)
    ref, cnt, boxes = ref[order], cnt[order], boxes[order]
    m = order.size

    # Leaf rows: each leaf's count rows, in node order then child order.
    n_rows = np.where(cnt > 0, cnt, 0).reshape(-1)
    start = np.cumsum(n_rows) - n_rows
    row_base = start.reshape(m, 8)[:, 0]
    offset = start.reshape(m, 8) - row_base[:, None]
    is_leaf = n_rows > 0
    lengths = n_rows[is_leaf]
    first = ref.reshape(-1)[is_leaf]
    total = int(n_rows.sum())
    within = np.arange(total) - np.repeat(start[is_leaf], lengths)
    src = np.repeat(first, lengths) + within
    rows = np.zeros((total, ROW_WORDS), np.float32)
    rows[:, 0:9] = pack[src, 0:9]
    words = rows.view(np.int32)
    words[:, 9] = pack[src, 9].astype(np.int32)  # float32 slots, exact < 2^24
    words[start[is_leaf] + lengths - 1, 10] = 1

    # Meta bytes and the kind mask.
    inner = cnt == 0
    rank = np.cumsum(inner, axis=1) - inner
    if (offset[cnt > 0] >= 64).any():
        raise ValueError("a node's leaves hold more than 64 rows")
    meta = np.where(inner, META_INNER | rank,
                    np.where(cnt > 0, META_LEAF | offset, 0)).astype(np.uint8)
    imask = (inner.astype(np.uint32) << np.arange(8, dtype=np.uint32)).sum(axis=1)

    plo, exps, q_lo, q_hi = _quantise(boxes[..., 0:3], boxes[..., 3:6],
                                      cnt >= 0)
    out = np.zeros((m, 4 * CW_WORDS), np.uint8)
    out[:, 0:12] = plo.view(np.uint8).reshape(m, 12)
    out[:, 12:15] = exps
    out[:, 15] = imask.astype(np.uint8)
    out[:, 16:20] = base[order].astype(np.int32).view(np.uint8).reshape(m, 4)
    out[:, 20:24] = row_base.astype(np.int32).view(np.uint8).reshape(m, 4)
    out[:, 24:32] = meta
    for k in range(3):
        out[:, 32 + 8 * k:40 + 8 * k] = q_lo[..., k]
        out[:, 56 + 8 * k:64 + 8 * k] = q_hi[..., k]
    return out.view(np.int32), rows, order


def decode_compressed(nodes):
    """The plain decode of compressed nodes [M,20] (tests only; the walk
    decodes in csrc/traverse.cuh): ``kind`` [M,8] (0 empty, 1 inner, 2
    leaf), ``child`` [M,8] (the inner child's id, else -1), ``row`` [M,8]
    (the leaf's first row, else -1; its rows run to the one marked last),
    the decoded boxes ``lo``/``hi`` [M,8,3] float32 (as the walk decodes
    them), their integer bounds ``q_lo``/``q_hi`` [M,8,3], the ``origin``
    and quanta ``scale`` [M,3] and ``imask`` [M]."""
    b = np.ascontiguousarray(nodes, np.int32).view(np.uint8).reshape(-1, 4 * CW_WORDS)
    m = b.shape[0]
    p = np.ascontiguousarray(b[:, 0:12]).view(np.float32).reshape(m, 1, 3)
    s = (b[:, 12:15].astype(np.uint32) << 23).view(np.float32).reshape(m, 1, 3)
    base = np.ascontiguousarray(b[:, 16:20]).view(np.int32).reshape(m, 1)
    row_base = np.ascontiguousarray(b[:, 20:24]).view(np.int32).reshape(m, 1)
    meta = b[:, 24:32].astype(np.int64)
    kind = np.where(meta & META_LEAF, 2, np.where(meta & META_INNER, 1, 0))
    q_lo = np.stack([b[:, 32 + 8 * k:40 + 8 * k] for k in range(3)], axis=-1)
    q_hi = np.stack([b[:, 56 + 8 * k:64 + 8 * k] for k in range(3)], axis=-1)
    return {
        "kind": kind,
        "child": np.where(kind == 1, base + (meta & 7), -1),
        "row": np.where(kind == 2, row_base + (meta & 63), -1),
        "lo": p + q_lo.astype(np.float32) * s,
        "hi": p + q_hi.astype(np.float32) * s,
        "q_lo": q_lo,
        "q_hi": q_hi,
        "origin": p.reshape(m, 3),
        "scale": s.reshape(m, 3),
        "imask": b[:, 15].astype(np.int64),
    }
