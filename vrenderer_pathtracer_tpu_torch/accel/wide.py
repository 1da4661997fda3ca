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
