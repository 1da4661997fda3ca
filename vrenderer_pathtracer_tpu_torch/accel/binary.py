"""K3b's copy of the binary SBVH (the port's own; no JAX counterpart).

The JAX-parity arrays (``nodes_f`` [M,12], ``nodes_i`` [M,4], ``tri_v0``/
``tri_e1``/``tri_e2`` [T,3]) stay as they are for the plain ``traverse``.
K3b (``csrc/traverse.cu``) reads a copy of the same tree built beside them
at pack time by :func:`compress_binary`:

Node: 16 words (64 bytes, four 16-byte loads, one aligned 64-byte block).
  Words 0-11 are the node's float row as it is (child 0's lo and hi, then
  child 1's, float32 bits).  Words 12-13 are the children's links, 14-15
  their counts (``nodes_i``'s, so -1 marks an empty child).  A link is the
  node id of an inner child (count 0), ``~(ref << 3 | (count - 1))`` of a
  leaf (negative: the walk tells leaves from inner nodes by the sign, and
  stacks a leaf as one word), and ``ref`` of an empty child.
Triangle row: 12 words (48 bytes, three 16-byte loads), one per slot of
  the contiguous leaf-ordered arrays (a binary leaf is the range
  ``[ref, ref + count)``, so the row index is the slot): v0, e1 and e2,
  each as a float4 whose fourth word is 0.

:func:`decode_binary` gives the JAX-parity arrays back, bit for bit.
"""

from __future__ import annotations

import numpy as np

NODE_WORDS = 16
TRI_ROW_WORDS = 12
LEAF_BITS = 3           # a leaf link's count field: counts 1..8 (MAX_LEAF)
MAX_LEAF_REF = 1 << 28  # leaf refs below this keep ~(ref << 3 | k) negative


def compress_binary(nodes_f, nodes_i, tri_v0, tri_e1, tri_e2):
    """K3b's copy (layout above) from the JAX-parity arrays: ``nodes_f``
    [M,12] float32, ``nodes_i`` [M,4] int32 (root 0), ``tri_v0``/``tri_e1``/
    ``tri_e2`` [T,3] float32.  Returns ``(nodes [M,16] int32, rows [T,12]
    float32)``.  Raises on a leaf the link cannot hold (a count outside
    1..8 or a ref of 2^28 or more)."""
    nf = np.ascontiguousarray(nodes_f, np.float32).reshape(-1, 12)
    ni = np.asarray(nodes_i, np.int64).reshape(-1, 4)
    ref, cnt = ni[:, 0::2], ni[:, 1::2]
    leaf = cnt > 0
    if (cnt[leaf] > 1 << LEAF_BITS).any() or (ref[leaf] < 0).any() \
            or (ref[leaf] >= MAX_LEAF_REF).any():
        raise ValueError("a binary leaf the copy's link cannot hold (count "
                         f"above {1 << LEAF_BITS} or ref outside [0, 2^28))")
    link = np.where(leaf, ~((ref << LEAF_BITS) | np.maximum(cnt - 1, 0)), ref)
    nodes = np.zeros((nf.shape[0], NODE_WORDS), np.int32)
    nodes[:, 0:12] = nf.view(np.int32)
    nodes[:, 12:14] = link.astype(np.int32)
    nodes[:, 14:16] = cnt.astype(np.int32)
    rows = np.zeros((np.shape(tri_v0)[0], TRI_ROW_WORDS), np.float32)
    for k, a in enumerate((tri_v0, tri_e1, tri_e2)):
        rows[:, 4 * k:4 * k + 3] = np.asarray(a, np.float32)
    return nodes, rows


def decode_binary(nodes, rows):
    """The plain decode of the copy (tests only; K3b decodes in
    csrc/traverse.cu): ``(nodes_f [M,12], nodes_i [M,4], tri_v0, tri_e1,
    tri_e2 [T,3])``."""
    words = np.ascontiguousarray(nodes, np.int32).reshape(-1, NODE_WORDS)
    link, cnt = words[:, 12:14].astype(np.int64), words[:, 14:16]
    ref = np.where(cnt > 0, (~link) >> LEAF_BITS, link)
    nodes_i = np.stack([ref[:, 0], cnt[:, 0], ref[:, 1], cnt[:, 1]],
                       axis=1).astype(np.int32)
    nodes_f = np.ascontiguousarray(words[:, 0:12]).view(np.float32)
    r = np.asarray(rows, np.float32).reshape(-1, TRI_ROW_WORDS)
    return (nodes_f, nodes_i, *(np.ascontiguousarray(r[:, 4 * k:4 * k + 3])
                                for k in range(3)))
