"""Ray sorting before a mesh search (port of ``accel/sorting.py``).

Rays are reordered by a (direction octant, origin Morton, direction Morton)
key before the search and the results scattered back to the caller's
order, so that neighbouring threads walk the same subtrees.  The key is the
JAX package's bit for bit, computed in int64 with explicit masks (CPU torch
cannot add or shift ``uint32``).  Pure torch around whichever search the
scene resolved (K3, K5 or a plain version).
"""

from __future__ import annotations

import torch

_DEAD_KEY = 0xFFFFFFFF


def _spread3(v):
    """Spread 9 bits to every 3rd bit (int64 holding uint32 values)."""
    v = v & 0x1FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _morton9(q):
    """27-bit Morton code of [B,3] values in [0, 1] quantized to 9 bits."""
    q = (q * 511.0).to(torch.int64)
    return (_spread3(q[:, 0]) << 2) | (_spread3(q[:, 1]) << 1) | _spread3(q[:, 2])


def ray_sort_keys(ray_o, ray_d, lo, hi):
    """[B] int64 keys holding uint32 values: octant (3 bits) | origin
    Morton (top 15 of 27) | direction Morton (top 14 of 27)."""
    octant = ((ray_d[:, 0] >= 0).long() | ((ray_d[:, 1] >= 0).long() << 1)
              | ((ray_d[:, 2] >= 0).long() << 2))
    span = torch.clamp(hi - lo, min=1e-12)
    morton_o = _morton9(torch.clamp((ray_o - lo) / span, 0.0, 1.0))
    morton_d = _morton9(torch.clamp((ray_d + 1.0) * 0.5, 0.0, 1.0))
    return ((octant << 29) | ((morton_o >> 12) << 14) | (morton_d >> 13)) \
        & 0xFFFFFFFF


def mesh_bounds(mesh):
    """The mesh's AABB ``(lo [3], hi [3])``: the page boxes of a paged
    mesh, else the root's two child boxes."""
    if mesh.paged is not None:
        bbox = mesh.paged.bbox
        return bbox[:, 0:3].amin(dim=0), bbox[:, 3:6].amax(dim=0)
    root = mesh.nodes_f[0]
    return (torch.minimum(root[0:3], root[6:9]),
            torch.maximum(root[3:6], root[9:12]))


def sorted_traverse(search, mesh, ray_o, ray_d, t_max):
    """Run ``search`` (a traverse-like function) on coherence-sorted rays.

    Returns ``(slot, t)`` in the original ray order.  Terminated lanes
    (``t_max <= 0``) sort last, whatever their stale ray."""
    lo, hi = mesh_bounds(mesh)
    keys = ray_sort_keys(ray_o, ray_d, lo, hi)
    keys = torch.where(t_max > 0.0, keys, torch.full_like(keys, _DEAD_KEY))
    perm = torch.argsort(keys, stable=True)
    slot_s, t_s = search(mesh, ray_o[perm].contiguous(),
                         ray_d[perm].contiguous(), t_max[perm].contiguous())
    slot = torch.empty_like(slot_s).index_put_((perm,), slot_s)
    t = torch.empty_like(t_s).index_put_((perm,), t_s)
    return slot, t
