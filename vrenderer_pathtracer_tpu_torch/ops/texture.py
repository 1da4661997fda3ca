"""Surface texture fetches: diffuse / normal / specular maps (port of
``ops/texture.py``).

Reference semantics: integer texel coordinates ``x = W*u``, ``y = H*v`` with
a clamped flat index, i.e. a nearest fetch with wrap-by-overflow folded into
the clamp; ``fetch_nearest`` reproduces it exactly, ``fetch_bilinear`` is the
differentiable variant.  The JAX module pads its row gathers to 64 lanes
behind optimisation barriers to dodge a TPU gather cliff; the port indexes
the flat table directly.
"""

from __future__ import annotations

import torch


def _flat(tex):
    return tex.reshape(-1, tex.shape[-1])


def fetch_nearest(tex, u, v):
    """tex [H,W,C]; u,v [B] -> [B,C] (reference-parity integer fetch)."""
    height, width = tex.shape[0], tex.shape[1]
    x = (u * width).to(torch.int32)
    y = (v * height).to(torch.int32)
    addr = torch.clamp(x + y * width, 0, width * height - 1)
    return _flat(tex)[addr.long()]


def fetch_bilinear(tex, u, v):
    """Clamped bilinear fetch ([H,W,C]) for smooth texture gradients."""
    height, width = tex.shape[0], tex.shape[1]
    fx = u * width - 0.5
    fy = v * height - 0.5
    x0 = torch.floor(fx).to(torch.int32)
    y0 = torch.floor(fy).to(torch.int32)
    wx = (fx - x0)[:, None]
    wy = (fy - y0)[:, None]
    x0c = torch.clamp(x0, 0, width - 1)
    x1c = torch.clamp(x0 + 1, 0, width - 1)
    y0c = torch.clamp(y0, 0, height - 1)
    y1c = torch.clamp(y0 + 1, 0, height - 1)
    flat = _flat(tex)
    c00 = flat[(x0c + y0c * width).long()]
    c10 = flat[(x1c + y0c * width).long()]
    c01 = flat[(x0c + y1c * width).long()]
    c11 = flat[(x1c + y1c * width).long()]
    top = c00 * (1 - wx) + c10 * wx
    bot = c01 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy


def fetch_maps(maps, u, v, filter_mode):
    """Fetch several maps at the same (u, v) with one combined gather.

    ``maps`` is a list of [H,W,C]-or-None; same-resolution present maps are
    fetched through a channel-concatenated table (bitwise-identical rows),
    the rest individually.  Returns a list aligned with ``maps`` (None where
    the input was None).
    """
    fetch = fetch_bilinear if filter_mode == "bilinear" else fetch_nearest
    live = [(i, m) for i, m in enumerate(maps) if m is not None]
    out = [None] * len(maps)
    shapes = {tuple(m.shape[:2]) for _, m in live}
    if len(live) <= 1 or len(shapes) != 1:
        for i, m in live:
            out[i] = fetch(m, u, v)
        return out
    texc = fetch(torch.cat([m for _, m in live], dim=2), u, v)
    # Split by each map's own channel count.
    off = 0
    for i, m in live:
        out[i] = texc[:, off:off + m.shape[2]]
        off += m.shape[2]
    return out


def decode_normal_map(texel):
    """Remap a normal-map texel to [-1,1] and normalise."""
    n = 2.0 * texel - 1.0
    return n / torch.linalg.norm(n, dim=-1, keepdim=True)


def apply_tbn(normal, tangent, n_tangentspace):
    """World normal = TBN * tangent-space normal.

    normal/tangent: [B,3] unit vectors; n_tangentspace: [B,3].
    bitangent = cross(normal, tangent), columns (tangent, bitangent, normal).
    """
    bitangent = torch.linalg.cross(normal, tangent)
    world = (
        tangent * n_tangentspace[:, 0:1]
        + bitangent * n_tangentspace[:, 1:2]
        + normal * n_tangentspace[:, 2:3]
    )
    return world / torch.linalg.norm(world, dim=-1, keepdim=True)
