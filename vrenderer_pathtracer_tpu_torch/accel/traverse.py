"""BVH traversal + mesh hit shading (port of ``accel/traverse.py``).

``traverse`` is the lockstep binary traversal of the JAX package, step for
step: each iteration pops one node per live ray, slab-tests both children
against the running closest hit, resolves leaf children inline with a
``MAX_LEAF``-wide Möller–Trumbore test, and pushes inner children far then
near.  It is the plain PyTorch version of both K3 and K3b
(``accel/cuda_traverse.py``), which return the same closest hit.  The port
processes only the rays that are still live in each iteration; a ray's own
sequence of steps is the JAX loop's.

Differentiability (detached-hit convention): the search only yields the
discrete winning slot per ray; the hit attributes (t, barycentrics, point,
interpolated normal/tangent/uv) are recomputed afterwards with
differentiable ops from the gathered triangle (``shade_mesh_hit``).

Win-time attribute capture (``settings.captured_attrs``, forward only): the
search also returns the winner's face normal, uv, tangent and smooth
normal (K3c on the card, ``capture_reference`` on the CPU), and
``shade_mesh_hit_captured`` shades from them without the recompute.
"""

from __future__ import annotations

import torch

from vrenderer_pathtracer_tpu_torch.accel.mesh import (
    MAX_LEAF, STACK_DEPTH, WIDE_STACK_DEPTH)
from vrenderer_pathtracer_tpu_torch.config import RenderSettings
from vrenderer_pathtracer_tpu_torch.ops import texture as tex_ops
from vrenderer_pathtracer_tpu_torch.scene.scene import MeshData, Scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import BRDF, DIFF
from vrenderer_pathtracer_tpu_torch.utils.profiling import plain_version

# Triangle-test epsilon (the reference's own backends use 3e-10 and 3e-4;
# this sits between).
TRI_EPS = 1e-7

# Win-time attribute capture: field -> component count (the JAX package's
# pallas_traverse.CAPTURE_WIDTHS).
CAPTURE_WIDTHS = {"normal": 3, "uv": 2, "tangent": 3, "smooth": 3}


def _moller_trumbore(ray_o, ray_d, v0, e1, e2):
    """Batched Möller–Trumbore over gathered triangles.

    ray_o/ray_d: [B,3]; v0/e1/e2: [B,K,3].  Returns (t, u, v, ok) each [B,K]
    (barycentric u along e1, v along e2; double-sided).
    """
    d = ray_d[:, None, :].expand_as(e2)
    o = ray_o[:, None, :]
    pvec = torch.linalg.cross(d, e2)
    det = torch.sum(e1 * pvec, dim=-1)
    big = torch.abs(det) > TRI_EPS
    inv_det = torch.where(big, 1.0 / det, torch.zeros_like(det))
    tvec = o - v0
    u = torch.sum(tvec * pvec, dim=-1) * inv_det
    qvec = torch.linalg.cross(tvec, e1)
    v = torch.sum(d * qvec, dim=-1) * inv_det
    t = torch.sum(e2 * qvec, dim=-1) * inv_det
    ok = big & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > TRI_EPS)
    return t, u, v, ok


def _slab_test(ray_o, inv_d, lo, hi, t_max):
    """Robust slab test. lo/hi: [B,3]. Returns (hit [B], t_near [B])."""
    t0 = (lo - ray_o) * inv_d
    t1 = (hi - ray_o) * inv_d
    t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
    t_near_c = torch.clamp(t_near, min=0.0)
    t_far_c = torch.minimum(t_far, t_max)
    return t_near_c <= t_far_c, t_near


def _safe_inv(ray_d):
    """1/d with the slab test's signed-epsilon guard (|d| <= 1e-12 -> ±1e-12)."""
    eps = torch.where(ray_d >= 0, 1e-12, -1e-12).to(ray_d.dtype)
    return 1.0 / torch.where(torch.abs(ray_d) > 1e-12, ray_d, eps)


def _leaf_intersect(mesh: MeshData, ray_o, ray_d, start, count, active, best_t,
                    best_slot):
    """Test up to MAX_LEAF triangles of one leaf child per ray."""
    k = torch.arange(MAX_LEAF, dtype=start.dtype, device=start.device)
    slots = start[:, None] + k[None, :]                    # [B,K]
    valid = active[:, None] & (k[None, :] < count[:, None])
    slots_safe = torch.where(valid, slots, torch.zeros_like(slots)).long()
    t, _, _, ok = _moller_trumbore(ray_o, ray_d, mesh.tri_v0[slots_safe],
                                   mesh.tri_e1[slots_safe],
                                   mesh.tri_e2[slots_safe])
    ok = ok & valid & (t < best_t[:, None])
    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    t_min, j = torch.min(t, dim=-1)  # the first minimum: leaf order wins ties
    slot_min = torch.gather(slots_safe, 1, j[:, None])[:, 0].to(torch.int32)
    won = torch.isfinite(t_min)
    return torch.where(won, t_min, best_t), torch.where(won, slot_min, best_slot)


@plain_version
@torch.no_grad()
def traverse(mesh: MeshData, ray_o, ray_d, t_max):
    """Find the nearest triangle hit per ray.

    Returns ``(slot [B] int32, t [B])``: slot -1 and t = t_max on a miss.
    ``traverse.count`` counts calls (the card's main path never makes one).
    """
    if mesh.paged is not None:
        raise ValueError("a paged mesh has no single-level tree: search it "
                         "with traverse_paged_reference or K5")
    traverse.count += 1
    b = ray_o.shape[0]
    dev = ray_o.device
    inv_d = _safe_inv(ray_d)
    best_t = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=dev), (b,)).clone()
    best_slot = torch.full((b,), -1, dtype=torch.int32, device=dev)
    sp = torch.ones((b,), dtype=torch.int64, device=dev)
    stack = torch.zeros((b, STACK_DEPTH), dtype=torch.int64, device=dev)  # root = 0
    nodes_i = mesh.nodes_i.long()
    max_iters = 4 * mesh.nodes_i.shape[0] + STACK_DEPTH

    for _ in range(max_iters):
        lane = torch.nonzero(sp > 0).squeeze(1)  # the rays still traversing
        if lane.numel() == 0:
            break
        o, id_ = ray_o[lane], inv_d[lane]
        sp_l = sp[lane] - 1
        node = stack[lane, sp_l]
        nf, ni = mesh.nodes_f[node], nodes_i[node]
        bt, bs = best_t[lane], best_slot[lane]
        hits, nears = [], []
        for c in range(2):
            hit, t_near = _slab_test(o, id_, nf[:, 6 * c: 6 * c + 3],
                                     nf[:, 6 * c + 3: 6 * c + 6], bt)
            hit = hit & (ni[:, 2 * c + 1] >= 0)
            hits.append(hit)
            nears.append(t_near)
            # Leaf child: resolve inline.
            bt, bs = _leaf_intersect(mesh, o, ray_d[lane], ni[:, 2 * c],
                                     ni[:, 2 * c + 1],
                                     hit & (ni[:, 2 * c + 1] > 0), bt, bs)
        best_t[lane], best_slot[lane] = bt, bs

        # Inner children: push in far-then-near order so near pops first.
        push0 = hits[0] & (ni[:, 1] == 0)
        push1 = hits[1] & (ni[:, 3] == 0)
        both = push0 & push1
        near0 = nears[0] <= nears[1]
        c0, c1 = ni[:, 0], ni[:, 2]
        first = torch.where(both, torch.where(near0, c1, c0),  # far child first
                            torch.where(push0, c0, c1))
        second = torch.where(near0, c0, c1)                    # near child on top
        any_push = push0 | push1
        idx_a = torch.clamp(sp_l, max=STACK_DEPTH - 1)
        idx_b = torch.clamp(sp_l + both.long(), max=STACK_DEPTH - 1)
        stack[lane, idx_a] = torch.where(any_push, first, stack[lane, idx_a])
        stack[lane, idx_b] = torch.where(
            any_push, torch.where(both, second, first), stack[lane, idx_b])
        sp[lane] = torch.clamp(sp_l + push0.long() + push1.long(),
                               max=STACK_DEPTH - 1)
    return best_slot, best_t


traverse.count = 0

# Rays per step of the plain paged traversal: bounds its [rays, 64, 16]
# leaf-block gathers (~270 MB at this size).
PAGED_REFERENCE_CHUNK = 1 << 16


def _wide_search(boxes, recs, pack, ray_o, ray_d, t_max):
    """Lockstep closest-hit search over an 8-wide tree from root 0.

    Each iteration pops one node per live ray, slab-tests its eight
    children against the ray's best t, tests every triangle of its hit
    leaf children (the first minimum in child order wins a tie) and pushes
    its hit inner children far to near by entry distance.  A ray with
    t_max <= 0 (or NaN) does no search."""
    b, dev = ray_o.shape[0], ray_o.device
    inv_d = _safe_inv(ray_d)
    best_t = t_max.clone()
    best_slot = torch.full((b,), -1, dtype=torch.int32, device=dev)
    stack = torch.zeros((b, WIDE_STACK_DEPTH), dtype=torch.int64, device=dev)
    sp = (t_max > 0).long()
    k8 = torch.arange(8, device=dev)
    kl = torch.arange(MAX_LEAF, device=dev)
    while True:
        lane = torch.nonzero(sp > 0).squeeze(1)
        if lane.numel() == 0:
            break
        sp_l = sp[lane] - 1
        node = stack[lane, sp_l]
        bx, rc = boxes[node], recs[node]        # [L,8,8], [L,8,2]
        o, inv, bt = ray_o[lane], inv_d[lane], best_t[lane]
        t0 = (bx[..., 0:3] - o[:, None]) * inv[:, None]
        t1 = (bx[..., 3:6] - o[:, None]) * inv[:, None]
        t_near = torch.amax(torch.minimum(t0, t1), dim=-1)
        t_far = torch.amin(torch.maximum(t0, t1), dim=-1)
        ref, cnt = rc[..., 0], rc[..., 1]
        hit = ((torch.clamp(t_near, min=0.0)
                <= torch.minimum(t_far, bt[:, None])) & (cnt >= 0))
        leaf = hit & (cnt > 0)
        sub = torch.nonzero(leaf.any(dim=1)).squeeze(1)
        if sub.numel():
            rows = ref[sub, :, None] + kl                      # [S,8,K]
            valid = leaf[sub, :, None] & (kl < cnt[sub, :, None])
            rows = torch.where(valid, rows, 0).reshape(sub.numel(), -1)
            blk = pack[rows]                                    # [S,8K,16]
            t, _, _, ok = _moller_trumbore(
                o[sub], ray_d[lane[sub]], blk[..., 0:3], blk[..., 3:6],
                blk[..., 6:9])
            ok = ok & valid.reshape(sub.numel(), -1) & (t < bt[sub, None])
            t = torch.where(ok, t, torch.full_like(t, float("inf")))
            t_min, j = torch.min(t, dim=-1)
            won = torch.isfinite(t_min)
            slot = torch.gather(blk[..., 9], 1, j[:, None])[:, 0]
            idx = lane[sub]
            best_t[idx] = torch.where(won, t_min, bt[sub])
            best_slot[idx] = torch.where(won, torch.round(slot).to(torch.int32),
                                         best_slot[idx])
        inner = hit & (cnt == 0)
        key = torch.where(inner, t_near, torch.full_like(t_near, -float("inf")))
        order = torch.argsort(key, dim=1, descending=True, stable=True)
        child = torch.gather(ref, 1, order)                     # far first
        m = inner.sum(dim=1)
        pos = torch.clamp(sp_l[:, None] + k8, max=WIDE_STACK_DEPTH - 1)
        put = k8 < m[:, None]
        rows_l = lane[:, None].expand_as(pos)
        stack[rows_l[put], pos[put]] = child[put].long()
        sp[lane] = sp_l + m
    return best_slot, best_t


@plain_version
@torch.no_grad()
def traverse_paged_reference(mesh: MeshData, ray_o, ray_d, t_max):
    """The closest hit per ray over a paged mesh, the plain version of K5
    (``accel/cuda_paged.py``).

    Returns ``(slot [B] int32, t [B])`` under the contract of
    :func:`traverse`: slot -1 and t = t_max on a miss, slots global
    (``page * page_tris + local``).  It walks the top-level tree and the
    pages' trees as one 8-wide tree (``scene.PagedNodes``), in lockstep
    over the rays, ``PAGED_REFERENCE_CHUNK`` rays at a time: a page whose
    box the ray enters at or past its best t fails the slab test and is
    skipped, as K5's occlusion skip does.  ``.count`` counts calls (the
    card's main path never makes one).
    """
    traverse_paged_reference.count += 1
    pg = mesh.paged
    if pg is None:
        raise ValueError("traverse_paged_reference takes a paged mesh "
                         "(accel/paged.py)")
    b = ray_o.shape[0]
    t_max = torch.broadcast_to(torch.as_tensor(
        t_max, dtype=torch.float32, device=ray_o.device), (b,)).contiguous()
    boxes = pg.nodes8_f.view(-1, 8, 8)
    recs = pg.nodes8_i.view(-1, 8, 2).long()
    slots, ts = [], []
    for c0 in range(0, b, PAGED_REFERENCE_CHUNK):
        c = slice(c0, c0 + PAGED_REFERENCE_CHUNK)
        s, t = _wide_search(boxes, recs, pg.tri_pack, ray_o[c], ray_d[c],
                            t_max[c])
        slots.append(s)
        ts.append(t)
    if not slots:
        return (torch.empty((0,), dtype=torch.int32, device=ray_o.device),
                t_max.clone())
    return torch.cat(slots), torch.cat(ts)


traverse_paged_reference.count = 0


@torch.no_grad()
def brute_force(mesh: MeshData, ray_o, ray_d, t_max):
    """All-triangles oracle for traversal tests: O(B*T), small sizes only.

    Padding slots hold degenerate triangles with zero edges, which never
    pass the determinant test.
    """
    b = ray_o.shape[0]
    shape = (b,) + tuple(mesh.tri_v0.shape)
    t, _, _, ok = _moller_trumbore(
        ray_o, ray_d, mesh.tri_v0[None].expand(shape),
        mesh.tri_e1[None].expand(shape), mesh.tri_e2[None].expand(shape))
    t_max = torch.broadcast_to(
        torch.as_tensor(t_max, dtype=torch.float32, device=ray_o.device), (b,))
    ok = ok & (t < t_max[:, None])
    t = torch.where(ok, t, torch.full_like(t, float("inf")))
    t_min, j = torch.min(t, dim=-1)
    hit = torch.isfinite(t_min)
    return (torch.where(hit, j.to(torch.int32), -1),
            torch.where(hit, t_min, t_max))


def shade_mesh_hit(scene: Scene, settings: RenderSettings, ray_o, ray_d, slot,
                   prev):
    """Differentiable hit-attribute recompute + reference shading semantics.

    Barycentric uv/tangent interpolation; diffuse/specular maps unless
    ``use_brdf``; the smooth interpolated normal only on the normal-map
    path, otherwise the flat face normal; emission 0; hit type BRDF or DIFF.
    """
    mesh = scene.mesh
    safe = torch.clamp(slot, min=0).long()
    r_tris = mesh.tri_v0.shape[0]
    attr = torch.cat([
        mesh.tri_v0, mesh.tri_e1, mesh.tri_e2,
        mesh.tri_uv.reshape(r_tris, 6),
        mesh.tri_t.reshape(r_tris, 9),
        mesh.tri_n.reshape(r_tris, 9),
    ], dim=1)
    rows = attr[safe]
    # Flat [B] components, in the JAX function's association order.
    oc = [ray_o[:, k] for k in range(3)]
    dc = [ray_d[:, k] for k in range(3)]
    v0c = [rows[:, k] for k in range(3)]
    e1c = [rows[:, 3 + k] for k in range(3)]
    e2c = [rows[:, 6 + k] for k in range(3)]

    def cross(a, b):
        return [a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0]]

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    # Recompute (t, u, v) differentiably for the winning triangle.
    pvec = cross(dc, e2c)
    det = dot(e1c, pvec)
    big = torch.abs(det) > TRI_EPS
    inv_det = torch.where(big, 1.0 / det, torch.zeros_like(det))
    tvec = [oc[k] - v0c[k] for k in range(3)]
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1c)
    v = dot(dc, qvec) * inv_det
    t = dot(e2c, qvec) * inv_det
    w = 1.0 - u - v
    point = ray_o + ray_d * t[:, None]

    def bary_mix(base):
        """w*c0 + u*c1 + v*c2 over column-triple-packed corners."""
        return [w * rows[:, base + k] + u * rows[:, base + 3 + k]
                + v * rows[:, base + 6 + k] for k in range(3)]

    def norm3(a, eps=1e-20):
        inv = 1.0 / torch.clamp(torch.sqrt(dot(a, a)), min=eps)
        return [a[k] * inv for k in range(3)]

    # uv corners are packed per corner (u0,v0,u1,v1,u2,v2) at cols 9:15.
    uv = torch.stack([
        w * rows[:, 9] + u * rows[:, 11] + v * rows[:, 13],
        w * rows[:, 10] + u * rows[:, 12] + v * rows[:, 14],
    ], dim=-1)
    tangent = torch.stack(norm3(bary_mix(15)), dim=-1)
    texd, texn, texs = _surface_maps(scene, settings, uv)

    ne1 = [-rows[:, 3 + k] for k in range(3)]
    ne2 = [-rows[:, 6 + k] for k in range(3)]
    # cross(v0-v1, v0-v2), the reference's orientation
    face_n = torch.stack(norm3(cross(ne1, ne2)), dim=-1)
    if settings.has_normal_map:
        smooth_n = torch.stack(norm3(bary_mix(24)), dim=-1)
        normal = tex_ops.apply_tbn(smooth_n, tangent,
                                   tex_ops.decode_normal_map(texn))
    else:
        normal = face_n
    return _merged_hit(settings, prev, slot >= 0, t, point, normal, tangent,
                       texd, texs)


def _surface_maps(scene: Scene, settings: RenderSettings, uv):
    """The diffuse, normal and specular texels at ``uv`` ([B,2]), each None
    where the scene lacks the map (diffuse and specular also under
    ``use_brdf``)."""
    use_tex = not settings.use_brdf
    return tex_ops.fetch_maps(
        [scene.diffuse_map if settings.has_diffuse_map and use_tex else None,
         scene.normal_map if settings.has_normal_map else None,
         scene.specular_map if settings.has_specular_map and use_tex
         else None],
        uv[:, 0], uv[:, 1], settings.texture_filter)


def _merged_hit(settings: RenderSettings, prev, closer, t, point, normal,
                tangent, texd, texs):
    """The mesh hit where ``closer``, else the running hit ``prev``: color
    from the diffuse texels (1 without), specular color from the specular
    texels (0 without), emission 0, hit type BRDF or DIFF."""
    from vrenderer_pathtracer_tpu_torch.render.integrator import HitData

    color = texd if texd is not None else torch.ones_like(point)
    spec = texs if texs is not None else torch.zeros_like(point)
    hit_type = torch.full(t.shape, BRDF if settings.use_brdf else DIFF,
                          dtype=torch.int32, device=t.device)
    c3 = closer[:, None]
    return HitData(
        hit=prev.hit | closer,
        t=torch.where(closer, t, prev.t),
        point=torch.where(c3, point, prev.point),
        normal=torch.where(c3, normal, prev.normal),
        tangent=torch.where(c3, tangent, prev.tangent),
        color=torch.where(c3, color, prev.color),
        spec_color=torch.where(c3, spec, prev.spec_color),
        emission=torch.where(c3, torch.zeros_like(point), prev.emission),
        hit_type=torch.where(closer, hit_type, prev.hit_type),
    )


def capture_fields(settings: RenderSettings) -> tuple:
    """The attributes the captured shading reads, the JAX rule: the face
    normal always; uv with a normal map, or with diffuse or specular maps
    when not ``use_brdf``; the tangent with a normal map or ``use_brdf``;
    the smooth normal with a normal map."""
    fields = ["normal"]
    use_tex = not settings.use_brdf
    if settings.has_normal_map or (use_tex and (settings.has_diffuse_map
                                                or settings.has_specular_map)):
        fields.append("uv")
    if settings.has_normal_map or settings.use_brdf:
        fields.append("tangent")
    if settings.has_normal_map:
        fields.append("smooth")
    return tuple(fields)


@torch.no_grad()
def capture_reference(mesh: MeshData, ray_o, ray_d, slot, fields) -> dict:
    """The plain version of K3c's extra outputs: ``{field: [B, k] float32}``
    for the winners ``slot`` ([B] int32, -1 on a miss).

    The winner's barycentrics are recomputed by Möller–Trumbore at the slot,
    each field interpolated as ``w*c0 + u*c1 + v*c2`` from ``tri_uv``,
    ``tri_t`` or ``tri_n`` (the face normal is ``e1 x e2``), and the three
    directions normalised by ``rsqrt(max(|x|^2, 1e-40))``, as the Pallas
    kernel does.  Miss lanes hold zeros.
    """
    unknown = set(fields) - set(CAPTURE_WIDTHS)
    if unknown:
        raise ValueError(f"unknown capture fields {sorted(unknown)}")
    hit = slot >= 0
    s = torch.clamp(slot, min=0).long()
    e1, e2 = mesh.tri_e1[s], mesh.tri_e2[s]
    _, u, v, _ = _moller_trumbore(ray_o, ray_d, mesh.tri_v0[s][:, None],
                                  e1[:, None], e2[:, None])
    u, v = u[:, 0, None], v[:, 0, None]
    w = 1.0 - u - v

    def bary(corners):  # [B, 3, k]
        return w * corners[:, 0] + u * corners[:, 1] + v * corners[:, 2]

    def unit(x):
        sq = x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1] + x[:, 2] * x[:, 2]
        return x * torch.rsqrt(torch.clamp(sq, min=1e-40))[:, None]

    make = {"normal": lambda: unit(torch.linalg.cross(e1, e2)),
            "uv": lambda: bary(mesh.tri_uv[s]),
            "tangent": lambda: unit(bary(mesh.tri_t[s])),
            "smooth": lambda: unit(bary(mesh.tri_n[s]))}
    return {f: torch.where(hit[:, None], make[f](), 0.0) for f in fields}


def shade_mesh_hit_captured(scene: Scene, settings: RenderSettings, ray_o,
                            ray_d, slot, t, extras, prev):
    """Forward-only shading from win-time captured attributes (port of the
    JAX ``shade_mesh_hit_captured``): the hit point from the search's t,
    the maps at the captured uv, the smooth normal through the TBN on the
    normal-map path, else the face normal.  No attribute gather and no
    Möller–Trumbore recompute; nothing flows back to the hit geometry."""
    closer = slot >= 0
    t_safe = torch.where(closer, t, torch.zeros_like(t))
    point = ray_o + ray_d * t_safe[:, None]
    texd = texn = texs = None
    if "uv" in extras:
        texd, texn, texs = _surface_maps(scene, settings, extras["uv"])
    tangent = extras.get("tangent")
    if tangent is None:
        tangent = torch.zeros_like(point)
    if settings.has_normal_map:
        normal = tex_ops.apply_tbn(extras["smooth"], tangent,
                                   tex_ops.decode_normal_map(texn))
    else:
        normal = extras["normal"]
    return _merged_hit(settings, prev, closer, t, point, normal, tangent,
                       texd, texs)


def mesh_search(scene: Scene, settings: RenderSettings, ray_o, ray_d, t_max):
    """Detached mesh search only: ``(slot [B] int32, t [B])``.

    The backend is the resolved ``settings.traversal``: ``"cuda"`` is
    ``traverse_cuda`` (K3, or K3b for a mesh without the 8-wide tree; the
    plain version for CPU tensors); ``"cuda_paged"`` is
    ``traverse_paged_cuda`` (K5, for a paged mesh); ``"torch"`` is the
    plain ``traverse``, or ``traverse_paged_reference`` for a paged mesh,
    which the main path runs only on CPU tensors.  With
    ``settings.sort_rays`` the search runs on coherence-sorted rays
    (``accel/sorting.py::sorted_traverse``), results in the caller's order.
    """
    from vrenderer_pathtracer_tpu_torch.accel.cuda_paged import traverse_paged_cuda
    from vrenderer_pathtracer_tpu_torch.accel.cuda_traverse import traverse_cuda

    paged = scene.mesh.paged is not None
    if settings.traversal == "torch":
        if ray_o.device.type == "cuda":
            raise ValueError("traversal='torch' (the plain traversal) runs on "
                             "CPU tensors; a CUDA scene resolves to 'cuda' "
                             "or 'cuda_paged' (settings_for_scene)")
        search = traverse_paged_reference if paged else traverse
    elif settings.traversal == "cuda_paged" or (settings.traversal == "auto"
                                                and paged):
        search = traverse_paged_cuda  # the plain version for CPU tensors
    elif settings.traversal in ("cuda", "auto"):
        search = traverse_cuda  # the plain traversal for CPU tensors
    else:
        raise ValueError(f"unknown traversal {settings.traversal!r}")
    if settings.sort_rays:
        import functools

        from vrenderer_pathtracer_tpu_torch.accel.sorting import sorted_traverse

        search = functools.partial(sorted_traverse, search)
    slot, t = search(scene.mesh, ray_o.detach().contiguous(),
                     ray_d.detach().contiguous(), t_max.detach().contiguous())
    return slot.detach(), t.detach()


def mesh_hit(scene: Scene, settings: RenderSettings, ray_o, ray_d, prev):
    """Mesh intersection vs the running closest hit (integrator hook): the
    detached search (:func:`mesh_search`), then the differentiable
    attribute recompute (:func:`shade_mesh_hit`).

    With ``settings.captured_attrs`` (and not ``sort_rays``) on a
    single-level mesh, the search captures the winner's attributes (K3c on
    the card, the plain ``traverse`` + :func:`capture_reference` on CPU
    tensors) and :func:`shade_mesh_hit_captured` shades from them, forward
    only.  A paged mesh keeps its K5 search and ignores the setting, as
    the JAX package's paged branch does.
    """
    if (settings.captured_attrs and not settings.sort_rays
            and scene.mesh.paged is None):
        from vrenderer_pathtracer_tpu_torch.accel.cuda_traverse import traverse_cuda

        if settings.traversal not in ("cuda", "auto", "torch"):
            raise ValueError(f"captured_attrs runs on K3's search, not "
                             f"traversal={settings.traversal!r}")
        if settings.traversal == "torch" and ray_o.device.type == "cuda":
            raise ValueError("traversal='torch' (the plain traversal) runs on "
                             "CPU tensors")
        if scene.mesh.nodes8_f is None:
            raise ValueError("attr capture needs the wide kernel: K3c walks "
                             "the 8-wide tree, which this mesh lacks (K3b)")
        slot, t, extras = traverse_cuda(
            scene.mesh, ray_o.detach().contiguous(), ray_d.detach().contiguous(),
            prev.t.detach().contiguous(), capture=capture_fields(settings))
        return shade_mesh_hit_captured(scene, settings, ray_o, ray_d, slot, t,
                                       extras, prev)
    slot, _ = mesh_search(scene, settings, ray_o, ray_d, prev.t)
    return shade_mesh_hit(scene, settings, ray_o, ray_d, slot, prev)
