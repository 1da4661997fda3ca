"""PyTorch port: K3b's copy of the binary SBVH and the walk that reads it.

``accel/binary.py::compress_binary`` builds, beside the JAX-parity arrays
(``nodes_f``, ``nodes_i``, ``tri_v0``/``tri_e1``/``tri_e2``), the copy K3b
(``csrc/traverse.cu``) reads: 64-byte nodes with the children's links and
48-byte triangle rows.  Here, on a 1,472-triangle sphere: the copy decodes
bit for bit to the JAX package's ``pack_mesh`` arrays for the same OBJ;
``without_wide()``, ``with_copy`` and ``interop`` keep it; and a scalar
model of K3b's walk (the nearer hit child in a register, ``(link, key)``
entries for the farther, cull on pop; and with postponed leaves, the order
that ``k3b_cuts.py``'s turns took out of the kernel; float32 as the plain
version rounds it) returns the JAX package's XLA traversal's hits on
primary rays, rays leaving the surface and dead lanes, under the traversal
contract of ``chip_smoke.py``.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_mesh_render import write_uv_sphere
from vrenderer_pathtracer_tpu.accel import traverse as jtrav
from vrenderer_pathtracer_tpu.accel.mesh import pack_mesh as j_pack_mesh
from vrenderer_pathtracer_tpu.native import load_obj as j_load_obj
from vrenderer_pathtracer_tpu_torch import interop
from vrenderer_pathtracer_tpu_torch.accel import binary
from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh, with_copy
from vrenderer_pathtracer_tpu_torch.native import load_obj

JAX_ARRAYS = ("nodes_f", "nodes_i", "tri_v0", "tri_e1", "tri_e2")
DONE = 0x7FFFFFFF            # csrc/traverse.cu kDone
TRI_EPS = np.float32(1e-7)   # accel/traverse.py TRI_EPS
F = np.float32


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    p = tmp_path_factory.mktemp("bin") / "s.obj"
    write_uv_sphere(p, 14.0, 24, 32)
    return (pack_mesh(load_obj(str(p)), device="cpu"),
            j_pack_mesh(j_load_obj(str(p)), paged=False))


def test_copy_decodes_to_the_jax_arrays(meshes):
    mesh, jmesh = meshes
    nodes, rows = mesh.nodes_c.numpy(), mesh.tri_rows.numpy()
    assert nodes.shape == (mesh.nodes_i.shape[0], binary.NODE_WORDS)
    assert rows.shape == (mesh.tri_v0.shape[0], binary.TRI_ROW_WORDS)
    assert nodes.dtype == np.int32 and rows.dtype == np.float32
    for name, got in zip(JAX_ARRAYS, binary.decode_binary(nodes, rows)):
        want = np.asarray(getattr(jmesh, name)).reshape(got.shape)
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32), err_msg=name)
    # Rebuilt from the JAX arrays, the copy is the pack's, word for word.
    again = binary.compress_binary(*(np.asarray(getattr(jmesh, f))
                                     for f in JAX_ARRAYS))
    np.testing.assert_array_equal(again[0], nodes)
    np.testing.assert_array_equal(again[1].view(np.int32), rows.view(np.int32))
    # Every leaf link is negative and every inner link a node id.
    ni = mesh.nodes_i.numpy()
    link, cnt = nodes[:, 12:14], ni[:, 1::2]
    assert (link[cnt > 0] < 0).all()
    assert ((link[cnt == 0] >= 0) & (link[cnt == 0] < ni.shape[0])).all()


def test_copy_travels_with_the_mesh(meshes):
    mesh, jmesh = meshes
    bare = mesh.without_wide()
    assert bare.nodes8_f is None and bare.nodes8_c is None
    assert bare.nodes_c is mesh.nodes_c and bare.tri_rows is mesh.tri_rows
    assert k3.supports(bare) and k3.binary_supported(bare)
    assert not k3.supports(dataclasses.replace(bare, nodes_c=None))
    leaves = {k: None if v is None else np.asarray(v)
              for k, v in jmesh._asdict().items()}
    for conv in (interop.mesh_from_numpy(leaves, device="cpu"),
                 interop.mesh_from_numpy(dict(leaves, nodes8_f=None), device="cpu")):
        assert torch.equal(conv.nodes_c, mesh.nodes_c)
        assert torch.equal(conv.tri_rows, mesh.tri_rows)
    # An edit of the records (chip_smoke.py's planted faults) reaches the
    # copy through with_copy.
    recs = mesh.nodes_i.clone().view(-1, 2, 2)
    recs[..., 1][recs[..., 1] >= 2] -= 1
    short = with_copy(dataclasses.replace(bare, nodes_i=recs.view(-1, 4)))
    assert short.nodes8_c is None
    got = binary.decode_binary(short.nodes_c.numpy(), short.tri_rows.numpy())
    np.testing.assert_array_equal(got[1], recs.view(-1, 4).numpy())


def test_copy_refuses_leaves_its_links_cannot_hold(meshes):
    mesh, _ = meshes
    arrays = [getattr(mesh, f).numpy() for f in JAX_ARRAYS]
    ni = arrays[1].copy()
    leaf = np.argwhere(ni[:, 1::2] > 0)[0]
    for field, value in ((1, 9), (0, 1 << 28)):
        bad = ni.copy()
        bad[leaf[0], 2 * leaf[1] + (field == 1)] = value
        with pytest.raises(ValueError, match="link"):
            binary.compress_binary(arrays[0], bad, *arrays[2:])


# -- a scalar model of K3b's walk ---------------------------------------------

def _safe_inv(d):
    return [F(1.0) / (x if abs(x) > 1e-12 else F(1e-12 if x >= 0 else -1e-12))
            for x in d]


def _slab(o, inv, lo, hi, best):
    """csrc/traverse.cuh slab, in float32: (hit, t_near)."""
    t0 = [(lo[k] - o[k]) * inv[k] for k in range(3)]
    t1 = [(hi[k] - o[k]) * inv[k] for k in range(3)]
    t_near = max(min(t0[k], t1[k]) for k in range(3))
    t_far = min(max(t0[k], t1[k]) for k in range(3))
    return max(t_near, F(0)) <= min(t_far, best), t_near


def _key_t(t_near):
    """The entry distance a stack key holds (traverse.cuh child_key/key_t):
    max(t_near, 0) with its four low mantissa bits cleared."""
    bits = np.array(max(t_near, F(0)), np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFFFF0)).view(np.float32)[()]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _dot(a, b):
    return (a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]


def _moller_trumbore(o, d, v0, e1, e2):
    """accel/traverse.py::_moller_trumbore for one triangle: t or None."""
    p = _cross(d, e2)
    det = _dot(e1, p)
    if not abs(det) > TRI_EPS:
        return None
    inv_det = F(1.0) / det
    tv = [o[k] - v0[k] for k in range(3)]
    u = _dot(tv, p) * inv_det
    q = _cross(tv, e1)
    v = _dot(d, q) * inv_det
    t = _dot(e2, q) * inv_det
    ok = u >= 0 and v >= 0 and u + v <= 1 and t > TRI_EPS
    return t if ok else None


def model_walk(nodes, rows, o, d, t_max, postpone):
    """K3b's walk for one ray over the copy, as csrc/traverse.cu runs it:
    ``(slot, t)``.  ``postpone``: a leaf the walk reaches is held until a
    second leaf or the walk's end (the longest a warp vote could hold it,
    the design the kernel does not ship); else tested at once, as the
    kernel does."""
    if not t_max > 0:
        return -1, t_max
    o = [F(x) for x in o]
    d = [F(x) for x in d]
    inv = _safe_inv(d)
    boxes = nodes[:, 0:12].view(np.float32)
    state = {"best": F(t_max), "slot": -1}
    stack = []

    def pop():
        while stack:
            link, key = stack.pop()
            if key < state["best"]:
                return link
        return DONE

    def test_leaf(link):
        bits = ~int(link)
        first, count = bits >> 3, (bits & 7) + 1
        for s in range(first, first + count):
            r = rows[s]
            t = _moller_trumbore(o, d, r[0:3], r[4:7], r[8:11])
            if t is not None and t < state["best"]:
                state["best"], state["slot"] = t, s

    node, leaf = 0, None
    while True:
        while 0 <= node < DONE:
            b, (l0, l1, c0, c1) = boxes[node], nodes[node, 12:16]
            h0, t0 = _slab(o, inv, b[0:3], b[3:6], state["best"]) if c0 >= 0 else (False, 0)
            h1, t1 = _slab(o, inv, b[6:9], b[9:12], state["best"]) if c1 >= 0 else (False, 0)
            if h0 and h1:
                near0 = t0 <= t1
                node = l0 if near0 else l1
                stack.append((l1 if near0 else l0, _key_t(t1 if near0 else t0)))
            elif h0 or h1:
                node = l0 if h0 else l1
            else:
                node = pop()
            if postpone and node < 0 and leaf is None:
                leaf, node = node, pop()
        while leaf is not None or node < 0:
            if leaf is not None:
                link, leaf = leaf, None
                test_leaf(link)
            else:
                test_leaf(node)
                node = pop()
        if node == DONE:
            return state["slot"], state["best"]


def walk_rays(jmesh):
    """Primary rays from z = 40 at the sphere, rays leaving its surface (at
    the primary hits, in random directions, some into the sphere) and dead
    lanes."""
    rng = np.random.default_rng(10)
    n = 256
    o1 = np.tile([[0.0, 0.0, 40.0]], (n, 1)).astype(np.float32)
    d1 = np.stack([rng.uniform(-0.4, 0.4, n), rng.uniform(-0.4, 0.4, n),
                   -np.ones(n)], 1)
    d1 = (d1 / np.linalg.norm(d1, axis=1, keepdims=True)).astype(np.float32)
    d1[:2, 0] = 0.0  # axis-parallel rays take the slab test's guarded 1/d
    big = np.full(n, 1e6, np.float32)
    slot, t = (np.asarray(x) for x in jtrav.traverse(jmesh, o1, d1, big))
    hit = slot >= 0
    # Leaving from 1e-3 along their way, so that no ray's hit rests on a
    # self-hit at rounding distance (t ~ TRI_EPS), which two programs that
    # round the triangle test apart decide apart.
    d2 = rng.standard_normal((int(hit.sum()), 3))
    d2 = (d2 / np.linalg.norm(d2, axis=1, keepdims=True)).astype(np.float32)
    o2 = (o1[hit] + t[hit, None] * d1[hit] + 1e-3 * d2).astype(np.float32)
    o = np.concatenate([o1, o2])
    d = np.concatenate([d1, d2])
    t_max = rng.choice([1e6, 30.0], size=len(o)).astype(np.float32)
    dead = rng.choice(len(o), 24, replace=False)
    t_max[dead[:12]] = 0.0
    t_max[dead[12:]] = -1.0
    return o, d, t_max


@pytest.fixture(scope="module")
def rays(meshes):
    return walk_rays(meshes[1])


@pytest.mark.parametrize("postpone", [True, False])
def test_model_walk_finds_the_jax_hits(meshes, rays, postpone):
    mesh, jmesh = meshes
    o, d, t_max = rays
    nodes, rows = mesh.nodes_c.numpy(), mesh.tri_rows.numpy()
    got = [model_walk(nodes, rows, *ray, postpone) for ray in zip(o, d, t_max)]
    slot = torch.tensor([g[0] for g in got], dtype=torch.int32)
    t = torch.tensor([float(g[1]) for g in got], dtype=torch.float32)
    jslot, jt = (np.asarray(x) for x in jtrav.traverse(jmesh, o, d, t_max))
    a = k3.hit_agreement(mesh, (slot, t), (torch.tensor(jslot), torch.tensor(jt)),
                         torch.tensor(t_max))
    assert a["hit_mismatch"] <= 1e-5 and a["geometry_mismatch"] <= 2e-5, a
    assert a["t_rel_max"] <= 1e-4 and a["miss_t_exact"], a
    assert 0.3 < a["hit_frac"] < 0.9, a
    dead = t_max <= 0
    assert (slot.numpy()[dead] == -1).all()
