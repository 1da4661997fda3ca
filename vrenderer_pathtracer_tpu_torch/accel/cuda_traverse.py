"""K3, K3c and K3b, the mesh traversal kernels: wrapper and launches.

Port of ``vrenderer_pathtracer_tpu/accel/pallas_traverse.py::traverse_packets``
(with and without ``capture=``).  The kernels are hand-written CUDA C++ in
``csrc/traverse.cu``, whose header says what they compute and what bounds
them on the card: operations, divergence and dependent loads (one thread
per ray walking a BVH that sits in L2), not memory.
This module:

* ``supports`` — the layouts the kernels take (the sparse 8-wide layout of
  ``accel/mesh.py`` with the kernels' compressed copy of it, which K3 and
  K3c walk, or the binary tree with its copy, ``accel/binary.py``, which
  K3b walks);
* ``traverse_cuda`` — the wrapper, ``(slot [B] int32, t [B])`` with slot -1
  and t = t_max on a miss.  CPU tensors take the plain version
  (``accel/traverse.py::traverse``); CUDA tensors launch K3 when the mesh
  has its 8-wide tree (``nodes8_f``) and K3b otherwise, or raise.  With
  ``capture=fields`` it returns ``(slot, t, extras)``, the winner's
  attributes beside the hit: K3c on the card, ``capture_reference`` after
  the plain traversal on the CPU; K3b has no capture and raises;
* ``launch_k3`` / ``launch_k3b`` — the launches; ``.count`` on each counts
  kernel launches, and ``launch_k3.capture_count`` those of K3c.  ``stats``
  (an int64 [3] CUDA tensor) makes the kernel add its node visits, box
  tests and triangle tests to it.  K3b's persistent warps fetch rays in
  batches from counters in a workspace the wrapper owns, one per stream,
  which every launch leaves zero (``fetch_args``);
* ``k3b_check_launcher`` — K3b's check build (``K3B_CHECK``): the
  parent K3b and K3b's two planted faults (``K3B_FAULTS``), prepared for
  ``chip_smoke.py``, ``k3b_cuts.py`` and the card tests; never on the main
  path;
* ``hit_agreement`` / ``capture_agreement`` — how two results on the same
  rays agree, the checks of the card tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vrenderer_pathtracer_tpu_torch.accel.binary import NODE_WORDS, TRI_ROW_WORDS
from vrenderer_pathtracer_tpu_torch.accel.traverse import (
    CAPTURE_WIDTHS, capture_reference, traverse)
from vrenderer_pathtracer_tpu_torch.accel.wide import CW_WORDS, ROW_WORDS
from vrenderer_pathtracer_tpu_torch.scene.scene import MeshData

# K3c's field bits (csrc/traverse.cu) and its planted faults, by what each
# does wrong (chip_smoke.py must see every one break the contract).
CAPTURE_BITS = {"normal": 1, "uv": 2, "tangent": 4, "smooth": 8}
CAPTURE_FAULTS = {"u and v swapped in the interpolation": 1,
                  "the tangent left unnormalised": 2,
                  "the first winner's attributes kept after a closer hit": 3}

# K3b's persistent warps fetch rays from one of 16 counters, 128 bytes
# apart in a workspace of K3B_COUNTER_WORDS int32 (csrc/traverse.cu
# kCounterWords, with the count of warps done); the batch and the refill
# thresholds are constants of the source.
K3B_COUNTER_WORDS = 17 * 32
# K3b's check build (csrc/traverse.cu with -DVPT_CHECK_INSTANCES): its
# vpt_traverse_binary_check launches the parent K3b (K3B_PARENT), the
# build's own K3b (0) or one of its planted faults, by what each does
# wrong (each must break the traversal contract).
K3B_CHECK_FLAGS = ("-DVPT_CHECK_INSTANCES",)
K3B_CHECK = ("traverse", K3B_CHECK_FLAGS)
K3B_PARENT = -1
K3B_FAULTS = {"a pop culls at 0.5x the best t": 1,
              "the fetch drops the batch that holds a given ray": 2}
# K3b's ingredient bits (csrc/traverse.cu kFetch, kCull, kRows).
K3B_INGREDIENTS = {"persistent fetch": 1, "cull on pop": 2, "48-byte rows": 4}
# The wrapper's workspaces, one per (device, stream), zeroed once: every
# K3b launch leaves its workspace zero again (its last warp resets it).
_workspaces: dict = {}


def copy_supported(nodes8_c, leaf_rows) -> bool:
    """Whether a compressed copy (``accel/wide.py::compress_wide``) has the
    shapes the walk takes: nodes [M,20], leaf rows [R,12]."""
    return (nodes8_c is not None and leaf_rows is not None
            and nodes8_c.dim() == 2 and nodes8_c.shape[1] == CW_WORDS
            and nodes8_c.shape[0] > 0
            and leaf_rows.dim() == 2 and leaf_rows.shape[1] == ROW_WORDS)


def binary_supported(mesh: MeshData) -> bool:
    """Whether a mesh holds K3b's copy (``accel/binary.py``) in the shapes
    K3b takes: nodes [M,16], one a binary node, and rows [T,12], one a
    slot."""
    nc, rows = mesh.nodes_c, mesh.tri_rows
    return (nc is not None and rows is not None and nc.dim() == 2
            and tuple(nc.shape) == (mesh.nodes_i.shape[0], NODE_WORDS)
            and rows.dim() == 2
            and tuple(rows.shape) == (mesh.tri_v0.shape[0], TRI_ROW_WORDS))


def supports(mesh: MeshData) -> bool:
    """The layouts K3/K3b take: the sparse 8-wide tree with its leaf pack
    ([N*8,8] boxes, [N,16] records, [N] axes, [T8,16] pack) and the
    kernels' compressed copy of it (K3 reads the copy alone), or the binary
    tree with K3b's copy (K3b reads the copy alone)."""
    if mesh.paged is not None:
        return False
    if mesh.nodes8_f is None:
        return binary_supported(mesh)
    n = mesh.nodes8_i.shape[0] if mesh.nodes8_i is not None else -1
    return (mesh.nodes8_i is not None and mesh.nodes8_ax is not None
            and mesh.tri_pack is not None
            and tuple(mesh.nodes8_f.shape) == (8 * n, 8)
            and tuple(mesh.nodes8_i.shape) == (n, 16)
            and tuple(mesh.nodes8_ax.shape) == (n,)
            and mesh.tri_pack.dim() == 2 and mesh.tri_pack.shape[1] == 16
            and copy_supported(mesh.nodes8_c, mesh.leaf_rows))


@functools.lru_cache(maxsize=None)
def _lib():
    from vrenderer_pathtracer_tpu_torch.kernels import build

    lib = build.load("traverse")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vpt_traverse_wide.argtypes = [ptr] * 5 + [i32] + [ptr] * 4
    lib.vpt_traverse_binary.argtypes = [ptr] * 5 + [i32] + [ptr] * 4 + [i32, ptr]
    lib.vpt_traverse_capture.argtypes = ([ptr] * 5 + [i32] + [ptr] * 8 + [i32]
                                         + [ptr] * 4 + [i32, ptr])
    lib.vpt_traverse_binary_ingredients.argtypes = []
    for fn in (lib.vpt_traverse_wide, lib.vpt_traverse_binary,
               lib.vpt_traverse_capture, lib.vpt_traverse_binary_ingredients):
        fn.restype = ctypes.c_int
    return lib


def _check(name, t, device, dtype, shape, aligned=False):
    if t.device != device:
        raise ValueError(f"traversal {name} on {t.device}, want {device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"traversal {name} must be contiguous {dtype}, got "
                         f"{t.dtype}{'' if t.is_contiguous() else ' (strided)'}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"traversal {name} has shape {tuple(t.shape)}, want "
                         f"{tuple(shape)}")
    if aligned and t.data_ptr() % 16:  # mesh rows are read as 16-byte vectors
        raise ValueError(f"traversal {name} is not 16-byte aligned")


def _copy_ptrs(nodes8_c, leaf_rows, device):
    """The compressed copy's pointers, after checking what the walk reads."""
    _check("nodes8_c", nodes8_c, device, torch.int32,
           (nodes8_c.shape[0], CW_WORDS), aligned=True)
    _check("leaf_rows", leaf_rows, device, torch.float32,
           (leaf_rows.shape[0], ROW_WORDS), aligned=True)
    return [nodes8_c.data_ptr(), leaf_rows.data_ptr()]


def _rays(ray_o, ray_d, t_max, device):
    b = ray_o.shape[0]
    if device.type != "cuda":
        raise ValueError(f"K3/K3b run on CUDA devices, not {device}")
    if not 0 <= b < 2 ** 31:
        raise ValueError(f"{b} rays is out of the kernels' range")
    f32 = torch.float32
    _check("ray_o", ray_o, device, f32, (b, 3))
    _check("ray_d", ray_d, device, f32, (b, 3))
    _check("t_max", t_max, device, f32, (b,))
    return b


def _prepare(fn, mesh_ptrs, ray_o, ray_d, t_max, stats, extra=()):
    """``fn``'s outputs made and its arguments gathered once, on the current
    stream: a call that launches it and returns ``(slot, t)``, the same
    tensors at every call."""
    b, device = ray_o.shape[0], ray_o.device
    if stats is not None:
        _check("stats", stats, device, torch.int64, (3,))
    slot = torch.empty((b,), dtype=torch.int32, device=device)
    t = torch.empty((b,), dtype=torch.float32, device=device)
    args = (*mesh_ptrs, ray_o.data_ptr(), ray_d.data_ptr(), t_max.data_ptr(),
            b, slot.data_ptr(), t.data_ptr(),
            None if stats is None else stats.data_ptr(), *extra,
            torch.cuda.current_stream(device).cuda_stream)

    def launch():
        with torch.cuda.device(device):
            err = fn(*args)
        if err != 0:
            raise RuntimeError(f"traversal launch failed: cudaError_t {err}")
        return slot, t

    return launch


def _run(fn, mesh_ptrs, ray_o, ray_d, t_max, stats, extra=()):
    return _prepare(fn, mesh_ptrs, ray_o, ray_d, t_max, stats, extra)()


def _capture_args(mesh: MeshData, b, capture, fault):
    """K3c's extra arguments (attribute arrays, field mask, outputs, fault)
    and its outputs ``{field: [b, k]}``."""
    unknown = set(capture) - set(CAPTURE_WIDTHS)
    if unknown or "normal" not in capture:
        raise ValueError(f"K3c captures the normal and any of uv, tangent, "
                         f"smooth; got {tuple(capture)}")
    if fault not in (0, *CAPTURE_FAULTS.values()):
        raise ValueError(f"unknown K3c fault {fault}")
    device, r = mesh.device, mesh.tri_v0.shape[0]
    for name, shape in (("tri_e1", (r, 3)), ("tri_e2", (r, 3)),
                        ("tri_uv", (r, 3, 2)), ("tri_t", (r, 3, 3)),
                        ("tri_n", (r, 3, 3))):
        _check(name, getattr(mesh, name), device, torch.float32, shape)
    extras = {f: torch.empty((b, CAPTURE_WIDTHS[f]), dtype=torch.float32,
                             device=device) for f in CAPTURE_WIDTHS
              if f in capture}
    mask = sum(CAPTURE_BITS[f] for f in extras)
    if fault and mask != 15:
        raise ValueError("K3c's planted faults capture every field")
    args = [mesh.tri_e1.data_ptr(), mesh.tri_e2.data_ptr(),
            mesh.tri_uv.data_ptr(), mesh.tri_t.data_ptr(),
            mesh.tri_n.data_ptr(), mask,
            *(extras[f].data_ptr() if f in extras else None
              for f in CAPTURE_WIDTHS), fault]
    return args, extras


def launch_k3(mesh: MeshData, ray_o, ray_d, t_max, *, stats=None, capture=(),
              fault=0):
    """Launch K3 (the 8-wide tree) on the current stream: ``(slot, t)``.

    ``capture`` (fields of ``CAPTURE_WIDTHS``, the normal among them)
    launches K3c instead, which returns ``(slot, t, {field: [B, k]})``;
    ``fault`` plants one of ``CAPTURE_FAULTS`` in it (the check's own
    test)."""
    device = mesh.device
    b = _rays(ray_o, ray_d, t_max, device)
    if mesh.nodes8_f is None or not supports(mesh):
        raise ValueError("K3 needs the sparse 8-wide layout and its "
                         "compressed copy (accel/mesh.py)")
    ptrs = _copy_ptrs(mesh.nodes8_c, mesh.leaf_rows, device)
    if not capture:
        if fault:
            raise ValueError("K3's faults are K3c's: pass capture=")
        out = _run(_lib().vpt_traverse_wide, ptrs, ray_o, ray_d, t_max, stats)
        launch_k3.count += 1
        return out
    extra, extras = _capture_args(mesh, b, capture, fault)
    slot, t = _run(_lib().vpt_traverse_capture, ptrs, ray_o, ray_d, t_max,
                   stats, extra)
    launch_k3.capture_count += 1
    return slot, t, {f: extras[f] for f in capture}


launch_k3.count = 0
launch_k3.capture_count = 0


def binary_ptrs(mesh: MeshData, device):
    """K3b's copy's pointers, after checking what the walk reads (both are
    read as 16-byte vectors)."""
    _check("nodes_c", mesh.nodes_c, device, torch.int32,
           (mesh.nodes_i.shape[0], NODE_WORDS), aligned=True)
    _check("tri_rows", mesh.tri_rows, device, torch.float32,
           (mesh.tri_v0.shape[0], TRI_ROW_WORDS), aligned=True)
    return [mesh.nodes_c.data_ptr(), mesh.tri_rows.data_ptr()]


def fetch_args(device):
    """K3b's fetch arguments: the pointer to the current stream's workspace
    of ``K3B_COUNTER_WORDS`` int32 (zeroed when made; every launch leaves
    it zero) and its size.  A workspace serves one stream, whose launches
    run in order."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    if key not in _workspaces:
        _workspaces[key] = torch.zeros((K3B_COUNTER_WORDS,), dtype=torch.int32,
                                       device=device)
    return _workspaces[key].data_ptr(), K3B_COUNTER_WORDS


def _binary_mesh(mesh: MeshData, ray_o, ray_d, t_max):
    device = mesh.device
    _rays(ray_o, ray_d, t_max, device)
    if mesh.paged is not None or not binary_supported(mesh):
        raise ValueError("K3b needs the binary tree's copy (accel/binary.py:"
                         " nodes_c [M,16], tri_rows [T,12])")
    return binary_ptrs(mesh, device)


def launch_k3b(mesh: MeshData, ray_o, ray_d, t_max, *, stats=None):
    """Launch K3b (the binary SBVH's copy) on the current stream."""
    ptrs = _binary_mesh(mesh, ray_o, ray_d, t_max)
    out = _run(_lib().vpt_traverse_binary, ptrs, ray_o, ray_d, t_max, stats,
               fetch_args(mesh.device))
    launch_k3b.count += 1
    return out


launch_k3b.count = 0


@functools.lru_cache(maxsize=None)
def _check_lib(flags):
    from vrenderer_pathtracer_tpu_torch.kernels import build

    lib = ctypes.CDLL(str(build.build_all([("traverse", flags)])[("traverse", flags)]))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vpt_traverse_binary_check.argtypes = ([ptr] * 10 + [i32] + [ptr] * 4
                                              + [i32] * 3 + [ptr])
    lib.vpt_traverse_binary_ingredients.argtypes = []
    for fn in (lib.vpt_traverse_binary_check, lib.vpt_traverse_binary_ingredients):
        fn.restype = ctypes.c_int
    return lib


def k3b_check_launcher(mesh: MeshData, ray_o, ray_d, t_max, variant=0, *,
                       fault_ray=-1, stats=None, flags=()):
    """K3b's check build, its arguments checked once: a call that launches
    it on the current stream and returns ``(slot, t)`` (the same tensors
    at every call), for timing loops whose host work must stay below a
    sparse wave's launch.  ``variant``: 0 the build's K3b, ``K3B_PARENT``
    the parent K3b (on the JAX-parity arrays), or a fault of
    ``K3B_FAULTS`` (the dropped batch is the one that holds ray
    ``fault_ray``).  ``flags``: more nvcc flags (``k3b_cuts.py``'s -D
    choices), each set a library of its own.  Not counted in
    ``launch_k3b.count``."""
    if variant not in (0, K3B_PARENT, *K3B_FAULTS.values()):
        raise ValueError(f"unknown K3b check variant {variant}")
    ptrs = _binary_mesh(mesh, ray_o, ray_d, t_max)
    device, m, r = mesh.device, mesh.nodes_i.shape[0], mesh.tri_v0.shape[0]
    for name, shape in (("nodes_f", (m, 12)), ("nodes_i", (m, 4)),
                        ("tri_v0", (r, 3)), ("tri_e1", (r, 3)), ("tri_e2", (r, 3))):
        _check(name, getattr(mesh, name), device,
               torch.int32 if name == "nodes_i" else torch.float32, shape,
               aligned=True)
    ptrs += [getattr(mesh, f).data_ptr() for f in
             ("nodes_f", "nodes_i", "tri_v0", "tri_e1", "tri_e2")]
    return _prepare(_check_lib((*K3B_CHECK_FLAGS, *flags)).vpt_traverse_binary_check,
                    ptrs, ray_o, ray_d, t_max, stats,
                    (*fetch_args(device), variant, fault_ray))


def k3b_ingredients(flags=None) -> int:
    """K3b's ingredient mask (csrc/traverse.cu kK3b: 1 persistent fetch, 2
    cull on pop, 4 48-byte rows) in the shipped build, or with ``flags`` in
    that check build; builds the library."""
    lib = _lib() if flags is None else _check_lib((*K3B_CHECK_FLAGS, *flags))
    return int(lib.vpt_traverse_binary_ingredients())


def hit_agreement(mesh: MeshData, got, want, t_max, want_mesh=None) -> dict:
    """How two closest-hit results ``(slot, t)`` on the same rays agree.

    A spatial split puts one triangle into several leaves, each copy with
    its own slot, so two traversal orders may return different slots for
    the same triangle: the winners are compared by their (v0, e1, e2) rows.
    ``want_mesh``: ``want``'s slots index another pack of the same mesh
    (a single-level and a paged one), whose rows copy the same vertices.
    Returns fractions of all rays: ``hit_mismatch`` (one hits, the other
    misses), ``geometry_mismatch`` (both hit, different triangles); and
    ``t_rel_max``, the largest |t_got - t_want| / t_want where both hit the
    same triangle; ``miss_t_exact``: every miss of either returns t_max.
    """
    (sg, tg), (sw, tw) = got, want
    hg, hw = sg >= 0, sw >= 0
    both = hg & hw
    a, b = sg[both].long(), sw[both].long()
    same = torch.ones_like(a, dtype=torch.bool)
    for f in ("tri_v0", "tri_e1", "tri_e2"):
        rows_b = getattr(want_mesh or mesh, f)[b]
        same &= (getattr(mesh, f)[a] == rows_b).all(dim=1)
    err = (tg[both] - tw[both]).abs()[same]
    rel = err / tw[both].abs()[same]
    n = max(sg.shape[0], 1)
    return {
        "rays": sg.shape[0],
        "hit_frac": hw.sum().item() / n,
        "hit_mismatch": (hg != hw).sum().item() / n,
        "geometry_mismatch": (~same).sum().item() / n,
        "t_abs_max": err.max().item() if err.numel() else 0.0,
        "t_rel_max": rel.max().item() if rel.numel() else 0.0,
        "miss_t_exact": bool(torch.equal(tg[~hg], t_max[~hg])
                             and torch.equal(tw[~hw], t_max[~hw])),
    }


def capture_agreement(mesh: MeshData, got, want) -> dict:
    """How two captures ``(slot, t, extras)`` on the same rays agree, on the
    rays where both hit the same triangle (its (v0, e1, e2) rows, as in
    :func:`hit_agreement`).  Per field: the largest absolute error, the
    largest ``|got - want| - 1e-4 * |want|`` (an element breaks rtol 1e-4 /
    atol 1e-5 where it exceeds 1e-5) and the count of such elements; and
    ``miss_zero``: every miss of ``got`` holds zeros."""
    (sg, _, xg), (sw, _, xw) = got, want
    both = (sg >= 0) & (sw >= 0)
    a, b = sg[both].long(), sw[both].long()
    same = torch.ones_like(a, dtype=torch.bool)
    for f in ("tri_v0", "tri_e1", "tri_e2"):
        same &= (getattr(mesh, f)[a] == getattr(mesh, f)[b]).all(dim=1)
    out = {"rays": int(same.sum()), "fields": {}, "miss_zero": True}
    for f in xw:
        g, w = xg[f][both][same], xw[f][both][same]
        err = (g - w).abs()
        excess = err - 1e-4 * w.abs()
        out["fields"][f] = {
            "abs_max": err.max().item() if err.numel() else 0.0,
            "excess_max": excess.max().item() if err.numel() else 0.0,
            "outside": int((excess > 1e-5).sum()),
        }
        out["miss_zero"] &= bool((xg[f][sg < 0] == 0).all())
    return out


def capture_contract(a) -> bool:
    """Whether a :func:`capture_agreement` reading meets K3c's contract:
    every field within rtol 1e-4 / atol 1e-5 on the agreeing hits, and
    zeros on the misses."""
    return a["miss_zero"] and all(v["outside"] == 0
                                  for v in a["fields"].values())


def traverse_cuda(mesh: MeshData, ray_o, ray_d, t_max, capture=()):
    """The closest hit per ray: ``(slot [B] int32, t [B])``, slot -1 and
    t = t_max on a miss; with ``capture`` (fields of ``CAPTURE_WIDTHS``)
    ``(slot, t, {field: [B, k]})``, the winner's attributes beside it.

    CPU tensors take the plain version (:func:`traverse`, then
    :func:`capture_reference`).  CUDA tensors launch K3 (K3c with
    ``capture``) on a mesh with its 8-wide tree and K3b on one without; a
    failed build or launch raises, and so does a mesh layout the kernels do
    not take, or a capture on a mesh without the 8-wide tree.
    """
    device = mesh.device
    if capture and mesh.nodes8_f is None:
        raise ValueError("attr capture needs the wide kernel: K3c walks the "
                         "8-wide tree, which this mesh lacks (K3b)")
    if device.type == "cpu" and ray_o.device.type == "cpu":
        slot, t = traverse(mesh, ray_o, ray_d, t_max)
        if not capture:
            return slot, t
        return slot, t, capture_reference(mesh, ray_o, ray_d, slot, capture)
    if device.type != "cuda":
        raise ValueError(f"K3/K3b run on CUDA devices, not {device}")
    if not supports(mesh):
        raise NotImplementedError(
            "K3/K3b take the sparse 8-wide layout of accel/mesh.py or the "
            "binary nodes alone")
    if capture:
        return launch_k3(mesh, ray_o, ray_d, t_max, capture=capture)
    launch = launch_k3 if mesh.nodes8_f is not None else launch_k3b
    return launch(mesh, ray_o, ray_d, t_max)
