"""K3, K3c and K3b, the mesh traversal kernels: wrapper and launches.

Port of ``vrenderer_pathtracer_tpu/accel/pallas_traverse.py::traverse_packets``
(with and without ``capture=``).  The kernels are hand-written CUDA C++ in
``csrc/traverse.cu``, whose header says what they compute and what bounds
them on the card: operations, divergence and dependent loads (one thread
per ray walking a BVH that sits in L2), not memory.
This module:

* ``supports`` — the layouts the kernels take (the sparse 8-wide layout of
  ``accel/mesh.py`` with the kernels' compressed copy of it, which K3 and
  K3c walk, or the binary nodes alone, which K3b walks);
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
  tests and triangle tests to it;
* ``hit_agreement`` / ``capture_agreement`` — how two results on the same
  rays agree, the checks of the card tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

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

def copy_supported(nodes8_c, leaf_rows) -> bool:
    """Whether a compressed copy (``accel/wide.py::compress_wide``) has the
    shapes the walk takes: nodes [M,20], leaf rows [R,12]."""
    return (nodes8_c is not None and leaf_rows is not None
            and nodes8_c.dim() == 2 and nodes8_c.shape[1] == CW_WORDS
            and nodes8_c.shape[0] > 0
            and leaf_rows.dim() == 2 and leaf_rows.shape[1] == ROW_WORDS)


def supports(mesh: MeshData) -> bool:
    """The layouts K3/K3b take: the sparse 8-wide tree with its leaf pack
    ([N*8,8] boxes, [N,16] records, [N] axes, [T8,16] pack) and the
    kernels' compressed copy of it (K3 reads the copy alone), or none."""
    if mesh.paged is not None:
        return False
    if mesh.nodes8_f is None:
        return True
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
    lib.vpt_traverse_binary.argtypes = [ptr] * 8 + [i32] + [ptr] * 4
    lib.vpt_traverse_capture.argtypes = ([ptr] * 5 + [i32] + [ptr] * 8 + [i32]
                                         + [ptr] * 4 + [i32, ptr])
    for fn in (lib.vpt_traverse_wide, lib.vpt_traverse_binary,
               lib.vpt_traverse_capture):
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


def _run(fn, mesh_ptrs, ray_o, ray_d, t_max, stats, extra=()):
    b, device = ray_o.shape[0], ray_o.device
    if stats is not None:
        _check("stats", stats, device, torch.int64, (3,))
    slot = torch.empty((b,), dtype=torch.int32, device=device)
    t = torch.empty((b,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = fn(*mesh_ptrs, ray_o.data_ptr(), ray_d.data_ptr(),
                 t_max.data_ptr(), b, slot.data_ptr(),
                 t.data_ptr(), None if stats is None else stats.data_ptr(),
                 *extra, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"traversal launch failed: cudaError_t {err}")
    return slot, t


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


def launch_k3b(mesh: MeshData, ray_o, ray_d, t_max, *, stats=None):
    """Launch K3b (the binary SBVH) on the current stream."""
    device = mesh.device
    _rays(ray_o, ray_d, t_max, device)
    m, r = mesh.nodes_i.shape[0], mesh.tri_v0.shape[0]
    for name, dtype, shape in (("nodes_f", torch.float32, (m, 12)),
                               ("nodes_i", torch.int32, (m, 4)),
                               ("tri_v0", torch.float32, (r, 3)),
                               ("tri_e1", torch.float32, (r, 3)),
                               ("tri_e2", torch.float32, (r, 3))):
        _check(name, getattr(mesh, name), device, dtype, shape, aligned=True)
    out = _run(_lib().vpt_traverse_binary,
               [mesh.nodes_f.data_ptr(), mesh.nodes_i.data_ptr(),
                mesh.tri_v0.data_ptr(), mesh.tri_e1.data_ptr(),
                mesh.tri_e2.data_ptr()],
               ray_o, ray_d, t_max, stats)
    launch_k3b.count += 1
    return out


launch_k3b.count = 0


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
