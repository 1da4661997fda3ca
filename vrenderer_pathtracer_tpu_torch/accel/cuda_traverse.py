"""K3 and K3b, the mesh traversal kernels: wrapper and launches.

Port of ``vrenderer_pathtracer_tpu/accel/pallas_traverse.py::traverse_packets``.
The kernels are hand-written CUDA C++ in ``csrc/traverse.cu``, whose header
says what they compute and what bounds them on the card: operations and
divergence (one thread per ray walking a BVH that sits in L2), not memory.
This module:

* ``supports`` — the layouts the kernels take (the sparse 8-wide layout of
  ``accel/mesh.py``, or the binary nodes alone);
* ``traverse_cuda`` — the wrapper, ``(slot [B] int32, t [B])`` with slot -1
  and t = t_max on a miss.  CPU tensors take the plain version
  (``accel/traverse.py::traverse``); CUDA tensors launch K3 when the mesh
  has its 8-wide tree (``nodes8_f``) and K3b otherwise, or raise;
* ``launch_k3`` / ``launch_k3b`` — the launches; ``.count`` on each counts
  kernel launches.  ``stats`` (an int64 [3] CUDA tensor) makes the kernel
  add its node visits, box tests and triangle tests to it.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vrenderer_pathtracer_tpu_torch.accel.traverse import traverse
from vrenderer_pathtracer_tpu_torch.scene.scene import MeshData

def supports(mesh: MeshData) -> bool:
    """The layouts K3/K3b take: the sparse 8-wide tree with its leaf pack
    ([N*8,8] boxes, [N,16] records, [N] axes, [T8,16] pack), or none."""
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
            and mesh.tri_pack.dim() == 2 and mesh.tri_pack.shape[1] == 16)


@functools.lru_cache(maxsize=None)
def _lib():
    from vrenderer_pathtracer_tpu_torch.kernels import build

    lib = build.load("traverse")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vpt_traverse_wide.argtypes = [ptr] * 7 + [i32] + [ptr] * 4
    lib.vpt_traverse_binary.argtypes = [ptr] * 8 + [i32] + [ptr] * 4
    lib.vpt_traverse_wide.restype = lib.vpt_traverse_binary.restype = ctypes.c_int
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
    if aligned and t.data_ptr() % 16:  # mesh rows are read as float4 / int4
        raise ValueError(f"traversal {name} is not 16-byte aligned")


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


def _run(fn, mesh_ptrs, ray_o, ray_d, t_max, stats):
    b, device = ray_o.shape[0], ray_o.device
    if stats is not None:
        _check("stats", stats, device, torch.int64, (3,))
    slot = torch.empty((b,), dtype=torch.int32, device=device)
    t = torch.empty((b,), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = fn(*mesh_ptrs, ray_o.data_ptr(), ray_d.data_ptr(),
                 t_max.data_ptr(), b, slot.data_ptr(),
                 t.data_ptr(), None if stats is None else stats.data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"traversal launch failed: cudaError_t {err}")
    return slot, t


def launch_k3(mesh: MeshData, ray_o, ray_d, t_max, *, stats=None):
    """Launch K3 (the 8-wide tree) on the current stream."""
    device = mesh.device
    _rays(ray_o, ray_d, t_max, device)
    if mesh.nodes8_f is None or not supports(mesh):
        raise ValueError("K3 needs the sparse 8-wide layout (accel/mesh.py)")
    n = mesh.nodes8_i.shape[0]
    for name, dtype, shape in (("nodes8_f", torch.float32, (8 * n, 8)),
                               ("nodes8_i", torch.int32, (n, 16)),
                               ("nodes8_ax", torch.int32, (n,)),
                               ("tri_pack", torch.float32,
                                tuple(mesh.tri_pack.shape))):
        _check(name, getattr(mesh, name), device, dtype, shape, aligned=True)
    out = _run(_lib().vpt_traverse_wide,
               [mesh.nodes8_f.data_ptr(), mesh.nodes8_i.data_ptr(),
                mesh.nodes8_ax.data_ptr(), mesh.tri_pack.data_ptr()],
               ray_o, ray_d, t_max, stats)
    launch_k3.count += 1
    return out


launch_k3.count = 0


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


def traverse_cuda(mesh: MeshData, ray_o, ray_d, t_max):
    """The closest hit per ray: ``(slot [B] int32, t [B])``, slot -1 and
    t = t_max on a miss.

    CPU tensors take the plain version (:func:`traverse`).  CUDA tensors
    launch K3 on a mesh with its 8-wide tree and K3b on one without; a
    failed build or launch raises, and so does a mesh layout the kernels do
    not take.
    """
    device = mesh.device
    if device.type == "cpu" and ray_o.device.type == "cpu":
        return traverse(mesh, ray_o, ray_d, t_max)
    if device.type != "cuda":
        raise ValueError(f"K3/K3b run on CUDA devices, not {device}")
    if not supports(mesh):
        raise NotImplementedError(
            "K3/K3b take the sparse 8-wide layout of accel/mesh.py or the "
            "binary nodes alone")
    launch = launch_k3 if mesh.nodes8_f is not None else launch_k3b
    return launch(mesh, ray_o, ray_d, t_max)
