"""K5, the paged traversal kernel: wrapper and launch.

Port of ``vrenderer_pathtracer_tpu/accel/pallas_paged.py::traverse_paged``.
The kernel is hand-written CUDA C++ in ``csrc/paged.cu``, whose header says
what it computes and what bounds it on the card.  This module:

* ``supports`` — the layout K5 takes (``scene.PagedNodes`` with its
  compressed copy, which K5 walks as one tree);
* ``traverse_paged_cuda`` — the wrapper, ``(slot [B] int32, t [B])`` with
  slot -1 and t = t_max on a miss.  CPU tensors take the plain version
  (``accel/traverse.py::traverse_paged_reference``); CUDA tensors launch
  K5, or raise;
* ``launch_k5`` — the launch; ``launch_k5.count`` counts kernel launches.
  ``stats`` (an int64 [4] CUDA tensor) makes the kernel add its node
  visits, box tests, triangle tests and pages searched to it; ``fault``
  plants one of ``FAULTS`` (chip_smoke.py's check that the contract
  catches a wrong kernel).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from vrenderer_pathtracer_tpu_torch.accel.cuda_traverse import (
    _check, _copy_ptrs, _rays, copy_supported)
from vrenderer_pathtracer_tpu_torch.accel.traverse import traverse_paged_reference
from vrenderer_pathtracer_tpu_torch.scene.scene import MeshData

# csrc/paged.cu's planted faults.
FAULTS = {
    "global slot one page off": 1,
    "nearest page skipped": 2,
    "a page's occlusion skip tests > against the next entry's entry t": 3,
}


def supports(mesh: MeshData) -> bool:
    """The layout K5 takes: a paged mesh (``accel/paged.py``)."""
    pg = mesh.paged
    if pg is None:
        return False
    n = pg.nodes8_i.shape[0]
    return (tuple(pg.nodes8_f.shape) == (8 * n, 8)
            and tuple(pg.nodes8_i.shape) == (n, 16)
            and tuple(pg.nodes8_ax.shape) == (n,)
            and pg.tri_pack.dim() == 2 and pg.tri_pack.shape[1] == 16
            and 0 < pg.n_top <= n
            and copy_supported(pg.nodes8_c, pg.leaf_rows)
            and pg.n_top + pg.n_pages <= pg.nodes8_c.shape[0])


@functools.lru_cache(maxsize=None)
def _lib():
    from vrenderer_pathtracer_tpu_torch.kernels import build

    lib = build.load("paged")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.vpt_traverse_paged.argtypes = ([ptr] * 2 + [i32] * 4 + [ptr] * 3
                                       + [i32] + [ptr] * 3 + [i32, ptr])
    lib.vpt_traverse_paged.restype = ctypes.c_int
    return lib


def launch_k5(mesh: MeshData, ray_o, ray_d, t_max, *, stats=None, fault=0):
    """Launch K5 on the current stream: ``(slot [B] int32, t [B])``."""
    device = mesh.device
    b = _rays(ray_o, ray_d, t_max, device)
    if not supports(mesh):
        raise ValueError("K5 needs a paged mesh with its compressed copy "
                         "(accel/paged.py)")
    if fault not in (0, *FAULTS.values()):
        raise ValueError(f"unknown K5 fault {fault}")
    pg = mesh.paged
    ptrs = _copy_ptrs(pg.nodes8_c, pg.leaf_rows, device)
    if stats is not None:
        _check("stats", stats, device, torch.int64, (4,))
    slot = torch.empty((b,), dtype=torch.int32, device=device)
    t = torch.empty((b,), dtype=torch.float32, device=device)
    if b == 0:
        return slot, t
    with torch.cuda.device(device):
        err = _lib().vpt_traverse_paged(
            *ptrs, pg.n_top, pg.n_pages, pg.page_tris, mesh.tri_v0.shape[0],
            ray_o.data_ptr(), ray_d.data_ptr(),
            t_max.data_ptr(), b, slot.data_ptr(), t.data_ptr(),
            None if stats is None else stats.data_ptr(),
            int(fault), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: cudaError_t {err}")
    launch_k5.count += 1
    return slot, t


launch_k5.count = 0


def traverse_paged_cuda(mesh: MeshData, ray_o, ray_d, t_max):
    """The closest hit per ray over a paged mesh: ``(slot [B] int32,
    t [B])``, slot -1 and t = t_max on a miss.

    CPU tensors take the plain version (:func:`traverse_paged_reference`).
    CUDA tensors launch K5; a failed build or launch raises, and so does a
    mesh that is not paged.
    """
    device = mesh.device
    if device.type == "cpu" and ray_o.device.type == "cpu":
        return traverse_paged_reference(mesh, ray_o, ray_d, t_max)
    if device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA devices, not {device}")
    if not supports(mesh):
        raise NotImplementedError("K5 takes the paged layout of accel/paged.py")
    return launch_k5(mesh, ray_o, ray_d, t_max)
