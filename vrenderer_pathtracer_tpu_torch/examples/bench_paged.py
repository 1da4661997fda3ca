"""Paged-search microbenchmark: coherent, shuffled and sorted shuffled rays.

Times K5 (``csrc/paged.cu``, through ``accel/cuda_paged.py::
traverse_paged_cuda``) in three coherence regimes on a ~180k-triangle UV
sphere, paged: primary rays of a 1024-wide view (coherent), rays of random
origins and directions in the sphere's box (shuffled), and the same
shuffled rays Morton-sorted before the search and scattered back
(``accel/sorting.py::sorted_traverse``).  Every iteration takes new rays,
and a regime's time is the host clock over its iterations, ending in a
synchronize.  Prints one JSON line for the mesh and one per regime.  With
``--cpu`` the plain paged search runs instead (use small ``--rays``); its
times are the CPU's, not a device's.

    python -m vrenderer_pathtracer_tpu_torch.examples.bench_paged \\
        [--tris-theta 300] [--iters 10] [--rays 524288]
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

import numpy as np


def _parser():
    ap = argparse.ArgumentParser(prog="bench_paged")
    ap.add_argument("--tris-theta", type=int, default=300)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--rays", type=int, default=512 * 1024,
                    help="rays a search (a multiple of 1024)")
    ap.add_argument("--cpu", action="store_true",
                    help="the plain paged search on the CPU (small shapes)")
    return ap


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)

    import torch

    from vrenderer_pathtracer_tpu_torch.accel.cuda_paged import traverse_paged_cuda
    from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
    from vrenderer_pathtracer_tpu_torch.accel.sorting import sorted_traverse
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera, generate_rays
    from vrenderer_pathtracer_tpu_torch.examples import device_of
    from vrenderer_pathtracer_tpu_torch.native import load_obj
    from vrenderer_pathtracer_tpu_torch.utils.profiling import synchronize
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    device = device_of(args.cpu)
    if args.rays % 1024:
        raise ValueError(f"--rays {args.rays} is not a multiple of 1024")
    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "bench_sphere.obj")
        write_uv_sphere(p, radius=12.0, n_theta=args.tris_theta,
                        n_phi=args.tris_theta)
        mesh = pack_mesh(load_obj(p), paged=True, device=device)
    pg = mesh.paged
    b = args.rays
    w, h = 1024, b // 1024
    f32 = dict(dtype=torch.float32, device=device)
    tmax = torch.full((b,), 1e6, **f32)

    # New rays every iteration (the first of each list is the warm-up's).
    coh = []
    for i in range(args.iters + 1):
        cam = Camera.default(device).replace(
            origin=torch.tensor([1e-4 * i, 0.0, 28.0], **f32))
        o, d = generate_rays(cam, w, h)
        coh.append((o.contiguous(), d))
    rng = np.random.default_rng(0)
    shuf = []
    for _ in range(args.iters + 1):
        o = rng.uniform(-14, 14, (b, 3)).astype(np.float32)
        d = rng.standard_normal((b, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        shuf.append((torch.as_tensor(o, device=device),
                     torch.as_tensor(d, device=device)))

    search = traverse_paged_cuda
    sorted_search = functools.partial(sorted_traverse, search)
    out = {"mesh": {"tris": int(mesh.tri_count), "pages": pg.n_pages,
                    "copy_MB": (pg.nodes8_c.numel() * 4
                                + pg.leaf_rows.numel() * 4) / 1e6,
                    "device": (torch.cuda.get_device_name(device)
                               if device.type == "cuda" else "cpu")}}
    print(json.dumps(out["mesh"]))

    def run(name, fn, rays):
        synchronize(device)
        fn(mesh, *rays[0], tmax)
        synchronize(device)
        t0 = time.perf_counter()
        outs = [fn(mesh, *rays[i], tmax) for i in range(1, args.iters + 1)]
        synchronize(device)
        dt = (time.perf_counter() - t0) / args.iters
        rec = {"case": name, "mrays_per_s": b / dt / 1e6, "ms": dt * 1e3,
               "hitrate": (outs[-1][0] >= 0).float().mean().item()}
        print(json.dumps(rec))
        out[name] = rec

    run("coherent", search, coh)
    run("shuffled", search, shuf)
    run("shuffled_sorted", sorted_search, shuf)
    return out


if __name__ == "__main__":
    main()
