"""The yardstick of the kernels' roofline shares: the card's published
peaks and the least work each kernel's inputs need, priced at fixed costs.

A share is ``least time / measured device time``, where the least time is
the larger of the operations over the busiest pipe's peak rate and the
bytes over the memory rate.  The operations of K1 and K2 are the sphere
tests, hits, Fresnel hits, records and score terms that the plain
reference counts for the cell's own inputs (``reference/cornell.py``'s
``work``), each priced at a fixed cost per piece; K5's bound is its bytes
alone.  Nothing is read from a counter of the program, so a new kernel
for the same work is held to the same least time.
"""

from __future__ import annotations

import re

# NVIDIA H100 SXM (data sheet; CUDA C++ Programming Guide throughput table,
# compute capability 9.0) at its 1.98 GHz boost clock: FP32 67 TFLOP/s (an
# FMA is 2 flops), 64 INT32 and 16 SFU results a clock on each of 132 SMs;
# device memory 3.35 TB/s.  The rates assume the card's full 700 W limit.
RATES = {"fp32": 67e12, "int32": 132 * 64 * 1.98e9, "sfu": 132 * 16 * 1.98e9}
HBM_BYTES_PER_S = 3.35e12

# Operations per piece of the Cornell estimator's work, in flops (an FMA
# 2; an IEEE division or reciprocal one SFU op and 4 flops, an IEEE square
# root one SFU op and 6 flops, a conversion one SFU op):
# - "sphere": one ray-sphere test;
# - "surface": a hit's hit point, normal, cosine frame and dot(d, n);
# - "fresnel": a Fresnel surface's probability (a power and a lerp);
# - "scatter": one sample's scatter: a 20-round Threefry block (~87 INT32
#   ops), the cosine sample and its normalisation, the next origin,
#   emission and throughput;
# - "draw0": a Fresnel hit's slot-0 Threefry block and its compare;
# - "pixel": the primary ray, first-hit depth and the mean (a render);
# - "reverse": one record's reverse step (a loss gradient);
# - "score": a Fresnel record's score-function terms;
# - "k2_pixel": the primary ray, the loss and the scaling of the sums.
# Frozen from the repository's counts of its Cornell kernels' loops.
CORNELL_OPS = {
    "sphere": {"fp32": 29, "sfu": 1, "int32": 0},
    "surface": {"fp32": 71, "sfu": 5, "int32": 2},
    "fresnel": {"fp32": 17, "sfu": 2, "int32": 0},
    "scatter": {"fp32": 106, "sfu": 7, "int32": 90},
    "draw0": {"fp32": 3, "sfu": 2, "int32": 87},
    "pixel": {"fp32": 80, "sfu": 14, "int32": 10},
    "reverse": {"fp32": 21, "sfu": 1, "int32": 12},
    "score": {"fp32": 35, "sfu": 2, "int32": 0},
    "k2_pixel": {"fp32": 112, "sfu": 11, "int32": 22},
}
# Bytes a pixel must move: a render writes rgb and depth (16); a loss
# gradient reads the pixel's target rgb (12).
RENDER_PIXEL_BYTES, LOSS_PIXEL_BYTES = 16, 12
# A mesh search reads each ray (origin, direction, bound: 7 floats) and
# writes its hit (triangle index, t: 8 bytes), and reads each triangle
# (v0, e1, e2: 9 floats) once.
RAY_BYTES, HIT_BYTES, TRI_BYTES = 28, 8, 36


# The port's own kernels, by the names of their symbols in its sources.
PORT_KERNELS = {"K1": "radiance_kernel", "K2": "grad_kernel",
                "K3": "traverse_wide_kernel", "K3c": "traverse_capture_kernel",
                "K3b": "traverse_binary_kernel", "K4": "mesh_kernel",
                "K5": "paged_kernel", "K6": "chain_kernel"}


def kernel_is(name: str, kernel: str) -> bool:
    """Whether a device operation named ``name`` (as the profiler names it:
    the demangled symbol with its namespace, template arguments and
    signature, such as ``void (anonymous namespace)::radiance_kernel<7>(
    float const*, ...)``) is the port's ``kernel``."""
    return re.search(r"(^|[\s:])" + PORT_KERNELS[kernel] + r"($|[<(])",
                     name) is not None


def is_port_kernel(name: str) -> bool:
    return any(kernel_is(name, k) for k in PORT_KERNELS)


def is_collective(name: str) -> bool:
    return "nccl" in name.lower()


def least_s(ops: dict, n_bytes: float) -> tuple:
    """(seconds, "operations" or "bytes"): the larger of the busiest pipe's
    time for ``ops`` and the memory time for ``n_bytes``."""
    t_ops = max(ops.get(k, 0) / r for k, r in RATES.items())
    t_bytes = n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def cornell_ops(w: dict, kernel: str) -> dict:
    """Operations of a render ("k1") or a loss gradient ("k2") pass over
    the work ``w`` (``reference/cornell.py::work``).  The primary ray is
    fixed per pixel, so bounce 0's sphere tests count once a pixel; a
    render shades bounce 0's surface once a pixel too."""
    ops = {"fp32": 0, "sfu": 0, "int32": 0}

    def add(piece, count):
        for k, v in CORNELL_OPS[piece].items():
            ops[k] += count * v

    spp = w["spp"]
    surfaces0 = w["hits0"] if kernel == "k1" else spp * w["hits0"]
    fres0 = w["fres0"] if kernel == "k1" else spp * w["fres0"]
    add("sphere", (w["pixels"] + w["tests"]) * w["spheres"])
    add("surface", surfaces0 + w["hits"])
    add("fresnel", fres0 + w["fres"])
    add("scatter", w["steps"])
    add("draw0", w["fres_steps"])
    if kernel == "k1":
        add("pixel", w["pixels"])
    else:
        add("reverse", w["records"])
        add("score", w["scores"])
        add("k2_pixel", w["pixels"])
    return ops


def cornell_least_s(w: dict, kernel: str) -> float:
    per_px = RENDER_PIXEL_BYTES if kernel == "k1" else LOSS_PIXEL_BYTES
    return least_s(cornell_ops(w, kernel), w["pixels"] * per_px)[0]


def search_bytes(waves, n_tris: int) -> int:
    """Bytes of a mesh search over waves of ``waves`` rays each: every
    ray read and its hit written once, the triangles read once a wave."""
    return sum(n * (RAY_BYTES + HIT_BYTES) + n_tris * TRI_BYTES for n in waves)
