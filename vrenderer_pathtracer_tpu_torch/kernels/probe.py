"""K6, the elementwise-rate probe: wrapper and launch.

Port of ``.bench/bf16_vpu.py``: a ``N_OPS``-step dependent chain
``v = v * c + a`` over every element, in float32 or bfloat16, which answers
whether bf16 elementwise math runs at twice the float32 element rate.  The
kernel is ``csrc/probe.cu``: ``k`` independent chains a thread, of float32
elements (``fmaf``) or packed bf16 pairs (``__hfma2``), moved as one vector
(:func:`vector_split` says which elements go in whole vectors and which in
the kernel's ragged tail), over a grid of one wave or of one vector a
thread (``GRIDS``); ``chain_reference`` is its plain version.
``launch_k6.count`` counts kernel launches; ``launch_k6(fault=1)`` is the
planted no-op kernel that ``chain_agreement`` must refuse.
"""

from __future__ import annotations

import ctypes
import functools

import torch

N_OPS = 512
# The probe's constants (.bench/bf16_vpu.py), for timing only: in bfloat16,
# c rounds to 1 and a is below half an ulp of values near 1, so the bf16
# chain keeps its input and no check could tell a kernel that skips it.
PROBE_C, PROBE_A = 1.0000001, 1e-7
# The check's constants, both exact in bfloat16: inputs in [0.5, 1.5) grow
# by c a step, to ~450-510 after N_OPS steps, so every step moves the value
# by an ulp or more in both dtypes and the result depends on the input, on
# the step count (a step fewer is 0.8% off), on c and on a.
CHECK_C, CHECK_A = 1.0078125, 0.0625
# Float32: fmaf rounds once a step, the plain chain twice (product, sum);
# each step's relative difference is at most two half-ulps (2^-24 each) and
# carries forward unamplified relative to the growing value, so the chains
# differ by at most 512 * 2^-23 = 6.1e-5 of the value.
F32_RTOL = 1e-4
# Chains a thread, the kernel's template argument: 1, 2, 4 or 8; and the
# grid: one wave of the blocks the card holds at once, each thread walking
# the vectors with a stride ("wave"), or a block for every 256 vectors, one
# a thread ("vector").  The shipped pair for each dtype is the fastest of
# chip_smoke.py's sweep on an H100 (PERF.md).
CHAINS = (1, 2, 4, 8)
GRIDS = {"wave": 0, "vector": 1}
K_F32, GRID_F32 = 2, "vector"
K_BF16, GRID_BF16 = 2, "vector"


def vector_split(numel, dtype, k):
    """How the kernel cuts ``numel`` elements of ``dtype`` (float32, or
    bfloat16 as packed pairs) at ``k`` chains a thread: ``(vectors,
    tail)``, the whole vectors of ``k`` units (a unit: one float32 element
    or one bf16 pair) and the units after them, which the kernel runs one a
    thread.  Raises where the kernel refuses: another ``k``, an odd bf16
    count, or more elements than its int32 index."""
    if k not in CHAINS:
        raise ValueError(f"K6 runs {CHAINS} chains a thread, not {k}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"K6 takes float32 or bfloat16, got {dtype}")
    if dtype == torch.bfloat16 and numel % 2:
        raise ValueError("K6's bf16 chain takes an even number of elements")
    if not 0 <= numel < 2 ** 31:
        raise ValueError(f"{numel} elements is out of K6's range")
    units = numel // 2 if dtype == torch.bfloat16 else numel
    return units // k, units % k


def chain_reference(x, c=PROBE_C, a=PROBE_A, n_ops=N_OPS):
    """The plain chain: each step ``v * c + a`` in float32, rounded to
    ``x``'s dtype.  For float32 the product and the sum are rounded apart
    (the kernel's fmaf rounds once: ``F32_RTOL``).  For bfloat16 the
    product of two 8-bit significands and, at the check's constants, the
    sum are exact in float32, so each step is rounded once, as ``__hfma2``
    rounds it: the kernel's result bit for bit."""
    c = torch.tensor(c, dtype=x.dtype, device=x.device).float()
    a = torch.tensor(a, dtype=x.dtype, device=x.device).float()
    v = x
    for _ in range(n_ops):
        v = (v.float() * c + a).to(x.dtype)
    return v


def chain_agreement(got, want):
    """``(ok, max_abs_err, max_rel_err)`` of a kernel's chain against the
    plain one at the check's constants: float32 within ``F32_RTOL`` of the
    value, bfloat16 bit-equal."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    rel = (err / w.abs()).max().item()
    if want.dtype == torch.bfloat16:
        return torch.equal(got, want), err.max().item(), rel
    return rel <= F32_RTOL, err.max().item(), rel


@functools.lru_cache(maxsize=None)
def _lib():
    from vrenderer_pathtracer_tpu_torch.kernels import build

    lib = build.load("probe")
    lib.vpt_probe_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_float,
                                    ctypes.c_float, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    lib.vpt_probe_chain.restype = ctypes.c_int
    return lib


def launch_k6(x, c=PROBE_C, a=PROBE_A, *, k=None, grid=None, fault=0):
    """Launch the chain on ``x`` (a contiguous, 16-byte aligned float32, or
    bfloat16 of even size, CUDA tensor) on the current stream, ``k`` chains
    a thread over ``grid`` (a key of ``GRIDS``; by default the dtype's
    shipped ``K_*``/``GRID_*``).  ``fault=1`` plants the no-op kernel (the
    input written back).  The size rules are :func:`vector_split`'s,
    checked before the device."""
    if not x.is_contiguous():
        raise ValueError("K6 takes a contiguous tensor")
    bf16 = x.dtype == torch.bfloat16
    if k is None:
        k = K_BF16 if bf16 else K_F32
    if grid is None:
        grid = GRID_BF16 if bf16 else GRID_F32
    if grid not in GRIDS:
        raise ValueError(f"K6's grid is one of {tuple(GRIDS)}, not {grid!r}")
    vector_split(x.numel(), x.dtype, k)
    if x.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA devices, not {x.device}")
    if x.data_ptr() % 16:  # read and written as 16-byte vectors
        raise ValueError("K6 takes a 16-byte aligned tensor")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().vpt_probe_chain(
            x.data_ptr(), y.data_ptr(), x.numel(), float(c), float(a),
            int(bf16), int(k), GRIDS[grid], int(fault),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K6 launch failed: cudaError_t {err}")
    launch_k6.count += 1
    return y


launch_k6.count = 0


def chain(x, c=PROBE_C, a=PROBE_A):
    """The chain on ``x``: the plain version for a CPU tensor, K6 for a
    CUDA tensor."""
    if x.device.type == "cpu":
        return chain_reference(x, c, a)
    return launch_k6(x, c, a)
