"""K6, the elementwise-rate probe: wrapper and launch.

Port of ``.bench/bf16_vpu.py``: a ``N_OPS``-step dependent chain
``v = v * c + a`` over every element, in float32 or bfloat16, which answers
whether bf16 elementwise math runs at twice the float32 element rate.  The
kernel is ``csrc/probe.cu`` (``fmaf`` a thread, or ``__hfma2`` on a packed
pair a thread); ``chain_reference`` is its plain version.  ``launch_k6.count``
counts kernel launches; ``launch_k6(fault=1)`` is the planted no-op kernel
that ``chain_agreement`` must refuse.
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
                                    ctypes.c_int, ctypes.c_void_p]
    lib.vpt_probe_chain.restype = ctypes.c_int
    return lib


def launch_k6(x, c=PROBE_C, a=PROBE_A, *, fault=0):
    """Launch the chain on ``x`` (a contiguous float32, or bfloat16 of even
    size, CUDA tensor) on the current stream.  ``fault=1`` plants the no-op
    kernel (the input written back)."""
    if x.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA devices, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or not x.is_contiguous():
        raise ValueError(f"K6 takes contiguous float32 or bfloat16, got {x.dtype}")
    bf16 = x.dtype == torch.bfloat16
    if bf16 and x.numel() % 2:
        raise ValueError("K6's bf16 chain takes an even number of elements")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"{x.numel()} elements is out of K6's range")
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().vpt_probe_chain(
            x.data_ptr(), y.data_ptr(), x.numel(), float(c), float(a),
            int(bf16), int(fault), torch.cuda.current_stream(x.device).cuda_stream)
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
