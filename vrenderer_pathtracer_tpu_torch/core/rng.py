"""Counter-based Threefry-2x32 RNG, bit-identical to the JAX package's stream.

Every uniform draw is a pure function of ``(seed, pixel_id, stream)``, where
the stream packs (frame, sample, bounce, draw slot) exactly as
``vrenderer_pathtracer_tpu/core/rng.py`` does, so the port and the JAX
package draw the same numbers for the same pixel and sample.

Words are held in ``int64`` tensors with values in ``[0, 2**32)``, masked
with ``& 0xFFFFFFFF`` after every add and rotate: PyTorch on the CPU has no
``uint32`` add or shift.  The CUDA kernels (``csrc/common.cuh::draw``, run
by K1, K2 and K4, and K7, ``csrc/draws.cu``) compute the same cipher on
native ``uint32``.  :func:`bounce_uniforms` draws every slot of one bounce
for the wavefront: on the CPU through :func:`uniform2`, on the card in one
K7 launch (``bounce_uniforms.count`` launches over ``bounce_uniforms.lanes``
lanes).

Threefry-2x32 follows Salmon et al., "Parallel random numbers: as easy as
1, 2, 3" (SC'11): 20 rounds, rotations (13,15,26,6 / 17,29,16,24),
key-schedule constant 0x1BD11BDA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_M32 = 0xFFFFFFFF

# Odd multiplier (2^32 / golden ratio): sample id -> key salt is a
# bijection on uint32, so no two sample ids share a stream.
_SAMPLE_KEY_MULT = 0x9E3779B9


def _u32(x, device=None) -> torch.Tensor:
    """An int or tensor of uint32 values as an int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _M32
    return torch.tensor(int(x) & _M32, dtype=torch.int64, device=device)


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key0, key1, x0, x1):
    """Threefry-2x32 block cipher: two uint32 counter words -> two words.

    Arguments are ints or int64 tensors of uint32 values and broadcast
    element-wise; the result is a pair of int64 tensors.
    """
    device = next((a.device for a in (x0, x1, key0, key1)
                   if isinstance(a, torch.Tensor)), None)
    ks0 = _u32(key0, device)
    ks1 = _u32(key1, device)
    ks2 = (ks0 ^ ks1) ^ _PARITY
    x0 = (_u32(x0, device) + ks0) & _M32
    x1 = (_u32(x1, device) + ks1) & _M32

    def four_rounds(x0, x1, rots):
        for r in rots:
            x0 = (x0 + x1) & _M32
            x1 = _rotl32(x1, r) ^ x0
        return x0, x1

    # 20 rounds = 5 groups of 4 with alternating rotation schedules and a
    # key injection after each group.
    inject = ((ks1, ks2), (ks2, ks0), (ks0, ks1), (ks1, ks2), (ks2, ks0))
    for g, (a0, a1) in enumerate(inject):
        x0, x1 = four_rounds(x0, x1, _ROTATIONS[g % 2])
        x0 = (x0 + a0) & _M32
        x1 = (x1 + a1 + (g + 1)) & _M32
    return x0, x1


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 word -> float32 uniform in [0, 1) from its top 24 bits."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def uniform2(seed: int, pixel_ids: torch.Tensor, stream):
    """Two independent U[0,1) draws per element of ``pixel_ids``.

    ``stream`` is a ``(counter_salt, key_salt)`` pair from
    :func:`make_stream` (ints or tensors broadcasting against
    ``pixel_ids``).
    """
    counter_salt, key_salt = stream
    device = pixel_ids.device
    k0 = _u32(key_salt, device) ^ (seed & _M32)
    k1 = (seed >> 32) & _M32
    x1 = torch.broadcast_to(_u32(counter_salt, device), pixel_ids.shape)
    b0, b1 = threefry2x32(k0, k1, pixel_ids, x1)
    return _bits_to_unit_float(b0), _bits_to_unit_float(b1)


def make_stream(frame, sample, bounce: int, slot: int):
    """The ``(counter_salt, key_salt)`` pair for one draw stream.

    Counter word: frame in bits 7.., bounce (5 bits), slot (2 bits).  The
    unbounded axis, the sample id, perturbs the key instead, multiplied into
    the full 32-bit key space.  ``frame`` and ``sample`` may be ints or
    tensors; the result has the same kind.
    """
    if isinstance(frame, torch.Tensor) or isinstance(sample, torch.Tensor):
        device = next(a.device for a in (frame, sample)
                      if isinstance(a, torch.Tensor))
        frame, sample = _u32(frame, device), _u32(sample, device)
    else:
        frame, sample = int(frame) & _M32, int(sample) & _M32
    counter_salt = ((frame << 7) & _M32) ^ (bounce << 2) ^ slot
    key_salt = (sample * _SAMPLE_KEY_MULT) & _M32
    return counter_salt, key_salt


@functools.lru_cache(maxsize=None)
def _k7():
    from vrenderer_pathtracer_tpu_torch.kernels import build

    lib = build.load("draws")
    ptr, u32 = ctypes.c_void_p, ctypes.c_uint32
    lib.vpt_bounce_draws.argtypes = [ptr, ptr, ctypes.c_longlong, u32, u32,
                                     u32, ptr, u32, ctypes.c_int, ptr, ptr]
    lib.vpt_bounce_draws.restype = ctypes.c_int
    return lib


def bounce_uniforms(seed: int, pix: torch.Tensor, samp: torch.Tensor, frame,
                    bounce: int, n_slots: int):
    """Every draw of one bounce: ``2 * n_slots`` float32 ``[B]`` tensors in
    stream order (slot 0's two words, then slot 1's, ...), each lane's
    ``uniform2(seed, pix, make_stream(frame, samp, bounce, slot))``.

    ``pix`` and ``samp`` are ``[B]`` int64 ids (their low 32 bits key the
    streams).  CPU tensors take :func:`uniform2` slot by slot.  CUDA tensors
    take one K7 launch (``csrc/draws.cu``), bit for bit the same words, as
    the rows of one ``[2 * n_slots, B]`` output; a CUDA 0-dim ``frame`` is
    read by the kernel on the card.  ``n_slots`` is 2, or 3 when the bounce
    also samples the BRDF.  Raises for another slot count, and on the CUDA
    path for ids that are not contiguous int64 ``[B]`` on one device.
    ``count`` and ``lanes`` add up K7's launches and the lanes they drew;
    an empty call launches nothing and counts nothing.
    """
    if n_slots not in (2, 3):
        raise ValueError(f"a bounce draws 2 or 3 slots, not {n_slots}")
    if pix.device.type == "cpu" and samp.device.type == "cpu":
        return tuple(u for slot in range(n_slots) for u in uniform2(
            seed, pix, make_stream(frame, samp, bounce, slot)))
    for name, t in (("pix", pix), ("samp", samp)):
        if t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"K7 takes {name} as a contiguous int64 [B] "
                             f"tensor, got {t.dtype} {tuple(t.shape)}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
    if pix.device != samp.device or pix.device.type != "cuda":
        raise ValueError(f"K7 runs on one CUDA device, not {pix.device} and "
                         f"{samp.device}")
    if samp.shape != pix.shape:
        raise ValueError(f"K7: pix {tuple(pix.shape)} and samp "
                         f"{tuple(samp.shape)} differ")
    device = pix.device
    frame_ptr = None
    if isinstance(frame, torch.Tensor) and frame.device.type == "cuda":
        if frame.dim() != 0 or frame.device != device:
            raise ValueError(f"K7 takes frame as a 0-dim tensor on {device}")
        frame_t = frame.to(torch.int64)  # the kernel reads its low 32 bits
        frame_ptr, frame = frame_t.data_ptr(), 0
    out = torch.empty((2 * n_slots, pix.shape[0]), dtype=torch.float32,
                      device=device)
    with torch.cuda.device(device):
        err = _k7().vpt_bounce_draws(
            pix.data_ptr(), samp.data_ptr(), pix.shape[0], seed & _M32,
            (seed >> 32) & _M32, int(frame) & _M32, frame_ptr, int(bounce),
            int(n_slots), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"K7 launch failed: cudaError_t {err}")
    if pix.shape[0]:
        bounce_uniforms.count += 1
        bounce_uniforms.lanes += pix.shape[0]
    return tuple(out.unbind(0))


bounce_uniforms.count = 0
bounce_uniforms.lanes = 0
