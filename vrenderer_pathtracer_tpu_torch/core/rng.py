"""Counter-based Threefry-2x32 RNG, bit-identical to the JAX package's stream.

Every uniform draw is a pure function of ``(seed, pixel_id, stream)``, where
the stream packs (frame, sample, bounce, draw slot) exactly as
``vrenderer_pathtracer_tpu/core/rng.py`` does, so the port and the JAX
package draw the same numbers for the same pixel and sample.

Words are held in ``int64`` tensors with values in ``[0, 2**32)``, masked
with ``& 0xFFFFFFFF`` after every add and rotate: PyTorch on the CPU has no
``uint32`` add or shift.  The CUDA kernel (``csrc/radiance.cu``) computes
the same cipher on native ``uint32``.

Threefry-2x32 follows Salmon et al., "Parallel random numbers: as easy as
1, 2, 3" (SC'11): 20 rounds, rotations (13,15,26,6 / 17,29,16,24),
key-schedule constant 0x1BD11BDA.
"""

from __future__ import annotations

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
