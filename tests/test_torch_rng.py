"""PyTorch port: the threefry stream is bit-identical to the JAX package's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vrenderer_pathtracer_tpu.core import rng as jrng
from vrenderer_pathtracer_tpu_torch.core import rng

# Random123 known-answer vectors (threefry2x32, 20 rounds), as in test_rng.py.
KAT = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


@pytest.mark.parametrize("key,ctr,expect", KAT)
def test_threefry_known_answers(key, ctr, expect):
    o0, o1 = rng.threefry2x32(key[0], key[1], torch.tensor([ctr[0]]),
                              torch.tensor([ctr[1]]))
    assert (int(o0[0]), int(o1[0])) == expect


def test_threefry_matches_jax_on_4096_counters():
    r = np.random.default_rng(0)
    x0, x1 = (r.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    k0, k1 = 0xDEADBEEF, 0x01234567
    a0, a1 = jrng.threefry2x32(jnp.uint32(k0), jnp.uint32(k1),
                               jnp.asarray(x0), jnp.asarray(x1))
    b0, b1 = rng.threefry2x32(k0, k1, torch.from_numpy(x0.astype(np.int64)),
                              torch.from_numpy(x1.astype(np.int64)))
    np.testing.assert_array_equal(np.asarray(a0).astype(np.int64), b0.numpy())
    np.testing.assert_array_equal(np.asarray(a1).astype(np.int64), b1.numpy())


@pytest.mark.parametrize("frame,sample,bounce,slot", [
    (1, 0, 0, 0), (3, 1, 2, 1), (7, 2048, 3, 1), (1 << 20, 4095, 31, 0),
    (1 << 20, 100_000, 4, 1),
])
def test_make_stream_and_uniform2_match_jax(frame, sample, bounce, slot):
    want = jrng.make_stream(jnp.uint32(frame), jnp.uint32(sample), bounce, slot)
    got = rng.make_stream(frame, sample, bounce, slot)
    assert tuple(int(w) for w in want) == got
    got_t = rng.make_stream(torch.tensor(frame), torch.tensor(sample), bounce, slot)
    assert tuple(int(w) for w in got_t) == got

    ids = np.arange(2048, dtype=np.uint32) * np.uint32(2654435761)
    seed = 0x1234_5678_9ABC
    ja, jb = jrng.uniform2(seed, jnp.asarray(ids), want)
    ta, tb = rng.uniform2(seed, torch.from_numpy(ids.astype(np.int64)), got)
    assert ta.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


def test_per_lane_sample_streams_match_jax():
    """Sample ids as a tensor (one per lane), as the integrator draws them."""
    ids = np.tile(np.arange(512, dtype=np.uint32), 4)
    samples = np.repeat(np.array([0, 1, 2048, 70_000], np.uint32), 512)
    ja, jb = jrng.uniform2(7, jnp.asarray(ids), jrng.make_stream(
        jnp.uint32(3), jnp.asarray(samples), 1, 1))
    ta, tb = rng.uniform2(7, torch.from_numpy(ids.astype(np.int64)), rng.make_stream(
        3, torch.from_numpy(samples.astype(np.int64)), 1, 1))
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
