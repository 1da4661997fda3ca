"""PyTorch port: the threefry stream is bit-identical to the JAX package's,
and K7 (``rng.bounce_uniforms`` on CUDA tensors) to the int64 path.

The JAX package is imported by the fixture ``j`` alone, so the card's
tests (marker ``cuda``; they skip without a card) import nothing of JAX
and run on the card by themselves:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_rng.py
"""

import types

import numpy as np
import pytest
import torch

from vrenderer_pathtracer_tpu_torch.core import rng

# Random123 known-answer vectors (threefry2x32, 20 rounds), as in test_rng.py.
KAT = [
    ((0x00000000, 0x00000000), (0x00000000, 0x00000000), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


@pytest.fixture(scope="module")
def j():
    """The JAX package's stream (``rng``) and ``jax.numpy`` (``jnp``)."""
    import jax.numpy as jnp

    from vrenderer_pathtracer_tpu.core import rng as jrng

    return types.SimpleNamespace(rng=jrng, jnp=jnp)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("key,ctr,expect", KAT)
def test_threefry_known_answers(key, ctr, expect):
    o0, o1 = rng.threefry2x32(key[0], key[1], torch.tensor([ctr[0]]),
                              torch.tensor([ctr[1]]))
    assert (int(o0[0]), int(o1[0])) == expect


def test_threefry_matches_jax_on_4096_counters(j):
    jrng, jnp = j.rng, j.jnp
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
def test_make_stream_and_uniform2_match_jax(j, frame, sample, bounce, slot):
    jrng, jnp = j.rng, j.jnp
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


def test_per_lane_sample_streams_match_jax(j):
    """Sample ids as a tensor (one per lane), as the integrator draws them."""
    jrng, jnp = j.rng, j.jnp
    ids = np.tile(np.arange(512, dtype=np.uint32), 4)
    samples = np.repeat(np.array([0, 1, 2048, 70_000], np.uint32), 512)
    ja, jb = jrng.uniform2(7, jnp.asarray(ids), jrng.make_stream(
        jnp.uint32(3), jnp.asarray(samples), 1, 1))
    ta, tb = rng.uniform2(7, torch.from_numpy(ids.astype(np.int64)), rng.make_stream(
        3, torch.from_numpy(samples.astype(np.int64)), 1, 1))
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())


# --- bounce_uniforms: every slot of one bounce; K7 on the card -------------

# Seeds past 2**32 (both key words), a frame whose ``frame << 7`` wraps, and
# bounces over the stream's 5 bits.
DRAW_SEEDS = (0x1234_5678_9ABC, (0xFEDC_BA98 << 32) | 0x7654_3210)
DRAW_FRAME = 1 << 25


def _ids(n, seed=0):
    """``n`` lanes of pixel ids up to 2**32 - 1 and sample ids past 2**31,
    the edges first."""
    r = np.random.default_rng(seed)
    pix = r.integers(0, 2 ** 32, n, dtype=np.int64)
    samp = r.integers(2 ** 31, 2 ** 32, n, dtype=np.int64)
    edges = ([0, 2 ** 32 - 1, 2 ** 31, 1], [2 ** 31, 2 ** 32 - 1, 0, 2 ** 31 - 1])
    k = min(n, 4)
    pix[:k], samp[:k] = edges[0][:k], edges[1][:k]
    return torch.from_numpy(pix), torch.from_numpy(samp)


def _per_slot(seed, pix, samp, frame, bounce, n_slots):
    """The int64 path, one ``uniform2`` a slot, on the ids' device."""
    return [u for slot in range(n_slots) for u in rng.uniform2(
        seed, pix, rng.make_stream(frame, samp, bounce, slot))]


@pytest.mark.parametrize("n_slots", [2, 3])
def test_bounce_uniforms_matches_uniform2_and_jax(j, n_slots):
    """On the CPU, every word of the bounce in stream order: the per-slot
    ``uniform2`` and the JAX package's stream, bit for bit."""
    jrng, jnp = j.rng, j.jnp
    pix, samp = _ids(1001, seed=n_slots)
    launches = rng.bounce_uniforms.count
    for seed, bounce in zip(DRAW_SEEDS, (0, 31)):
        got = rng.bounce_uniforms(seed, pix, samp, DRAW_FRAME, bounce, n_slots)
        want = _per_slot(seed, pix, samp, DRAW_FRAME, bounce, n_slots)
        assert len(got) == 2 * n_slots
        for g, w in zip(got, want):
            assert g.dtype == torch.float32 and torch.equal(g, w)
        for slot in range(n_slots):
            stream = jrng.make_stream(jnp.uint32(DRAW_FRAME),
                                      jnp.asarray(samp.numpy().astype(np.uint32)),
                                      bounce, slot)
            ja, jb = jrng.uniform2(seed, jnp.asarray(pix.numpy().astype(np.uint32)),
                                   stream)
            np.testing.assert_array_equal(np.asarray(ja), got[2 * slot].numpy())
            np.testing.assert_array_equal(np.asarray(jb), got[2 * slot + 1].numpy())
    assert rng.bounce_uniforms.count == launches  # the CPU launches nothing


@pytest.mark.parametrize("n_slots", [0, 1, 4, 5])
def test_bounce_uniforms_draws_two_or_three_slots(n_slots):
    """A bounce draws 2 slots, or 3 with BRDF sampling: the wrapper refuses
    other counts on every device, as K7 does."""
    pix, samp = _ids(8)
    with pytest.raises(ValueError):
        rng.bounce_uniforms(0, pix, samp, 1, 0, n_slots)


@pytest.mark.cuda
@pytest.mark.parametrize("n_slots", [2, 3])
@pytest.mark.parametrize("n", [0, 1, 100_003])
def test_k7_matches_int64_path(cuda, n, n_slots):
    """K7's words are the int64 path's on the card, bit for bit, at every
    bounce of the stream's 5 bits, for both seeds."""
    pix, samp = (t.to(cuda) for t in _ids(n, seed=n))
    for seed in DRAW_SEEDS:
        for bounce in range(32):
            got = rng.bounce_uniforms(seed, pix, samp, DRAW_FRAME, bounce, n_slots)
            want = _per_slot(seed, pix, samp, DRAW_FRAME, bounce, n_slots)
            assert len(got) == 2 * n_slots
            for k, (g, w) in enumerate(zip(got, want)):
                assert g.dtype == torch.float32 and g.device == pix.device
                assert torch.equal(g, w), (seed, bounce, k)


@pytest.mark.cuda
def test_k7_reads_a_frame_tensor_on_the_card(cuda):
    pix, samp = (t.to(cuda) for t in _ids(4097))
    for frame in (1, 7, DRAW_FRAME, 2 ** 31 - 1, 2 ** 32 + 5):
        want = rng.bounce_uniforms(DRAW_SEEDS[0], pix, samp, frame, 3, 3)
        frames = [torch.tensor(frame, device=cuda)]
        if frame < 2 ** 31:
            frames.append(torch.tensor(frame, dtype=torch.int32, device=cuda))
        for f in frames:
            got = rng.bounce_uniforms(DRAW_SEEDS[0], pix, samp, f, 3, 3)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), frame


@pytest.mark.cuda
def test_k7_refuses_what_it_does_not_take(cuda):
    pix, samp = (t.to(cuda) for t in _ids(64))
    bad = [(pix.to(torch.int32), samp), (pix, samp.to(torch.int32)),
           (pix[::2], samp[::2]), (pix.reshape(8, 8), samp.reshape(8, 8)),
           (pix, samp[:32]), (pix, samp.cpu())]
    for p, s in bad:
        with pytest.raises(ValueError):
            rng.bounce_uniforms(0, p, s, 1, 0, 2)
    for n_slots in (0, 1, 4, 5):
        with pytest.raises(ValueError):
            rng.bounce_uniforms(0, pix, samp, 1, 0, n_slots)
    with pytest.raises(ValueError):
        rng.bounce_uniforms(0, pix, samp, torch.ones(2, dtype=torch.int64,
                                                     device=cuda), 0, 2)


@pytest.mark.cuda
def test_k7_never_takes_the_plain_path(cuda, monkeypatch):
    """A CUDA call launches K7, once a call: the int64 cipher never runs,
    and the counters count launches and lanes; an empty call launches
    nothing and counts nothing."""
    pix, samp = (t.to(cuda) for t in _ids(513))
    want = rng.bounce_uniforms(5, pix, samp, 2, 1, 3)

    def plain(*args, **kw):
        raise AssertionError("the int64 path ran on CUDA tensors")

    monkeypatch.setattr(rng, "threefry2x32", plain)
    count, lanes = rng.bounce_uniforms.count, rng.bounce_uniforms.lanes
    for call in range(1, 4):
        got = rng.bounce_uniforms(5, pix, samp, 2, 1, 3)
        assert rng.bounce_uniforms.count == count + call
        assert rng.bounce_uniforms.lanes == lanes + call * 513
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert rng.bounce_uniforms(5, pix[:0], samp[:0], 2, 1, 3)[0].shape == (0,)
    assert rng.bounce_uniforms.count == count + 3
    assert rng.bounce_uniforms.lanes == lanes + 3 * 513
