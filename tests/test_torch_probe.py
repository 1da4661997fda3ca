"""K6's plain chain (``kernels/probe.py``) on the CPU.

The plain chain is the oracle of K6 (``csrc/probe.cu``).  At the check
constants it is held to a float64 model of the kernel's fused multiply-add
(one rounding a step): bfloat16 bit for bit, float32 within
``probe.F32_RTOL``.  The check must refuse the wrong chains a kernel could
compute: its input back (the planted no-op), a step short, the addend or
the multiplier dropped.
"""

import numpy as np
import pytest
import torch

from vrenderer_pathtracer_tpu_torch.kernels import probe


def _inputs(dtype):
    rng = np.random.default_rng(6)
    return torch.from_numpy(rng.uniform(0.5, 1.5, (64, 128))
                            .astype(np.float32)).to(dtype)


def _fused_chain(x, c, a, n_ops=probe.N_OPS):
    """The kernel's chain: each step's product and sum in float64, rounded
    once to ``x``'s dtype."""
    c = float(torch.tensor(c, dtype=x.dtype))
    a = float(torch.tensor(a, dtype=x.dtype))
    v = x
    for _ in range(n_ops):
        v = (v.double() * c + a).to(x.dtype)
    return v


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_chain_matches_fused_chain(dtype):
    x = _inputs(dtype)
    want = probe.chain_reference(x, probe.CHECK_C, probe.CHECK_A)
    ok, err, rel = probe.chain_agreement(
        _fused_chain(x, probe.CHECK_C, probe.CHECK_A), want)
    assert ok, (err, rel)
    if dtype == torch.bfloat16:
        assert err == 0.0
    # The chain moves: every value is far from its input.
    assert ((want.float() - x.float()).abs() > 100).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_check_refuses_wrong_chains(dtype):
    x = _inputs(dtype)
    c, a = probe.CHECK_C, probe.CHECK_A
    want = probe.chain_reference(x, c, a)
    wrong = {
        "no-op": x,
        "a step short": probe.chain_reference(x, c, a, probe.N_OPS - 1),
        "no addend": probe.chain_reference(x, c, 0.0),
        "no multiplier": probe.chain_reference(x, 1.0, a),
    }
    for name, got in wrong.items():
        assert not probe.chain_agreement(got, want)[0], name


def test_cpu_tensor_takes_the_plain_chain():
    x = _inputs(torch.float32)
    before = probe.launch_k6.count
    got = probe.chain(x, probe.CHECK_C, probe.CHECK_A)
    assert probe.launch_k6.count == before
    assert torch.equal(got, probe.chain_reference(x, probe.CHECK_C, probe.CHECK_A))
    with pytest.raises(ValueError):
        probe.launch_k6(x)


@pytest.mark.parametrize("k", probe.CHAINS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vector_split_covers_every_element_once(dtype, k):
    per_unit = 2 if dtype == torch.bfloat16 else 1
    for numel in (0, 2, 6, 64, 2 ** 22 + 6, 2 ** 23):
        vectors, tail = probe.vector_split(numel, dtype, k)
        assert 0 <= tail < k
        assert (vectors * k + tail) * per_unit == numel
    # The card tests' ragged size: a tail at every k above 2.
    assert probe.vector_split(2 ** 22 + 6, torch.float32, 4) == (2 ** 20 + 1, 2)
    assert probe.vector_split(2 ** 22 + 6, torch.bfloat16, 8) == (2 ** 18, 3)


def test_wrapper_size_rules_before_the_device():
    x = _inputs(torch.float32).reshape(-1)
    xb = x.to(torch.bfloat16)
    refused = {
        "k outside 1, 2, 4, 8": lambda: probe.launch_k6(x, k=3),
        "an odd bf16 count": lambda: probe.launch_k6(xb[:7].contiguous()),
        "float64": lambda: probe.launch_k6(x.double()),
        "a strided tensor": lambda: probe.launch_k6(x[::2]),
        "an unknown grid": lambda: probe.launch_k6(x, grid="tiles"),
    }
    for what, call in refused.items():
        with pytest.raises(ValueError) as e:
            call()
        assert "CUDA" not in str(e.value), what
    for k in probe.CHAINS:  # sound arguments: refused only for the device
        for grid in probe.GRIDS:
            with pytest.raises(ValueError, match="CUDA"):
                probe.launch_k6(xb[:2 * 8 * k + 6].contiguous(), k=k, grid=grid)


def test_chain_of_a_ragged_size_is_its_pieces_chains():
    """Each element's chain is its own: the plain chain of an array equals,
    bit for bit, the plain chains of the kernel's whole vectors and of its
    tail, which the kernel runs apart."""
    c, a = probe.CHECK_C, probe.CHECK_A
    for dtype in (torch.float32, torch.bfloat16):
        x = _inputs(dtype).reshape(-1)[:2 * 4 * 37 + 6]
        whole = probe.chain(x, c, a)
        vectors, _ = probe.vector_split(x.numel(), dtype, 4)
        cut = vectors * 4 * (2 if dtype == torch.bfloat16 else 1)
        pieces = torch.cat([probe.chain_reference(x[:cut], c, a),
                            probe.chain_reference(x[cut:], c, a)])
        assert torch.equal(whole, pieces), dtype
