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
