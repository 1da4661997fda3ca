"""PyTorch port: the intersection helpers of ``ops/intersect.py``
(Moller-Trumbore with barycentrics, the slab test, the guarded inverse
direction) against the JAX package's, on tests/test_intersect.py's
analytic cases and on random batches from a seed, at float32 rounding.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vrenderer_pathtracer_tpu.ops import intersect as J
from vrenderer_pathtracer_tpu_torch.ops import intersect as T

TRI = ([0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0])
# (origin, direction) of tests/test_intersect.py's triangle cases: a hit at
# (0.25, 0.25), outside the triangle, parallel, behind the origin.
TRI_CASES = [([0.25, 0.25, 1.0], [0.0, 0.0, -1.0]),
             ([0.9, 0.9, 1.0], [0.0, 0.0, -1.0]),
             ([0.25, 0.25, 1.0], [1.0, 0.0, 0.0]),
             ([0.25, 0.25, -1.0], [0.0, 0.0, -1.0])]


def _both(fn_j, fn_t, *arrays, **kw):
    a = [np.asarray(x, np.float32) for x in arrays]
    want = fn_j(*(jnp.asarray(x) for x in a), **kw)
    got = fn_t(*(torch.tensor(x) for x in a), **kw)
    return got, want


def _check(got, want, atol=1e-6):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol, rtol=1e-6)


def test_constants_match():
    assert (T.TRI_EPS, T.INF, T.SPHERE_EPS) == (J.TRI_EPS, J.INF, J.SPHERE_EPS)


@pytest.mark.parametrize("case", range(len(TRI_CASES)))
def test_triangle_cases_match_jax(case):
    o, d = TRI_CASES[case]
    got, want = _both(J.intersect_triangles, T.intersect_triangles,
                      [o], [d], [TRI[0]], [TRI[1]], [TRI[2]])
    _check(got, want)
    hit = case == 0
    assert (got[0].item() == np.float32(T.INF)) != hit
    if hit:
        u, v = got[1].item(), got[2].item()
        assert abs(got[0].item() - 1.0) < 1e-6 and abs(u - 0.25) < 1e-6
        assert abs(v - 0.25) < 1e-6


def test_random_triangles_match_jax():
    rng = np.random.default_rng(3)
    n = 4096
    v0, v1, v2 = (rng.uniform(-1, 1, (n, 3)) for _ in range(3))
    o = rng.uniform(-3, 3, (n, 3))
    # Aimed near each triangle's centroid: about half the rays hit.
    d = (v0 + v1 + v2) / 3 + rng.normal(0, 0.3, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    (t, u, v), (jt, ju, jv) = _both(J.intersect_triangles, T.intersect_triangles,
                                   o, d, v0, v1, v2)
    miss, jmiss = t.numpy() == np.float32(T.INF), np.asarray(jt) == np.float32(J.INF)
    assert 0.2 < (~jmiss).mean() < 0.8
    # A ray on an edge may flip between hit and miss under rounding.
    assert (miss != jmiss).mean() <= 1e-3
    both = ~miss & ~jmiss
    np.testing.assert_allclose(t.numpy()[both], np.asarray(jt)[both], rtol=1e-4)
    _check((u, v), (ju, jv), atol=1e-4)


def test_slab_cases_and_random_boxes_match_jax():
    o, d = [[0.0, 0.0, 5.0], [3.0, 0.0, 5.0]], [[0.0, 0.0, -1.0]] * 2
    inv, jinv = _both(J.safe_inv_dir, T.safe_inv_dir, d)
    lo, hi = [-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]
    got, want = _both(J.slab_test, T.slab_test, o, jinv, lo, hi)
    _check(got[:2], want[:2])
    assert got[2].tolist() == [True, False] == np.asarray(want[2]).tolist()
    assert got[0][0].item() == 4.0 and got[1][0].item() == 6.0

    rng = np.random.default_rng(5)
    n = 2048
    o = rng.uniform(-4, 4, (n, 3))
    d = rng.standard_normal((n, 3))
    d[rng.uniform(size=(n, 3)) < 0.05] = 0.0          # axis-parallel rays
    d[rng.uniform(size=(n, 3)) < 0.02] = 5e-9          # below the guard
    inv, jinv = _both(J.safe_inv_dir, T.safe_inv_dir, d)
    assert inv.numpy().tobytes() == np.asarray(jinv).tobytes()
    c = rng.uniform(-2, 2, (n, 3))
    lo, hi = c - rng.uniform(0.1, 1, (n, 3)), c + rng.uniform(0.1, 1, (n, 3))
    for kw in ({}, {"t_min": 0.5, "t_max": 3.0}):
        got, want = _both(J.slab_test, T.slab_test, o, jinv, lo, hi, **kw)
        assert got[2].numpy().tolist() == np.asarray(want[2]).tolist()
        _check(got[:2], want[:2], atol=1e-5)


def test_example_sphere_matches_jax():
    from vrenderer_pathtracer_tpu.scene.spheres import example_sphere as j_example
    from vrenderer_pathtracer_tpu_torch.scene.spheres import example_sphere

    got, want = example_sphere("cpu"), j_example()
    assert got.count == 1
    for name in ("pos", "radius", "emission", "color", "refl", "spec_color"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    # Rays from the default camera's side hit it head on at z = 10.
    o, d = np.array([[0.0, 0.0, 40.0], [0.0, 11.0, 40.0]]), np.array([[0.0, 0.0, -1.0]] * 2)
    t, jt = _both(J.intersect_spheres, T.intersect_spheres, o, d,
                  np.asarray(want.pos), np.asarray(want.radius))
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6)
    assert t[0, 0].item() == 30.0 and t[1, 0].item() == np.float32(T.INF)
