"""PyTorch port: sphere intersection and scatter match the JAX functions."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vrenderer_pathtracer_tpu.ops import intersect as jintersect
from vrenderer_pathtracer_tpu.ops import shading as jshading
from vrenderer_pathtracer_tpu.scene.spheres import build_sphere_set as j_build
from vrenderer_pathtracer_tpu_torch.ops import intersect, shading
from vrenderer_pathtracer_tpu_torch.scene.spheres import build_sphere_set

B = 4096


def _unit(r, n):
    v = r.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def test_sphere_tables_match_jax():
    for cornell in (False, True):
        j, t = j_build(cornell), build_sphere_set(cornell, "cpu")
        for f in ("pos", "radius", "emission", "color", "refl", "spec_color"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)))


def test_intersect_spheres_matches_jax():
    r = np.random.default_rng(1)
    o = r.uniform(-45, 45, (B, 3)).astype(np.float32)
    d = _unit(r, B)
    s = j_build(True)
    want = np.asarray(jintersect.intersect_spheres(o, d, s.pos, s.radius))
    got = intersect.intersect_spheres(_t(o), _t(d), _t(np.asarray(s.pos)),
                                      _t(np.asarray(s.radius))).numpy()
    assert got.shape == (B, 8)
    hit = want < jintersect.INF
    np.testing.assert_array_equal(got < intersect.INF, hit)
    # Small spheres (the light, r=160, and the two r=3.5 ones) within 1e-5.
    # The r=1e5 walls take t = b - sqrt(det) with b near 1e5, so either
    # side's t carries about one float32 ulp of 1e5 (2^-7) absolute error.
    small = np.asarray(s.radius) < 1e3
    h_small, h_wall = hit & small[None, :], hit & ~small[None, :]
    np.testing.assert_allclose(got[h_small], want[h_small], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[h_wall], want[h_wall], rtol=0, atol=2 ** -6)


@pytest.mark.parametrize("fc,fp", [(0.1, 3.0), (0.9, 1.0)])
def test_scatter_matches_jax(fc, fp):
    r = np.random.default_rng(2)
    d = _unit(r, B)
    n = _unit(r, B)
    n = np.where((np.sum(n * d, -1) > 0)[:, None], -n, n)  # facing the ray
    color = r.uniform(0, 1, (B, 3)).astype(np.float32)
    spec = np.repeat(r.integers(0, 2, (B, 1)), 3, axis=1).astype(np.float32)
    hit_type = r.integers(0, 3, B).astype(np.int32)
    u = r.uniform(0, 1, (3, B)).astype(np.float32)
    args = (d, n, np.zeros_like(n), color, spec, hit_type, u[0], u[1], u[2])
    jdir, jmult = jshading.scatter(*[jnp.asarray(a) for a in args],
                                   jnp.float32(fc), jnp.float32(fp))
    tdir, tmult = shading.scatter(*[_t(a) for a in args],
                                  torch.tensor(fc), torch.tensor(fp))
    np.testing.assert_allclose(tdir.numpy(), np.asarray(jdir), atol=1e-5)
    np.testing.assert_allclose(tmult.numpy(), np.asarray(jmult), atol=1e-5)


def test_scatter_fresnel_gradient_flows_through_ratio_trick():
    r = np.random.default_rng(3)
    d, n = _t(_unit(r, 64)), -_t(_unit(r, 64))
    fc = torch.tensor(0.5, requires_grad=True)
    ones = torch.ones(64, 3)
    u = _t(r.uniform(0, 1, (3, 64)).astype(np.float32))
    _, mult = shading.scatter(d, n, torch.zeros_like(n), ones, ones,
                              torch.ones(64, dtype=torch.int32), u[0], u[1],
                              u[2], fc, torch.tensor(3.0))
    assert torch.all(mult.detach() >= 0)
    mult.sum().backward()
    assert fc.grad is not None and fc.grad != 0


def test_measured_brdf_table_raises():
    """A table that is not [3, 90*90*180] raises instead of being read out
    of bounds (the lookup is tests/test_torch_brdf.py's)."""
    r = np.random.default_rng(3)
    d, n = _t(_unit(r, 64)), _t(_unit(r, 64))
    t = torch.linalg.cross(n, _t(_unit(r, 64)))
    u = _t(r.uniform(0, 1, (3, 64)).astype(np.float32))
    ones = torch.ones(64, 3)
    with pytest.raises(IndexError):
        shading.scatter(-d, n, t, ones, ones, torch.full((64,), 2, dtype=torch.int32),
                        u[0], u[1], u[2], 0.1, 3.0, brdf_table=torch.zeros(3, 8))
