"""PyTorch port: the MERL BRDF lookup, its lobe importance sampler, the
BRDF branch of ``scatter`` and the MERL binary reader against the JAX
package.

The same seeded numpy inputs go through ``ops/brdf.py``,
``ops/brdf_sampling.py`` and ``ops/shading.py`` of both packages.
Tolerances: the MERL index is exact except where a float32 rounding
difference between the two programs' acos/atan2 carries an angle across a
bin edge (at most 0.5% of lanes); the samplers' tables to 1e-5 relative
(means over 16,200 table cells summed in another order);
directions, pdfs and weights to 1e-4 relative outside those bin-edge lanes.
``load_merl`` is bit for bit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from vrenderer_pathtracer_tpu import native as jnative
from vrenderer_pathtracer_tpu.ops import brdf as jbrdf
from vrenderer_pathtracer_tpu.ops import brdf_sampling as jbs
from vrenderer_pathtracer_tpu.ops import shading as jshading
from vrenderer_pathtracer_tpu_torch import native
from vrenderer_pathtracer_tpu_torch.ops import brdf, brdf_sampling as bs, shading

B = 4096
EDGE_FRAC = 0.005  # lanes whose MERL bin may differ between the programs


def _t(a):
    return torch.from_numpy(np.array(a))


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _geometry(seed, n=B):
    """Unit normals, tangents orthogonal to them, incoming directions
    pointing at the surface and outgoing ones above it."""
    r = np.random.default_rng(seed)
    nrm = _unit(r.normal(size=(n, 3)))
    tan = _unit(np.cross(nrm, _unit(r.normal(size=(n, 3)))))
    d_in = _unit(r.normal(size=(n, 3)))
    d_in = np.where((np.sum(d_in * nrm, -1) > 0)[:, None], -d_in, d_in)
    d_out = _unit(r.normal(size=(n, 3)))
    d_out = np.where((np.sum(d_out * nrm, -1) < 0)[:, None], -d_out, d_out)
    return [x.astype(np.float32) for x in (d_out, d_in, nrm, tan)]


def _glossy(seed=0):
    th = np.linspace(0, 1, 90) ** 0.5
    lobe = np.exp(-th * 12.0)[None, :, None, None] * np.ones((3, 90, 90, 180))
    noise = np.random.default_rng(seed).uniform(0.9, 1.1, (3, 90, 1, 1))
    return (3000.0 * lobe * noise).reshape(3, brdf.TABLE_SIZE).astype(np.float32)


def test_constants_match_jax():
    assert (brdf.RES_THETA_H, brdf.RES_THETA_D, brdf.RES_PHI_D, brdf.TABLE_SIZE) == (
        jbrdf.RES_THETA_H, jbrdf.RES_THETA_D, jbrdf.RES_PHI_D, jbrdf.TABLE_SIZE)
    np.testing.assert_array_equal(brdf.CHANNEL_SCALE, jbrdf.CHANNEL_SCALE)
    np.testing.assert_array_equal(bs._COS_EDGES, jbs._COS_EDGES)
    np.testing.assert_array_equal(bs._BIN_DOMEGA, jbs._BIN_DOMEGA)
    assert bs._COS_EDGES.dtype == bs._BIN_DOMEGA.dtype == np.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_merl_index_matches_jax(seed):
    g = _geometry(seed)
    want = np.asarray(jbrdf.merl_index(*[jnp.asarray(x) for x in g]))
    got = brdf.merl_index(*[_t(x) for x in g]).numpy()
    assert got.min() >= 0 and got.max() < brdf.TABLE_SIZE
    assert (got != want).mean() <= EDGE_FRAC, (got != want).mean()
    # Degenerate frames: out = -in (theta_d = 0, the tangent-frame case) and
    # out = n = -in (theta_h = 0).
    d_out, _, nrm, tan = g
    for out, d_in in ((d_out, -d_out), (nrm, -nrm)):
        want = np.asarray(jbrdf.merl_index(*[jnp.asarray(x) for x in (out, d_in, nrm, tan)]))
        got = brdf.merl_index(*[_t(x) for x in (out, d_in, nrm, tan)]).numpy()
        assert (got != want).mean() <= EDGE_FRAC


def test_lookup_brdf_matches_jax_and_differentiates():
    g = _geometry(2)
    table = np.random.default_rng(2).uniform(0, 300, (3, brdf.TABLE_SIZE)).astype(np.float32)
    want = np.asarray(jbrdf.lookup_brdf(jnp.asarray(table), *[jnp.asarray(x) for x in g]))
    tt = _t(table).requires_grad_()
    got = brdf.lookup_brdf(tt, *[_t(x) for x in g])
    same = np.all(np.abs(got.detach().numpy() - want) <= 1e-6 * np.abs(want), axis=-1)
    assert (~same).mean() <= EDGE_FRAC
    # The gather's backward is a scatter-add: d sum(lookup) / d table counts
    # each cell's hits times the channel scale, as jax.grad does.
    got.sum().backward()
    jgrad = jax.grad(lambda t: jnp.sum(jbrdf.lookup_brdf(
        t, *[jnp.asarray(x) for x in g])))(jnp.asarray(table))
    gt, gj = tt.grad.numpy(), np.asarray(jgrad)
    assert np.abs(gt.sum(axis=1) - gj.sum(axis=1)).max() <= 1e-6 * B
    assert (gt != gj).sum() <= 2 * 3 * EDGE_FRAC * B


def test_build_merl_sampler_matches_jax():
    table = _glossy()
    js = jbs.build_merl_sampler(jnp.asarray(table))
    t = _t(table).requires_grad_()
    s = bs.build_merl_sampler(t)
    assert not s.mass.requires_grad and not s.cdf.requires_grad  # detached
    np.testing.assert_allclose(s.mass.numpy(), np.asarray(js.mass), rtol=1e-5)
    np.testing.assert_allclose(s.cdf.numpy(), np.asarray(js.cdf), rtol=1e-5)


def _uniforms(seed, n=B, k=4):
    return np.random.default_rng(seed).uniform(0, 1, (k, n)).astype(np.float32)


def test_sample_lobe_and_pdfs_match_jax():
    table = _glossy()
    js, s = jbs.build_merl_sampler(jnp.asarray(table)), bs.build_merl_sampler(_t(table))
    _, d_in, nrm, _ = _geometry(3)
    u = _uniforms(3)
    want = np.asarray(jbs.sample_lobe(js, jnp.asarray(d_in), jnp.asarray(nrm),
                                      *[jnp.asarray(x) for x in u[:3]]))
    got = bs.sample_lobe(s, _t(d_in), _t(nrm), *[_t(x) for x in u[:3]]).numpy()
    close = np.all(np.abs(got - want) <= 1e-4, axis=-1)
    assert (~close).mean() <= EDGE_FRAC
    # pdfs of the JAX draws, under both programs.
    for jf, f in ((lambda o: jbs.pdf_lobe(js, jnp.asarray(d_in), jnp.asarray(nrm), o),
                   lambda o: bs.pdf_lobe(s, _t(d_in), _t(nrm), o)),
                  (lambda o: jbs.pdf_cosine(jnp.asarray(nrm), o),
                   lambda o: bs.pdf_cosine(_t(nrm), o))):
        pw = np.asarray(jf(jnp.asarray(want)))
        pg = f(_t(want)).numpy()
        ok = np.isclose(pg, pw, rtol=1e-4, atol=1e-7)
        assert (~ok).mean() <= EDGE_FRAC


def test_sample_brdf_mis_matches_jax():
    table = _glossy(1)
    js, s = jbs.build_merl_sampler(jnp.asarray(table)), bs.build_merl_sampler(_t(table))
    _, d_in, nrm, tan = _geometry(4)
    u = _uniforms(4, k=6)
    cos_dir = np.asarray(jshading.cosine_hemisphere(jnp.asarray(nrm), u[4], u[5]))
    jd, jw = jbs.sample_brdf_mis(js, jnp.asarray(table), *[jnp.asarray(x) for x in (
        d_in, nrm, tan, cos_dir, u[0], u[1], u[2], u[3])])
    d, w = bs.sample_brdf_mis(s, _t(table), *[_t(x) for x in (
        d_in, nrm, tan, cos_dir, u[0], u[1], u[2], u[3])])
    jd, jw = np.asarray(jd), np.asarray(jw)
    ok = (np.all(np.abs(d.numpy() - jd) <= 1e-4, -1)
          & np.all(np.abs(w.numpy() - jw) <= 1e-4 * np.abs(jw) + 1e-6, -1))
    assert (~ok).mean() <= 2 * EDGE_FRAC, (~ok).mean()
    assert np.abs(jw).max() > 0


@pytest.mark.parametrize("mis", [False, True])
def test_scatter_with_table_matches_jax(mis):
    """``scatter`` on a mix of SPEC, DIFF and BRDF lanes with a MERL table,
    with and without the lobe sampler."""
    table = _glossy(2)
    _, d_in, nrm, tan = _geometry(5)
    r = np.random.default_rng(5)
    color = r.uniform(0, 1, (B, 3)).astype(np.float32)
    spec = np.repeat(r.uniform(0, 1, (B, 1)), 3, axis=1).astype(np.float32)
    hit_type = r.integers(0, 3, B).astype(np.int32)
    u = _uniforms(5, k=5)
    args = (d_in, nrm, tan, color, spec, hit_type, u[0], u[1], u[2])
    jkw = dict(brdf_table=jnp.asarray(table))
    kw = dict(brdf_table=_t(table))
    if mis:
        jkw.update(brdf_sampler=jbs.build_merl_sampler(jnp.asarray(table)),
                   u_b1=jnp.asarray(u[3]), u_b2=jnp.asarray(u[4]))
        kw.update(brdf_sampler=bs.build_merl_sampler(_t(table)),
                  u_b1=_t(u[3]), u_b2=_t(u[4]))
    jd, jm = jshading.scatter(*[jnp.asarray(x) for x in args], jnp.float32(0.1),
                              jnp.float32(3.0), **jkw)
    d, m = shading.scatter(*[_t(x) for x in args], torch.tensor(0.1),
                           torch.tensor(3.0), **kw)
    jd, jm = np.asarray(jd), np.asarray(jm)
    ok = (np.all(np.abs(d.numpy() - jd) <= 1e-4, -1)
          & np.all(np.abs(m.numpy() - jm) <= 1e-4 * np.abs(jm) + 1e-5, -1))
    assert (~ok).mean() <= 2 * EDGE_FRAC, (~ok).mean()
    brdf_lanes = hit_type == 2
    assert np.abs(jm[brdf_lanes]).max() > 0


def test_load_merl_is_bit_exact(tmp_path):
    p = tmp_path / "synthetic.binary"
    raw = np.random.default_rng(6).uniform(0, 500, (3, brdf.TABLE_SIZE))
    with open(p, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        raw.reshape(-1).astype(np.float64).tofile(f)
    got, want = native.load_merl(str(p)), jnative.load_merl(str(p))
    assert got.shape == (3, brdf.TABLE_SIZE) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    bad = tmp_path / "bad.binary"
    np.asarray([90, 90, 90], np.int32).tofile(str(bad))
    with pytest.raises(IOError, match="dimensions"):
        native.load_merl(str(bad))
