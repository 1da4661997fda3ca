"""PyTorch port: the grounds of K1's and K2's Hopper design, on the CPU.

K1 and K2 (``csrc/radiance.cu``, ``csrc/grad.cu``) trace with
``csrc/common.cuh::trace``, which skips work that cannot change the result,
and K2 sweeps each sample in reverse at a unit loss gradient, scaling the
sums by the real one at the end.  The kernels run only on the card
(``tests/test_torch_cuda.py``); this file holds the plain versions to the
facts the design rests on:

* cut (a): at a DIFF hit whose specular colour has channel 0 equal to 0
  (and at SPEC and table-less BRDF hits) ``ops/shading.py::scatter`` gives
  the same direction and multiplier whatever ``u_reflect`` is, and its
  Fresnel gradient is 0, so the slot-0 draw and ``powf`` can be skipped;
* cut (b): every sample of a pixel has the same primary ray and bounce-0
  hit, so bounce 0's sphere loop, hit and frame are per pixel;
* K2's algorithm: a plain-torch mirror of it (per sample, reverse sweep at
  g = 1 per channel, scaled at the end) against autograd
  (``cornell_loss_grads_reference``);
* the wrapper's reading of the kernel's reduced row (``cuda_grad.unpack``).
"""

import math

import numpy as np
import pytest
import torch

import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.core import rng
from vrenderer_pathtracer_tpu_torch.core.camera import (
    Camera, generate_rays, pixel_ids)
from vrenderer_pathtracer_tpu_torch.ops.intersect import INF, intersect_spheres
from vrenderer_pathtracer_tpu_torch.ops.shading import (
    ORIGIN_OFFSET, _norm, cosine_hemisphere, reflect, scatter)
from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
from vrenderer_pathtracer_tpu_torch.render import integrator
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
from vrenderer_pathtracer_tpu_torch.scene.spheres import BRDF, DIFF, SPEC, SphereSet

CORNELL = dict(use_cornell_box=True, has_hdr=False)

# The well-conditioned scene of tests/test_pallas_grad.py::_benign_scene
# (radius, pos, emission, color, refl, spec_color): every branch of the
# estimator is taken and no ray grazes a wall.
BENIGN = [
    (20.0, (0.0, 45.0, 0.0), (4.0, 3.6, 3.2), (0, 0, 0), DIFF, (0, 0, 0)),
    (60.0, (95.0, 0.0, 0.0), (0.075, 0.025, 0.025), (0.75, 0.25, 0.25), DIFF, (0, 0, 0)),
    (60.0, (-95.0, 0.0, 0.0), (0.025, 0.075, 0.025), (0.25, 0.75, 0.25), DIFF, (0, 0, 0)),
    (60.0, (0.0, 0.0, -120.0), (0, 0, 0), (1, 1, 1), DIFF, (0, 0, 0)),
    (60.0, (0.0, -95.0, 0.0), (0, 0, 0), (0.9, 0.9, 0.9), DIFF, (0, 0, 0)),
    (12.0, (18.0, -5.0, 20.0), (0, 0, 0), (0, 0, 0), SPEC, (1, 1, 1)),
    (12.0, (-18.0, -5.0, 20.0), (0, 0, 0), (1, 1, 1), DIFF, (1, 1, 1)),
]


def _benign():
    f32 = dict(dtype=torch.float32)
    return Scene(spheres=SphereSet(
        pos=torch.tensor([r[1] for r in BENIGN], **f32),
        radius=torch.tensor([r[0] for r in BENIGN], **f32),
        emission=torch.tensor([r[2] for r in BENIGN], **f32),
        color=torch.tensor([r[3] for r in BENIGN], **f32),
        refl=torch.tensor([r[4] for r in BENIGN], dtype=torch.int32),
        spec_color=torch.tensor([r[5] for r in BENIGN], **f32)))


def _lanes(rng_np, n):
    """n random hits: unit normals, incoming directions into the surface,
    albedos and the cosine sample's uniforms."""
    normal = _norm(torch.from_numpy(rng_np.normal(size=(n, 3)).astype(np.float32)))
    d = _norm(torch.from_numpy(rng_np.normal(size=(n, 3)).astype(np.float32)))
    d = torch.where((d * normal).sum(-1, keepdim=True) > 0, -d, d)
    color = torch.from_numpy(rng_np.uniform(0, 1, (n, 3)).astype(np.float32))
    u_phi, u_r = (torch.from_numpy(rng_np.uniform(0, 1, n).astype(np.float32))
                  for _ in range(2))
    return d, normal, color, u_phi, u_r


@pytest.mark.parametrize("fc", [0.1, 0.4])
@pytest.mark.parametrize("fp", [3.0, 1.5, 0.5])
def test_cut_a_no_slot0_draw_where_spec0_is_zero(fc, fp):
    """Cut (a): a DIFF hit with spec[0] == 0, a SPEC hit and a table-less
    BRDF hit scatter the same whatever u_reflect is.  u_reflect = 0 and
    5e-7 lie below p's clip floor (1e-6), so the equality also shows that
    the branch compares the unclipped probability (0 here), as
    ops/shading.py does; a hit with spec[0] = 1 does depend on the draw."""
    rs = np.random.default_rng(0)
    n = 512
    d, normal, color, u_phi, u_r = _lanes(rs, n)
    spec = torch.from_numpy(rs.uniform(0.2, 1, (n, 3)).astype(np.float32))
    spec[:, 0] = 0.0
    kinds = torch.tensor([DIFF, SPEC, BRDF], dtype=torch.int32).repeat(n // 3 + 1)[:n]
    draws = [torch.zeros(n), torch.full((n,), 5e-7),
             torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32)),
             torch.full((n,), 0.999999)]
    outs = [scatter(d, normal, torch.zeros_like(normal), color, spec, kinds,
                    u, u_phi, u_r, fc, fp) for u in draws]
    for new_dir, mult in outs[1:]:
        assert torch.equal(new_dir, outs[0][0]) and torch.equal(mult, outs[0][1])
    # The same lanes with spec[0] = 1 on the DIFF rows take the mirror
    # branch at u_reflect = 0 and not at 0.999999.
    lit = spec.clone()
    lit[:, 0] = 1.0
    diff = kinds == DIFF
    lo, hi = (scatter(d, normal, torch.zeros_like(normal), color, lit, kinds,
                      u, u_phi, u_r, fc, fp) for u in (draws[0], draws[3]))
    assert not torch.equal(lo[0][diff], hi[0][diff])
    assert torch.equal(lo[0][~diff], hi[0][~diff])


@pytest.mark.parametrize("fc, fp", [(0.1, 3.0), (0.4, 0.5)])
def test_cut_a_score_gradient_is_zero_where_spec0_is_zero(fc, fp):
    """K2 reads no Fresnel term at such a hit: the multiplier's gradient
    with respect to both sliders is 0 (p = 0 lies below the clip range)."""
    rs = np.random.default_rng(1)
    n = 256
    d, normal, color, u_phi, u_r = _lanes(rs, n)
    spec = torch.from_numpy(rs.uniform(0.2, 1, (n, 3)).astype(np.float32))
    spec[:, 0] = 0.0
    kinds = torch.full((n,), DIFF, dtype=torch.int32)
    sliders = [torch.tensor(fc, requires_grad=True), torch.tensor(fp, requires_grad=True)]
    _, mult = scatter(d, normal, torch.zeros_like(normal), color, spec, kinds,
                      torch.from_numpy(rs.uniform(0, 1, n).astype(np.float32)),
                      u_phi, u_r, *sliders)
    grads = torch.autograd.grad(mult.sum(), sliders)
    assert all(float(g) == 0.0 for g in grads)


@pytest.mark.parametrize("chunk", [None, 1])
def test_cut_b_samples_share_the_primary_ray_and_bounce0_hit(monkeypatch, chunk):
    """Cut (b): the plain pass's bounce-0 rays and hits are the same for
    every sample of a pixel (the primary ray has a fixed sub-pixel
    offset), whether the samples ride in one lane batch or one at a time."""
    s = vpt.RenderSettings(width=16, height=12, samples_per_pass=3, bounces=2,
                           samples_per_chunk=chunk, **CORNELL)
    scene = Scene.analytic(s, "cpu")
    seen = []
    real = integrator.intersect_scene

    def spy(scene_, settings, ray_o, ray_d, alive=None):
        hd = real(scene_, settings, ray_o, ray_d, alive=alive)
        if alive is None:  # bounce 0
            seen.append((ray_o, ray_d, hd))
        return hd

    monkeypatch.setattr(integrator, "intersect_scene", spy)
    integrator.render_camera_pass(scene, s, Camera.default("cpu"), 1, 0.1, 3.0)
    n = s.n_pixels
    per_sample = []
    for ray_o, ray_d, hd in seen:
        fields = (ray_o, ray_d, hd.t, hd.point, hd.normal, hd.color,
                  hd.spec_color, hd.emission, hd.hit_type)
        for k in range(ray_o.shape[0] // n):
            per_sample.append([f[k * n:(k + 1) * n] for f in fields])
    assert len(per_sample) == s.samples_per_pass
    assert per_sample[0][2].lt(INF).any()  # some primary rays hit
    for other in per_sample[1:]:
        for a, b in zip(per_sample[0], other):
            assert torch.equal(a, b)


def _winner(scene, o, d):
    """The running-min winner's row per lane (-1 on a miss), strict < as in
    the integrator and the kernels."""
    sp = scene.spheres
    dist = intersect_spheres(o, d, sp.pos, sp.radius)
    best_t = torch.full((o.shape[0],), INF)
    best = torch.full((o.shape[0],), -1, dtype=torch.int64)
    for i in range(sp.count):
        closer = dist[:, i] < best_t
        best_t = torch.where(closer, dist[:, i], best_t)
        best = torch.where(closer, torch.full_like(best, i), best)
    return best


def k2_mirror(scene, settings, camera, target, frame, fc, fp, seed=0):
    """K2's algorithm in plain torch, vectorised over pixels: per sample,
    the forward pass keeps one record per bounce, a killed sample is
    dropped, and the reverse sweep runs at g = 1 per channel; the unit-g
    sums are scaled by g once the mean over the samples is known.  Returns
    (loss, dcolor, demission, dfresnel_coef, dfresnel_pow)."""
    sp = scene.spheres
    n, ns = settings.n_pixels, sp.count
    spp, bounces = settings.samples_per_pass, settings.bounces
    o0, d0 = generate_rays(camera, settings.width, settings.height)
    ids = pixel_ids(settings.width, settings.height, "cpu")
    lanes = torch.arange(n)
    rgb = torch.zeros(n, 3)
    dcol, dem = torch.zeros(n, ns, 3), torch.zeros(n, ns, 3)  # unit g
    dfc, dfp = torch.zeros(n, 3), torch.zeros(n, 3)           # per channel
    for s in range(spp):
        o, d, m = o0, d0, torch.ones(n, 3)
        alive = torch.ones(n, dtype=torch.bool)
        radiance, recs = torch.zeros(n, 3), []
        for b in range(bounces):
            hd = integrator._intersect_sphere_set(scene, o, d)
            alive = alive & hd.hit
            idx = _winner(scene, o, d).clamp(min=0)
            u_reflect, _ = rng.uniform2(seed, ids, rng.make_stream(frame, s, b, 0))
            u_phi, u_r = rng.uniform2(seed, ids, rng.make_stream(frame, s, b, 1))
            nrm = hd.normal
            one_m_aoi = torch.clamp(1.0 - (nrm * -d).sum(-1), min=0.0)
            grazing = one_m_aoi ** fp
            spec0 = hd.spec_color[:, 0]
            p = (grazing * (1.0 - fc) + fc) * spec0
            is_spec = hd.hit_type == SPEC
            take = (u_reflect < p) & ~is_spec
            cos_dir = cosine_hemisphere(nrm, u_phi, u_r)
            cos2 = (cos_dir * nrm).sum(-1) * 2.0
            mirror = reflect(d, nrm)
            mult = torch.where(is_spec[:, None], torch.ones_like(m),
                               torch.where(take[:, None], hd.spec_color,
                                           hd.color * cos2[:, None]))
            new_d = torch.where(is_spec[:, None], mirror,
                                torch.where(take[:, None], _norm(mirror), cos_dir))
            radiance = radiance + m * hd.emission
            score = ((hd.hit_type == DIFF) & (p >= 1e-6) & (p <= 1.0 - 1e-6))
            w = torch.where(take, 1.0 / p, -cos2 / (1.0 - p))
            log_term = torch.where(one_m_aoi > 0, torch.log(one_m_aoi),
                                   torch.zeros_like(one_m_aoi))
            recs.append(dict(idx=idx, m=m, cos2=cos2, take=take, spec=is_spec,
                             mult=mult, em=hd.emission, col=hd.color,
                             sc=hd.spec_color,
                             dpc=torch.where(score, w * (1.0 - grazing) * spec0, 0.0),
                             dpp=torch.where(score, w * (1.0 - fc) * spec0 * grazing
                                             * log_term, 0.0)))
            a3 = alive[:, None]
            o = torch.where(a3, hd.point + ORIGIN_OFFSET * nrm, o)
            d = torch.where(a3, new_d, d)
            m = m * mult
        live = alive[:, None]
        rgb = rgb + torch.where(live, radiance, 0.0)
        rn = torch.zeros(n, 3)
        for r in reversed(recs):
            cm = r["m"] * rn
            dem[lanes, r["idx"]] += torch.where(live, r["m"], 0.0)
            cosine = (~r["spec"] & ~r["take"])[:, None]
            dcol[lanes, r["idx"]] += torch.where(live & cosine, r["cos2"][:, None] * cm, 0.0)
            q = cm * torch.where(r["take"][:, None], r["sc"], r["col"])
            dfc = dfc + torch.where(live, q * r["dpc"][:, None], 0.0)
            dfp = dfp + torch.where(live, q * r["dpp"][:, None], 0.0)
            rn = r["em"] + r["mult"] * rn
    diff = rgb / spp - target
    g = diff * (2.0 / (3.0 * n * spp))
    return ((diff ** 2).sum() / (3 * n), (dcol * g[:, None, :]).sum(0),
            (dem * g[:, None, :]).sum(0), (dfc * g).sum(), (dfp * g).sum())


@pytest.mark.parametrize("sliders", [(0.1, 3.0), (0.4, 1.5)])
def test_k2_algorithm_mirror_matches_autograd(sliders):
    """K2's per-sample sweep at unit g, scaled at the end, gives autograd's
    loss and gradients (16x16, 2 spp x 4 bounces, the well-conditioned
    scene: the two run the same float32 forward, so they take the same
    branches).  rtol 1e-4; atol 1e-8 absorbs float32 summation order on
    sums of order 1e-2 (dcolor, demission) down to 1e-6 (dfresnel_pow)."""
    s = vpt.RenderSettings(width=16, height=16, samples_per_pass=2, bounces=4,
                           **CORNELL)
    scene, cam = _benign(), Camera.default("cpu")
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 0.5, (s.n_pixels, 3)).astype(np.float32))
    got = k2_mirror(scene, s, cam, target, 1, *sliders)
    want = k2.cornell_loss_grads_reference(scene, s, cam, target, 1, *sliders)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w.double(), rtol=1e-4, atol=1e-8)
    assert float(want[3]) != 0.0 and float(want[4]) != 0.0  # the Fresnel terms ran


@pytest.mark.parametrize("with_camera", [False, True])
def test_unpack_reads_the_reduced_row(with_camera):
    """cuda_grad.unpack: [0] the sum of squared errors, [1 + 6i + c]
    dcolor, [4 + 6i + c] demission, [1 + 6Ns] dfresnel_coef, [2 + 6Ns]
    dfresnel_pow, then the 12 camera-vector sums."""
    ns, n_pixels = 5, 16
    k = k2.n_partials(ns, with_camera)
    row = torch.arange(k, dtype=torch.float32) * 0.5 + 1.0
    (loss, dcol, dem, dfc, dfp), dcam = k2.unpack(row, ns, n_pixels)
    assert math.isclose(float(loss), 1.0 / (3 * n_pixels), rel_tol=1e-6)
    for i in range(ns):
        for c in range(3):
            assert float(dcol[i, c]) == float(row[1 + 6 * i + c])
            assert float(dem[i, c]) == float(row[4 + 6 * i + c])
    assert float(dfc) == float(row[1 + 6 * ns]) and float(dfp) == float(row[2 + 6 * ns])
    if with_camera:
        assert torch.equal(dcam, row[3 + 6 * ns:]) and dcam.shape == (12,)
    else:
        assert dcam is None
    with pytest.raises(ValueError):
        k2.unpack(row[:-1], ns, n_pixels)
