"""PyTorch port: config 5's inverse-rendering step (``deferred_opt_step``
with Adam on the HDRI and the MERL table) against the benchmark's plain
reference (``benchmark/reference/c5inverse.py``), on the CPU.

The scene is the ``c5inverse`` configuration's, cut to run here: its
seeded displaced sphere at 40 rings and segments (3,120 triangles) paged at
512 triangles a page (7 pages, as ``chip_smoke.py`` phase 31 pages its
sphere), the seeded 16x32 HDRI and the seeded glossy MERL table; 48x32,
2 spp, 4 bounces, remat, compact waves.  Two steps from the flat start on
two of the cell's orbit views, each against its view's target (2 passes
with the true tables).  The reference follows them from the same start
with the program's targets.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.accel.paged import pack_mesh_paged
from vrenderer_pathtracer_tpu_torch.native import load_obj
from vrenderer_pathtracer_tpu_torch.ops import brdf as brdf_ops
from vrenderer_pathtracer_tpu_torch.ops import envmap
from vrenderer_pathtracer_tpu_torch.parallel.sharding import (
    DeferredParams, deferred_opt_step)
from vrenderer_pathtracer_tpu_torch.render.renderer import render_pass

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import faults, grad_faults  # noqa: E402
from benchmark.loops import grad  # noqa: E402
from benchmark.reference import c5, c5_assets, views  # noqa: E402
from benchmark.reference import c5inverse as ref  # noqa: E402

W, H, SPP, SEED = 48, 32, 2, 2 ** 31 + 19
STEPS = 2
LIMITS = json.loads((ROOT / "benchmark" / "limits"
                     / "c5inverse.grad8.json").read_text())


def _cfg():
    cfg = json.loads((ROOT / "benchmark" / "configs"
                      / "c5inverse.json").read_text())
    cfg["mesh"].update(n_theta=40, n_phi=40)
    cfg["hdri"].update(height=16, width=32)
    return cfg


def _traffic():
    t = json.loads((ROOT / "benchmark" / "traffic" / "grad8.json").read_text())
    t.update(width=W, height=H, spp_per_pass=SPP, target_passes=2)
    return t


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The program's renderer of the cut scene, its views' cameras (the
    reference's and the program's) and targets."""
    cfg, t = _cfg(), _traffic()
    obj = tmp_path_factory.mktemp("c5inv") / "mesh.obj"
    obj.write_text(c5_assets.obj_text(*c5_assets.mesh(cfg, SEED)))
    r = vpt.Renderer(W, H, device="cpu", seed=SEED, settings=vpt.RenderSettings(
        samples_per_pass=SPP, bounces=cfg["bounces"], use_fxaa=cfg["fxaa"],
        use_brdf=True, remat_bounces=cfg["remat_bounces"]))
    r.load_hdr(c5_assets.hdri(cfg, SEED))
    r.load_brdf(c5_assets.merl(cfg, SEED))
    r.init_mesh(pack_mesh_paged(load_obj(str(obj)), 512, device="cpu"))
    assert r.scene.mesh.paged.n_pages == 7
    assert r.settings.compact_waves and r.settings.remat_bounces
    cams, ref_cams, targets = [], [], []
    for k in range(STEPS):
        view = views.spec(t["views"], SEED, k)
        r.update_camera(origin=view["origin"], yaw=view["yaw"],
                        pitch=view["pitch"], fov_deg=view["fov_deg"])
        acc = sum(render_pass(r.scene, r.settings, r.camera, f, r.fresnel_coef,
                              r.fresnel_pow, SEED)[0]
                  for f in range(1, t["target_passes"] + 1))
        cams.append(r.camera)
        ref_cams.append(views.camera(view))
        targets.append(acc / t["target_passes"])
    return dict(r=r, cfg=cfg, t=t, cams=cams, ref_cams=ref_cams,
                targets=targets)


def _program_steps(sc, patch=None):
    """(losses, grads [[hdr, brdf]], tables after each step incl. the
    start) of STEPS program steps from the flat start."""
    r, t = sc["r"], sc["t"]
    s0 = ref.start(sc["cfg"], SEED)
    params = DeferredParams(hdr=torch.tensor(s0["hdr"]).requires_grad_(),
                            brdf=torch.tensor(s0["brdf"]).requires_grad_())
    opt = torch.optim.Adam(params.leaves(), lr=t["lr"])
    step = deferred_opt_step(r.settings, opt, scene=r.scene, seed=SEED,
                             device="cpu")
    out = {"losses": [], "grads": [],
           "params": [[x.detach().clone() for x in params.leaves()]]}
    with faults.patcher() as p:
        if patch is not None:
            patch(p)
        for i in range(STEPS):
            params, m = step(params, r.scene, sc["cams"][i], sc["targets"][i],
                             t["first_frame"] + i, r.fresnel_coef,
                             r.fresnel_pow)
            out["losses"].append(float(m["loss"]))
            out["grads"].append([x.grad.clone() for x in params.leaves()])
            out["params"].append([x.detach().clone() for x in params.leaves()])
    return out


@pytest.fixture(scope="module")
def program(scene):
    return _program_steps(scene)


@pytest.fixture(scope="module")
def reference(scene):
    t = scene["t"]
    return ref.train(scene["cfg"], t, SEED, scene["ref_cams"],
                     [t["first_frame"] + i for i in range(STEPS)],
                     scene["targets"], torch.device("cpu"), block_lanes=768)


def _compare(program, reference):
    run = type("Run", (), {"traffic": _traffic()})()
    got = dict(program, target_blocks=[])
    return grad.compare(run, reference, [], got, LIMITS)


def test_losses_gradients_and_steps_match_the_reference(program, reference):
    np.testing.assert_allclose(program["losses"], reference["loss"],
                               rtol=1e-5)
    for gs, ws in zip(program["grads"], reference["grads"]):
        for g, w in zip(gs, ws):
            assert float(w.abs().sum()) > 0
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-3,
                                       atol=1e-4 * float(w.abs().max()))
    for g, w, p0 in zip(program["params"][-1], reference["params"][-1],
                        program["params"][0]):
        assert float((w - p0).abs().max()) > 0
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=1e-3 * _traffic()["lr"])
    got = _compare(program, reference)
    for k in ("loss_gap", "grad_err", "step_err"):
        assert got[k] < 1e-3 * LIMITS[k], (k, got)


def test_the_blockwise_sum_is_the_whole_frames_gradient(scene):
    t = scene["t"]
    sc = ref.scene_of(scene["cfg"], SEED, torch.device("cpu"))
    s0 = ref.start(scene["cfg"], SEED)
    args = (sc, torch.tensor(s0["hdr"]), torch.tensor(s0["brdf"]),
            scene["ref_cams"][0], t["first_frame"], scene["targets"][0], SPP,
            W, H)
    whole = ref.loss_and_grads(*args, block_lanes=W * H * SPP)
    blocks = ref.loss_and_grads(*args, block_lanes=W * SPP * 5)
    assert blocks[0] == pytest.approx(whole[0], rel=1e-6)
    for b, w in zip(blocks[1:], whole[1:]):
        np.testing.assert_allclose(b.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-7 * float(w.abs().max()))


def test_an_hdri_gradient_one_texel_off_fails_grad_err(scene, reference):
    off = _program_steps(scene, grad_faults.hdr_texel_off)
    np.testing.assert_allclose(off["losses"][0], reference["loss"][0],
                               rtol=1e-5)
    assert _compare(off, reference)["grad_err"] > LIMITS["grad_err"]


def test_the_spans_and_counters_of_a_step(scene):
    """``opt.loss``, ``opt.backward`` and ``opt.update`` on the profiler's
    timeline; the gather counters count each lane whose gradient the
    backward pass scatters once (not again in the remat recompute): the
    MERL lookups of every bounce over the compact lanes, the HDRI fetch at
    full width and over the compact lanes."""
    from torch.profiler import ProfilerActivity, profile

    r = scene["r"]
    far = {"origin": [0.0, 0.0, 40.0], "yaw": 0.0, "pitch": 0.0,
           "fov_deg": 75.0}
    r.update_camera(**far)
    params = DeferredParams.from_scene(r.scene, hdr=True, brdf=True)
    for x in params.leaves():
        x.requires_grad_()
    step = deferred_opt_step(r.settings, torch.optim.Adam(params.leaves()),
                             scene=r.scene, seed=SEED, device="cpu")
    before = (brdf_ops.lookup_brdf.grad_lanes, envmap.sample_env.grad_lanes)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(params, r.scene, r.camera, scene["targets"][0], 3,
             r.fresnel_coef, r.fresnel_pow)
    names = {e.key for e in prof.key_averages()}
    assert {"opt.loss", "opt.backward", "opt.update"} <= names
    sc = c5.Scene(scene["cfg"], SEED, torch.device("cpu"))
    hits = c5.primary_hits(sc, far, W, H)
    assert 0 < hits < W * H
    lanes = (brdf_ops.lookup_brdf.grad_lanes - before[0],
             envmap.sample_env.grad_lanes - before[1])
    assert lanes == (r.settings.bounces * SPP * hits, SPP * (W * H + hits))
    # A render without gradients counts nothing.
    with torch.no_grad():
        render_pass(r.scene.replace(hdr=params.hdr, brdf=params.brdf),
                    r.settings, r.camera, 1, r.fresnel_coef, r.fresnel_pow,
                    SEED)
    assert (brdf_ops.lookup_brdf.grad_lanes - before[0],
            envmap.sample_env.grad_lanes - before[1]) == lanes
