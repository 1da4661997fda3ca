"""PyTorch port: progressive state, checkpoint/resume and the JSONL metrics
log against the JAX package, on the CPU.

* ``checkpoint_state`` holds the JAX ``checkpoint_state``'s keys and values
  for the same renderer state;
* a 6-pass render stopped after 3 (save, a new ``Renderer``, restore) is
  bitwise the uninterrupted one;
* the scheduler's metrics lines carry the JAX scheduler's fields, event by
  event, through a checkpointed run and its resume; a corrupt checkpoint
  is logged and the render starts afresh.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tests.test_mesh_render import write_uv_sphere
import vrenderer_pathtracer_tpu as jvpt
from vrenderer_pathtracer_tpu.render import progressive as jprog
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.render import progressive as prog
from vrenderer_pathtracer_tpu_torch.utils.metrics import MetricsLogger

CORNELL = dict(use_cornell_box=True, has_hdr=False, samples_per_pass=2,
               bounces=2)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_checkpoint_state_matches_jax():
    rng = np.random.default_rng(0)
    accum = rng.uniform(0, 3, (8 * 6, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (8 * 6,)).astype(np.float32)
    states = []
    for pkg, kw in ((jvpt, {}), (vpt, dict(device="cpu"))):
        r = pkg.Renderer(8, 6, settings=pkg.RenderSettings(**CORNELL), seed=7,
                         **kw)
        r.update_camera(origin=(1.0, 2.0, 90.0), yaw=0.1, pitch=-0.2,
                        fov_deg=60.0)
        r.set_fresnel_coef(0.3)
        r.set_fresnel_power(2.5)
        wrap = jnp.asarray if pkg is jvpt else torch.from_numpy
        r._accum, r.frame, r._last_depth = wrap(accum), 4, wrap(depth)
        mod = jprog if pkg is jvpt else prog
        states.append(_leaves(mod.checkpoint_state(r)))
    got, want = states
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert int(got["frame"]) == 4 and int(got["seed"]) == 7


@pytest.fixture(scope="module")
def textured(tmp_path_factory):
    p = tmp_path_factory.mktemp("prog") / "s.obj"
    write_uv_sphere(p, 14.0, 12, 16)
    rng = np.random.default_rng(2)
    maps = [rng.uniform(0.1, 1, (16, 16, 3)).astype(np.float32),
            (rng.uniform(0, 1, (16, 16, 3)) * 0.2
             + (0.4, 0.4, 0.8)).astype(np.float32),
            rng.uniform(0, 1, (16, 16, 3)).astype(np.float32)]
    sky = rng.uniform(0, 1.5, (8, 16, 3)).astype(np.float32)

    def make():
        r = vpt.Renderer(24, 16, settings=vpt.RenderSettings(
            samples_per_pass=1, bounces=3), seed=3, device="cpu")
        r.load_mesh(str(p))
        for kind, m in enumerate(maps):
            r.load_texture(m, 2.2, kind)
        r.load_hdr(sky)
        r.update_camera(origin=(0.0, 1.0, 40.0), yaw=0.05)
        r.set_fresnel_coef(0.2)
        return r

    return make


def test_resumed_render_is_bitwise_the_uninterrupted_one(textured, tmp_path):
    whole = textured()
    img, depth = whole.render_frames(6)
    part = textured()
    part.render_frames(3)
    prog.save_checkpoint(part, tmp_path / "ck")
    again = textured()
    again.set_fresnel_coef(0.5)  # overwritten by the restore
    prog.restore_checkpoint(again, tmp_path / "ck")
    assert again.get_frame_count() == 4 and again.samples_per_pixel == 3
    img2, depth2 = again.render_frames(3)
    assert np.array_equal(img, img2) and np.array_equal(depth, depth2)
    assert torch.equal(whole._accum, again._accum)
    assert again.get_frame_count() == whole.get_frame_count() == 7


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_scheduler_metrics_carry_jax_fields(tmp_path):
    logs = {}
    for name, pkg, mod, kw in (("jax", jvpt, jprog, {}),
                               ("port", vpt, prog, dict(device="cpu"))):
        log = tmp_path / f"{name}.jsonl"
        for target in (4, 6):
            r = pkg.Renderer(8, 8, settings=pkg.RenderSettings(**CORNELL), **kw)
            passes = []
            sched = mod.ProgressiveScheduler(
                r, target_spp=target, checkpoint_dir=str(tmp_path / name),
                checkpoint_every=1, metrics_path=str(log),
                on_pass=lambda i, spp: passes.append((i, spp)))
            assert sched.resume_if_possible() == (target == 6)
            img, depth = sched.run()
            assert r.samples_per_pixel == target
            assert passes == ([(1, 2), (2, 4)] if target == 4 else [(1, 6)])
            assert img.shape == (8, 8, 3) and depth.shape == (8, 8)
        logs[name] = _events(log)
    shape = [(e["event"], sorted(e)) for e in logs["jax"]]
    assert [(e["event"], sorted(e)) for e in logs["port"]] == shape
    assert [e["event"] for e in logs["port"]] == [
        "pass", "checkpoint", "pass", "checkpoint", "done", "resumed", "pass",
        "checkpoint", "done"]
    for j, p in zip(logs["jax"], logs["port"]):
        for k in ("idx", "spp", "frame"):
            assert j.get(k) == p.get(k)


def test_corrupt_checkpoint_starts_afresh(tmp_path, capsys):
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "latest").write_bytes(b"half a checkpoint")
    r = vpt.Renderer(8, 8, settings=vpt.RenderSettings(**CORNELL), device="cpu")
    sched = prog.ProgressiveScheduler(r, target_spp=2, checkpoint_dir=str(ck),
                                      metrics_path=str(tmp_path / "m.jsonl"))
    assert not sched.resume_if_possible()
    assert "starting fresh" in capsys.readouterr().err
    assert r.get_frame_count() == 1
    sched.run()
    events = _events(tmp_path / "m.jsonl")
    assert [e["event"] for e in events] == ["resume_failed", "pass", "done"]
    assert "error" in events[0]


def test_metrics_logger_coerces_values(tmp_path):
    p = tmp_path / "sub" / "m.jsonl"
    with MetricsLogger(str(p)) as m:
        rec = m.log("x", a=torch.tensor(3.0), b=np.float32(0.5), c="s",
                    d=None, e=True, f=object.__new__(object))
    assert rec["a"] == 3 and isinstance(rec["a"], int) and rec["b"] == 0.5
    assert rec["c"] == "s" and rec["d"] is None and rec["e"] is True
    assert isinstance(rec["f"], str)
    (line,) = _events(p)
    assert {"event", "t", "wall"} <= set(line) and line["event"] == "x"
