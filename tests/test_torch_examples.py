"""PyTorch port: the example scripts (``vrenderer_pathtracer_tpu_torch/
examples/``) on the CPU at 32x32 with a few steps, as tests/test_examples.py
runs the JAX package's.

* ``inverse_rendering``: its PNG and ``train_step`` metrics lines, and its
  first Adam step's loss and gradients against the JAX package's op-by-op
  loss for the same perturbed parameters, frame and target, at
  tests/test_torch_sharded_train.py's tolerances;
* ``envmap_recovery``: its PNG, a falling sun-disc error, its ground-truth
  HDRI and sun-disc mask against those the JAX package's example builds,
  and its first step's loss and HDRI gradient against the JAX package's
  ``sharded_deferred_opt_step`` on the port's target, at
  tests/test_torch_sharded_train.py's tolerances;
* ``config5``: ``synth_assets`` writes the OBJ, EXR and MERL files of the
  JAX package's ``synth_assets`` byte for byte; ``main`` renders a small
  paged sphere with FXAA and takes the MERL and HDRI gradients;
* ``bench_paged --cpu``: a mesh line and three well-formed regime lines.
"""

import importlib.util
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from tests.conftest import cpu_devices
import vrenderer_pathtracer_tpu as jvpt
from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.core.camera import generate_rays, pixel_ids
from vrenderer_pathtracer_tpu.parallel import sharding as js
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
from vrenderer_pathtracer_tpu.scene import scene as jscene
from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
from vrenderer_pathtracer_tpu_torch.examples import (
    bench_paged, config5, envmap_recovery, inverse_rendering)


@pytest.fixture(autouse=True)
def _one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)


def _jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    path = pathlib.Path(jvpt.__path__[0]).parent / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_first_step(got, size=32, spp=2):
    """JAX's op-by-op loss and gradients at the example's first step: the
    perturbed parameters (numpy ``default_rng(0)`` on the true ones), frame
    100, the port's target."""
    s = jvpt.RenderSettings(width=size, height=size, samples_per_pass=spp,
                            bounces=4, use_cornell_box=True, has_hdr=False)
    scene = JScene.analytic(s)
    true = js.TrainParams.from_scene(scene)
    rng = np.random.default_rng(0)

    def perturb(x):
        x = np.asarray(x, np.float32)
        return jnp.asarray(np.clip(x + rng.uniform(-0.25, 0.25, x.shape), 0.0,
                                   None))

    p0 = true._replace(color=perturb(true.color),
                       emission=perturb(true.emission),
                       fresnel_coef=jnp.float32(0.4),
                       fresnel_pow=jnp.float32(1.5))
    target = jnp.asarray(got["target"])
    cam = JCamera.default()

    def loss_fn(p):
        rgb, _ = j_render_pass(js._apply_params(scene, p), s,
                               *generate_rays(cam, size, size),
                               pixel_ids(size, size), jnp.uint32(100),
                               p.fresnel_coef, p.fresnel_pow)
        return jnp.sum((rgb - target) ** 2) / (s.n_pixels * 3)

    # Op by op, as tests/test_torch_sharded_train.py holds Cornell losses.
    return jax.value_and_grad(loss_fn)(p0)


def test_inverse_rendering_example(tmp_path):
    out, metrics = tmp_path / "rec.png", tmp_path / "m.jsonl"
    got = inverse_rendering.main([
        "--size", "32", "--spp", "2", "--steps", "6", "--lr", "0.1",
        "--out", str(out), "--metrics", str(metrics), "--cpu"])
    assert out.exists()
    events = [json.loads(line) for line in metrics.read_text().splitlines()]
    assert [e["event"] for e in events] == ["train_step", "train_step"]
    assert [e["step"] for e in events] == [0, 5]
    assert all(np.isfinite([got["rec_mse"], got["true_mse"], got["err_fc"]]))
    loss, g = _jax_first_step(got)
    np.testing.assert_allclose(got["first_step"]["loss"], float(loss), rtol=1e-3)
    assert events[0]["loss"] == pytest.approx(got["first_step"]["loss"])
    want = (g.color, g.emission, g.fresnel_coef, g.fresnel_pow)
    for mine, theirs in zip(got["first_step"]["grads"], want):
        np.testing.assert_allclose(mine, np.asarray(theirs), rtol=2e-2, atol=2e-3)


class _SceneBuilt(Exception):
    """Raised where the JAX example builds its scene, with its arguments."""


def _jax_envmap_scene(monkeypatch, eh, ew):
    """The spheres and ground-truth HDRI that the JAX package's
    ``examples/envmap_recovery.py`` builds its scene from (its ``main`` is
    stopped there)."""
    def built(**kw):
        raise _SceneBuilt(kw)

    example = _jax_example("envmap_recovery")
    with monkeypatch.context() as m:
        m.setattr(jscene, "Scene", built)
        m.setattr(sys, "argv", ["envmap_recovery.py", "--env", str(eh), str(ew)])
        with pytest.raises(_SceneBuilt) as info:
            example.main()
    return info.value.args[0]


def test_envmap_recovery_example(tmp_path, monkeypatch):
    out = tmp_path / "env.png"
    got = envmap_recovery.main([
        "--size", "32", "--spp", "2", "--steps", "4", "--env", "8", "16",
        "--out", str(out), "--cpu"])
    assert out.exists()
    assert got["backend"] == "torch" and np.isfinite(got["loss"])
    assert got["sun_err"] < got["sun_err_init"]

    kw = _jax_envmap_scene(monkeypatch, 8, 16)
    truth, mask = envmap_recovery.ground_truth(8, 16)
    assert truth.tobytes() == np.asarray(kw["hdr"]).tobytes()
    np.testing.assert_array_equal(mask, (truth == (6.0, 5.5, 5.0)).all(-1))
    assert mask.sum() > 0

    # The first step, as JAX's deferred step takes it on the port's target:
    # SGD(1.0) from the flat 0.5 guess at frame 2, whose update is the
    # gradient.
    scene = JScene(**kw)
    s = jscene.settings_for_scene(scene, jvpt.RenderSettings(
        width=32, height=32, samples_per_pass=2, bounces=3,
        use_cornell_box=False, has_hdr=True))
    mesh = js.make_render_mesh(n_tiles=1, n_samples=1, devices=cpu_devices()[:1])
    p0 = js.DeferredParams(hdr=jnp.full_like(scene.hdr, 0.5))
    sgd = optax.sgd(1.0)
    step = js.sharded_deferred_opt_step(mesh, s, sgd, scene=scene)
    p1, _, m = step(js.replicate(mesh, p0),
                    js.replicate(mesh, jax.device_get(sgd.init(jax.device_get(p0)))),
                    js.replicate(mesh, scene), js.replicate(mesh, JCamera.default()),
                    js.shard_pixels(mesh, jnp.asarray(got["target"])),
                    jnp.uint32(2), jnp.float32(0.1), jnp.float32(3.0))
    np.testing.assert_allclose(got["first_step"]["grad"],
                               np.asarray(p0.hdr - p1.hdr), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got["first_step"]["loss"], float(m["loss"]),
                               rtol=1e-3)
    assert np.abs(got["first_step"]["grad"][mask]).max() > 0


def test_config5_synth_assets_match_the_jax_example(tmp_path):
    jax_config5 = _jax_example("config5")
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    mine = config5.synth_assets(str(tmp_path / "port"), n_theta=12)
    theirs = jax_config5.synth_assets(str(tmp_path / "jax"), n_theta=12)
    for a, b in zip(mine, theirs):
        assert open(a, "rb").read() == open(b, "rb").read(), a


def test_config5_example(tmp_path):
    out = tmp_path / "c5.png"
    got = config5.main(["--size", "32", "32", "--sphere-theta", "16",
                        "--spp", "4", "--out", str(out), "--cpu"])
    assert out.exists()
    assert got["traversal"] == "torch" and got["passes"] == 2
    assert 0 < got["hit_frac"] < 1
    assert np.isfinite(got["loss"])
    assert got["g_brdf_abs"] > 0 and got["g_hdr_abs"] > 0


def test_bench_paged_cpu_prints_three_records(capsys):
    got = bench_paged.main(["--cpu", "--tris-theta", "12", "--iters", "2",
                            "--rays", "1024"])
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert lines[0]["device"] == "cpu" and lines[0]["pages"] >= 1
    assert [x["case"] for x in lines[1:]] == [
        "coherent", "shuffled", "shuffled_sorted"]
    for rec in lines[1:]:
        assert set(rec) == {"case", "mrays_per_s", "ms", "hitrate"}
        assert rec["ms"] > 0 and 0 <= rec["hitrate"] <= 1
        assert rec == got[rec["case"]]
    # Sorting reorders the search, not its answer.
    assert lines[2]["hitrate"] == lines[3]["hitrate"]
