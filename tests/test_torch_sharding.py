"""The port's sharded execution against the JAX package's (CPU).

The port's ranks run on gloo groups spawned by tests/test_torch_multihost.py
(1x1 in this process); the JAX side runs here on the 8-device CPU mesh of
tests/conftest.py.  Contracts:

* the shard offsets of the plain versions (K1's, K4's records, K2's): tiles
  reassemble the full frame bit for bit, a mid-row range included; sample
  halves average to the full pass within 1e-6;
* ``sharded_render_step`` on 1x1, 2x1, 1x2 and 2x2 groups against the
  port's single device (tiles bit for bit, sample shards within 1e-6) and
  against JAX ``sharded_render_step`` on its 2x2 mesh, under the contract
  tests/test_sharding.py holds JAX's sharded step to against one device
  (two programs: under 1% of elements off by more than 1e-5);
* ``Renderer(device_mesh=...)`` over four tiles with FXAA on the gathered
  frame: the one-device Renderer's frame bit for bit.

The sharded train steps are tests/test_torch_sharded_train.py's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.conftest import cpu_devices
from tests.test_torch_multihost import FC, FP, SETTINGS, hdr_table, spawn
import vrenderer_pathtracer_tpu as jvpt
from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.parallel import sharding as js
from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.ops.tonemap import tonemap
from vrenderer_pathtracer_tpu_torch.parallel import multihost, sharding
from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4
from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

SHAPES = ("1x1", "2x1", "1x2", "2x2")


def _settings(**kw):
    return vpt.RenderSettings(**{**SETTINGS, **kw})


def _jsettings(**kw):
    return jvpt.RenderSettings(**{**SETTINGS, **kw})


def _port_scene(hdr: bool):
    s = _settings(use_cornell_box=False, has_hdr=True) if hdr else _settings()
    scene = Scene.analytic(s, "cpu")
    return s, scene.replace(hdr=torch.from_numpy(hdr_table())) if hdr else scene


@pytest.fixture
def one_rank_group(tmp_path):
    """A one-process gloo group (``multihost.initialize`` on a file under
    ``tmp_path``), torn down after the test so that the worker's other
    tests see none."""
    import torch.distributed as dist

    multihost.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0,
                         backend="gloo")
    yield
    dist.destroy_process_group()


# --- the offsets of the plain versions --------------------------------------

RANGES = [(0, 128), (128, 128), (256, 256)]      # (offset, n): 32x16
MID_ROW = [(0, 100), (100, 200), (300, 212)]     # ranges that start mid-row


@pytest.mark.parametrize("ranges", [RANGES, MID_ROW])
def test_k1_plain_offsets_reassemble_the_frame(ranges):
    s = _settings()
    scene, cam = Scene.analytic(s, "cpu"), Camera.default("cpu")
    full = k1.render_pass_cuda(scene, s, cam, 2, FC, FP)
    parts = [k1.render_pass_cuda(scene, s, cam, 2, FC, FP, pixel_offset=o,
                                 n_local_pixels=n) for o, n in ranges]
    for got, want in zip(zip(*parts), full):
        assert torch.equal(torch.cat(got), want)
    # Two sample halves: their mean is the full pass, the last half's depth
    # the full pass's.
    half = s.replace(samples_per_pass=2)
    a, b = (k1.render_pass_cuda(scene, half, cam, 2, FC, FP, sample_offset=o)
            for o in (0, 2))
    torch.testing.assert_close((a[0] + b[0]) / 2, full[0], rtol=1e-6, atol=1e-6)
    assert torch.equal(b[1], full[1])
    # A range outside the frame is refused.
    with pytest.raises(ValueError, match="not in the frame"):
        k1.render_pass_cuda(scene, s, cam, 2, FC, FP, pixel_offset=500,
                            n_local_pixels=100)


def test_k4_plain_records_take_a_shards_place():
    """K4's plain version (records_reference) on the example sphere under
    an HDRI: tiles, a mid-row range among them, are the full records'
    columns bit for bit; a sample shard's records are the full pass's
    samples from its offset on."""
    s = vpt.RenderSettings(width=24, height=16, samples_per_pass=2, bounces=3,
                           use_cornell_box=False, use_example_sphere=True)
    scene = Scene.analytic(s, "cpu").replace(hdr=torch.from_numpy(hdr_table()))
    s = vpt.scene.scene.settings_for_scene(scene, s)
    cam = Camera.default("cpu").replace(origin=torch.tensor([0.0, 0.0, 40.0]))
    args = (scene, s, cam, 1, FC, FP)
    full = k4.records_reference(*args)
    for off, n in ((0, 150), (150, 234)):
        got = k4.records_reference(*args, pixel_offset=off, n_local_pixels=n)
        assert torch.equal(got, full[:, off:off + n])
        rgb, depth = k4.render_pass_mesh(*args, pixel_offset=off,
                                         n_local_pixels=n)
        frgb, fdepth = k4.compose(full, scene, s)
        assert torch.equal(rgb, frgb[off:off + n])
        assert torch.equal(depth, fdepth[off:off + n])
    one = s.replace(samples_per_pass=1)
    idx, _ = k4.layout(s)
    idx1, n1 = k4.layout(one)
    second = k4.records_reference(scene, one, cam, 1, FC, FP, sample_offset=1)
    for key, k in idx1.items():
        if key[0] not in ("depth", "rgb"):
            w = {"A": 3, "E": 3, "dir": 3, "uv": 2, "midx": 1}[key[0]]
            src = idx[(key[0], 1, key[2])]
            assert torch.equal(second[k:k + w], full[src:src + w]), key
    assert torch.equal(second[0], full[0])


def test_k2_plain_tile_sums_add_up_to_the_frame():
    """K2's plain version on two tiles (one starts mid-row): the losses and
    gradients, each with the frame's normaliser, sum to the frame's."""
    s = _settings()
    scene, cam = Scene.analytic(s, "cpu"), Camera.default("cpu")
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 0.5, (s.n_pixels, 3)).astype(np.float32))
    full = k2.cornell_loss_grads(scene, s, cam, target, 1, FC, FP,
                                 with_camera=True)
    parts = [k2.cornell_loss_grads(scene, s, cam, target[o:o + n], 1, FC, FP,
                                   with_camera=True, pixel_offset=o,
                                   n_local_pixels=n)
             for o, n in ((0, 200), (200, 312))]
    for i in range(5):
        torch.testing.assert_close(parts[0][i] + parts[1][i], full[i],
                                   rtol=1e-5, atol=1e-7)
    for a, b, want in zip(parts[0][5].__dict__.values(),
                          parts[1][5].__dict__.values(),
                          full[5].__dict__.values()):
        torch.testing.assert_close(a + b, want, rtol=1e-4, atol=1e-7)


# --- the sharded render step -------------------------------------------------

@pytest.fixture(scope="module")
def port_render(tmp_path_factory):
    """Gathered (accum, img, depth) of every shape and scene (1x1 is run in
    the test's own process): 2x1 and 1x2 on two ranks, 2x2 on four, and on
    four ranks the Renderer over four tiles with FXAA."""
    out = tmp_path_factory.mktemp("render")
    spawn("render", 2, out, "2x1", "1x2")
    spawn("render", 4, out, "2x2")
    got = {}
    for scene in ("cornell", "hdr"):
        for shape in SHAPES[1:]:
            got[scene, shape] = [np.load(out / f"{scene}_{shape}_{f}_0.npy")
                                 for f in ("accum", "img", "depth")]
    got["renderer"] = [np.load(out / f"renderer_{f}_{rank}.npy")
                       for f, rank in (("img", 0), ("depth", 3))]
    return got


@pytest.fixture(scope="module")
def jax_render():
    """JAX ``sharded_render_step`` on its 2x2 CPU mesh, the Cornell scene."""
    s = _jsettings()
    scene = JScene.analytic(s)
    mesh = js.make_render_mesh(n_tiles=2, n_samples=2, devices=cpu_devices()[:4])
    step = js.sharded_render_step(mesh, s, scene=scene)
    accum = js.shard_pixels(mesh, jnp.zeros((s.n_pixels, 3), jnp.float32))
    return [np.asarray(x) for x in step(
        js.replicate(mesh, scene), js.replicate(mesh, JCamera.default()),
        accum, jnp.uint32(1), jnp.float32(FC), jnp.float32(FP))]


def test_make_render_mesh_needs_a_process_group():
    """The mesh never starts a group itself: ``multihost.initialize`` does,
    for one process too."""
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="multihost.initialize"):
        sharding.make_render_mesh(1, 1, "cpu")


@pytest.mark.parametrize("scene", ["cornell", "hdr"])
def test_sharded_render_step_matches_single_device_and_jax(
        scene, port_render, jax_render, one_rank_group):
    s, sc = _port_scene(scene == "hdr")
    cam = Camera.default("cpu")
    rgb, depth = vpt.render.integrator.render_camera_pass(sc, s, cam, 1, FC, FP)
    # 1x1 here, in this process's one-rank group.
    mesh = sharding.make_render_mesh(1, 1, "cpu")
    step = sharding.sharded_render_step(mesh, s, scene=sc)
    accum, img, d = step(sc, cam, torch.zeros((s.n_pixels, 3)), 1,
                         torch.tensor(FC), torch.tensor(FP))
    got = {**port_render, (scene, "1x1"): [x.numpy() for x in (accum, img, d)]}
    for shape in SHAPES:
        accum, img, d = got[scene, shape]
        if shape.endswith("x1"):       # tiles only: bit for bit
            np.testing.assert_array_equal(accum, rgb.numpy())
        else:                          # sample shards: the mean's order
            np.testing.assert_allclose(accum, rgb.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(d, depth.numpy())
        np.testing.assert_array_equal(
            img, tonemap(torch.from_numpy(accum), 1, s.gamma).numpy())
        if scene == "cornell":
            jaccum, _, jdepth = jax_render
            diff = np.abs(accum - jaccum)
            assert (diff > 1e-5).mean() < 0.01 and diff.max() < 0.05, shape
            np.testing.assert_allclose(d, jdepth, atol=5e-4)


def test_renderer_with_device_mesh_applies_fxaa_to_the_gathered_frame(
        port_render):
    """Four tiles, two passes, FXAA on the gathered frame (it reads across
    the tile edges): the one-device Renderer's frame bit for bit, on every
    rank."""
    r = vpt.Renderer(32, 16, settings=_settings(use_fxaa=True), device="cpu")
    img, depth = r.render_frames(2)
    got_img, got_depth = port_render["renderer"]
    np.testing.assert_array_equal(got_img, img)
    np.testing.assert_array_equal(got_depth, depth)


