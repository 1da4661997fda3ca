"""The port's multi-process execution over torch.distributed (gloo, CPU).

Mirrors tests/test_multiprocess.py: two REAL processes join one gloo group
through ``multihost.initialize``, render one sharded Cornell pass on a 2x1
mesh, and check that

* ``gather_image`` gives both processes the same full frame;
* ``local_shard`` / ``local_tile_bounds`` round-trip against it (inside the
  ranks), the tiles disjoint and covering the frame;
* the two-process frame equals the port's one-process ``Renderer``
  bitwise: tile sharding never changes arithmetic.

This file imports torch and the port only (no jax), because it also holds
the rank programs that the sharding tests spawn (``spawn``): each rank
runs ``python -m tests.test_torch_multihost <program> <init> <world>
<rank> <out_dir>``, meets the others through a ``FileStore`` under the
test's ``tmp_path`` (never a fixed port: several test workers run at
once), and writes what it computed as ``.npy`` files.  A group that does
not finish within ``TIMEOUT_S`` is killed and fails its test.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 60

CORNELL = dict(use_cornell_box=True, has_hdr=False)
SETTINGS = dict(width=32, height=16, samples_per_pass=4, bounces=2, **CORNELL)
FC, FP, LR = 0.1, 3.0, 0.05


def spawn(program: str, world: int, tmp_path, *args) -> None:
    """Run ``program`` on ``world`` ranks of a fresh gloo group; fail the
    test if any rank fails or the group outlives ``TIMEOUT_S``."""
    start(program, world, tmp_path, *args)()


def start(program: str, world: int, tmp_path, *args):
    """Start ``program`` on ``world`` ranks of a fresh gloo group; returns
    ``wait()``, which fails the test if any rank fails or the group
    outlives ``TIMEOUT_S`` from its start."""
    store = tmp_path / f"store_{program}_{world}"
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_multihost", program,
         f"file://{store}", str(world), str(rank), str(tmp_path),
         *map(str, args)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for rank in range(world)]
    deadline = time.monotonic() + TIMEOUT_S

    def wait():
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(
                    timeout=max(deadline - time.monotonic(), 0.1))
                outs.append(out.decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.communicate()
            pytest.fail(f"{program}: {world} ranks did not finish in "
                        f"{TIMEOUT_S} s")
        for rank, p in enumerate(procs):
            assert p.returncode == 0, \
                f"{program} rank {rank} failed:\n{outs[rank]}"

    return wait


# --- rank programs (run in the spawned processes) ---------------------------

def _settings(**kw):
    import vrenderer_pathtracer_tpu_torch as vpt

    return vpt.RenderSettings(**{**SETTINGS, **kw})


def hdr_table():
    """The trainable environment map of the HDRI cases, from a seed."""
    return np.random.default_rng(5).uniform(0.2, 1.0, (8, 16, 3)).astype(
        np.float32)


def hdr_scene():
    """The open scene (no Cornell box) under :func:`hdr_table`."""
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

    s = _settings(use_cornell_box=False, has_hdr=True)
    return s, Scene.analytic(s, "cpu").replace(hdr=torch.from_numpy(hdr_table()))


def _save(out, name, rank, x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    np.save(out / f"{name}_{rank}.npy", np.asarray(x))


def _pass(mesh, settings, scene, camera):
    """One sharded pass from a zero accumulation; the gathered
    ``(accum, img, depth)``."""
    from vrenderer_pathtracer_tpu_torch.parallel import (
        multihost, replicate, shard_pixels, sharded_render_step)

    step = sharded_render_step(mesh, settings, scene=scene)
    accum = shard_pixels(mesh, torch.zeros((settings.n_pixels, 3)))
    accum, img, depth = step(*replicate(mesh, (scene, camera)), accum, 1,
                             torch.tensor(FC), torch.tensor(FP))
    return [multihost.gather_image(x, mesh) for x in (accum, img, depth)]


def rank_gather(out, rank):
    """test_two_process_render_and_gather's rank."""
    import vrenderer_pathtracer_tpu_torch as vpt
    from vrenderer_pathtracer_tpu_torch.ops.tonemap import tonemap
    from vrenderer_pathtracer_tpu_torch.parallel import make_render_mesh, multihost

    mesh = make_render_mesh(2, 1, "cpu")
    s = _settings(width=16, height=16, samples_per_pass=2)
    r = vpt.Renderer(16, 16, settings=s, device="cpu", device_mesh=mesh)
    img, depth = r.render()
    assert img.shape == (16, 16, 3) and r._accum.shape == (128, 3)
    tile = tonemap(r._accum, 1, s.gamma)
    full = multihost.gather_image(tile, mesh)
    assert torch.equal(full, img.reshape(-1, 3))
    local = multihost.local_shard(tile)
    start, stop = multihost.local_tile_bounds(tile, mesh)
    np.testing.assert_array_equal(full.numpy()[start:stop], local)
    _save(out, "full", rank, full)
    _save(out, "depth", rank, depth)
    (out / f"bounds_{rank}.txt").write_text(f"{start} {stop}")


def rank_render(out, rank, *shapes):
    """sharded_render_step on every mesh shape given (``2x1`` ...), on the
    Cornell scene and the open HDRI scene; on four ranks also the Renderer
    over four tiles with FXAA on the gathered frame."""
    import vrenderer_pathtracer_tpu_torch as vpt
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.parallel import make_render_mesh
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

    cam = Camera.default("cpu")
    s = _settings()
    scenes = {"cornell": (s, Scene.analytic(s, "cpu")), "hdr": hdr_scene()}
    for shape in shapes:
        n_tiles, n_samples = map(int, shape.split("x"))
        mesh = make_render_mesh(n_tiles, n_samples, "cpu")
        for name, (settings, scene) in scenes.items():
            for field, x in zip(("accum", "img", "depth"),
                                _pass(mesh, settings, scene, cam)):
                _save(out, f"{name}_{shape}_{field}", rank, x)
    if int(os.environ["WORLD_SIZE"]) == 4:
        r = vpt.Renderer(32, 16, settings=_settings(use_fxaa=True),
                         device="cpu", device_mesh=make_render_mesh(4, 1, "cpu"))
        for _ in range(2):
            img, depth = r.render()
        assert r.get_frame_count() == 3
        _save(out, "renderer_img", rank, img)
        _save(out, "renderer_depth", rank, depth)


def rank_train(out, rank):
    """The 2x2 (and 4x1) train steps and optimiser steps."""
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.parallel import (
        DeferredParams, TrainParams, make_render_mesh, replicate,
        shard_pixels, sharded_deferred_opt_step, sharded_opt_step,
        sharded_train_step, sharding)
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

    cam = Camera.default("cpu")
    m22 = make_render_mesh(2, 2, "cpu")
    m41 = make_render_mesh(4, 1, "cpu")

    # SGD: the gradients recovered from one step, camera and HDRI trained
    # (the wavefront route), and on the Cornell scene (K2's route on 4x1,
    # the wavefront's sample-mean form on 2x2).
    s_hdr, scene_hdr = hdr_scene()
    s = _settings()
    scene = Scene.analytic(s, "cpu")
    zeros = torch.zeros((s.n_pixels, 3))
    cases = {
        "hdr_2x2": (m22, s_hdr, scene_hdr, TrainParams.from_scene(
            scene_hdr, camera=cam, optimize_hdr=True)),
        "cornell_2x2": (m22, s, scene, TrainParams.from_scene(scene)),
        "cornell_4x1": (m41, s, scene, TrainParams.from_scene(scene)),
    }
    for name, (mesh, settings, sc, p0) in cases.items():
        step = sharded_train_step(mesh, settings, lr=LR, with_metrics=True)
        p1, metrics = step(replicate(mesh, p0), replicate(mesh, sc),
                           replicate(mesh, cam), shard_pixels(mesh, zeros), 1)
        for i, (a, b) in enumerate(zip(p0.leaves(), p1.leaves())):
            _save(out, f"{name}_grad{i}", rank, (a - b) / LR)
        _save(out, f"{name}_loss", rank, metrics["loss"])

    # The in-backward reduction equals the reduction after the backward.
    mesh, settings, sc, p0 = cases["hdr_2x2"]
    sh = sharding._shard(mesh, settings)
    tile = shard_pixels(mesh, zeros)
    got = []
    for in_bwd in (True, False):
        leaves = [t.detach().requires_grad_() for t in p0.leaves()]
        p = p0.with_leaves(leaves)
        if in_bwd:
            p = sharding.allreduce_grads_in_bwd(p, mesh)
        loss = sharding._train_loss(p, sc, settings, cam, tile, 1, 0, sh)
        grads = torch.autograd.grad(loss, leaves)
        got.append(grads if in_bwd else [sharding.reduce_grad(g, 2)
                                         for g in grads])
    for a, b in zip(*got):
        assert torch.equal(a, b)

    # Adam on the albedo towards the true image of the open HDRI scene,
    # from +0.2.
    target = torch.from_numpy(np.load(out / "hdr_target.npy"))
    p = TrainParams.from_scene(scene_hdr)
    p = TrainParams(torch.clamp(p.color + 0.2, 0, 1), p.emission,
                    p.fresnel_coef, p.fresnel_pow)
    p.color.requires_grad_()
    step = sharded_opt_step(m41, s_hdr, torch.optim.Adam([p.color], lr=0.05))
    losses = [float(step(p, scene_hdr, cam, shard_pixels(m41, target), 5 + i)[
        1]["loss"]) for i in range(6)]
    _save(out, "adam_losses", rank, np.array(losses))

    # The deferred HDRI: one SGD(1.0) step's gradient on 2x2, then Adam.
    target = torch.from_numpy(np.load(out / "hdr_target.npy"))
    scene_d = Scene.analytic(s_hdr, "cpu").replace(
        hdr=torch.from_numpy(hdr_table()))
    tile = shard_pixels(m22, target)
    for opt_name in ("sgd", "adam"):
        d = DeferredParams(hdr=torch.clamp(scene_d.hdr + 0.3, min=0))
        d.hdr.requires_grad_()
        opt = (torch.optim.SGD([d.hdr], lr=1.0) if opt_name == "sgd"
               else torch.optim.Adam([d.hdr], lr=0.3))
        step = sharded_deferred_opt_step(m22, s_hdr, opt, scene=scene_d)
        before = d.hdr.detach().clone()
        losses = []
        for i in range(1 if opt_name == "sgd" else 6):
            losses.append(float(step(d, scene_d, cam, tile, 5 + i, FC, FP)[1][
                "loss"]))
        if opt_name == "sgd":
            _save(out, "deferred_grad", rank, before - d.hdr.detach())
        _save(out, f"deferred_{opt_name}_losses", rank, np.array(losses))


def rank_cli(out, rank):
    """``render --cpu --tiles 2`` as under torchrun (WORLD_SIZE, RANK)."""
    from vrenderer_pathtracer_tpu_torch import cli

    os.environ["RANK"] = str(rank)
    cli.main(CLI_ARGS + ["--tiles", "2", "--out", str(out / "two.png"),
                         "--out-exr", str(out / "two.exr"),
                         "--depth-out", str(out / "two_depth.png")])


CLI_ARGS = ["render", "--cpu", "--cornell", "--width", "16", "--height", "8",
            "--spp", "4", "--bounces", "2", "--quiet"]
PROGRAMS = {"gather": rank_gather, "render": rank_render, "train": rank_train,
            "cli": rank_cli}


def _rank_main(argv) -> int:
    program, init, world, rank, out, *args = argv
    from vrenderer_pathtracer_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    os.environ["WORLD_SIZE"] = world
    multihost.initialize(init, int(world), int(rank), backend="gloo")
    PROGRAMS[program](pathlib.Path(out), int(rank), *args)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    return 0


# --- tests ------------------------------------------------------------------

def test_initialize_is_a_no_op_for_one_process_without_an_address():
    import torch.distributed as dist

    from vrenderer_pathtracer_tpu_torch.parallel import multihost

    was = dist.is_initialized()
    multihost.initialize()
    multihost.initialize(num_processes=1)
    assert dist.is_initialized() == was
    tile = torch.arange(6.0).reshape(3, 2)
    if not was:
        assert multihost.gather_image(tile) is tile
        assert multihost.local_tile_bounds(tile) == (0, 3)
    np.testing.assert_array_equal(multihost.local_shard(tile), tile.numpy())


def test_two_process_render_and_gather(tmp_path):
    import vrenderer_pathtracer_tpu_torch as vpt

    spawn("gather", 2, tmp_path)
    full0, full1 = (np.load(tmp_path / f"full_{i}.npy") for i in range(2))
    np.testing.assert_array_equal(full0, full1)
    bounds = {tuple(map(int, (tmp_path / f"bounds_{i}.txt").read_text().split()))
              for i in range(2)}
    assert bounds == {(0, 128), (128, 256)}
    # Bitwise the one-process Renderer: tiles never change arithmetic.
    r = vpt.Renderer(16, 16, settings=_settings(width=16, height=16,
                                                samples_per_pass=2),
                     device="cpu")
    img, depth = r.render()
    np.testing.assert_array_equal(full0, img.reshape(-1, 3).numpy())
    np.testing.assert_array_equal(np.load(tmp_path / "depth_1.npy"),
                                  depth.numpy())


def test_cli_tiles_under_a_two_process_world(tmp_path, monkeypatch):
    """Two ranks of ``render --tiles 2``: rank 0 alone writes, and its PNG,
    EXR and depth PNG are the one-process run's byte for byte."""
    from vrenderer_pathtracer_tpu_torch import cli

    spawn("cli", 2, tmp_path)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cli.main(CLI_ARGS + ["--out", str(tmp_path / "one.png"),
                         "--out-exr", str(tmp_path / "one.exr"),
                         "--depth-out", str(tmp_path / "one_depth.png")])
    for a, b in (("two.png", "one.png"), ("two.exr", "one.exr"),
                 ("two_depth.png", "one_depth.png")):
        assert (tmp_path / a).read_bytes() == (tmp_path / b).read_bytes(), a


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1:]))
