"""PyTorch port: the ``render`` command of ``cli.py`` against the JAX
package's CLI, in-process on the CPU at 16x16.

The scene is BASELINE config 3 from its files, at test size: a UV-sphere
OBJ standing in for the bunny, diffuse, normal and specular PNGs, and a
PIZ-compressed EXR HDRI.  Both CLIs render it to ``--out``, ``--out-exr``,
``--depth-out`` and ``--metrics``; the PNGs agree under the outlier
contract of tests/test_config3_textured_mesh.py (at most 2% of pixels with
a max-channel error above 1e-3, mean at most 1e-4 over the rest).  A
render stopped at half its samples and resumed from ``--checkpoint-dir``
writes the uninterrupted render's files byte for byte.  Flags that do not
fit the run raise, and without ``--cpu`` ``render`` and ``view`` need a
card, as ``bench`` always does.
"""

import json
import runpy
import sys

import numpy as np
import pytest
import torch

from tests.test_mesh_render import write_uv_sphere
from vrenderer_pathtracer_tpu import cli as jcli
from vrenderer_pathtracer_tpu import io as jio
from vrenderer_pathtracer_tpu_torch import cli
from vrenderer_pathtracer_tpu_torch import io as tio


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    write_uv_sphere(d / "s.obj", 14.0, 12, 16)
    rng = np.random.default_rng(0)
    tio.write_exr(str(d / "sky.exr"),
                  rng.uniform(0, 1.5, (8, 16, 3)).astype(np.float32), "piz")
    maps = {"d": rng.uniform(0.1, 1, (16, 16, 3)),
            "n": rng.uniform(0, 1, (16, 16, 3)) * 0.2 + (0.4, 0.4, 0.8),
            "s": rng.uniform(0, 1, (16, 16, 3))}
    for name, m in maps.items():
        tio.save_png(str(d / f"{name}.png"), m, flip_y=False)
    args = ["render", "--cpu", "--width", "16", "--height", "16",
            "--samples-per-pass", "2", "--bounces", "3", "--seed", "5",
            "--mesh", str(d / "s.obj"), "--hdr", str(d / "sky.exr"),
            "--diffuse-map", str(d / "d.png"), "--normal-map", str(d / "n.png"),
            "--specular-map", str(d / "s.png"), "--camera", "0", "1", "40",
            "--fresnel-coef", "0.2", "--quiet"]
    return d, args


def _outputs(d, tag):
    return ["--out", str(d / f"{tag}.png"), "--out-exr", str(d / f"{tag}.exr"),
            "--depth-out", str(d / f"{tag}_depth.png"),
            "--metrics", str(d / f"{tag}.jsonl")]


def _events(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_render_matches_the_jax_cli(assets, tmp_path):
    _, args = assets
    assert cli.main(args + ["--spp", "4"] + _outputs(tmp_path, "port")) == 0
    assert jcli.main(args + ["--spp", "4"] + _outputs(tmp_path, "jax")) == 0
    got, want = (tio.load_image(str(tmp_path / f"{t}.png"))
                 for t in ("port", "jax"))
    assert got.shape == (16, 16, 3)
    err = np.abs(got - want).max(axis=-1)
    assert (err > 1e-3).mean() <= 0.02, f"{(err > 1e-3).mean():.3%} diverge"
    assert err[err <= 1e-3].mean() <= 1e-4
    assert got[4:12, 4:12].mean() > 0.05  # the mesh is lit
    ex, jex = (jio.load_exr(str(tmp_path / f"{t}.exr")) for t in ("port", "jax"))
    assert ex.shape == (16, 16, 3) and np.isfinite(ex).all()
    assert (np.abs(ex - jex).max(axis=-1) > 1e-2).mean() <= 0.02
    dp, jdp = (tio.load_image(str(tmp_path / f"{t}_depth.png"))
               for t in ("port", "jax"))
    assert (np.abs(dp - jdp).max(axis=-1) > 1e-2).mean() <= 0.02
    assert dp[8, 8, 0] > 0.0  # the centre ray hits
    port, jax_ = (_events(tmp_path / f"{t}.jsonl") for t in ("port", "jax"))
    assert [(e["event"], sorted(e)) for e in port] == [
        (e["event"], sorted(e)) for e in jax_]
    assert [e["event"] for e in port] == ["pass", "pass", "done"]


def test_resume_from_checkpoint_dir_is_bitwise(assets, tmp_path):
    _, args = assets
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "1"]
    assert cli.main(args + ["--spp", "8"] + _outputs(tmp_path, "whole")) == 0
    assert cli.main(args + ["--spp", "4"] + ck) == 0  # stopped at half
    assert (tmp_path / "ck" / "latest").is_file()
    assert cli.main(args + ["--spp", "8"] + ck + _outputs(tmp_path, "resumed")) == 0
    for suffix in (".png", ".exr", "_depth.png"):
        assert ((tmp_path / f"whole{suffix}").read_bytes()
                == (tmp_path / f"resumed{suffix}").read_bytes()), suffix
    events = [e["event"] for e in _events(tmp_path / "resumed.jsonl")]
    assert events == ["resumed", "pass", "checkpoint", "pass", "checkpoint",
                      "done"]


@pytest.mark.parametrize("argv,error,match", [
    # One process: shard counts other than 1 x 1 do not fit its world.
    (["render", "--cpu", "--tiles", "2"], ValueError, "world size is 1"),
    (["render", "--cpu", "--sample-shards", "2"], ValueError, "world size is 1"),
    (["view", "--cpu", "--headless", "--tiles", "2"], ValueError,
     "world size is 1"),
    # The bench runs on the card only.
    (["bench"], RuntimeError, "no CUDA device"),
])
def test_unported_flags_and_commands_raise(argv, error, match, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(error, match=match):
        cli.main(argv + (["--width", "4", "--height", "4"]
                         if argv[0] != "bench" else []))


def test_render_without_cpu_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["render", "--width", "4", "--height", "4", "--quiet"])


def test_view_without_cpu_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["view", "--width", "4", "--height", "4", "--headless",
                  "--passes", "1"])


def test_python_dash_m_runs_the_cli(assets, tmp_path, monkeypatch):
    _, args = assets
    out = tmp_path / "m.png"
    monkeypatch.setattr(sys, "argv", ["vrenderer_pathtracer_tpu_torch", *args,
                                      "--spp", "2", "--out", str(out)])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("vrenderer_pathtracer_tpu_torch", run_name="__main__")
    assert e.value.code == 0 and out.is_file()


@pytest.mark.parametrize("argv", [["render", "--cpu", "--no-such-flag"],
                                  ["bench", "--no-such-flag"],
                                  ["view", "--cpu", "--no-such-flag"]])
def test_unknown_flags_are_refused(argv):
    """Every command rejects an unknown flag."""
    with pytest.raises(SystemExit):
        cli.main(argv)
