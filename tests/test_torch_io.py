"""PyTorch port: host I/O against the JAX package, on the CPU.

* EXR: for every compression ``write_exr`` takes, the port's file is the
  JAX package's byte for byte, and each package reads the other's back bit
  for bit; truncated and fuzzed files raise the JAX loader's errors (or
  load to the same arrays), never crash.
* FBX: binary (plain and deflated) and ASCII files, written as
  tests/test_fbx.py writes them, load to equal arrays in both packages.
* Images: ``load_image``, ``save_png`` and ``save_depth_png`` round trips,
  the same bytes as the JAX package's.
* ``Renderer.load_hdr`` takes an EXR path.

The port's host library is built from its own copies of the JAX package's
sources (``native/csrc``); no other tool is compiled.
"""

import random

import numpy as np
import pytest

from tests.test_fbx import _ASCII_QUAD, _write_quad_fbx
from vrenderer_pathtracer_tpu import io as jio
from vrenderer_pathtracer_tpu import native as jnative
import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch import io as tio
from vrenderer_pathtracer_tpu_torch import native


def _hdr(h=24, w=40, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 4, (h, w, 3)).astype(np.float32)
    img[::5] *= 50.0  # a few bright rows: the half range, not just [0, 4)
    return img


@pytest.mark.parametrize("comp", list(native.EXR_COMPRESSIONS))
def test_write_exr_matches_jax_both_ways(tmp_path, comp):
    img = _hdr()
    mine, theirs = tmp_path / "port.exr", tmp_path / "jax.exr"
    native.write_exr(str(mine), img, comp)
    jnative.write_exr(str(theirs), img, comp)
    assert mine.read_bytes() == theirs.read_bytes()
    back = jnative.load_exr(str(mine))
    np.testing.assert_array_equal(native.load_exr(str(mine)), back)
    np.testing.assert_array_equal(native.load_exr(str(theirs)), back)
    assert back.shape == img.shape and back.dtype == np.float32
    if comp not in ("b44", "dwaa", "dwab"):  # lossless up to half rounding
        np.testing.assert_array_equal(back, img.astype(np.float16)
                                      .astype(np.float32))


def _outcome(load, path):
    try:
        return load(path)
    except IOError as e:
        return str(e)


@pytest.mark.parametrize("comp", ["zip", "piz", "pxr24", "dwab"])
def test_truncated_and_fuzzed_exr_fail_as_jax(tmp_path, comp):
    f = tmp_path / "good.exr"
    native.write_exr(str(f), _hdr(33, 21, seed=1), comp)
    base = f.read_bytes()
    rng = random.Random(comp)
    p = str(tmp_path / "fz.exr")
    errors = 0
    for trial in range(24):
        b = bytearray(base)
        if trial % 3 == 0:
            b = b[:rng.randrange(8, len(b))]
        else:
            lo = 0 if trial % 3 == 1 else min(300, len(b) - 1)
            for _ in range(6):
                b[rng.randrange(lo, len(b))] = rng.randrange(256)
        with open(p, "wb") as fh:
            fh.write(bytes(b))
        got, want = _outcome(native.load_exr, p), _outcome(jnative.load_exr, p)
        if isinstance(want, str):
            assert got == want, trial
            errors += 1
        else:
            np.testing.assert_array_equal(got, want)
    assert errors > 0
    with open(p, "wb") as fh:
        fh.write(b"not an exr at all")
    assert _outcome(native.load_exr, p) == _outcome(jnative.load_exr, p)
    assert "not an EXR" in _outcome(native.load_exr, p)


def _same_mesh(a, b):
    assert a._fields == b._fields
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


@pytest.mark.parametrize("version,compress", [(7400, False), (7500, True)])
def test_binary_fbx_loads_as_jax(tmp_path, version, compress):
    p = tmp_path / "quad.fbx"
    _write_quad_fbx(p, version=version, compress=compress,
                    extra_first_mesh=True)
    got = native.load_fbx(str(p))
    _same_mesh(got, jnative.load_fbx(str(p)))
    _same_mesh(native.load_mesh_file(str(p)), got)
    assert got.tris.shape == (2, 3)


def test_ascii_fbx_loads_as_jax_and_foreign_files_fail_as_jax(tmp_path):
    p = tmp_path / "quad_ascii.fbx"
    p.write_text(_ASCII_QUAD)
    _same_mesh(native.load_fbx(str(p)), jnative.load_fbx(str(p)))
    q = tmp_path / "nope.fbx"
    q.write_text("solid ascii_stl\nendsolid\n" * 4)
    for path in (q, tmp_path / "missing.fbx"):
        assert (_outcome(native.load_fbx, str(path))
                == _outcome(jnative.load_fbx, str(path)))


def test_png_round_trips_match_jax(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.uniform(-0.1, 1.1, (12, 20, 3)).astype(np.float32)
    depth = rng.uniform(0, 1, (12, 20)).astype(np.float32)
    for name, save, arr in (("img", "save_png", img),
                            ("depth", "save_depth_png", depth)):
        mine, theirs = tmp_path / f"{name}_p.png", tmp_path / f"{name}_j.png"
        getattr(tio, save)(str(mine), arr)
        getattr(jio, save)(str(theirs), arr)
        assert mine.read_bytes() == theirs.read_bytes()
        back = tio.load_image(str(mine))
        np.testing.assert_array_equal(back, jio.load_image(str(mine)))
        assert back.shape == (12, 20, 3) and back.dtype == np.float32
    q = np.round(np.clip(img, 0, 1) * 255) / 255
    np.testing.assert_allclose(tio.load_image(str(tmp_path / "img_p.png")),
                               q[::-1], atol=1e-6)
    d = tio.load_image(str(tmp_path / "depth_p.png"))
    np.testing.assert_allclose(d[..., 0], np.round((1 - depth) * 255)[::-1] / 255,
                               atol=1e-6)


def test_renderer_load_hdr_reads_an_exr(tmp_path):
    sky = _hdr(8, 16, seed=4)
    p = tmp_path / "sky.exr"
    tio.write_exr(str(p), sky, "piz")
    r = vpt.Renderer(8, 8, device="cpu")
    r.load_hdr(str(p))
    assert r.settings.has_hdr
    np.testing.assert_array_equal(r.scene.hdr.numpy(), jnative.load_exr(str(p)))
    r.load_hdr(p)  # a path-like too
    assert r.scene.hdr.shape == (8, 16, 3)
