"""The port's bench (``vrenderer_pathtracer_tpu_torch/bench.py``) on the CPU.

* ``bench.KEYS`` maps exactly the keys of the repository's ``bench.py``
  line, read from its source with ``ast`` (``bench.py`` imports JAX and
  sets a compilation cache when imported, so it is never imported here);
* every measurement runs on the CPU at a small size (the plain versions,
  no twins), and together they report every mapped key and every twin;
* the Cornell step's loss against the JAX package's op-by-op loss on the
  same parameters and frame; the mesh measurement's triangles and hit rate
  against the JAX package's plain ``traverse`` on the same sphere and
  rays; the paged measurement's triangles and pages against the JAX
  package's ``pack_mesh(paged=True)``;
* the command: a failing measurement leaves no line, a missing card
  raises ``RuntimeError``, ``--only`` and ``--baseline``.
"""

import ast
import json
import math
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vrenderer_pathtracer_tpu.accel.mesh import pack_mesh as j_pack_mesh
from vrenderer_pathtracer_tpu.accel.traverse import traverse as j_traverse
from vrenderer_pathtracer_tpu.config import RenderSettings as JSettings
from vrenderer_pathtracer_tpu.core.camera import Camera as JCamera
from vrenderer_pathtracer_tpu.core.camera import generate_rays, pixel_ids
from vrenderer_pathtracer_tpu.native import load_obj as j_load_obj
from vrenderer_pathtracer_tpu.parallel import sharding as js
from vrenderer_pathtracer_tpu.render.integrator import render_pass as j_render_pass
from vrenderer_pathtracer_tpu.scene.scene import Scene as JScene
from vrenderer_pathtracer_tpu_torch import RenderSettings, bench, cli
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

REPO = pathlib.Path(__file__).resolve().parents[1]
RECORD = ("metric", "value", "unit", "vs_baseline", "extra")
# Keys the command itself sets (the rest come from the measurements).
COMMAND_KEYS = ("n_devices", "platform")

STEP = dict(width=32, height=32, spp=2, bounces=4, iters=1)
MESH = dict(n_theta=16, width=64, height=32, iters=1)
PAGED = dict(n_theta=50, width=64, height=32, iters=1)  # 4,900 tris, 2 pages
TINY = dict(hdr_shape=(8, 16), tex_size=8, n_theta=8, width=16, height=16,
            iters=1)
SMALL = {
    "step": STEP,
    "headline": dict(width=16, height=16, groups=2, calls=2, twin_calls=1),
    "mesh": MESH,
    "megakernel": dict(width=16, height=16, iters=1),
    "paged": PAGED,
    "mesh_megakernel": TINY,
    "nm_wavefront": TINY,
    "config5": dict(width=32, height=24, n_theta=12, warm=1, passes=1),
}


def _bench_py_keys() -> set:
    """The keys of ``bench.py``'s line: its record, the literal keys of its
    ``extra``, and those of the dict each ``_*_bench`` helper returns at
    the end of its ``try`` block (its measurement; the other returns are
    its ``*_error`` and fallback reasons, which the port raises instead)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    funcs = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    record = next(n.value for n in ast.walk(funcs["main"])
                  if isinstance(n, ast.Assign)
                  and [getattr(t, "id", None) for t in n.targets] == ["record"])
    keys = set()
    for k, v in zip(record.keys, record.values):
        keys.add(k.value)
        if k.value == "extra":
            keys |= {kk.value for kk in v.keys if kk is not None}
    helpers = [f for name, f in funcs.items()
               if name.startswith("_") and name.endswith("_bench")]
    assert len(helpers) == 6
    for fn in helpers:
        ret = next(n for n in fn.body if isinstance(n, ast.Try)).body[-1]
        assert isinstance(ret, ast.Return) and isinstance(ret.value, ast.Dict)
        keys |= {k.value for k in ret.value.keys}
    return keys


def test_key_mapping_covers_bench_py_exactly():
    want = _bench_py_keys()
    assert set(bench.KEYS) == want
    assert len(set(bench.KEYS.values())) == len(bench.KEYS)
    for old, new in bench.KEYS.items():
        renamed = "pallas" in old or "xla" in old
        assert (new != old) == renamed, (old, new)
        assert "pallas" not in new and "xla" not in new
    assert bench.KEYS["fwdbwd_pallas_ms"] == "fwdbwd_k2_ms"
    assert bench.KEYS["fwdbwd_xla_ms"] == "fwdbwd_step_ms"


@pytest.fixture(scope="module")
def readings():
    """Every measurement at its small size on the CPU; the Cornell step
    also keeps the parameters its last step started from."""
    out, state = {}, {}
    for name, fn in bench.MEASUREMENTS.items():
        kw = dict(state=state) if name == "step" else {}
        out[name] = fn(**SMALL[name], device="cpu", **kw)
    out["state"] = state
    return out


@pytest.mark.parametrize("name", list(bench.MEASUREMENTS))
def test_measurement_runs_on_the_cpu(readings, name):
    got = readings[name]
    # No device time on the CPU: no twin, and no kernel in any window.
    assert got["kernel_device_ms"] and all(
        v == {} for v in got["kernel_device_ms"].values())
    for key, value in got.items():
        if key == "kernel_device_ms":
            continue
        if key in bench.TWINS.values():
            assert value is None, key
        elif isinstance(value, str):
            assert value, key
        else:
            for x in value if isinstance(value, list) else [value]:
                assert math.isfinite(x) and x > 0, (key, value)


def test_measurements_report_every_mapped_key_and_twin(readings):
    reported = set().union(*(set(readings[n]) for n in bench.MEASUREMENTS))
    want = set(bench.KEYS.values()) - set(RECORD) - set(COMMAND_KEYS)
    assert want <= reported
    assert set(bench.TWINS) <= reported and set(bench.TWINS.values()) <= reported


def test_step_loss_matches_jax_op_by_op(readings):
    """The last timed step's loss against the JAX package's L2 loss of one
    pass, op by op, on the parameters that step started from, at its
    frame (the compiled JAX pass flips a few Cornell paths)."""
    p = readings["state"]["last_params"]
    s = JSettings(width=STEP["width"], height=STEP["height"],
                  samples_per_pass=STEP["spp"], bounces=STEP["bounces"],
                  use_cornell_box=True, has_hdr=False)
    params = js.TrainParams(*(jnp.asarray(t.numpy()) for t in p.leaves()))
    scene, cam = JScene.analytic(s), JCamera.default()
    with jax.disable_jit():
        rgb, _ = j_render_pass(js._apply_params(scene, params), s,
                               *generate_rays(cam, s.width, s.height),
                               pixel_ids(s.width, s.height),
                               jnp.uint32(1 + STEP["iters"]),
                               params.fresnel_coef, params.fresnel_pow)
        want = float(jnp.sum(rgb ** 2) / (s.n_pixels * 3))
    np.testing.assert_allclose(readings["step"]["loss"], want, rtol=1e-3)


def _j_mesh(n_theta, tmp_path, paged):
    p = tmp_path / "sphere.obj"
    write_uv_sphere(str(p), radius=12.0, n_theta=n_theta, n_phi=n_theta)
    return j_pack_mesh(j_load_obj(str(p)), paged=paged)


def test_mesh_tris_and_hitrate_match_jax_traverse(readings, tmp_path):
    mesh = _j_mesh(MESH["n_theta"], tmp_path, None)
    cam = JCamera.default()._replace(origin=jnp.asarray(
        [1e-4 * MESH["iters"], 0.0, 28.0], jnp.float32))
    ro, rd = generate_rays(cam, MESH["width"], MESH["height"])
    slot, _ = j_traverse(mesh, ro, rd, jnp.full((ro.shape[0],), 1e6, jnp.float32))
    got = readings["mesh"]
    assert got["mesh_tris"] == int(np.asarray(mesh.tri_count))
    assert abs(got["mesh_hitrate"] - float((slot >= 0).mean())) <= 1e-5


def test_paged_tris_and_pages_match_jax_pack(readings, tmp_path):
    mesh = _j_mesh(PAGED["n_theta"], tmp_path, True)
    got = readings["paged"]
    assert got["paged_tris"] == int(np.asarray(mesh.tri_count))
    assert got["paged_pages"] == int(mesh.paged.nodes8_f.shape[0]) == 2


def _fake_card(monkeypatch):
    monkeypatch.setattr(bench, "_device", lambda device: torch.device("cpu"))
    monkeypatch.setattr(bench, "card", lambda: ("a card", "1.00 W"))
    monkeypatch.setitem(bench.MEASUREMENTS, "headline",
                        lambda **kw: {"fwdbwd_k2_ms": 2.0})


def test_a_failing_measurement_fails_the_command_with_no_line(monkeypatch, capsys):
    _fake_card(monkeypatch)

    def broken(**kw):
        raise ValueError("a planted failure")

    monkeypatch.setitem(bench.MEASUREMENTS, "mesh", broken)
    with pytest.raises(ValueError, match="a planted failure"):
        bench.main(["--only", "mesh"])
    assert capsys.readouterr().out == ""


def test_line_only_and_baseline(monkeypatch, capsys, tmp_path):
    _fake_card(monkeypatch)
    base = tmp_path / "earlier.jsonl"
    base.write_text("noise\n" + json.dumps({"metric": bench.METRIC,
                                            "value": 4194.304}) + "\n")
    rec = bench.main(["--only", "headline", "--baseline", str(base)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == rec
    assert set(rec) == set(RECORD) and rec["unit"] == "Mrays/s"
    assert rec["value"] == pytest.approx(2 * 1024 * 1024 * 2 * 4 / 2e-3 / 1e6)
    assert rec["vs_baseline"] == pytest.approx(2.0)
    extra = rec["extra"]
    assert extra["platform"] == "gpu" and extra["n_devices"] == 1
    assert (extra["card"], extra["power_limit"]) == ("a card", "1.00 W")
    assert set(extra["launches"]) == set(bench.KERNELS)
    assert bench.selected("mesh,paged") == ["headline", "mesh", "paged"]
    with pytest.raises(ValueError, match="unknown measurements"):
        bench.selected("mesh,nope")
    base.write_text(json.dumps({"metric": "another", "value": 1.0}))
    with pytest.raises(ValueError, match="another"):
        bench.main(["--only", "headline", "--baseline", str(base)])


def test_without_a_card_the_command_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["bench"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_plain_versions_are_ranges_on_the_timeline():
    """What phase 50 of chip_smoke.py reads in the twins' timelines: each
    plain version a ``plain_version:<name>`` range, its count kept."""
    from vrenderer_pathtracer_tpu_torch.accel import traverse
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh, cuda_radiance
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
    from vrenderer_pathtracer_tpu_torch.utils.profiling import PLAIN_VERSION

    for fn in (cuda_radiance.render_pass_reference, traverse.traverse,
               traverse.traverse_paged_reference, cuda_mesh.records_reference):
        assert hasattr(fn, "__wrapped__") and hasattr(fn, "count")
    s = RenderSettings(width=8, height=8, samples_per_pass=1, bounces=2,
                       use_cornell_box=True, has_hdr=False)
    scene, cam = Scene.analytic(s, "cpu"), Camera.default("cpu")
    count = cuda_radiance.render_pass_reference.count
    with torch.profiler.profile() as prof:
        cuda_radiance.render_pass_reference(scene, s, cam, 1, 0.1, 3.0)
    assert cuda_radiance.render_pass_reference.count == count + 1
    assert PLAIN_VERSION + "render_pass_reference" in {
        e.key for e in prof.key_averages()}


def test_device_time_refuses_the_cpu():
    from vrenderer_pathtracer_tpu_torch.utils.profiling import device_ms_per_call

    with pytest.raises(ValueError, match="CUDA device"):
        device_ms_per_call(lambda i: None, 1, "cpu")
