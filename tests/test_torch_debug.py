"""The port's numerical guards (mirrors tests/test_debug_utils.py), and the
sanitizer build ``interpret_kernels``."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.render import integrator
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene
from vrenderer_pathtracer_tpu_torch.utils import (
    assert_finite_tree, checked, interpret_kernels)
from vrenderer_pathtracer_tpu_torch.utils.debug import interpreting


def test_checked_passes_clean_fn():
    f = checked(lambda x: x * 2.0)
    np.testing.assert_allclose(f(torch.ones(4)).numpy(), 2.0)


@pytest.mark.parametrize("fn,x", [
    (torch.log, [-1.0]),                       # log(-1) -> NaN
    (lambda x: (x, {"inv": 1.0 / x}), [0.0]),  # inf in a nested output
])
def test_checked_catches_nan(fn, x):
    with pytest.raises(FloatingPointError, match="non-finite"):
        checked(fn)(torch.tensor(x))


def test_checked_render_pass_is_finite():
    """The shading path produces no NaN/Inf on the golden config."""
    s = vpt.RenderSettings(width=16, height=16, samples_per_pass=2, bounces=3,
                           use_cornell_box=True, has_hdr=False)
    scene = Scene.analytic(s, "cpu")
    f = checked(lambda: integrator.render_camera_pass(
        scene, s, Camera.default("cpu"), 1, torch.tensor(0.1),
        torch.tensor(3.0)))
    rgb, depth = f()
    assert_finite_tree((rgb, depth), "render")


def test_assert_finite_tree_raises():
    with pytest.raises(AssertionError, match="non-finite"):
        assert_finite_tree({"a": torch.tensor([1.0, float("nan")])}, "t")


def test_assert_finite_tree_names_the_leaf():
    @dataclasses.dataclass
    class P:
        ok: torch.Tensor
        bad: torch.Tensor

    tree = [P(torch.ones(2), torch.tensor([0.0, float("inf"), float("nan")]))]
    with pytest.raises(AssertionError, match=r"t\[0\]\.bad: 2 non-finite"):
        assert_finite_tree(tree, "t")
    assert_finite_tree({"ids": torch.arange(3), "x": torch.zeros(2)}, "ints")


def test_interpret_kernels_refuses_cuda_scenes():
    """The sanitizer build is the plain versions on CPU tensors: inside the
    context a CPU scene resolves to them as ever, and a CUDA scene is
    refused rather than run without its kernels; outside it a CUDA scene
    resolves to the kernels.  The scene is a CPU scene that reports a CUDA
    device (no card here)."""
    s = vpt.RenderSettings(width=8, height=8, use_cornell_box=True,
                           has_hdr=False)

    class CudaScene(Scene):
        @property
        def device(self):
            return torch.device("cuda", 0)

    cpu = Scene.analytic(s, "cpu")
    scene = CudaScene(spheres=cpu.spheres)
    out = settings_for_scene(scene, s)
    assert (out.radiance_kernel, out.traversal) == ("cuda", "cuda")
    assert not interpreting()
    with interpret_kernels():
        assert interpreting()
        out = settings_for_scene(cpu, s)
        assert (out.radiance_kernel, out.traversal) == ("torch", "torch")
        with pytest.raises(ValueError, match="device='cpu'"):
            settings_for_scene(scene, s)
    assert not interpreting()


def test_metrics_logger_coercion(tmp_path):
    """Device scalars / numpy types must coerce to plain JSON values."""
    from vrenderer_pathtracer_tpu_torch.utils.metrics import MetricsLogger

    path = tmp_path / "m.jsonl"
    with MetricsLogger(str(path)) as log:
        log.log("x", a=np.float32(1.5), b=np.int64(7), c="s", d=None,
                e=True, f=np.float64(2.0), g=torch.tensor(3.0))
    rec = json.loads(path.read_text().splitlines()[0])
    assert rec["event"] == "x" and rec["a"] == 1.5 and rec["b"] == 7
    assert rec["c"] == "s" and rec["d"] is None and rec["e"] is True
    assert rec["f"] == 2 and isinstance(rec["f"], int)  # integral float
    assert rec["g"] == 3
    assert "t" in rec and "wall" in rec
