"""PyTorch port on the card: K1 against its plain version, the Renderer on
CUDA, and the failure paths of the build and the dispatch.

Every test here needs a CUDA device (and ``nvcc``) and skips without one.
The file imports no jax, so on a machine with a card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Contract of the kernel against the plain version (two differently compiled
programs flip discrete branches on grazing rays): fewer than 1% of rgb
elements off by more than 1e-5, and depth within 1e-3.
"""

import numpy as np
import pytest
import torch

import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene

pytestmark = pytest.mark.cuda

CORNELL = dict(use_cornell_box=True, has_hdr=False)
SMALL = dict(width=64, height=32, samples_per_pass=4, bounces=4, **CORNELL)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _assert_contract(got, want):
    (rgb, depth), (want_rgb, want_depth) = got, want
    assert rgb.shape == want_rgb.shape and depth.shape == want_depth.shape
    d = (rgb - want_rgb).abs()
    assert (d > 1e-5).float().mean().item() < 0.01
    assert (depth - want_depth).abs().max().item() < 1e-3


@pytest.mark.parametrize("frame", [1, 3])
def test_kernel_matches_plain(cuda, frame):
    s = vpt.RenderSettings(**SMALL)
    scene, cam = Scene.analytic(s, cuda), Camera.default(cuda)
    before = k1.launch.count
    got = k1.render_pass_cuda(scene, s, cam, frame, 0.1, 3.0)
    torch.cuda.synchronize()
    assert k1.launch.count == before + 1
    assert got[0].is_cuda and got[0].dtype == torch.float32
    _assert_contract(got, k1.render_pass_reference(scene, s, cam, frame, 0.1, 3.0))


def test_kernel_odd_size_moved_camera_and_wide_seed(cuda):
    s = vpt.RenderSettings(**dict(SMALL, width=37, height=11))
    scene = Scene.analytic(s, cuda)
    cam = Camera.default(cuda).replace(
        origin=torch.tensor([5.0, -3.0, 120.0], device=cuda),
        yaw=torch.tensor(0.2, device=cuda), pitch=torch.tensor(-0.1, device=cuda))
    args = (scene, s, cam, 2, 0.5, 2.0, 2 ** 40 + 7)
    got = k1.render_pass_cuda(*args)
    torch.cuda.synchronize()
    _assert_contract(got, k1.render_pass_reference(*args))


def test_renderer_on_card_matches_cpu(cuda):
    s = vpt.RenderSettings(**CORNELL)
    before = k1.launch.count
    card = vpt.Renderer(64, 32, settings=s, device=cuda)
    assert card.settings.radiance_kernel == "cuda"
    img, depth = card.render_frames(2)
    assert k1.launch.count == before + 2
    cimg, cdepth = vpt.Renderer(64, 32, settings=s, device="cpu").render_frames(2)
    # The golden image contract of tests/test_golden_cornell.py::_compare.
    diff = np.abs(img - cimg)
    assert (diff > 1e-3).any(axis=-1).mean() <= 0.02
    assert diff.mean() <= 2e-3
    assert (diff > 0.3).mean() <= 0.005
    assert (np.abs(depth - cdepth) > 1e-3).mean() <= 0.02


def test_cuda_scene_never_takes_plain_path(cuda):
    s = vpt.RenderSettings(**SMALL)
    scene = Scene.analytic(s, cuda)
    with pytest.raises(ValueError):
        settings_for_scene(scene, s.replace(radiance_kernel="torch"))
    with pytest.raises(NotImplementedError):
        settings_for_scene(Scene.analytic(s.replace(use_cornell_box=False), cuda),
                           s.replace(use_cornell_box=False))
    with pytest.raises(NotImplementedError):
        k1.render_pass_cuda(scene, s.replace(has_hdr=True), Camera.default(cuda),
                            1, 0.1, 3.0)


def test_failed_build_raises(cuda, monkeypatch, tmp_path):
    from vrenderer_pathtracer_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build("radiance")
    assert not list(tmp_path.iterdir())
