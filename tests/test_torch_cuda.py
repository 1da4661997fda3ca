"""PyTorch port on the card: K1, K2, K3, K3c, K3b, K4, K5 and K6 against
their plain versions, the Renderer and the train steps on CUDA, and the
failure paths of the build and the dispatch.

Every test here needs a CUDA device (and ``nvcc``) and skips without one.
The file imports no jax, so on a machine with a card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Contract of K1 against the plain version (two differently compiled
programs flip discrete branches on grazing rays): fewer than 1% of rgb
elements off by more than 1e-5, and depth within 1e-3, also where
specular walls make every hit a Fresnel surface.  K2 is held to the
gradient tolerances of tests/test_pallas_grad.py on that file's
well-conditioned scene, at a frame where K1 and its plain version agree on
every rgb element (a flipped branch moves the sums by a whole path), at 2
spp x 4 and 3 spp x 5 bounces; its planted channel fault must break them.
K3 (which walks the mesh's compressed copy, ``accel/wide.py``) and K3b
are held to chip_smoke.py's traversal contract against the plain
``traverse`` and ``brute_force``: hit/miss agrees on all but 1e-5 of the
rays and the winning triangle on all but 2e-5 (none of these 4,096), t to
rtol 1e-4 where the triangle is the same, and a miss returns t_max.  K3c's
slot and t are K3's bit for bit, and its captured attributes are held to
``capture_reference`` at its own winners within rtol 1e-4 / atol 1e-5
(``capture_contract``), which each of its planted faults must break.
K4 is held to chip_smoke.py's K4 contract (``k4_contract``) against
``records_reference``, record by record and on the composed image; its
direct mode on the image and the depth, against the plain version's and
the records mode's composed passes.  K5 is
held to K3's contract against ``traverse_paged_reference`` and
``brute_force``; K6 to the plain chain at ``probe.CHECK_C``/``CHECK_A``,
where the chain moves in both dtypes (float32 rtol 1e-4: the plain chain
rounds product and sum apart, the kernel fuses them; bf16 bit-equal), and
its planted no-op kernel must fail that check.  ``records_reference``
draws each bounce through K7 and its records are the int64 draws' bit for
bit (K7's own tests are in tests/test_torch_rng.py and
tests/test_torch_compact.py).
"""

import tempfile

import numpy as np
import pytest
import torch

import vrenderer_pathtracer_tpu_torch as vpt
from vrenderer_pathtracer_tpu_torch.core.camera import Camera
from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
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
    with pytest.raises(ValueError):
        settings_for_scene(scene, s.replace(traversal="torch"))
    # Outside K1's scope a CUDA sphere scene runs K4; the wavefront (whose
    # mesh search is K3/K3b) only on request.  K4 on a Cornell sphere scene
    # (K1's) raises.
    open_s = s.replace(use_cornell_box=False)
    open_scene = Scene.analytic(open_s, cuda)
    other = settings_for_scene(open_scene, open_s)
    assert (other.radiance_kernel, other.traversal) == ("cuda_mesh", "cuda")
    assert settings_for_scene(open_scene, open_s.replace(
        radiance_kernel="wavefront")).radiance_kernel == "wavefront"
    with pytest.raises(ValueError):
        settings_for_scene(scene, s.replace(radiance_kernel="cuda_mesh"))
    with pytest.raises(NotImplementedError):
        k1.render_pass_cuda(scene, s.replace(has_hdr=True), Camera.default(cuda),
                            1, 0.1, 3.0)


def test_cornell_scene_beyond_smem_spheres_runs_k1(cuda):
    """A Cornell sphere scene with more spheres than K1 stages in shared
    memory runs K1, which reads the table from global memory: with the
    extra spheres beyond the walls it renders the 8-sphere image bit for
    bit; with them visible it matches the plain version under the golden
    image contract.  Outside Cornell mode the same spheres run K4."""
    from chip_smoke import many_spheres

    s = vpt.RenderSettings(width=256, height=256, samples_per_pass=1, bounces=2,
                           **CORNELL)
    base = Scene.analytic(s, cuda)
    cam = Camera.default(cuda)
    rng = np.random.default_rng(0)
    far = many_spheres(base, k1.SMEM_SPHERES + 88, rng, visible=False)
    visible = many_spheres(base, k1.SMEM_SPHERES + 88, rng, visible=True)
    assert settings_for_scene(far, s).radiance_kernel == "cuda"
    before = k1.launch.count
    for x, y in zip(k1.render_pass_cuda(far, s, cam, 1, 0.1, 3.0),
                    k1.render_pass_cuda(base, s, cam, 1, 0.1, 3.0)):
        assert torch.equal(x, y)
    got = k1.render_pass_cuda(visible, s, cam, 1, 0.1, 3.0)
    torch.cuda.synchronize()
    assert k1.launch.count == before + 3
    want = k1.render_pass_reference(visible, s, cam, 1, 0.1, 3.0)
    diff = (got[0] - want[0]).abs().amax(dim=-1)
    assert (diff > 1e-3).float().mean().item() <= 0.02
    assert diff.mean().item() <= 2e-3
    other = settings_for_scene(visible, s.replace(use_cornell_box=False))
    assert other.radiance_kernel == "cuda_mesh"


def test_failed_build_raises(cuda, monkeypatch, tmp_path):
    from vrenderer_pathtracer_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.build("radiance")
    assert not list(tmp_path.iterdir())


# tests/test_pallas_grad.py::_benign_scene, rows (radius, pos, emission,
# color, refl, spec_color); this file imports no jax.
BENIGN = [
    (20.0, (0.0, 45.0, 0.0), (4.0, 3.6, 3.2), (0, 0, 0), 1, (0, 0, 0)),
    (60.0, (95.0, 0.0, 0.0), (0.075, 0.025, 0.025), (0.75, 0.25, 0.25), 1, (0, 0, 0)),
    (60.0, (-95.0, 0.0, 0.0), (0.025, 0.075, 0.025), (0.25, 0.75, 0.25), 1, (0, 0, 0)),
    (60.0, (0.0, 0.0, -120.0), (0, 0, 0), (1, 1, 1), 1, (0, 0, 0)),
    (60.0, (0.0, -95.0, 0.0), (0, 0, 0), (0.9, 0.9, 0.9), 1, (0, 0, 0)),
    (12.0, (18.0, -5.0, 20.0), (0, 0, 0), (0, 0, 0), 0, (1, 1, 1)),
    (12.0, (-18.0, -5.0, 20.0), (0, 0, 0), (1, 1, 1), 1, (1, 1, 1)),
]
GRAD = dict(width=64, height=32, samples_per_pass=2, bounces=4, **CORNELL)


def _benign(device):
    from vrenderer_pathtracer_tpu_torch.scene.spheres import SphereSet

    f32 = dict(dtype=torch.float32, device=device)
    return Scene(spheres=SphereSet(
        pos=torch.tensor([r[1] for r in BENIGN], **f32),
        radius=torch.tensor([r[0] for r in BENIGN], **f32),
        emission=torch.tensor([r[2] for r in BENIGN], **f32),
        color=torch.tensor([r[3] for r in BENIGN], **f32),
        refl=torch.tensor([r[4] for r in BENIGN], dtype=torch.int32,
                          device=device),
        spec_color=torch.tensor([r[5] for r in BENIGN], **f32)))


def _grad_case(device, **kw):
    """Benign scene, settings, camera, target and a flip-free frame."""
    s = vpt.RenderSettings(**dict(GRAD, **kw))
    scene, cam = _benign(device), Camera.default(device)
    for frame in range(1, 25):
        got, _ = k1.render_pass_cuda(scene, s, cam, frame, 0.1, 3.0)
        want, _ = k1.render_pass_reference(scene, s, cam, frame, 0.1, 3.0)
        if (got - want).abs().max().item() <= 1e-5:
            break
    else:
        pytest.fail("no flip-free frame in 1..24")
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 0.5, (s.n_pixels, 3)).astype(np.float32)).to(device)
    return scene, s, cam, target, frame


@pytest.fixture
def grad_case(cuda):
    return _grad_case(cuda)


def _assert_k2_matches_plain(args):
    got = k2.cornell_loss_grads(*args)
    torch.cuda.synchronize()
    want = k2.cornell_loss_grads_reference(*args)
    torch.testing.assert_close(got[0], want[0], rtol=1e-4, atol=0.0)
    for i, atol in ((1, 2e-4), (2, 2e-4), (3, 1e-6), (4, 1e-6)):
        torch.testing.assert_close(got[i], want[i], rtol=1e-2, atol=atol)
    return got, want


@pytest.mark.parametrize("with_camera", [False, True])
@pytest.mark.parametrize("sliders", [(0.1, 3.0), (0.4, 1.5)])
def test_k2_matches_plain(grad_case, sliders, with_camera):
    scene, s, cam, target, frame = grad_case
    args = (scene, s, cam, target, frame, *sliders, 0, with_camera)
    before = k2.launch.count
    got, want = _assert_k2_matches_plain(args)
    assert k2.launch.count == before + 1
    if with_camera:
        for f, atol in (("origin", 2e-6), ("yaw", 1e-5), ("pitch", 1e-5),
                        ("fov_deg", 1e-6)):
            torch.testing.assert_close(getattr(got[5], f), getattr(want[5], f),
                                       rtol=2e-2, atol=atol)
        base = k2.cornell_loss_grads(*args[:-1], False)
        for a, b in zip(got[:5], base):
            assert torch.equal(a, b)


def test_k2_repeat_launches_bit_identical(grad_case):
    """K2 reduces its row in the kernel in a fixed order: two launches give
    the same [K] row bit for bit."""
    scene, s, cam, target, frame = grad_case
    tables = (k1.pack_camera(cam, s, 0.1, 3.0), k1.pack_spheres(scene.spheres))
    for with_camera in (False, True):
        before = k2.launch.count
        a = k2.launch(*tables, s, target, frame, 0, with_camera)
        b = k2.launch(*tables, s, target, frame, 0, with_camera)
        assert k2.launch.count == before + 2
        assert a.shape == (k2.n_partials(7, with_camera),)
        assert torch.equal(a, b)


def test_k2_channel_fault_breaks_contract(grad_case):
    """The instance with the planted fault (channel 1's unit-g sums scaled
    by channel 0's g) keeps the loss and fails the dcolor tolerance that
    the real kernel meets."""
    scene, s, cam, target, frame = grad_case
    args = (scene, s, cam, target, frame, 0.4, 1.5, 0, False)
    _, want = _assert_k2_matches_plain(args)
    tables = (k1.pack_camera(cam, s, 0.4, 1.5), k1.pack_spheres(scene.spheres))
    row = k2.launch(*tables, s, target, frame, 0, fault=True)
    bad = k2.unpack(row, scene.spheres.count, s.n_pixels)[0]
    torch.testing.assert_close(bad[0], want[0], rtol=1e-4, atol=0.0)
    assert not torch.allclose(bad[1], want[1], rtol=1e-2, atol=2e-4)


def test_k2_three_samples_five_bounces_matches_plain(cuda):
    """3 spp x 5 bounces: 15 records a pixel, one sample's at a time."""
    scene, s, cam, target, frame = _grad_case(cuda, samples_per_pass=3, bounces=5)
    _assert_k2_matches_plain((scene, s, cam, target, frame, 0.1, 3.0, 0, False))


def test_k1_with_specular_walls_matches_plain(cuda):
    """Walls with a non-zero specular colour are Fresnel surfaces, where
    cut (a) is not taken: K1 still holds its contract."""
    s = vpt.RenderSettings(**SMALL)
    scene, cam = Scene.analytic(s, cuda), Camera.default(cuda)
    spec = scene.spheres.spec_color.clone()
    spec[(spec == 0).all(dim=1)] = 0.3
    walls = scene.replace_spheres(spec_color=spec)
    for frame in (1, 2):
        _assert_contract(k1.render_pass_cuda(walls, s, cam, frame, 0.1, 3.0),
                         k1.render_pass_reference(walls, s, cam, frame, 0.1, 3.0))


def test_k2_odd_size_and_loss_matches_k1(cuda):
    """A frame that is no multiple of the block: the threads past it add
    nothing, and K2's loss is the L2 loss of K1's own image."""
    s = vpt.RenderSettings(**dict(GRAD, width=37, height=11))
    scene, cam = Scene.analytic(s, cuda), Camera.default(cuda)
    target = torch.full((s.n_pixels, 3), 0.25, device=cuda)
    loss = k2.cornell_loss_grads(scene, s, cam, target, 2, 0.1, 3.0)[0]
    rgb, _ = k1.render_pass_cuda(scene, s, cam, 2, 0.1, 3.0)
    want = torch.mean((rgb.double() - target.double()) ** 2)
    torch.testing.assert_close(loss.double(), want, rtol=1e-5, atol=0.0)


def test_cuda_tensors_never_take_plain_grads(cuda, grad_case, monkeypatch):
    scene, s, cam, target, frame = grad_case

    def refuse(*_a, **_k):
        raise AssertionError("plain version ran for CUDA tensors")

    monkeypatch.setattr(k2, "cornell_loss_grads_reference", refuse)
    monkeypatch.setattr(k2, "_plain_loss", refuse)
    before = k2.launch.count
    k2.cornell_loss_grads(scene, s, cam, target, frame, 0.1, 3.0)
    params = vpt.TrainParams.from_scene(scene)
    params.color.requires_grad_()
    loss = k2.cornell_loss(params, scene, s, cam, target, frame)
    (2.0 * loss).backward()
    assert k2.launch.count == before + 2
    want = k2.cornell_loss_grads(scene, s, cam, target, frame, 0.1, 3.0)[1]
    assert torch.equal(params.color.grad, 2.0 * want)
    with pytest.raises(NotImplementedError):
        k2.cornell_loss_grads(scene, s.replace(has_hdr=True), cam, target,
                              frame, 0.1, 3.0)
    with pytest.raises(NotImplementedError):  # 20 records, above the 16 kept
        k2.cornell_loss_grads(scene, s.replace(samples_per_pass=5), cam, target,
                              frame, 0.1, 3.0)
    assert k2.launch.count == before + 3  # the refused calls launched nothing
    with pytest.raises(ValueError):
        k2.cornell_loss_grads(scene, s, cam, target.cpu(), frame, 0.1, 3.0)


def test_train_steps_on_card(cuda):
    s = vpt.RenderSettings(**dict(GRAD, width=32, height=32))
    scene, cam = Scene.analytic(s, cuda), Camera.default(cuda)
    bright = scene.spheres.emission.clone()
    bright[0] *= 1.5
    target, _ = k1.render_pass_cuda(scene.replace_spheres(emission=bright), s,
                                    cam, 1, 0.1, 3.0)
    params = vpt.TrainParams.from_scene(scene)
    params.emission.requires_grad_()
    step = vpt.opt_step(s, torch.optim.Adam([params.emission], lr=0.1))
    before = k2.launch.count
    losses = [step(params, scene, cam, target, 1)[1]["loss"].item()
              for _ in range(12)]
    assert k2.launch.count == before + 12
    assert losses[-1] < 0.5 * losses[0], losses
    sgd = vpt.train_step(s, with_metrics=True)
    new, metrics = sgd(vpt.TrainParams.from_scene(scene, camera=cam), scene,
                       cam, target, 1)
    assert new.camera is not None and new.emission.is_cuda
    assert np.isfinite(metrics["grad_global_norm"].item())


def test_failed_grad_build_raises(cuda, monkeypatch, tmp_path):
    from vrenderer_pathtracer_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="nvcc failed for grad"):
        build.build_all(["radiance", "grad"])
    assert not list(tmp_path.iterdir())


# -- K3 and K3b ---------------------------------------------------------------

@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    """The 1.5k-triangle sphere on the card and on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
    from vrenderer_pathtracer_tpu_torch.native import load_obj
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    p = tmp_path_factory.mktemp("k3") / "s.obj"
    write_uv_sphere(p, 14.0, 24, 32)
    host = load_obj(str(p))
    return pack_mesh(host, device="cuda"), pack_mesh(host, device="cpu")


def _mesh_rays(device, n=4096, seed=3):
    """Rays from z = 40 at the sphere and from random points in random
    directions, with open, cutting and zero (dead-lane) bounds."""
    rng = np.random.default_rng(seed)
    o = np.concatenate([np.tile([[0.0, 0.0, 40.0]], (n // 2, 1)),
                        rng.uniform(-30, 30, (n // 2, 3))])
    d = np.concatenate([
        np.stack([rng.uniform(-0.45, 0.45, n // 2),
                  rng.uniform(-0.45, 0.45, n // 2), -np.ones(n // 2)], 1),
        rng.standard_normal((n // 2, 3))])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t = rng.choice([1e6, 30.0, 0.0], size=n, p=[0.7, 0.25, 0.05])
    return tuple(torch.tensor(x, dtype=torch.float32, device=device)
                 for x in (o, d, t))


def _assert_traversal_contract(mesh, got, want, t_max):
    from vrenderer_pathtracer_tpu_torch.accel.cuda_traverse import hit_agreement

    a = hit_agreement(mesh, got, want, t_max)
    assert a["hit_mismatch"] <= 1e-5, a
    assert a["geometry_mismatch"] <= 2e-5, a
    assert a["t_rel_max"] <= 1e-4, a
    assert a["miss_t_exact"], a


@pytest.mark.parametrize("wide", [True, False])
def test_k3_matches_plain_and_brute_force(meshes, wide):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel.traverse import brute_force, traverse

    card, cpu = meshes
    m = card if wide else card.without_wide()
    launch = k3.launch_k3 if wide else k3.launch_k3b
    o, d, t = _mesh_rays("cuda")
    before = launch.count
    got = launch(m, o, d, t)
    torch.cuda.synchronize()
    assert launch.count == before + 1
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    _assert_traversal_contract(card, got, traverse(card, o, d, t), t)
    _assert_traversal_contract(card, got, brute_force(card, o, d, t), t)
    on_cpu = traverse(cpu, o.cpu(), d.cpu(), t.cpu())
    _assert_traversal_contract(cpu, tuple(x.cpu() for x in got), on_cpu, t.cpu())


def test_k3_walk_matches_plain(meshes):
    """K3's walk (near to far, popped nodes culled, one 256-entry stack)
    against the plain traverse under the traversal contract, on rays of
    their own seed, with and without the work counters."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel.traverse import traverse

    card, _ = meshes
    o, d, t = _mesh_rays("cuda", seed=7)
    got = k3.launch_k3(card, o, d, t)
    stats = torch.zeros(3, dtype=torch.int64, device="cuda")
    counted = k3.launch_k3(card, o, d, t, stats=stats)
    assert torch.equal(got[0], counted[0]) and torch.equal(got[1], counted[1])
    assert stats[0].item() > 0
    _assert_traversal_contract(card, got, traverse(card, o, d, t), t)


def test_k3_and_k3b_agree_and_repeat_bit_identical(meshes):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3

    card, _ = meshes
    o, d, t = _mesh_rays("cuda", seed=5)
    wide = k3.traverse_cuda(card, o, d, t)
    binary = k3.traverse_cuda(card.without_wide(), o, d, t)
    _assert_traversal_contract(card, wide, binary, t)
    for m in (card, card.without_wide()):
        a, b = k3.traverse_cuda(m, o, d, t), k3.traverse_cuda(m, o, d, t)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    stats = torch.zeros(3, dtype=torch.int64, device="cuda")
    k3.launch_k3(card, o, d, t, stats=stats)
    visits, boxes, tris = stats.tolist()
    assert 0 < visits <= boxes <= 8 * visits and tris > 0


def test_k3_walks_the_compressed_copy_alone(meshes):
    """K3 reads the compressed copy and nothing of the JAX-parity arrays:
    with those zeroed it returns the same hits, bit for bit; a copy built
    from records that drop each leaf's last triangle breaks the contract;
    a mesh without its copy is refused, not walked on another layout."""
    import dataclasses

    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel.cuda_traverse import hit_agreement
    from vrenderer_pathtracer_tpu_torch.accel.mesh import with_copy
    from vrenderer_pathtracer_tpu_torch.accel.traverse import traverse

    card, _ = meshes
    o, d, t = _mesh_rays("cuda", seed=11)
    sound = k3.launch_k3(card, o, d, t)
    _assert_traversal_contract(card, sound, traverse(card, o, d, t), t)
    blank = dataclasses.replace(card, **{f: torch.zeros_like(getattr(card, f))
                                         for f in ("nodes8_f", "nodes8_i",
                                                   "tri_pack")})
    again = k3.launch_k3(blank, o, d, t)
    assert all(torch.equal(a, b) for a, b in zip(sound, again))
    recs = card.nodes8_i.clone().view(-1, 8, 2)
    cnt = recs[..., 1]
    cnt[cnt >= 2] -= 1
    short = with_copy(dataclasses.replace(card, nodes8_i=recs.view(-1, 16)))
    a = hit_agreement(card, k3.launch_k3(short, o, d, t), sound, t)
    assert a["geometry_mismatch"] + a["hit_mismatch"] > 1e-3, a
    with pytest.raises(NotImplementedError):
        k3.traverse_cuda(dataclasses.replace(card, nodes8_c=None), o, d, t)


def test_k3_refuses_what_it_does_not_take(meshes):
    import dataclasses

    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3

    card, cpu = meshes
    o, d, t = _mesh_rays("cuda", n=64)
    lane_dense = dataclasses.replace(
        card, nodes8_f=torch.zeros((8, 128), device="cuda"))
    with pytest.raises(NotImplementedError):
        k3.traverse_cuda(lane_dense, o, d, t)
    with pytest.raises(ValueError):
        k3.traverse_cuda(card, o.cpu(), d.cpu(), t.cpu())
    with pytest.raises(ValueError):
        k3.traverse_cuda(card, o.double(), d, t)
    with pytest.raises(ValueError):
        k3.traverse_cuda(card, o.t().contiguous().t(), d, t)
    with pytest.raises(ValueError):
        k3.traverse_cuda(card, o, d, t[:-1])
    empty = k3.traverse_cuda(card, o[:0], d[:0], t[:0])
    assert empty[0].shape == (0,)


def _bounce_rays(mesh, o, d, t, seed=9):
    """A bounce wave after (o, d, t): rays leaving the primary hits in
    random directions, and dead lanes (t_max 0) where the primary ray
    missed, as the integrator's waves hold them.  Each leaves from 1e-3
    along its way, so that no ray rests on a self-hit at rounding distance
    (t ~ TRI_EPS), whose t two programs that round the triangle test apart
    give apart by more than the contract's rtol."""
    from vrenderer_pathtracer_tpu_torch.accel.traverse import traverse

    slot, hit_t = traverse(mesh, o, d, t)
    g = torch.Generator(device="cpu").manual_seed(seed)
    nd = torch.randn(o.shape, generator=g).to(o.device)
    nd = nd / nd.norm(dim=1, keepdim=True)
    hit = slot >= 0
    no = torch.where(hit[:, None], o + hit_t[:, None] * d + 1e-3 * nd, o)
    nt = torch.where(hit, torch.full_like(t, 1e6), torch.zeros_like(t))
    return no.contiguous(), nd.contiguous(), nt


def test_k3b_matches_parent_and_plain_on_primary_and_bounce_waves(meshes):
    """The redesigned K3b (persistent warps, cull, rows) against the parent
    K3b of the check build and the plain traverse under the traversal
    contract, on a primary and a bounce wave; the check build's own K3b
    too."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel.traverse import traverse

    card = meshes[0].without_wide()
    prim = _mesh_rays("cuda", seed=13)
    for o, d, t in (prim, _bounce_rays(card, *prim)):
        got = k3.launch_k3b(card, o, d, t)
        want = traverse(card, o, d, t)
        _assert_traversal_contract(card, got, want, t)
        _assert_traversal_contract(
            card, got, k3.k3b_check_launcher(card, o, d, t, k3.K3B_PARENT)(), t)
        _assert_traversal_contract(card, k3.k3b_check_launcher(card, o, d, t)(), want, t)


def test_k3b_repeat_launches_bit_identical(meshes):
    """Two launches in a row give the same result bit for bit: every launch
    leaves its fetch counters zero (a stale count would leave rays untaken);
    so does the check build's K3b, which shares the wrapper's workspace, on
    the same stream, and on another stream with a workspace of its own."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3

    card = meshes[0].without_wide()
    o, d, t = _mesh_rays("cuda", seed=17)
    first = k3.launch_k3b(card, o, d, t)
    runs = [k3.launch_k3b(card, o, d, t), k3.k3b_check_launcher(card, o, d, t)(),
            k3.launch_k3b(card, o, d, t)]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        runs += [k3.launch_k3b(card, o, d, t), k3.launch_k3b(card, o, d, t)]
    torch.cuda.current_stream().wait_stream(side)
    for again in runs:
        assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])
    with pytest.raises(ValueError):
        k3.k3b_check_launcher(card, o, d, t, 3)()


def test_k3b_planted_faults_break_the_contract(meshes):
    """The check build's faults (a cull at half the best distance, the
    fetch dropping the batch of the first camera ray) break the contract."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel.traverse import traverse

    card = meshes[0].without_wide()
    o, d, t = _mesh_rays("cuda", seed=19)
    want = traverse(card, o, d, t)
    for fault in k3.K3B_FAULTS.values():
        got = k3.k3b_check_launcher(card, o, d, t, fault, fault_ray=0)()
        a = k3.hit_agreement(card, got, want, t)
        assert a["hit_mismatch"] + a["geometry_mismatch"] > 1e-3, (fault, a)


K3C_FIELDS = [("normal",), ("normal", "uv"), ("normal", "tangent"),
              ("normal", "uv", "tangent"), ("normal", "uv", "tangent", "smooth")]


@pytest.mark.parametrize("fields", K3C_FIELDS)
def test_k3c_matches_capture_reference(meshes, fields):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel.traverse import capture_reference

    card, _ = meshes
    o, d, t = _mesh_rays("cuda", seed=7)
    before = (k3.launch_k3.count, k3.launch_k3.capture_count)
    slot, tt, extras = k3.launch_k3(card, o, d, t, capture=fields)
    torch.cuda.synchronize()
    assert (k3.launch_k3.count, k3.launch_k3.capture_count) == (
        before[0], before[1] + 1)
    assert tuple(extras) == fields
    plain = k3.launch_k3(card, o, d, t)
    assert torch.equal(slot, plain[0]) and torch.equal(tt, plain[1])
    assert (slot >= 0).sum() > 500
    want = capture_reference(card, o, d, slot, fields)
    a = k3.capture_agreement(card, (slot, tt, extras), (slot, tt, want))
    assert k3.capture_contract(a), a
    assert a["rays"] == int((slot >= 0).sum())


def test_k3c_planted_faults_break_the_contract(meshes):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel.traverse import CAPTURE_WIDTHS

    card, _ = meshes
    o, d, t = _mesh_rays("cuda", seed=8)
    fields = tuple(CAPTURE_WIDTHS)
    good = k3.launch_k3(card, o, d, t, capture=fields)
    for what, fault in k3.CAPTURE_FAULTS.items():
        bad = k3.launch_k3(card, o, d, t, capture=fields, fault=fault)
        assert torch.equal(bad[0], good[0]) and torch.equal(bad[1], good[1])
        a = k3.capture_agreement(card, bad, good)
        assert not k3.capture_contract(a), what


def test_k3c_refuses_what_it_does_not_take(meshes):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3

    card, _ = meshes
    o, d, t = _mesh_rays("cuda", n=64)
    with pytest.raises(ValueError, match="wide kernel"):
        k3.traverse_cuda(card.without_wide(), o, d, t, capture=("normal",))
    with pytest.raises(ValueError, match="normal"):
        k3.launch_k3(card, o, d, t, capture=("uv",))
    for fault in k3.CAPTURE_FAULTS.values():
        with pytest.raises(ValueError, match="every field"):
            k3.launch_k3(card, o, d, t, capture=("normal",), fault=fault)
    empty = k3.launch_k3(card, o[:0], d[:0], t[:0], capture=("normal",))
    assert empty[2]["normal"].shape == (0, 3)


def test_captured_renderer_on_card_runs_k3c_and_matches_cpu(meshes, tmp_path):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    p = tmp_path / "s.obj"
    write_uv_sphere(p, 14.0, 24, 32)
    rng = np.random.default_rng(1)
    hdr = rng.uniform(0, 1.5, (16, 32, 3)).astype(np.float32)
    nmap = (rng.uniform(0, 1, (32, 32, 3)) * 0.2 + (0.4, 0.4, 0.8)).astype(np.float32)
    smap = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    imgs = []
    for device in ("cuda", "cpu"):
        r = vpt.Renderer(64, 32, settings=vpt.RenderSettings(
            samples_per_pass=2, bounces=3, captured_attrs=True), device=device)
        r.load_mesh(str(p))
        r.load_texture(nmap, 2.2, 1)
        r.load_texture(smap, 2.2, 2)
        r.load_hdr(hdr)
        r.update_camera(origin=(0.0, 0.0, 40.0))
        before = (k3.launch_k3.count, k3.launch_k3.capture_count,
                  trav.traverse.count)
        imgs.append(r.render_frames(2))
        if device == "cuda":
            assert not r.settings.compact_waves
            assert (k3.launch_k3.count, k3.launch_k3.capture_count,
                    trav.traverse.count) == (before[0], before[1] + 2 * 3,
                                             before[2])
    _assert_contract(*[[torch.from_numpy(x) for x in pair] for pair in imgs])


def test_mesh_renderer_on_card_runs_k3_and_matches_cpu(meshes, tmp_path):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    p = tmp_path / "s.obj"
    write_uv_sphere(p, 14.0, 24, 32)
    rng = np.random.default_rng(0)
    hdr = rng.uniform(0, 1.5, (16, 32, 3)).astype(np.float32)
    nmap = (rng.uniform(0, 1, (32, 32, 3)) * 0.2 + (0.4, 0.4, 0.8)).astype(np.float32)
    imgs = []
    for device in ("cuda", "cpu"):
        r = vpt.Renderer(64, 32, settings=vpt.RenderSettings(
            samples_per_pass=2, bounces=3), device=device)
        r.load_mesh(str(p))
        r.load_texture(nmap, 2.2, 1)
        r.load_hdr(hdr)
        r.update_camera(origin=(0.0, 0.0, 40.0))
        before = (k3.launch_k3.count, trav.traverse.count)
        imgs.append(r.render_frames(2))
        if device == "cuda":
            assert r.settings.radiance_kernel == "wavefront"
            assert k3.launch_k3.count == before[0] + 2 * 3
            assert trav.traverse.count == before[1]
    _assert_contract(*[[torch.from_numpy(x) for x in pair] for pair in imgs])


def test_failed_traverse_build_raises(cuda, monkeypatch, tmp_path):
    from vrenderer_pathtracer_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="nvcc failed for traverse"):
        build.build("traverse")
    assert not list(tmp_path.iterdir())


# -- K4 -----------------------------------------------------------------------

def _k4_renderer(kind, device, tmp_path, size=64):
    """A small K4 scene through the Renderer's entry points: the textured
    1.5k-triangle sphere under an HDRI, the same sphere with a glossy MERL
    table under lobe MIS, the example sphere with a MERL table (config 4's
    shape), or the Cornell box with the sphere and a diffuse map."""
    from chip_smoke import glossy_merl, write_merl
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    obj = tmp_path / "s.obj"
    if not obj.exists():
        write_uv_sphere(obj, 14.0, 24, 32)
    rng = np.random.default_rng(0)
    hdr = rng.uniform(0, 1.5, (16, 32, 3)).astype(np.float32)
    tex = rng.uniform(0.1, 1, (32, 32, 3)).astype(np.float32)
    table = tmp_path / "glossy.binary"
    write_merl(table, glossy_merl(0.1, (1.0, 0.8, 0.4)))
    cornell = kind == "cornell mesh texture"
    r = vpt.Renderer(size, size, settings=vpt.RenderSettings(
        samples_per_pass=2, bounces=3, use_cornell_box=cornell,
        has_hdr=not cornell, brdf_importance_sampling=kind == "mesh merl mis"),
        device=device)
    if kind == "example sphere merl":
        r.use_example_sphere(True)
    else:
        r.load_mesh(str(obj))
    if kind in ("textured mesh", "cornell mesh texture"):
        r.load_texture(tex, 2.2, 0)
    if not cornell:
        r.load_hdr(hdr)
        r.update_camera(origin=(0.0, 0.0, 40.0))
    if "merl" in kind:
        r.load_brdf(str(table))
        r.use_brdf(True)
    return r


K4_KINDS = ["textured mesh", "mesh merl mis", "example sphere merl",
            "cornell mesh texture"]


@pytest.mark.parametrize("kind", K4_KINDS)
def test_k4_matches_plain_and_repeats_bit_identical(cuda, tmp_path, kind):
    """K4's records against records_reference under chip_smoke.py's K4
    contract, and two launches bit-identical."""
    from chip_smoke import k4_args, k4_contract, k4_readings
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

    r = _k4_renderer(kind, cuda, tmp_path)
    assert r.settings.radiance_kernel == "cuda_mesh"
    before = k4.launch_k4.count
    got = k4.launch_k4(*k4_args(r), 1, 0)
    torch.cuda.synchronize()
    assert k4.launch_k4.count == before + 1
    want = k4.records_reference(r.scene, r.settings, r.camera, 1,
                                r.fresnel_coef, r.fresnel_pow, 0)
    assert k4_contract(k4_readings(r, got, want), r.settings.use_cornell_box)
    assert torch.equal(got, k4.launch_k4(*k4_args(r), 1, 0))


@pytest.mark.parametrize("kind", ["textured mesh", "example sphere merl"])
def test_k4_direct_matches_records_and_plain(cuda, tmp_path, kind):
    """K4's direct mode against the plain version's composed pass and the
    records mode's, under chip_smoke.py's K4 contract on the image and the
    depth; its planted fetch faults break it."""
    from chip_smoke import direct_readings, k4_args, k4_contract
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

    r = _k4_renderer(kind, cuda, tmp_path)
    a = k4_args(r)
    before = k4.launch_k4.count
    got = k4.launch_k4(*a, 1, 0, direct=True)
    torch.cuda.synchronize()
    assert k4.launch_k4.count == before + 1 and got.shape == (4, r.settings.n_pixels)
    plain = k4.compose(k4.records_reference(r.scene, r.settings, r.camera, 1,
                                            r.fresnel_coef, r.fresnel_pow, 0),
                       r.scene, r.settings)
    records = k4.compose(k4.launch_k4(*a, 1, 0), r.scene, r.settings)
    cornell = r.settings.use_cornell_box
    for want in (plain, records):
        assert k4_contract(direct_readings(got, want), cornell)
    assert torch.equal(got, k4.launch_k4(*a, 1, 0, direct=True))
    fault = k4.FAULT_MERL_SCALE if "merl" in kind else k4.FAULT_ENV_U
    bad = k4.launch_k4(*a, 1, 0, direct=True, fault=fault)
    assert not k4_contract(direct_readings(bad, plain), cornell)
    with pytest.raises(ValueError):
        k4.launch_k4(*a, 1, 0, fault=fault)  # a direct fault in records mode


def test_k4_renderer_runs_k4_each_pass_and_matches_cpu(cuda, tmp_path):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

    r = _k4_renderer("textured mesh", cuda, tmp_path)
    before = (k4.launch_k4.count, k4.records_reference.count, k3.launch_k3.count,
              k4.compose.count)
    img, depth = r.render_frames(3)
    assert (k4.launch_k4.count, k4.records_reference.count, k3.launch_k3.count,
            k4.compose.count) == (before[0] + 3, before[1], before[2], before[3])
    cpu = _k4_renderer("textured mesh", "cpu", tmp_path)
    assert cpu.settings.radiance_kernel == "torch"
    cimg, cdepth = cpu.render_frames(3)
    diff = np.abs(img - cimg)  # the golden image contract
    assert (diff > 1e-3).any(axis=-1).mean() <= 0.02 and diff.mean() <= 2e-3
    assert (np.abs(depth - cdepth) > 1e-3).mean() <= 0.02


@pytest.mark.parametrize("kind", ["textured mesh", "mesh merl mis"])
def test_k4_records_reference_draws_through_k7(cuda, tmp_path, monkeypatch,
                                               kind):
    """records_reference (K4's records mode on the card) draws each bounce
    through K7, with the slot-2 draw under lobe MIS: its records are the
    int64 draws' bit for bit."""
    from vrenderer_pathtracer_tpu_torch.core import rng
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

    r = _k4_renderer(kind, cuda, tmp_path)
    args = (r.scene, r.settings, r.camera, 3, r.fresnel_coef, r.fresnel_pow, 7)
    launches = rng.bounce_uniforms.count
    got = k4.records_reference(*args)
    assert rng.bounce_uniforms.count == launches + r.settings.bounces

    def int64_draws(seed, pix, samp, frame, bounce, n_slots):
        assert n_slots == (3 if kind == "mesh merl mis" else 2)
        return tuple(u for slot in range(n_slots) for u in rng.uniform2(
            seed, pix, rng.make_stream(frame, samp, bounce, slot)))

    monkeypatch.setattr(rng, "bounce_uniforms", int64_draws)
    assert torch.equal(got, k4.records_reference(*args))


def test_k4_refuses_inputs_that_require_grad(cuda, tmp_path):
    from chip_smoke import k4_args
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

    r = _k4_renderer("textured mesh", cuda, tmp_path, size=16)
    cam, sph, scene, s = k4_args(r)
    with pytest.raises(ValueError, match="requires grad"):
        k4.launch_k4(cam.clone().requires_grad_(), sph, scene, s, 1)
    yaw = r.camera.yaw.clone().requires_grad_()
    with pytest.raises(ValueError, match="requires grad"):
        k4.render_pass_mesh(scene, s, r.camera.replace(yaw=yaw), 1,
                            r.fresnel_coef, r.fresnel_pow)
    with pytest.raises(NotImplementedError):
        k4.launch_k4(cam, sph, scene, s.replace(has_normal_map=True), 1)


def test_deferred_opt_step_runs_k4_on_card(cuda, tmp_path):
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

    r = _k4_renderer("example sphere merl", cuda, tmp_path, size=32)
    target, _ = k4.render_pass_mesh(r.scene.replace(hdr=r.scene.hdr * 1.5),
                                    r.settings, r.camera, 1, r.fresnel_coef,
                                    r.fresnel_pow)
    params = vpt.DeferredParams.from_scene(r.scene, hdr=True, brdf=True)
    for leaf in params.leaves():
        leaf.requires_grad_()
    step = vpt.deferred_opt_step(r.settings, torch.optim.Adam(params.leaves(), lr=0.05),
                                 scene=r.scene)
    before = k4.launch_k4.count
    losses = [step(params, r.scene, r.camera, target, 1, r.fresnel_coef,
                   r.fresnel_pow)[1]["loss"].item() for _ in range(4)]
    assert k4.launch_k4.count == before + 4
    assert losses[-1] < losses[0]


def test_failed_mesh_build_raises(cuda, monkeypatch, tmp_path):
    from vrenderer_pathtracer_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["--no-such-flag"])
    with pytest.raises(RuntimeError, match="nvcc failed for mesh"):
        build.build("mesh")
    assert not list(tmp_path.iterdir())


# -- K5 and K6 ----------------------------------------------------------------

@pytest.fixture(scope="module")
def paged_meshes(tmp_path_factory):
    """A 3,120-triangle sphere in 7 pages of 512, on the card and the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from vrenderer_pathtracer_tpu_torch.accel.paged import pack_mesh_paged
    from vrenderer_pathtracer_tpu_torch.native import load_obj
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    p = tmp_path_factory.mktemp("k5") / "s.obj"
    write_uv_sphere(p, 12.0, 40, 40)
    host = load_obj(str(p))
    return (pack_mesh_paged(host, 512, device="cuda"),
            pack_mesh_paged(host, 512, device="cpu"))


def test_k5_matches_plain_and_brute_force(paged_meshes):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav

    card, cpu = paged_meshes
    o, d, t = _mesh_rays("cuda")
    before = k5.launch_k5.count
    got = k5.traverse_paged_cuda(card, o, d, t)
    torch.cuda.synchronize()
    assert k5.launch_k5.count == before + 1
    assert got[0].dtype == torch.int32 and got[1].dtype == torch.float32
    before = trav.traverse_paged_reference.count
    want = trav.traverse_paged_reference(card, o, d, t)
    _assert_traversal_contract(card, got, want, t)
    _assert_traversal_contract(card, got, trav.brute_force(card, o, d, t), t)
    on_cpu = k5.traverse_paged_cuda(cpu, o.cpu(), d.cpu(), t.cpu())
    assert trav.traverse_paged_reference.count == before + 2
    _assert_traversal_contract(cpu, tuple(x.cpu() for x in got), on_cpu, t.cpu())
    stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    k5.launch_k5(card, o, d, t, stats=stats)
    visits, boxes, tris, pages = stats.tolist()
    assert 0 < pages < visits <= boxes and tris > 0


def test_k5_planted_faults_break_the_contract(paged_meshes):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5
    from vrenderer_pathtracer_tpu_torch.accel.cuda_traverse import hit_agreement

    card, _ = paged_meshes
    o, d, t = _mesh_rays("cuda", seed=8)
    want = k5.launch_k5(card, o, d, t)
    for name in ("global slot one page off", "nearest page skipped"):
        a = hit_agreement(card, k5.launch_k5(card, o, d, t,
                                              fault=k5.FAULTS[name]), want, t)
        assert a["geometry_mismatch"] + a["hit_mismatch"] > 1e-3, (name, a)


def test_k5_one_walk_finds_k3s_triangles_and_counts_pages(paged_meshes):
    """K5 is one walk over the paged tree's compressed copy: it finds the
    same triangle as K3 on a single-level pack of the same mesh on every
    ray (chip_smoke.py phase 35 at full size), counts at most one entry a
    page a ray, and its gate fault (a page root gated on the next entry's
    distance) breaks that equality."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
    from vrenderer_pathtracer_tpu_torch.native import load_obj
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    card, _ = paged_meshes
    with tempfile.TemporaryDirectory() as tmp:
        write_uv_sphere(f"{tmp}/s.obj", 12.0, 40, 40)
        flat = pack_mesh(load_obj(f"{tmp}/s.obj"), paged=False, device="cuda")
    o, d, t = _mesh_rays("cuda", seed=12)
    want = k3.launch_k3(flat, o, d, t)
    stats = torch.zeros(4, dtype=torch.int64, device="cuda")
    got = k5.launch_k5(card, o, d, t, stats=stats)
    a = k3.hit_agreement(flat, want, got, t, want_mesh=card)
    assert a["hit_mismatch"] == a["geometry_mismatch"] == 0, a
    visits, boxes, tris, pages = stats.tolist()
    assert 0 < pages <= card.paged.n_pages * o.shape[0] and pages < visits
    gate = k5.FAULTS["a page's occlusion skip tests > against the next entry's entry t"]
    bad = k5.launch_k5(card, o, d, t, fault=gate)
    a = k3.hit_agreement(flat, want, bad, t, want_mesh=card)
    assert a["hit_mismatch"] + a["geometry_mismatch"] > 0, a
    with pytest.raises(ValueError):
        k5.launch_k5(card, o, d, t, fault=9)


def test_k5_nan_rays_leave_others_bit_identical(paged_meshes):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5

    card, _ = paged_meshes
    o, d, t = _mesh_rays("cuda", seed=9)
    bad = torch.zeros(o.shape[0], dtype=torch.bool, device="cuda")
    bad[::7] = True
    bad[3::11] = True
    o2, d2 = o.clone(), d.clone()
    o2[::7] = float("nan")
    d2[3::11, 1] = float("nan")
    clean, mixed = k5.launch_k5(card, o, d, t), k5.launch_k5(card, o2, d2, t)
    for a, b in zip(clean, mixed):
        assert torch.equal(a[~bad], b[~bad])
    assert (mixed[0][bad] == -1).all()
    again = k5.launch_k5(card, o, d, t)
    assert all(torch.equal(a, b) for a, b in zip(clean, again))


def test_k5_refuses_what_it_does_not_take(paged_meshes, meshes):
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5

    card, _ = paged_meshes
    o, d, t = _mesh_rays("cuda", n=64)
    with pytest.raises(NotImplementedError):
        k5.traverse_paged_cuda(meshes[0], o, d, t)  # a single-level mesh
    with pytest.raises(ValueError):
        k5.traverse_paged_cuda(card, o.cpu(), d.cpu(), t.cpu())
    with pytest.raises(ValueError):
        k5.traverse_paged_cuda(card, o, d, t[:-1])
    empty = k5.traverse_paged_cuda(card, o[:0], d[:0], t[:0])
    assert empty[0].shape == (0,)


def test_paged_renderer_on_card_runs_k5_and_matches_cpu(paged_meshes):
    """A config-5-shaped scene (paged mesh, HDRI, MERL, FXAA, remat): on the
    card it resolves to the wavefront with K5 and compact waves, runs K5
    `bounces` times a pass and never the plain search, and matches the CPU."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.ops.brdf import TABLE_SIZE

    rng = np.random.default_rng(0)
    hdr = rng.uniform(0.2, 1.2, (16, 32, 3)).astype(np.float32)
    imgs = []
    for mesh in paged_meshes:
        r = vpt.Renderer(64, 32, settings=vpt.RenderSettings(
            samples_per_pass=2, bounces=3, use_fxaa=True, use_brdf=True,
            remat_bounces=True), device=mesh.device)
        r.load_hdr(hdr)
        r.load_brdf(np.full((3, TABLE_SIZE), 0.05, np.float32))
        r.init_mesh(mesh)
        r.update_camera(origin=(0.0, 0.0, 40.0))
        before = (k5.launch_k5.count, trav.traverse_paged_reference.count)
        imgs.append(r.render_frames(2))
        if mesh.device.type == "cuda":
            s = r.settings
            assert (s.radiance_kernel, s.traversal, s.compact_waves) == (
                "wavefront", "cuda_paged", True)
            assert k5.launch_k5.count == before[0] + 2 * 3
            assert trav.traverse_paged_reference.count == before[1]
    _assert_contract(*[[torch.from_numpy(x) for x in pair] for pair in imgs])


def test_k6_matches_plain_chain(cuda):
    from vrenderer_pathtracer_tpu_torch.kernels import probe

    g = torch.Generator().manual_seed(0)
    xf = (torch.rand((256, 128), generator=g) + 0.5).to(cuda)
    xb = (torch.rand((512, 128), generator=g) + 0.5).to(cuda, torch.bfloat16)
    c, a = probe.CHECK_C, probe.CHECK_A
    for x in (xf, xb):
        before = probe.launch_k6.count
        got = probe.chain(x, c, a)
        assert probe.launch_k6.count == before + 1
        want = probe.chain_reference(x, c, a)
        # float32 within probe.F32_RTOL (fmaf against two roundings a
        # step), bfloat16 bit-equal.
        assert probe.chain_agreement(got, want)[0], x.dtype
        # The planted no-op kernel (the input written back) must fail.
        assert not probe.chain_agreement(
            probe.launch_k6(x, c, a, fault=1), want)[0], x.dtype
    with pytest.raises(ValueError):
        probe.launch_k6(xb.reshape(-1)[:3].contiguous())
    with pytest.raises(ValueError):
        probe.launch_k6(xf.double())


@pytest.mark.parametrize("k", [1, 2, 4, 8])
def test_k6_every_chain_count_matches_plain_chain(cuda, k):
    """K6 at k chains a thread on each grid against the plain chain at the
    check constants, float32 within probe.F32_RTOL and bf16 bit-equal, at a
    ragged size (2^22 + 6: a tail at every k above 2)."""
    from vrenderer_pathtracer_tpu_torch.kernels import probe

    g = torch.Generator().manual_seed(k)
    c, a = probe.CHECK_C, probe.CHECK_A
    n = (1 << 22) + 6
    for dtype in (torch.float32, torch.bfloat16):
        x = (torch.rand(n, generator=g) + 0.5).to(cuda, dtype)
        want = probe.chain_reference(x, c, a)
        for grid in probe.GRIDS:
            got = probe.launch_k6(x, c, a, k=k, grid=grid)
            assert probe.chain_agreement(got, want)[0], (dtype, grid)


def test_failed_paged_build_raises(cuda, monkeypatch, tmp_path):
    from vrenderer_pathtracer_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["--no-such-flag"])
    for name in ("paged", "probe"):
        with pytest.raises(RuntimeError, match=f"nvcc failed for {name}"):
            build.build(name)
    assert not list(tmp_path.iterdir())


# --- shard offsets (parallel/sharding.py) ------------------------------------

def test_k1_tiles_and_sample_halves_reassemble_the_frame(cuda):
    """K1 over tile ranges (one from mid-row) is its full launch bit for
    bit; two one-sample halves average to it, the last half's depth its."""
    s = vpt.RenderSettings(width=64, height=32, samples_per_pass=2, bounces=4,
                           **CORNELL)
    scene, cam = Scene.analytic(s, cuda), Camera.default(cuda)
    tables = (k1.pack_camera(cam, s, 0.1, 3.0), k1.pack_spheres(scene.spheres))
    full = k1.launch(*tables, s, 1)
    parts = [k1.launch(*tables, s, 1, 0, o, 0, n)
             for o, n in ((0, 100), (100, 1000), (1100, 948))]
    for got, want in zip(zip(*parts), full):
        assert torch.equal(torch.cat(got), want)
    half = s.replace(samples_per_pass=1)
    a, b = (k1.launch(*tables, half, 1, 0, 0, so) for so in (0, 1))
    assert torch.equal((a[0] + b[0]) / 2, full[0]) and torch.equal(b[1], full[1])
    with pytest.raises(ValueError, match="not in the frame"):
        k1.launch(*tables, s, 1, 0, 2000, 0, 100)


def test_k2_tile_rows_add_up_to_the_frame(cuda):
    s = vpt.RenderSettings(**SMALL)
    scene, cam = Scene.analytic(s, cuda), Camera.default(cuda)
    tables = (k1.pack_camera(cam, s, 0.1, 3.0), k1.pack_spheres(scene.spheres))
    target = torch.rand((s.n_pixels, 3), generator=torch.Generator().manual_seed(0)).to(cuda)
    full = k2.launch(*tables, s, target, 1)
    rows = sum(k2.launch(*tables, s, target[o:o + n].contiguous(), 1,
                         pixel_offset=o, n_local_pixels=n)
               for o, n in ((0, 1000), (1000, 1048)))
    torch.testing.assert_close(rows, full, rtol=1e-5, atol=1e-7)


def test_k4_tiles_reassemble_both_modes(cuda, meshes):
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

    r = vpt.Renderer(48, 32, settings=vpt.RenderSettings(
        samples_per_pass=2, bounces=3), device=cuda)
    r.init_mesh(meshes[0])
    r.load_hdr(np.random.default_rng(0).uniform(0, 1, (16, 32, 3)).astype(np.float32))
    r.update_camera(origin=(0.0, 0.0, 40.0))
    assert r.settings.radiance_kernel == "cuda_mesh"
    args = (k1.pack_camera(r.camera, r.settings, r.fresnel_coef, r.fresnel_pow),
            k1.pack_spheres(r.scene.spheres), r.scene, r.settings, 1, 0)
    for direct in (True, False):
        full = k4.launch_k4(*args, direct=direct)
        parts = [k4.launch_k4(*args, direct=direct, pixel_offset=o,
                              n_local_pixels=n)
                 for o, n in ((0, 70), (70, 900), (970, 566))]
        assert torch.equal(torch.cat(parts, dim=1), full)


def test_world_size_one_sharded_renderer_is_the_unsharded_one(cuda, tmp_path):
    import torch.distributed as dist

    from vrenderer_pathtracer_tpu_torch.parallel import make_render_mesh, multihost

    s = vpt.RenderSettings(**SMALL)
    multihost.initialize(f"file://{tmp_path / 'rendezvous'}", 1, 0)
    try:
        mesh = make_render_mesh(1, 1, "cuda")
        a = vpt.Renderer(64, 32, settings=s, device_mesh=mesh).render_frames(2)
        b = vpt.Renderer(64, 32, settings=s).render_frames(2)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    finally:
        dist.destroy_process_group()
