"""The headline benchmark on the card: one JSON line of Mrays/s (port of
the repository's ``bench.py``).

Rays are counted as pixels x spp x bounces for a forward pass, doubled for
forward + backward (one loss + gradient step with respect to the material
and Fresnel parameters), as ``bench.py`` counts them.  The headline,
``mrays_per_s_per_chip_fwdbwd_cornell1024_4bounce``, is K2
(``render/cuda_grad.py::cornell_loss_grads``) on the Cornell scene at
1024², 2 spp, 4 bounces: the median of 5 groups of 8 calls, a new frame a
call.  The other measurements keep ``bench.py``'s sizes, iteration counts
and varied inputs (a new frame, or a camera moved by 1e-4, a call):

* ``step`` — ``sharded_render_step`` (K1) and ``sharded_train_step`` (K2)
  on a (1, 1) mesh, in a world-size-1 process group (NCCL on the card);
* ``mesh`` — K3 (``traverse_cuda``) on a 28,560-triangle UV sphere,
  1024x512 primary rays;
* ``megakernel`` — ``Renderer`` passes of the Cornell scene (K1);
* ``paged`` — K5 (``traverse_paged_cuda``) on the 179,400-triangle
  sphere, paged;
* ``mesh_megakernel`` — K4 (``render_pass_mesh``, direct mode) on the
  28.5k sphere under a 64x128 HDRI with a 256² diffuse map, 1024²;
* ``nm_wavefront`` — the wavefront (``integrator.render_pass``) on the
  same scene with normal and specular maps, its mesh search K3;
* ``config5`` — BASELINE config 5 (a 499,000-triangle paged sphere, HDRI,
  MERL, FXAA, remat) at 1920x1080 through the ``Renderer``: K5 and the
  wavefront.

Each timed measurement reports its wall time (the host clock over the
calls, ending in a synchronize) and a ``*_device_ms`` twin (``TWINS``):
the device time per call from the profiler over as many further calls
(``utils/profiling.py::device_ms_per_call``), the busy time of every
kernel, copy and fill, or for the headline K2's kernel alone, as
``bench.py``'s ``fwdbwd_pallas_device_ms``.  The Cornell, K4 and config-5
passes are host-bound, so their walls and device times differ.  Asset
set-up (``*_setup_s``) stays outside every timed window.

The line is ``bench.py``'s: ``metric``, ``value``, ``unit``,
``vs_baseline``, ``extra``.  ``KEYS`` maps every key of ``bench.py``'s line
to the port's; a name that says ``pallas`` or ``xla`` is renamed to what
the port runs.  ``extra`` also states the card and its power limit
(``nvidia-smi``), the launches of K1-K5 over the command, and every
twin's device ms by kernel.  ``vs_baseline`` is this value over that of
an earlier line of this command (``--baseline FILE``), else 1.0.

Nothing is caught or skipped: a measurement that fails, or a path that
resolves to another backend than its kernel (or runs a plain version on
the card), raises, and the command exits non-zero with no line.  It runs
on the card only, and raises ``RuntimeError`` without one.  The
measurement functions take their sizes and ``device`` as keywords; on the
CPU (the tests, at small sizes) the plain versions run and the twins are
None.

    python -m vrenderer_pathtracer_tpu_torch bench [--only mesh,paged] \\
        [--baseline earlier.jsonl] [--trace DIR]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

METRIC = "mrays_per_s_per_chip_fwdbwd_cornell1024_4bounce"
HEADLINE_SHAPE = (1024, 1024, 2, 4)  # width, height, spp, bounces

# Every key of bench.py's line (its record and its extra) -> the port's.
KEYS = {
    "metric": "metric",
    "value": "value",
    "unit": "unit",
    "vs_baseline": "vs_baseline",
    "extra": "extra",
    "mrays_per_s_forward": "mrays_per_s_forward",
    "fwd_ms": "fwd_ms",
    "fwdbwd_xla_ms": "fwdbwd_step_ms",
    "mrays_per_s_fwdbwd_xla": "mrays_per_s_fwdbwd_step",
    "fwdbwd_pallas_ms": "fwdbwd_k2_ms",
    "fwdbwd_pallas_ms_group_minmax": "fwdbwd_k2_ms_group_minmax",
    "fwdbwd_pallas_device_ms": "fwdbwd_k2_device_ms",
    "n_devices": "n_devices",
    "platform": "platform",
    "loss": "loss",
    "mesh_traversal_mrays_per_s": "mesh_traversal_mrays_per_s",
    "mesh_tris": "mesh_tris",
    "mesh_hitrate": "mesh_hitrate",
    "megakernel_fwd_mrays_per_s": "megakernel_fwd_mrays_per_s",
    "megakernel_pass_ms": "megakernel_pass_ms",
    "paged_traversal_mrays_per_s": "paged_traversal_mrays_per_s",
    "paged_tris": "paged_tris",
    "paged_pages": "paged_pages",
    "mesh_megakernel_fwd_mrays_per_s": "mesh_megakernel_fwd_mrays_per_s",
    "mesh_megakernel_pass_ms": "mesh_megakernel_pass_ms",
    "nm_wavefront_mrays_per_s": "nm_wavefront_mrays_per_s",
    "nm_wavefront_pass_ms": "nm_wavefront_pass_ms",
    "c5_spec_pass_ms": "c5_spec_pass_ms",
    "c5_spec_mrays_per_s": "c5_spec_mrays_per_s",
    "c5_compact_mode": "c5_compact_mode",
}

# Each timed measurement's wall key -> its device twin.
TWINS = {
    "fwd_ms": "fwd_device_ms",
    "fwdbwd_step_ms": "fwdbwd_step_device_ms",
    "fwdbwd_k2_ms": "fwdbwd_k2_device_ms",
    "mesh_traversal_ms": "mesh_traversal_device_ms",
    "megakernel_pass_ms": "megakernel_pass_device_ms",
    "paged_traversal_ms": "paged_traversal_device_ms",
    "mesh_megakernel_pass_ms": "mesh_megakernel_pass_device_ms",
    "nm_wavefront_pass_ms": "nm_wavefront_pass_device_ms",
    "c5_spec_pass_ms": "c5_spec_pass_device_ms",
}

# The kernels the card launches, by their symbols in csrc/ (K3b is K3's
# twin on a mesh without the 8-wide tree; no measurement should run it).
KERNELS = {"K1": "radiance_kernel", "K2": "grad_kernel",
           "K3": "traverse_wide_kernel", "K3b": "traverse_binary_kernel",
           "K4": "mesh_kernel", "K5": "paged_kernel"}


# --- bookkeeping ------------------------------------------------------------

def _device(device) -> torch.device:
    """None or "cuda": the current card (``RuntimeError`` without one:
    nothing carries on quietly on the CPU); else ``device``."""
    if device is not None and torch.device(device) != torch.device("cuda"):
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: the bench runs on "
                           "the card only")
    return torch.device("cuda", torch.cuda.current_device())


def _counted():
    """The functions whose ``.count`` the route checks read: the kernels'
    launches and the plain versions' calls."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged, cuda_traverse, traverse
    from vrenderer_pathtracer_tpu_torch.render import cuda_grad, cuda_mesh, cuda_radiance

    return {"K1": cuda_radiance.launch, "K2": cuda_grad.launch,
            "K3": cuda_traverse.launch_k3, "K3b": cuda_traverse.launch_k3b,
            "K4": cuda_mesh.launch_k4, "K5": cuda_paged.launch_k5,
            "render_pass_reference": cuda_radiance.render_pass_reference,
            "traverse": traverse.traverse,
            "traverse_paged_reference": traverse.traverse_paged_reference,
            "records_reference": cuda_mesh.records_reference}


def _counts() -> dict:
    return {name: fn.count for name, fn in _counted().items()}


def _check_route(name: str, device: torch.device, before: dict, want: dict):
    """Raise unless, since ``before``, the card launched exactly ``want``
    ({kernel: launches}) and ran no plain version; on the CPU, unless no
    kernel launched (the plain versions run there)."""
    got = {k: v - before[k] for k, v in _counts().items()}
    if device.type == "cuda":
        expect = {k: want.get(k, 0) for k in got}
    else:
        got = {k: got[k] for k in KERNELS}
        expect = dict.fromkeys(KERNELS, 0)
    if got != expect:
        raise RuntimeError(f"bench {name}: launches and plain-version calls "
                           f"{got}, want {expect}")


def _require(name: str, what: str, got, want):
    if got != want:
        raise RuntimeError(f"bench {name}: {what} resolved to {got!r}, not "
                           f"{want!r}")


def kernel_ms(by_name: dict) -> dict:
    """Device ms per call by kernel ID (``KERNELS``) from
    ``device_ms_per_call``'s readings, for the kernels present."""
    out = {}
    for kid, symbol in KERNELS.items():
        pattern = re.compile(rf"(^|[\s:]){symbol}\b")
        ms = sum(v for k, v in by_name.items() if pattern.search(k))
        if ms:
            out[kid] = ms
    return out


def _twin(label, fn, calls, device, trace_dir, want, kernel_only=None):
    """``(device ms per call, {kernel: ms per call})`` of ``calls`` calls of
    ``fn(i)``: every device event's time, or ``kernel_only``'s alone;
    ``(None, {})`` on the CPU.  Raises unless every kernel of ``want`` ran
    in the window."""
    from vrenderer_pathtracer_tpu_torch.utils.profiling import device_ms_per_call

    if device.type != "cuda":
        return None, {}
    by_name = device_ms_per_call(fn, calls, device, trace_dir=trace_dir,
                                 label=label)
    kernels = kernel_ms(by_name)
    missing = [k for k in want if k not in kernels]
    if missing:
        raise RuntimeError(f"bench {label}: the profiler shows no {missing} "
                           f"(kernels seen: {sorted(kernels)})")
    ms = kernels[kernel_only] if kernel_only else sum(by_name.values())
    return ms, kernels


def _wall(fn, calls, device) -> float:
    """Host seconds per call of ``fn(0), ..., fn(calls - 1)``, the last
    ending in a synchronize."""
    from vrenderer_pathtracer_tpu_torch.utils.profiling import synchronize

    synchronize(device)
    t0 = time.perf_counter()
    for i in range(calls):
        fn(i)
    synchronize(device)
    return (time.perf_counter() - t0) / calls


def _sliders(device):
    f32 = dict(dtype=torch.float32, device=device)
    return torch.tensor(0.1, **f32), torch.tensor(3.0, **f32)


def _cornell(width, height, spp, bounces):
    from vrenderer_pathtracer_tpu_torch.config import RenderSettings

    return RenderSettings(width=width, height=height, samples_per_pass=spp,
                          bounces=bounces, use_cornell_box=True, has_hdr=False)


def _camera_at(x, z, device):
    """The default camera moved to ``(x, 0, z)``: ``bench.py``'s jitter."""
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera

    return Camera.default(device).replace(origin=torch.tensor(
        [x, 0.0, z], dtype=torch.float32, device=device))


def _primary_rays(i, width, height, device):
    """Primary rays from ``(1e-4 i, 0, 28)``, ``bench.py``'s traversal
    rays: ``(origins [B,3] contiguous, directions [B,3])``."""
    from vrenderer_pathtracer_tpu_torch.core.camera import generate_rays

    o, d = generate_rays(_camera_at(1e-4 * i, 28.0, device), width, height)
    return o.contiguous(), d


def _sphere_mesh(n_theta, paged, device):
    """``bench.py``'s UV sphere (radius 12, ``n_theta`` rings and
    segments), packed on ``device``."""
    from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
    from vrenderer_pathtracer_tpu_torch.native import load_obj
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    with tempfile.TemporaryDirectory() as tmp:
        p = os.path.join(tmp, "bench_sphere.obj")
        write_uv_sphere(p, radius=12.0, n_theta=n_theta, n_phi=n_theta)
        return pack_mesh(load_obj(p), paged=paged, device=device)


def _single_level(name, mesh, device):
    """On the card the 8-wide tree with its copy, which K3 walks."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse

    if device.type == "cuda" and (mesh.nodes8_f is None
                                  or not cuda_traverse.supports(mesh)):
        raise RuntimeError(f"bench {name}: the mesh has no 8-wide tree that "
                           "K3 takes (K3b would run)")


def _textured_scene(n_theta, hdr_shape, tex_size, maps, device):
    """``bench.py``'s mesh scene: the sphere, a uniform(0, 1.5) HDRI and a
    uniform(0.1, 1) diffuse map, with ``maps`` also its normal and
    specular maps, drawn in that order from ``default_rng(0)``."""
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
    from vrenderer_pathtracer_tpu_torch.scene.spheres import build_sphere_set

    mesh = _sphere_mesh(n_theta, False, device)
    rng = np.random.default_rng(0)

    def table(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    h, w = hdr_shape
    t = (tex_size, tex_size, 3)
    assets = dict(hdr=table(rng.uniform(0, 1.5, (h, w, 3))),
                  diffuse_map=table(rng.uniform(0.1, 1, t)))
    if maps:
        assets["normal_map"] = table(rng.uniform(0, 1, t) * 0.2
                                     + (0.4, 0.4, 0.8))
        assets["specular_map"] = table(rng.uniform(0, 1, t))
    return Scene(spheres=build_sphere_set(False, device), mesh=mesh, **assets)


# --- the measurements -------------------------------------------------------

def cornell_step(*, width=1024, height=1024, spp=2, bounces=4, iters=10,
                 device=None, trace_dir=None, state=None) -> dict:
    """``bench.py``'s ``main``, first half: ``sharded_render_step`` (K1)
    and ``sharded_train_step`` (K2, SGD at lr 0.05) on the Cornell scene
    on a (1, 1) mesh in a world-size-1 group, destroyed on exit.  Frame 1
    warms each, then ``iters`` timed calls take frames 2, 3, ...; ``loss``
    is the last timed step's.  ``state``, a dict, receives
    ``last_params``: the ``TrainParams`` that step started from."""
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.examples import process_group
    from vrenderer_pathtracer_tpu_torch.parallel import (
        TrainParams, make_render_mesh, replicate, shard_pixels,
        sharded_render_step, sharded_train_step)
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene

    device = _device(device)
    settings = _cornell(width, height, spp, bounces)
    before = _counts()
    with process_group(device.type == "cpu") as world:
        if world != 1:
            raise RuntimeError(f"bench runs on one device, not a world of {world}")
        mesh = make_render_mesh(1, 1, device.type)
        scene = replicate(mesh, Scene.analytic(settings, device))
        camera = replicate(mesh, Camera.default(device))
        zeros = torch.zeros((settings.n_pixels, 3), dtype=torch.float32,
                            device=device)
        _require("step", "radiance_kernel",
                 settings_for_scene(scene, settings).radiance_kernel,
                 "cuda" if device.type == "cuda" else "torch")
        render = sharded_render_step(mesh, settings, scene=scene)
        train = sharded_train_step(mesh, settings)
        fc, fp = _sliders(device)
        run = {"accum": shard_pixels(mesh, zeros),
               "params": replicate(mesh, TrainParams.from_scene(scene))}

        def fwd(frame):
            run["accum"], run["img"], _ = render(scene, camera, run["accum"],
                                                 frame, fc, fp)

        def step(frame):
            run["last_params"] = run["params"]
            run["params"], run["loss"] = train(run["params"], scene, camera,
                                               run["target"], frame)

        fwd(1)
        fwd_s = _wall(lambda i: fwd(2 + i), iters, device)
        run["target"] = shard_pixels(mesh, torch.zeros_like(run["img"]))
        step(1)
        step_s = _wall(lambda i: step(2 + i), iters, device)
        loss = run["loss"].item()
        if state is not None:
            state["last_params"] = run["last_params"]
        frame = 2 + iters
        fwd_dev, k_fwd = _twin("fwd", lambda i: fwd(frame + i), iters, device,
                               trace_dir, ["K1"])
        step_dev, k_step = _twin("fwdbwd_step", lambda i: step(frame + i),
                                 iters, device, trace_dir, ["K2"])
    calls = 1 + 2 * iters
    _check_route("step", device, before, {"K1": calls, "K2": calls})
    if not math.isfinite(loss):
        raise FloatingPointError(f"bench step: loss {loss}")
    rays = settings.n_pixels * spp * bounces
    return {
        "mrays_per_s_forward": rays / fwd_s / 1e6,
        "fwd_ms": fwd_s * 1e3,
        "fwd_device_ms": fwd_dev,
        "fwdbwd_step_ms": step_s * 1e3,
        "fwdbwd_step_device_ms": step_dev,
        "mrays_per_s_fwdbwd_step": 2 * rays / step_s / 1e6,
        "loss": loss,
        "kernel_device_ms": {"fwd": k_fwd, "fwdbwd_step": k_step},
    }


def headline(*, width=1024, height=1024, spp=2, bounces=4, groups=5, calls=8,
             twin_calls=8, device=None, trace_dir=None) -> dict:
    """The headline: ``cornell_loss_grads`` (K2) against a black target,
    frame 1 to warm, then ``groups`` groups of ``calls`` calls with a new
    frame each; the median group's ms per call, the fastest and slowest
    groups', and K2's device ms per call over ``twin_calls`` more."""
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.render.cuda_grad import cornell_loss_grads
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

    device = _device(device)
    settings = _cornell(width, height, spp, bounces)
    scene = Scene.analytic(settings, device)
    cam = Camera.default(device)
    target = torch.zeros((settings.n_pixels, 3), dtype=torch.float32,
                         device=device)
    fc, fp = _sliders(device)
    before = _counts()

    def call(frame):
        return cornell_loss_grads(scene, settings, cam, target, frame, fc, fp)

    loss = call(1)[0]
    if not math.isfinite(loss.item()):
        raise FloatingPointError(f"bench headline: loss {loss.item()}")
    group_s = [_wall(lambda i, g=g: call(2 + g * calls + i), calls, device)
               for g in range(groups)]
    frame = 2 + groups * calls
    dev_ms, kernels = _twin("fwdbwd_k2", lambda i: call(frame + i),
                            twin_calls, device, trace_dir, ["K2"],
                            kernel_only="K2")
    _check_route("headline", device, before,
                 {"K2": 1 + groups * calls + twin_calls})
    group_s.sort()
    return {
        "fwdbwd_k2_ms": group_s[len(group_s) // 2] * 1e3,
        "fwdbwd_k2_ms_group_minmax": [group_s[0] * 1e3, group_s[-1] * 1e3],
        "fwdbwd_k2_device_ms": dev_ms,
        "kernel_device_ms": {"fwdbwd_k2": kernels},
    }


def mesh_traversal(*, n_theta=120, width=1024, height=512, iters=20,
                   device=None, trace_dir=None) -> dict:
    """K3 (``traverse_cuda``) on the UV sphere: rays from ``(1e-4 i, 0,
    28)``, the last set to warm (its hit rate is ``mesh_hitrate``), then
    ``iters`` timed sets."""
    from vrenderer_pathtracer_tpu_torch.accel.cuda_traverse import traverse_cuda

    device = _device(device)
    t0 = time.perf_counter()
    mesh = _sphere_mesh(n_theta, False, device)
    setup_s = time.perf_counter() - t0
    _single_level("mesh", mesh, device)
    rays = [_primary_rays(i, width, height, device) for i in range(iters + 1)]
    b = width * height
    t_max = torch.full((b,), 1e6, dtype=torch.float32, device=device)
    before = _counts()

    def search(i):
        return traverse_cuda(mesh, *rays[i], t_max)

    slot, _ = search(iters)
    hitrate = (slot >= 0).float().mean().item()
    dt = _wall(search, iters, device)
    dev_ms, kernels = _twin("mesh_traversal", search, iters, device,
                            trace_dir, ["K3"])
    _check_route("mesh", device, before, {"K3": 1 + 2 * iters})
    return {
        "mesh_traversal_mrays_per_s": b / dt / 1e6,
        "mesh_traversal_ms": dt * 1e3,
        "mesh_traversal_device_ms": dev_ms,
        "mesh_tris": int(mesh.tri_count),
        "mesh_hitrate": hitrate,
        "mesh_setup_s": setup_s,
        "kernel_device_ms": {"mesh_traversal": kernels},
    }


def megakernel(*, width=1024, height=1024, spp=2, bounces=4, iters=20,
               device=None, trace_dir=None) -> dict:
    """``Renderer`` passes of the Cornell scene, which the card resolves to
    K1: one to warm, then ``iters`` timed."""
    from vrenderer_pathtracer_tpu_torch.render.renderer import Renderer

    device = _device(device)
    r = Renderer(width, height, settings=_cornell(width, height, spp, bounces),
                 device=device)
    _require("megakernel", "radiance_kernel", r.settings.radiance_kernel,
             "cuda" if device.type == "cuda" else "torch")
    before = _counts()
    r.render()
    dt = _wall(lambda i: r.render(), iters, device)
    dev_ms, kernels = _twin("megakernel_pass", lambda i: r.render(), iters,
                            device, trace_dir, ["K1"])
    _check_route("megakernel", device, before, {"K1": 1 + 2 * iters})
    rays = width * height * spp * bounces
    return {
        "megakernel_fwd_mrays_per_s": rays / dt / 1e6,
        "megakernel_pass_ms": dt * 1e3,
        "megakernel_pass_device_ms": dev_ms,
        "kernel_device_ms": {"megakernel_pass": kernels},
    }


def paged_traversal(*, n_theta=300, width=1024, height=512, iters=10,
                    device=None, trace_dir=None) -> dict:
    """K5 (``traverse_paged_cuda``) on the sphere packed paged: rays from
    ``(1e-4 i, 0, 28)``, the last set to warm, then ``iters`` timed."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged

    device = _device(device)
    t0 = time.perf_counter()
    mesh = _sphere_mesh(n_theta, True, device)
    setup_s = time.perf_counter() - t0
    if device.type == "cuda" and not cuda_paged.supports(mesh):
        raise RuntimeError("bench paged: the mesh has no paged copy K5 takes")
    rays = [_primary_rays(i, width, height, device) for i in range(iters + 1)]
    b = width * height
    t_max = torch.full((b,), 1e6, dtype=torch.float32, device=device)
    before = _counts()

    def search(i):
        return cuda_paged.traverse_paged_cuda(mesh, *rays[i], t_max)

    search(iters)
    dt = _wall(search, iters, device)
    dev_ms, kernels = _twin("paged_traversal", search, iters, device,
                            trace_dir, ["K5"])
    _check_route("paged", device, before, {"K5": 1 + 2 * iters})
    return {
        "paged_traversal_mrays_per_s": b / dt / 1e6,
        "paged_traversal_ms": dt * 1e3,
        "paged_traversal_device_ms": dev_ms,
        "paged_tris": int(mesh.tri_count),
        "paged_pages": mesh.paged.n_pages,
        "paged_setup_s": setup_s,
        "kernel_device_ms": {"paged_traversal": kernels},
    }


def mesh_megakernel(*, n_theta=120, width=1024, height=1024, spp=2,
                    bounces=4, iters=20, hdr_shape=(64, 128), tex_size=256,
                    device=None, trace_dir=None) -> dict:
    """K4 (``render_pass_mesh``; direct mode, as no table requires grad) on
    the textured sphere under the HDRI, camera at ``(1e-4 i, 0, 40)``: the
    last camera at frame 1 to warm, then ``iters`` timed passes."""
    from vrenderer_pathtracer_tpu_torch.config import RenderSettings
    from vrenderer_pathtracer_tpu_torch.render.cuda_mesh import render_pass_mesh
    from vrenderer_pathtracer_tpu_torch.scene.scene import settings_for_scene

    device = _device(device)
    t0 = time.perf_counter()
    scene = _textured_scene(n_theta, hdr_shape, tex_size, False, device)
    setup_s = time.perf_counter() - t0
    settings = settings_for_scene(scene, RenderSettings(
        width=width, height=height, samples_per_pass=spp, bounces=bounces,
        use_cornell_box=False))
    _require("mesh_megakernel", "radiance_kernel", settings.radiance_kernel,
             "cuda_mesh" if device.type == "cuda" else "torch")
    cams = [_camera_at(1e-4 * i, 40.0, device) for i in range(iters + 1)]
    fc, fp = _sliders(device)
    before = _counts()

    def run(i, frame):
        return render_pass_mesh(scene, settings, cams[i], frame, fc, fp)

    run(iters, 1)
    dt = _wall(lambda i: run(i, 2 + i), iters, device)
    dev_ms, kernels = _twin("mesh_megakernel_pass",
                            lambda i: run(i, 2 + iters + i), iters, device,
                            trace_dir, ["K4"])
    _check_route("mesh_megakernel", device, before, {"K4": 1 + 2 * iters})
    rays = width * height * spp * bounces
    return {
        "mesh_megakernel_fwd_mrays_per_s": rays / dt / 1e6,
        "mesh_megakernel_pass_ms": dt * 1e3,
        "mesh_megakernel_pass_device_ms": dev_ms,
        "mesh_megakernel_setup_s": setup_s,
        "kernel_device_ms": {"mesh_megakernel_pass": kernels},
    }


def nm_wavefront(*, n_theta=120, width=1024, height=1024, spp=2, bounces=4,
                 iters=10, hdr_shape=(64, 128), tex_size=256, device=None,
                 trace_dir=None) -> dict:
    """The wavefront (``integrator.render_pass``) on the textured sphere
    with normal and specular maps, its mesh search K3 once a bounce: the
    last camera at frame 1 to warm, then ``iters`` timed passes."""
    from vrenderer_pathtracer_tpu_torch.config import RenderSettings
    from vrenderer_pathtracer_tpu_torch.core.camera import generate_rays, pixel_ids
    from vrenderer_pathtracer_tpu_torch.render import integrator
    from vrenderer_pathtracer_tpu_torch.scene.scene import settings_for_scene

    device = _device(device)
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    scene = _textured_scene(n_theta, hdr_shape, tex_size, True, device)
    setup_s = time.perf_counter() - t0
    settings = settings_for_scene(scene, RenderSettings(
        width=width, height=height, samples_per_pass=spp, bounces=bounces,
        use_cornell_box=False,
        radiance_kernel="wavefront" if on_card else "auto"))
    _require("nm_wavefront", "radiance_kernel", settings.radiance_kernel,
             "wavefront" if on_card else "torch")
    _require("nm_wavefront", "traversal", settings.traversal,
             "cuda" if on_card else "torch")
    _require("nm_wavefront", "captured_attrs", settings.captured_attrs, False)
    _single_level("nm_wavefront", scene.mesh, device)
    cams = [_camera_at(1e-4 * i, 40.0, device) for i in range(iters + 1)]
    ids = pixel_ids(width, height, device)
    fc, fp = _sliders(device)
    before = _counts()

    def run(i, frame):
        ray_o, ray_d = generate_rays(cams[i], width, height)
        return integrator.render_pass(scene, settings, ray_o, ray_d, ids,
                                      frame, fc, fp)

    run(iters, 1)
    dt = _wall(lambda i: run(i, 2 + i), iters, device)
    dev_ms, kernels = _twin("nm_wavefront_pass",
                            lambda i: run(i, 2 + iters + i), iters, device,
                            trace_dir, ["K3"])
    _check_route("nm_wavefront", device, before,
                 {"K3": bounces * (1 + 2 * iters)})
    rays = width * height * spp * bounces
    return {
        "nm_wavefront_mrays_per_s": rays / dt / 1e6,
        "nm_wavefront_pass_ms": dt * 1e3,
        "nm_wavefront_pass_device_ms": dev_ms,
        "nm_wavefront_setup_s": setup_s,
        "kernel_device_ms": {"nm_wavefront_pass": kernels},
    }


def config5(*, width=1920, height=1080, spp=2, bounces=4, n_theta=500,
            warm=2, passes=3, device=None, trace_dir=None) -> dict:
    """BASELINE config 5 through the ``Renderer``: ``examples/config5.py``'s
    synthesised sphere, sky EXR and Lambertian MERL ``.binary`` loaded with
    ``load_hdr``/``load_brdf``/``load_mesh`` (which pages the mesh above
    ``PAGED_MIN_TRIS``), FXAA and remat on; ``warm`` passes, then
    ``passes`` timed.  ``c5_compact_mode`` is the port's compaction of the
    bounce waves: "exact" (``torch.nonzero``'s count) or "off"."""
    from vrenderer_pathtracer_tpu_torch.config import RenderSettings
    from vrenderer_pathtracer_tpu_torch.examples.config5 import synth_assets
    from vrenderer_pathtracer_tpu_torch.render.renderer import Renderer

    device = _device(device)
    on_card = device.type == "cuda"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        obj, hdr, brdf = synth_assets(tmp, n_theta)
        r = Renderer(width, height, device=device, settings=RenderSettings(
            samples_per_pass=spp, bounces=bounces, use_fxaa=True,
            use_brdf=True, remat_bounces=True))
        r.load_hdr(hdr)
        r.load_brdf(brdf)
        r.load_mesh(obj)
    setup_s = time.perf_counter() - t0
    _require("config5", "radiance_kernel", r.settings.radiance_kernel,
             "wavefront" if on_card else "torch")
    if on_card:
        _require("config5", "traversal", r.settings.traversal, "cuda_paged")
    before = _counts()
    for _ in range(warm):
        r.render()
    dt = _wall(lambda i: r.render(), passes, device)
    dev_ms, kernels = _twin("c5_spec_pass", lambda i: r.render(), passes,
                            device, trace_dir, ["K5"])
    _check_route("config5", device, before,
                 {"K5": bounces * (warm + 2 * passes)})
    rays = width * height * spp * bounces
    return {
        "c5_spec_pass_ms": dt * 1e3,
        "c5_spec_pass_device_ms": dev_ms,
        "c5_spec_mrays_per_s": rays / dt / 1e6,
        "c5_compact_mode": "exact" if r.settings.compact_waves else "off",
        "c5_setup_s": setup_s,
        "kernel_device_ms": {"c5_spec_pass": kernels},
    }


# In bench.py's order; the headline always runs.
MEASUREMENTS = {
    "step": cornell_step,
    "headline": headline,
    "mesh": mesh_traversal,
    "megakernel": megakernel,
    "paged": paged_traversal,
    "mesh_megakernel": mesh_megakernel,
    "nm_wavefront": nm_wavefront,
    "config5": config5,
}


# --- the command ------------------------------------------------------------

def card() -> tuple[str, str]:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    name, limit = out.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def baseline_value(path) -> float:
    """The headline value of an earlier line of this command: the last
    JSON line of ``path``, whose metric must be ``METRIC``."""
    with open(path) as f:
        lines = [s for s in f.read().splitlines() if s.lstrip().startswith("{")]
    if not lines:
        raise ValueError(f"{path} holds no JSON line")
    rec = json.loads(lines[-1])
    if rec.get("metric") != METRIC:
        raise ValueError(f"{path}'s line is of {rec.get('metric')!r}, not "
                         f"{METRIC!r}")
    return float(rec["value"])


def selected(only) -> list[str]:
    """The measurements ``--only`` names (all by default), in
    ``MEASUREMENTS``' order, the headline among them."""
    if not only:
        return list(MEASUREMENTS)
    names = {n.strip() for n in only.split(",") if n.strip()}
    unknown = names - set(MEASUREMENTS)
    if unknown:
        raise ValueError(f"unknown measurements {sorted(unknown)}; choose "
                         f"from {', '.join(MEASUREMENTS)}")
    return [n for n in MEASUREMENTS if n in names or n == "headline"]


def add_arguments(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    ap.add_argument("--only", default=None,
                    help="comma-separated measurements to run beside the "
                         "headline: " + ", ".join(MEASUREMENTS))
    ap.add_argument("--baseline", default=None,
                    help="a file whose last JSON line is an earlier line of "
                         "this command: vs_baseline is this value over its")
    ap.add_argument("--trace", default=None,
                    help="write the profiler timeline of every device twin "
                         "into this directory")
    return ap


def run(args) -> dict:
    """Run the measurements ``args`` select on the card and print the line
    (the last line of standard output); returns it."""
    device = _device(None)
    names = selected(args.only)
    base = baseline_value(args.baseline) if args.baseline else None
    name, limit = card()
    before = _counts()
    extra = {"n_devices": 1, "platform": "gpu", "card": name,
             "power_limit": limit, "kernel_device_ms": {}}
    for m in names:
        t0 = time.perf_counter()
        got = MEASUREMENTS[m](device=device, trace_dir=args.trace)
        extra["kernel_device_ms"].update(got.pop("kernel_device_ms", {}))
        extra.update(got)
        print(f"bench: {m} in {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    extra["launches"] = {k: v - before[k] for k, v in _counts().items()
                         if k in KERNELS}
    width, height, spp, bounces = HEADLINE_SHAPE
    value = 2 * width * height * spp * bounces / (extra["fwdbwd_k2_ms"] / 1e3) / 1e6
    record = {"metric": METRIC, "value": value, "unit": "Mrays/s",
              "vs_baseline": value / base if base else 1.0, "extra": extra}
    print(json.dumps(record), flush=True)
    return record


def main(argv=None) -> dict:
    return run(add_arguments(argparse.ArgumentParser(
        prog="bench", description=__doc__.split("\n\n")[0])).parse_args(argv))


if __name__ == "__main__":
    main()
