"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. Card: print ``nvidia-smi``'s name and power limit.
2. Build: compile K1 (``csrc/radiance.cu``), K2 (``csrc/grad.cu``), K3,
   K3b and K3c (``csrc/traverse.cu``), K4 (``csrc/mesh.cu``), K5 (``csrc/paged.cu``)
   and K6 (``csrc/probe.cu``) of
   ``vrenderer_pathtracer_tpu_torch`` from the sources, K1's check
   build twice, with and without FMA contraction (``K1_CHECK``,
   ``K1_CHECK_NOFMA``: the shipped instance, the exact cuts alone, the
   parent design and a planted fault), and K3b's
   (``cuda_traverse.K3B_CHECK``: the parent K3b, two planted faults), one
   ``nvcc``
   each, started together; print the seconds, ptxas' report (registers,
   spills and stack frame of every kernel instance: K2's with and without
   the camera and its fault, K4's direct and records modes and its
   direct-fault instances among them), the SASS instruction count of every
   K1, K2 and K3b instance, and K3b's shipped ingredient mask.
3. K1 vs plain: K1 against its plain PyTorch version on the card at
   256x256 (frames 1 and 3) and at the main path's 1024x1024, 2 spp,
   4 bounces; the port's ``Renderer`` on the card against the same
   ``Renderer`` on the CPU at 64x32.  Cuts (a) and (b) of
   ``csrc/common.cuh`` (``k1_cut_checks``): in the contraction-free check
   build, K1's exact cuts give the parent design's image and depth bit for
   bit on four scenes and the planted fault (cut (a) taken on Fresnel
   surfaces too) does not; with contraction (as K1 ships) the elements
   apart are counted and held under ``CUT_FMA_APART_FRAC``; on a scene with
   specular walls the shipped kernel holds the contract and the fault
   breaks it.
4. Render path: ``Renderer(1024, 1024)`` on the card for 1 warm-up and 10
   timed passes; K1's launch count must rise by one per pass; the image must
   be finite and of plausible Cornell brightness.
5. K1 times per pass at 1024x1024 from CUDA events: K1 alone, its wrapper
   (table packing + K1) and the plain version; then, in turns, K1 against
   the check build's parent design and exact cuts alone (the same flags).
6. K2 vs plain on a well-conditioned scene (the rows of
   tests/test_pallas_grad.py::_benign_scene) at 64x32, 2 spp, 4 bounces, at
   the first frame where K1 and its plain version agree on every rgb
   element to 1e-5: material gradients at two slider pairs and camera
   gradients, at the tolerances of tests/test_pallas_grad.py; at 3 spp x 5
   bounces against plain.
7. K2 at 1024x1024 on the Cornell scene: K2's loss against the L2 loss of
   K1's own image, and against the plain version's within the difference
   of the two images' losses; each gradient leaf's relative error, and the
   gradient norm's, against the plain version, under a limit that planted
   faults (wrong rows, swapped leaves, a flipped sign, a dropped Fresnel
   term, and the kernel's own: channel 1's unit-g sums scaled by channel
   0's g) must exceed; two launches on the same inputs bit-identical.
8. Training path: ``opt_step`` with Adam (lr 0.1) on the sphere emission
   for 12 steps at 1024x1024 towards a K1 image with the light 1.5x
   brighter; K2's launch count must rise by one per step, the plain
   integrator must never run, and the loss must halve.
9. K2 times per loss + gradient step at 1024x1024 from CUDA events, in
   turns: K2 alone, its with_camera instance, the
   ``cornell_loss`` wrapper (packing + K2 + backward) and the plain
   autograd version; ``train_step``'s wall time on the host clock.
10. Where the time goes: a ``torch.profiler`` trace of 20 render passes
   and 20 ``train_step`` calls (device busy time, idle share, top kernels).
11. Bounds: the least time the card could take for each kernel's work on
   this run's inputs (``cornell_work``, ``cornell_ops``, ``bound``): per
   pipe and by instruction issue (``issue_s``), beside the parent design's
   work.
12. The nm scene (``bench.py::_nm_wavefront_bench``): a 28.5k-triangle UV
   sphere with diffuse, normal and specular maps under a 64x128 HDRI, no
   Cornell box, camera at z = 40, loaded through ``Renderer.load_mesh``,
   ``load_texture`` and ``load_hdr`` (the port's host library built with
   g++ from its own sources); the bytes of the walk's compressed copy
   (``accel/wide.py::compress_wide``) beside the float layout's.
13. K3 and K3b against the plain ``traverse`` on the card: the bench's
   traversal view (1024x512 primary rays from z = 28), a bounce-1 wave of
   the render path at 256x256, and the primary and bounce-1 waves of one
   1024x1024 pass; both against ``brute_force`` on a 1.5k-triangle sphere
   with 64x64 rays; K3, K3b and the parent K3b against the plain
   ``traverse`` on 2^20 rays into an 8,000-triangle soup
   (``write_soup``); K3 against K3b (the rays on another triangle
   counted); the parent K3b (the check build) against the plain
   ``traverse``, and K3b against the parent.  Contract: see
   ``HIT_MISMATCH_FRAC``; planted faults (``planted_traversal_faults``, on
   copies rebuilt from faulty records) must break it, and so must K3b's
   own (``cuda_traverse.K3B_FAULTS``): a dropped fetch batch on the nm
   sets, a cull at half the best t on the soup by ``SOUP_FAULT_MARGIN``
   times the limit.
14. Mesh render path: ``Renderer(1024, 1024)`` on the nm scene, 1 warm-up
   and 10 timed passes; K3's count must rise by ``bounces`` a pass, K3b's
   and the plain ``traverse``'s stay 0; the image is finite and the mesh
   lit.  Then the same renderer with the mesh's 8-wide tree dropped
   (``init_mesh``), 3 passes through K3b.  The port's ``Renderer`` on the
   card against the same scene on the CPU at 64x32.
15. Times from CUDA events: K3, K3b and the parent K3b per primary wave
   (2M rays) and per bounce wave, the wrapper, and the plain version at
   the bench's traversal view and on one pass's waves; the nm pass through
   the full-width and the compact chain (bit-identical images); K3b
   against the parent K3b in turns, wave by wave (``k3b_pair_turns``).
   The SM clock and power draw are read before and after each timed K3b
   loop.  The turns that chose K3b's ingredients and fetch constants are
   ``k3b_cuts.py``'s.
16. Where the time goes: a ``torch.profiler`` trace of 20 mesh passes.
17. Bounds of K3 and K3b: node visits, box tests and triangle tests
   counted by the kernels on one pass's waves (see ``traversal_bound``);
   K3's with the compressed copy's bytes and the operations the work needs
   (``TRAV_OPS``) and, beside it, with the copy's decode
   (``TRAV_OPS_DECODE``) and on the float layout the walk read before
   (``TRAV_OPS_FLOAT``); K3b's on its own counted work and its copy
   (``TRAV_OPS_BINARY``) and on the parent K3b's (``TRAV_OPS_FLOAT``).
18. The K4 scenes (``k4_renderers``), each through the ``Renderer``'s
   entry points and resolving ``radiance_kernel == "cuda_mesh"``: the
   mesh-megakernel scene of ``bench.py::_mesh_megakernel_bench`` (the nm
   sphere, its 256^2 diffuse map and 64x128 HDRI, 1024^2); BASELINE config
   4 (the example sphere, a synthetic gold-paint-like MERL table written as
   a ``.binary`` and loaded through ``load_brdf(path)``, the HDRI, 1024x768)
   with and without ``brdf_importance_sampling``; the nm sphere with a
   glossy synthetic table under lobe MIS (1024^2); and the Cornell box with
   the sphere and the diffuse map, with and without its five walls
   (256^2); 2 spp, 4 bounces, camera at z = 40 outside the Cornell box.
19. K4 against ``records_reference`` on the card on every K4 scene, record
   field by field and on the composed images, under ``k4_contract``; K4's
   direct mode (the tables fetched in the kernel, depth and rgb written)
   against the plain version's composed pass and against the records
   mode's, under ``k4_contract``'s image and depth limits; two launches of
   each mode bit-identical.
20. Planted K4 faults (a dropped MIS factor, a MERL index off by one, the
   Cornell kill-zeroing skipped, uv off by one texel; in direct mode the
   HDRI one texel off in u, the texture's v flipped, the MERL channel
   scale dropped), each of which must break the contract.
21. K4 render paths: 1 warm-up and 10 timed ``Renderer`` passes on each K4
   scene but the wall-less one; K4's count rises by one a pass in direct
   mode, ``compose`` is never called, and the plain integrator,
   ``records_reference``, K1, K2, K3 and K3b never run; the image is finite
   and lit.  Then the mesh-megakernel scene with
   ``radiance_kernel="wavefront"`` (K3 as its search) as the comparison pass.
22. ``deferred_opt_step`` with Adam on config 4's HDRI and MERL table for 12
   steps at 1024x768: K4 runs each step in records mode, ``compose`` once a
   step, and the loss falls; the gradients through K4 + ``compose`` against
   the wavefront's autograd on one frame.
23. A 600-sphere Cornell scene (more than K1 stages in shared memory)
   through K1 against its plain version at 256^2.
24. Times from CUDA events on the mesh-megakernel scene and config 4: K4
   alone in each mode, the pass in each mode (direct: packing + K4;
   records: packing + K4 + ``compose``), ``compose`` alone, the plain
   version and the wavefront pass; K4 alone in each mode on the other
   scenes of phase 21.  K4 alone is timed over K4_TIMED_LAUNCHES launches
   a reading, and on config 4 also profiled (device busy time a launch
   beside the host's wall).
25. Where the time goes: a ``torch.profiler`` trace of 20 K4 passes of
   the Renderer (direct mode).
26. K4's bound from the work it counts in each mode (``k4_bound``), and
   beside it the same work with the copy's decode and on the float layout
   the walk read before.
27. Config 5 (``config5_assets``: ``examples/config5.py::synth_assets``'s
   499,000-triangle UV sphere, 128x256 gradient sky as an array, Lambertian
   MERL ``.binary``): the set-up seconds (page SBVHs, collapse and leaf
   blocks, top tree and upload), the page count, the device bytes and the
   compressed copy's bytes beside the float layout's; then
   ``Renderer(1920, 1080)`` with FXAA, MERL and remat through ``load_hdr``,
   ``load_brdf(path)`` and ``load_mesh`` (which pages the mesh).
28. Resolution: radiance "wavefront", traversal "cuda_paged" (K5), compact
   waves on, K4 refusing the scene.
29. K5 against ``traverse_paged_reference`` under phase 13's contract, on
   65,536 rays sampled (fixed seed) from each of the four waves of a spec
   pass and on every ray of a 480x270 pass; two planted faults (the slot
   one page off, the nearest page skipped) must break it, and a third (a
   page's occlusion skip gated on the next entry's entry t with ``>``),
   which errs below the contract's allowance, must change rays of the full
   spec waves (every ray of those waves is also compared with the plain
   version, and the rays apart counted); the skip faults must not lose
   every hit; NaN rays among the rays of a wave leave every other ray's
   result bit-identical.
30. The compact chain against the full-width chain at 480x270: image and
   depth bit-identical.
31. The config-5 ``Renderer`` on the card against the CPU at 64x32 on a
   3,120-triangle sphere paged at 512.
32. 2 warm and 5 timed ``Renderer`` passes at 1920x1080: K5 and K7
   ``bounces`` times a pass (the K7 row's ``launches``), no plain search
   and no K3/K3b/K4; the image is FXAA of
   the tonemapped accumulation, finite, the sphere hit at the centre.
33. The gradient at spec with remat (MERL table and HDRI, the loss of
   ``examples/config5.py``): loss, wall time, peak memory; the same
   against a single-level pack through the full-width K3 wavefront under
   tests/test_paged_grad_parity.py's policy.
34. Where the time goes (``torch.profiler`` over 5 passes), times in turns
   (K5 and K3 on the four spec waves, the plain version, the pass) and
   K5's bound from the work it counts (``paged_bound``), with the copy's
   decode and the float layout's beside it.
35. The K3 comparison: K3 on the single-level pack against K5 on the same
   four waves: the same triangle and hit/miss on every ray, exactly, which
   K5's gate fault of phase 29 must break; K3's time and bound.
36. K6, the bf16 probe: at every chain count k against the plain chain at
   the check constants (where the chain moves in both dtypes; float32
   within 1e-4, bf16 bit-equal), at the probe's shapes, at 2^22 / 2^23
   elements and at the ragged 2^22 + 6, with a planted no-op kernel that
   must fail, at every k on both grids; then, at the probe's constants,
   the sweep over k and the grid in turns (SM clock and power before and
   after), the SASS FMA opcodes of every instance, the SM clock and power
   sampled while the bf16 chain runs for 1.5 s, and elements/s of the
   shipped k and grid of each dtype, their ratio.

37. K3c (``csrc/traverse.cu``, K3 with win-time attribute capture) against
   its plain version (``traverse`` + ``capture_reference``) on the nm
   scene's four waves at 1024^2: slot and t under phase 13's contract and
   bit-identical to K3's, every captured field within rtol 1e-4 / atol
   1e-5 on the agreeing hits, zeros on the misses.
38. Three planted K3c faults (u and v swapped, the tangent unnormalised,
   the first winner's attributes kept), each of which must break it.
39. The captured path: ``Renderer(1024, 1024)`` on the nm scene with
   ``captured_attrs``, K3c ``bounces`` times a pass and no K3; the captured
   pass against the recompute pass under the outlier contract of
   tests/test_config3_textured_mesh.py; 10 alternating timing pairs of
   the two passes; K3 and K3c times on the four waves; K3c's bound, and
   beside it with the copy's decode.
40. BASELINE config 3 from files through ``cli.main(["render", ...])``:
   a 69,452-triangle UV-sphere OBJ (for the 69,451-triangle bunny), 256^2
   diffuse, normal and specular PNGs and a 128x256 PIZ EXR sky written by
   the run into a temporary directory, 512x512, 2 spp, 4 bounces, 8
   passes, with ``--out``, ``--out-exr``, ``--depth-out``, ``--metrics``
   and ``--checkpoint-dir``: K3 4 times a pass and nothing else, the
   files and the metrics log checked; a run stopped after 4 passes and
   resumed to 8 writes the same files byte for byte; the CLI on the card
   against the CPU at 32x32.
41. K1's shard offsets at 1024^2, 2 spp, 4 bounces (``K1_TILES``): four
   tile ranges, one starting mid-row, reassemble the full-frame launch bit
   for bit; two sample halves (``sample_offset`` 0 and 1, 1 spp each)
   average to it within 1e-6 relative, the last half's depth bit for bit;
   two planted faults of the check build (the sample offset ignored, the
   pixel offset applied to the ray but not to the RNG) must break these
   checks; the full frame against the four tiles' launches in time.
42. K4's offsets on config 4 (``config4_renderer``, 1024x768), in both
   modes: tiles with a mid-row range reassemble the full launch bit for
   bit; the direct mode's sample halves within 1e-6 relative (depth bit for
   bit), and each half's records are the full launch's records of its
   sample bit for bit.
43. K2 on two tiles of the 1024^2 frame (the second from mid-row): the rows
   summed against the full frame's, leaf by leaf under ``SHARD_GRAD_RTOL``
   (float32 summation order), with and without the camera.
44. A world-size-1 NCCL group (``multihost.initialize`` on a local
   address): ``Renderer(1024, 1024, device_mesh=make_render_mesh(1, 1))``
   for 4 passes equals the unsharded Renderer bit for bit, and
   ``sharded_train_step`` equals ``train_step``; their wall ms in turns.
45. ``TrainParams.hdr`` at full width: on config 4, one ``train_step`` with
   ``optimize_hdr=True`` (the wavefront's autograd) against
   ``DeferredParams.hdr`` through K4's records and ``compose``
   (``deferred_opt_step``), the HDRI gradients under K4's gradient limits.
46. Two ranks on the one card in a gloo group (``chip_smoke.py
   --gloo-rank``, a process each, each with a time limit): K1 with its
   offsets on a 1x2 and a 2x1 mesh; the gathered frames against the
   single-process K1 frame (2x1 bit for bit, 1x2 within 1e-6 relative).
47. The viewer headless on the card (``view.py::TerminalViewer`` on
   ``Renderer(1024, 1024)``): a key script (orbit, dolly, the Fresnel
   slider, FXAA, the depth view, an SGR left-button drag with a wheel
   report) through ``step``, then ``run(max_passes=8, interactive=False)``
   inside ``utils.profiling.profiler_trace`` (its trace written into the
   work directory): K1 once a pass by its launch count and by the
   profiler, no plain version; the camera and sliders after the script
   equal the CPU viewer's (yaw, pitch and sliders bit for bit, the origin
   within 1e-6 relative); at 64x32 the card viewer's frame before FXAA
   against the CPU viewer's within phase 3's limits (the FXAA frames'
   difference printed); ``measure_renderer``'s ms/pass.
48. The examples (``vrenderer_pathtracer_tpu_torch/examples/``) at their
   default widths with fewer steps: ``inverse_rendering`` (256^2, 4 spp,
   10 Adam steps: K2 once a step, K1 for the target and the converged
   renders), ``envmap_recovery`` (256^2, 10 steps: K4's records and
   ``compose`` once a step), ``config5`` (960x540, 16 spp on phase 27's
   assets: K5 each bounce of each pass and of the gradient's pass, no
   plain search), ``bench_paged`` (its defaults, 3 iterations: K5 four
   times a regime); their ms/step, ms/pass and Mrays/s.
49. ``bench_scaling``: ``--real`` at world size 1 over NCCL (strong and
   weak, render and train: K1 and K2 once a step), then a sweep over one
   and two gloo ranks sharing the card, which its summary labels a
   harness check.
50. The port's ``bench`` command (``python -m vrenderer_pathtracer_tpu_torch
   bench --trace DIR``) in a subprocess at its full sizes: its line printed;
   every key it maps from the repository's ``bench.py`` (``bench.KEYS``)
   and every ``*_device_ms`` twin present, finite and positive; the
   profiler's timelines of its twins show K1, K2, K3, K4 and K5 and no
   plain version's range (``utils/profiling.py::plain_version``); its
   headline twin (K2's device ms a step) within ``BENCH_TWIN_RTOL`` of
   phase 9's K2 row.
51. K7, the bounce draws (``core/rng.py::bounce_uniforms``), at config 5's
   width (1920x1080 at 8 spp, ``K7_LANES``) on random ids up to 2^32 - 1:
   every word of 2 and 3 slots bit for bit the int64 path's, a launch a
   call; K7 and the int64 path timed in turns (CUDA events) at each slot
   count; K7's bound (``K7_SLOT_OPS``, 16 + 8 x slots bytes a lane).

The last lines are the kernel table (K1, K2, K3, K3b, K3c, K4, K5, K6, K7) as
one JSON object, every row with its per-pipe and issue bounds and the
bench keys that drive it (with the kernel's device ms in each of the
bench's twins), and then ``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH = HEIGHT = 1024
PASSES = 10
STEPS = 12
# Phase 50: the bench command's time limit, and how far its headline twin
# (K2's device ms a step, from the profiler, frames 42-49 against a black
# target) may sit from phase 9's K2 row (CUDA events, frame 1).
BENCH_TIMEOUT_S = 600
BENCH_TWIN_RTOL = 0.10
# The bench keys (wall times, as bench.TWINS names them) that drive each
# kernel of the kernels line; K3b, K3c and K6 run in no measurement.
BENCH_KEYS_OF = {
    "K1": ("fwd_ms", "megakernel_pass_ms"),
    "K2": ("fwdbwd_k2_ms", "fwdbwd_step_ms"),
    "K3": ("mesh_traversal_ms", "nm_wavefront_pass_ms"),
    "K4": ("mesh_megakernel_pass_ms",),
    "K5": ("paged_traversal_ms", "c5_spec_pass_ms"),
}
# Parity contract of K1 against its plain version (two differently
# compiled programs flip discrete branches on grazing rays): fewer than 1%
# of rgb elements off by more than 1e-5, and depth within 1e-3.  At the full
# 1024x1024 a flipped Cornell kill can land on a pixel of the last sample
# (depth 0 in one program, the hit distance in the other; measured: 1 pixel
# of 1M), so there depth is held to the outlier form of the repo's golden
# contract instead: fewer than 1% of pixels off by more than 1e-3.
RGB_ATOL, OUTLIER_FRAC, DEPTH_ATOL = 1e-5, 0.01, 1e-3
# K2 at 1024x1024 on the Cornell scene, against its plain version: the
# r = 1e5 walls flip hit/miss on a few grazing rays between any two
# programs (K1 against the plain forward: 0.063% of rgb elements, each by up
# to a whole path's radiance, 8.3 at most), and a flipped path moves every
# sum it feeds.  K1 and K2 trace with the same device code
# (csrc/common.cuh), so K2's loss and the L2 loss of K1's image agree to
# float32 summation order (K1_LOSS_RTOL).  Each gradient leaf is held to
# |K2 - plain| / |plain| <= GRAD_RTOL, the gradient rtol of
# tests/test_pallas_grad.py.  Measured on an H100: the flip-driven readings
# are at most 0.39% (dcolor), and the weakest planted fault of
# _planted_faults reads 5.9% (demission rows of the side walls swapped).
K1_LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-2
GRAD_LEAVES = ("dcolor", "demission", "dfresnel_coef", "dfresnel_pow")
# K2's tile sums against the full frame's are the same draws summed in
# another order, so they agree to float32 summation order; a tile that
# keyed its draws by the local pixel would change the Monte Carlo estimate
# by about 1e-3 at 1024^2 and 2 spp.
SHARD_GRAD_RTOL = 1e-5

# The well-conditioned scene of tests/test_pallas_grad.py::_benign_scene:
# (radius, pos, emission, color, refl, spec_color); refl 0 = SPEC, 1 = DIFF.
BENIGN = [
    (20.0, (0.0, 45.0, 0.0), (4.0, 3.6, 3.2), (0, 0, 0), 1, (0, 0, 0)),
    (60.0, (95.0, 0.0, 0.0), (0.075, 0.025, 0.025), (0.75, 0.25, 0.25), 1, (0, 0, 0)),
    (60.0, (-95.0, 0.0, 0.0), (0.025, 0.075, 0.025), (0.25, 0.75, 0.25), 1, (0, 0, 0)),
    (60.0, (0.0, 0.0, -120.0), (0, 0, 0), (1, 1, 1), 1, (0, 0, 0)),
    (60.0, (0.0, -95.0, 0.0), (0, 0, 0), (0.9, 0.9, 0.9), 1, (0, 0, 0)),
    (12.0, (18.0, -5.0, 20.0), (0, 0, 0), (0, 0, 0), 0, (1, 1, 1)),
    (12.0, (-18.0, -5.0, 20.0), (0, 0, 0), (1, 1, 1), 1, (1, 1, 1)),
]

# Peak issue rates of an H100 SXM at its 1.98 GHz boost clock: FP32 67
# TFLOP/s (an FMA is 2 flops; NVIDIA's data sheet), and 64 INT32 and 16 SFU
# (sqrt/rcp/lg2/ex2, int-to-float) results per clock per SM on 132 SMs (the
# CUDA C++ Programming Guide's throughput table, compute capability 9.0);
# device memory 3.35 TB/s.  The per-pipe bound takes the busiest pipe's
# time, as if the pipes issued at once, and counts FP32 work in flops (an
# FMA as 2), as FP32 rates are quoted.  One scheduler issues one warp
# instruction a clock, so the issue bound (ISSUE_RATE, 132 SMs x 4
# schedulers x 32 lanes) takes the sum of the counted instructions: every
# table of operations below also counts, under "fma", how many pairs of
# its FP32 flops fuse into one FMA instruction, at the most the source
# lets fuse (an FMA written, or a multiply whose only use is an add; an
# IEEE reciprocal's or division's 4 refinement flops are 2 FMAs, an IEEE
# square root's 6 flops 2 FMAs and 2 multiplies), so that the count of
# instructions, and the bound, stay as low as the work allows.
RATES = {"fp32": 67e12, "int32": 132 * 64 * 1.98e9, "sfu": 132 * 16 * 1.98e9}
ISSUE_RATE = 132 * 128 * 1.98e9
HBM_BYTES_PER_S = 3.35e12


def pipe_s(ops):
    """Seconds of the busiest pipe for ``ops`` (per type; "fma" is not a
    pipe's)."""
    return max(ops[k] / RATES[k] for k in RATES)


def issue_s(ops):
    """Seconds to issue ``ops`` as thread instructions: each FP32 flop,
    SFU and INT32 operation one, an FMA's two flops one."""
    return (ops["fp32"] - ops["fma"] + ops["sfu"] + ops["int32"]) / ISSUE_RATE
# Operations per live (sample, bounce) step of the parent design's Cornell
# loop (trace_parent: every sample tests bounce 0's spheres, draws slot 0
# and runs powf at every hit), counted from its sources: per sphere 17
# round-to-nearest flops, an IEEE sqrt as one SFU op and 6 flops of
# refinement, 6 compares and selects; then the hit point, four
# normalisations with IEEE division, precise sincosf and powf as their
# libdevice polynomials, two 20-round threefry blocks as 32-bit integer
# adds, rotates and xors; and the parent K2's material reverse step (a log
# and a few divisions).  K4 still counts its sphere tests with these.  Of
# the flops, "fma" pairs fuse: a sphere test's square root (2; its 17
# others round to nearest and never fuse), and per step about 78 (the 12
# refinements of six IEEE divisions and four of two square roots, the
# polynomials of sincosf and powf, dot products, the cosine sample, the
# mirror, emission and next origin); in the reverse step 18.
FWD_STEP = {"fp32": 280, "fp32_per_sphere": 29, "sfu": 17, "sfu_per_sphere": 1,
            "int32": 155, "fma": 78, "fma_per_sphere": 2}
REV_STEP = {"fp32": 70, "sfu": 3, "fma": 18}
# Operations of K1's and K2's loop as it is now (csrc/common.cuh trace, the
# inexact cuts of kCornellFast: one reciprocal a normalisation, sincospif,
# exp2(p log2 x)), per piece, counted from the sources in flops (an FMA 2;
# an IEEE division or reciprocal one SFU op and 4 flops, an IEEE sqrt one
# SFU op and 6 flops, a conversion one SFU op), with the pairs that fuse
# under "fma"; shared-memory loads and stores are not counted:
# - "sphere": one sphere test, as FWD_STEP counts it;
# - "surface": a hit's Surface: the hit point (6), the normal (3 and a
#   normalisation by one reciprocal: 19 flops, 2 SFU), the cosine frame
#   (18 and a normalisation), dot(d, n) (5), the row's type (1 SFU and 3);
# - "fresnel": a Fresnel surface's probability: 1 - aoi and its clamp,
#   exp2(p log2 x) (2 SFU, ~11 flops), the lerp and scale (4);
# - "scatter": one sample's scatter: the slot-1 threefry block (a 20-round
#   chain of add, rotate and xor, the key schedule and the salts: ~87
#   INT32; two conversions and scales), sincospif (~30 flops), two sqrts,
#   the cosine sample (15) and its normalisation, cos2, the multiplier, and
#   trace's emission, next origin and throughput (15);
# - "draw0": a Fresnel hit's slot-0 threefry block and its compare;
# - "pixel": K1's primary ray (IEEE round-to-nearest divisions and sqrt),
#   first-hit depth and the mean's divisions;
# - K2: "reverse", one record's reverse step at g = 1 (key decode, row
#   address, cm, the multiplier, rn, and the shared-memory sums' adds);
#   "score", a Fresnel record's score terms (a division, a log, and the
#   per-channel sums); "k2_pixel", the primary ray, g and the scaling of the
#   touched rows.
# FMAs: a sphere test's square root (2); a Surface's two normalisations
# (6 each: the squared length, the square root, the reciprocal), the frame's
# cross products (4) and dot(d, n) (2); a Fresnel probability's lerp (1);
# a scatter's sincospif polynomials (8), two square roots (4), the cosine
# sample (6), its normalisation (6), cos2 (2), emission and next origin
# (6); the pixel's six IEEE divisions and two square roots (16) and its
# depth's and mean's dot products and divisions (8); a reverse step's
# albedo and rn sums (6); a score's division, log and per-channel sums (8);
# K2's pixel: the primary ray (12), the mean's divisions and the squared
# errors (9), the scale's division (2) and the Fresnel sums' (6).
CORNELL_OPS = {
    "sphere": {"fp32": 29, "sfu": 1, "int32": 0, "fma": 2},
    "surface": {"fp32": 71, "sfu": 5, "int32": 2, "fma": 18},
    "fresnel": {"fp32": 17, "sfu": 2, "int32": 0, "fma": 1},
    "scatter": {"fp32": 106, "sfu": 7, "int32": 90, "fma": 32},
    "draw0": {"fp32": 3, "sfu": 2, "int32": 87, "fma": 0},
    "pixel": {"fp32": 80, "sfu": 14, "int32": 10, "fma": 24},
    "reverse": {"fp32": 21, "sfu": 1, "int32": 12, "fma": 6},
    "score": {"fp32": 35, "sfu": 2, "int32": 0, "fma": 8},
    "k2_pixel": {"fp32": 112, "sfu": 11, "int32": 22, "fma": 29},
}

# The mesh path (phases 12-17).  The nm scene of bench.py::_nm_wavefront_bench
# and the small sphere of tests/test_config3_textured_mesh.py.
CHAIN_PAIRS = 10                # nm passes through each chain, in pairs
NM_SPHERE = (12.0, 120, 120)     # radius, n_theta, n_phi: 28,560 triangles
SMALL_SPHERE = (14.0, 24, 32)    # 1,472 triangles
MESH_PASSES, MESH_K3B_PASSES = 10, 3
# Contract of K3/K3b against the plain traverse and brute_force, and of K3
# against K3b, on the same rays.  Two programs that round the triangle test
# differently (FMA contraction, summation order) disagree on rays that graze
# a triangle's edge or plane: such a ray may hit in one and miss in the
# other, or hit the neighbour across a shared edge at the same t.  Measured
# on an H100 (PERF.md): hit/miss never differed, and at most 5.7e-6 of a
# set's rays (3 of 524,288) hit another triangle.  The limits sit a few
# times above those readings, HIT_MISMATCH_FRAC (21 rays of a 2M wave) and
# GEOMETRY_MISMATCH_FRAC (42), and far below what planted faults read (a
# single dropped leaf: see planted_traversal_faults and PERF.md).  Where
# both hit the same triangle, t is one float32 rounding chain of ~20
# operations apart: T_RTOL (measured at most 2.3e-5).  A miss returns t_max
# exactly.
HIT_MISMATCH_FRAC = 1e-5
GEOMETRY_MISMATCH_FRAC = 2e-5
T_RTOL = 1e-4
# Phase 13's triangle soup (write_soup), where K3b's half-distance cull
# fault must break the contract by SOUP_FAULT_MARGIN times its limit.
SOUP_TRIANGLES, SOUP_RAYS, SOUP_FAULT_MARGIN = 8000, 1 << 20, 10


def write_soup(path, n, seed=5, side=1.5):
    """An OBJ of ``n`` equilateral triangles of edge ``side`` (fixed seed):
    centres uniform in [-10, 10]^3, orientations uniform.  Its leaves'
    boxes overlap, so a walk's first hit is often not its nearest, which
    the cull on pop must not drop; its triangles are well conditioned, so
    that two programs' roundings keep to the contract's t rtol."""
    rng = np.random.default_rng(seed)
    rot, _ = np.linalg.qr(rng.standard_normal((n, 3, 3)))
    ang = np.array([0.0, 2 * np.pi / 3, 4 * np.pi / 3])
    corners = side / np.sqrt(3) * np.stack([np.cos(ang), np.sin(ang),
                                            np.zeros(3)], 1)
    v = rng.uniform(-10, 10, (n, 1, 3)) + np.einsum("nij,cj->nci", rot, corners)
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v.reshape(-1, 3)]
    lines += [f"f {3 * k + 1} {3 * k + 2} {3 * k + 3}" for k in range(n)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
# Operations per unit of traversal work: the node visits, box tests and
# triangle tests the kernels count (one FP32 add, multiply, min, max or
# compare each, a fused multiply-add 2, as the FP32 rate counts it; the
# IEEE division as one SFU reciprocal and 4 FP32 operations).  Two walks
# do this work, and each adds operations of its own layout:
# - TRAV_OPS_DECODE, csrc/traverse.cuh's walk on the compressed copy.  A
#   node visit decodes the node: three quanta times the reciprocals, and
#   the origin's three distances less 2^15 quanta (a subtraction, a
#   multiply and a fused multiply-add each: 15 FP32), and ~51 INT32
#   operations (pop and cull, the five loads' address, the exponent bytes,
#   the twelve near/far selects, the leaf and push loops).  A box (slab)
#   test of a non-empty child is six decoded planes, each a byte permute
#   (INT32) and a fused multiply-add (12 FP32), 6 min/max, a compare and
#   the key's max (20 FP32), and ~15 INT32 (the permutes, the meta byte,
#   the key).
# - TRAV_OPS_FLOAT, the walk on the float layout it read before the copy,
#   whose slab test K3b still runs: a box test 6 subtractions, 6
#   multiplications, 10 min/max and a compare, and 4 INT32; a node visit
#   ~30 INT32.
# A triangle test is 27 multiplications, 18 additions, 7 compares and the
# division (56 + 1 SFU) in both, 16 of whose pairs fuse (the cross
# products, the dot products, the reciprocal's refinement).  Fused pairs
# ("fma_per_*"): the decode's fmaf per plane (6 a box) and per origin
# distance (3 a visit); the float slab test's (l - o) * inv fuses none.
# The work itself needs no more than the fewer of the two per operation
# type, TRAV_OPS (the fewer flops, and the fused pairs that leave the fewer
# FP32 instructions), which the bounds of the walks on the copy (K3, K3c,
# K4, K5) count; phases 17, 26, 34 and 39 print beside it the bound with
# the copy's decode (TRAV_OPS_DECODE), what the layout adds, and the float
# layout's bound.
TRAV_OPS_DECODE = {"fp32_per_box": 20, "fp32_per_visit": 15, "fp32_per_tri": 56,
                   "sfu_per_tri": 1, "int32_per_visit": 51, "int32_per_box": 15,
                   "fma_per_box": 6, "fma_per_visit": 3, "fma_per_tri": 16}
TRAV_OPS_FLOAT = {"fp32_per_box": 23, "fp32_per_visit": 0, "fp32_per_tri": 56,
                  "sfu_per_tri": 1, "int32_per_visit": 30, "int32_per_box": 4,
                  "fma_per_box": 0, "fma_per_visit": 0, "fma_per_tri": 16}


def _least_work(a, b):
    """Per unit, the fewer of two tables' operations of each type; the
    fused pairs chosen so that the FP32 instructions are the fewer."""
    out = {k: min(v, b[k]) for k, v in a.items() if not k.startswith("fma")}
    for unit in ("box", "visit", "tri"):
        inst = min(t[f"fp32_per_{unit}"] - t[f"fma_per_{unit}"] for t in (a, b))
        out[f"fma_per_{unit}"] = out[f"fp32_per_{unit}"] - inst
    return out


TRAV_OPS = _least_work(TRAV_OPS_DECODE, TRAV_OPS_FLOAT)
# TRAV_OPS_BINARY, K3b's walk on its binary copy (csrc/traverse.cu
# traverse_binary_kernel, the shipped instance), counted from its source.
# A node visit: the loop's test and branch, the counter, the node's 64-bit
# address (2), the hit tests' predicate and branch (2), the register's
# select, and either the push of the farther child (its link's select, the
# key's mask, the stack's bound test, the entry's address, the stack
# pointer) or a pop (the stack's test, the pointer, the entry's address,
# the key's mask, the branch): 5 INT32, so ~13 INT32 a visit; the near/far
# compare, and the key's max on a push or the cull's compare on a pop: 2
# FP32.  A box (slab) test of a non-empty child: 6 subtractions, 6
# multiplications, 12 min/max and a compare (25 FP32), none fusable, and 2
# INT32 (the count test, the counter).  A triangle: the test (TRAV_OPS's
# 56 FP32 and 1 SFU, 16 fused pairs) and ~5 INT32 (the loop's test,
# increment and branch, the row's address, the counter), and its share of
# its leaf's ~11 (the link's decode, the loop's bounds, the pop after it;
# ~3 a triangle at the nm sphere's 3.37 triangles a leaf): ~8 INT32.  The
# warp's refill and fetch run once a ray, not a visit, and are not counted.
# The parent K3b (its slab test is the float one, ~30 INT32 a visit) is
# counted by TRAV_OPS_FLOAT.
TRAV_OPS_BINARY = {"fp32_per_box": 25, "fp32_per_visit": 2, "fp32_per_tri": 56,
                   "sfu_per_tri": 1, "int32_per_visit": 13, "int32_per_box": 2,
                   "int32_per_tri": 8, "fma_per_box": 0, "fma_per_visit": 0,
                   "fma_per_tri": 16}
TRAV_TABLES = {"copy": TRAV_OPS, "decode": TRAV_OPS_DECODE, "float": TRAV_OPS_FLOAT,
               "binary": TRAV_OPS_BINARY}


def trav_ops(visits, boxes, tris, layout="copy"):
    """The operations of a walk's counted work, per type: what the work
    needs (``layout`` "copy", TRAV_OPS), with the compressed copy's decode
    ("decode", TRAV_OPS_DECODE), on the float layout ("float",
    TRAV_OPS_FLOAT, the parent K3b's too), or K3b's walk on its binary
    copy ("binary", TRAV_OPS_BINARY)."""
    t = TRAV_TABLES[layout]
    return {"fp32": (boxes * t["fp32_per_box"] + visits * t["fp32_per_visit"]
                     + tris * t["fp32_per_tri"]),
            "sfu": tris * t["sfu_per_tri"],
            "int32": (visits * t["int32_per_visit"] + boxes * t["int32_per_box"]
                      + tris * t.get("int32_per_tri", 0)),
            "fma": (boxes * t["fma_per_box"] + visits * t["fma_per_visit"]
                    + tris * t["fma_per_tri"])}


def _compare(name, got, want, depth_outliers=False):
    (rgb_k, dep_k), (rgb_p, dep_p) = got, want
    assert rgb_k.shape == rgb_p.shape and dep_k.shape == dep_p.shape, name
    assert torch.isfinite(rgb_k).all() and torch.isfinite(dep_k).all(), name
    d = (rgb_k - rgb_p).abs()
    frac = (d > RGB_ATOL).float().mean().item()
    dd = (dep_k - dep_p).abs()
    dfrac = (dd > DEPTH_ATOL).float().mean().item()
    print(f"  {name}: rgb outliers {frac:.5%} (max abs {d.max().item():.6g}), "
          f"depth max abs {dd.max().item():.6g}, depth >{DEPTH_ATOL}: "
          f"{dfrac:.5%}")
    assert frac < OUTLIER_FRAC, f"{name}: {frac:.4%} rgb elements differ"
    if depth_outliers:
        assert dfrac < OUTLIER_FRAC, f"{name}: {dfrac:.4%} depth pixels differ"
    else:
        assert dd.max().item() < DEPTH_ATOL, f"{name}: depth error {dd.max().item()}"
    return d.max().item()


def _benign_scene(dev):
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
    from vrenderer_pathtracer_tpu_torch.scene.spheres import SphereSet

    f32 = dict(dtype=torch.float32, device=dev)
    return Scene(spheres=SphereSet(
        pos=torch.tensor([r[1] for r in BENIGN], **f32),
        radius=torch.tensor([r[0] for r in BENIGN], **f32),
        emission=torch.tensor([r[2] for r in BENIGN], **f32),
        color=torch.tensor([r[3] for r in BENIGN], **f32),
        refl=torch.tensor([r[4] for r in BENIGN], dtype=torch.int32, device=dev),
        spec_color=torch.tensor([r[5] for r in BENIGN], **f32)))


def _close(name, got, want, rtol, atol):
    got, want = got.double(), want.double()
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    print(f"    {name}: max abs err {err.max().item():.4g}"
          f" (|want| max {want.abs().max().item():.4g}) {'ok' if ok else 'FAIL'}")
    assert ok, f"{name}: {got.tolist()} vs {want.tolist()}"
    return err.max().item()


def _leaf_errors(grads, want):
    """|got - want| / |want| (2-norms) for each of the GRAD_LEAVES."""
    return {name: ((g.double() - w.double()).norm() / w.double().norm()).item()
            for name, g, w in zip(GRAD_LEAVES, grads, want)}


def _planted_faults(grads):
    """K2's gradients as a wrong kernel would return them, one fault each:
    rows written to the wrong sphere, leaves swapped, a flipped sign, a
    dropped Fresnel term.  None changes the loss."""
    col, em, fc, fp = grads
    walls = [0, 2, 1, *range(3, col.shape[0])]  # right and left wall swapped
    return {
        "dcolor rows of the side walls swapped": (col[walls], em, fc, fp),
        "dcolor rows off by one": (col.roll(1, 0), em, fc, fp),
        "demission rows of the side walls swapped": (col, em[walls], fc, fp),
        "demission rows off by one": (col, em.roll(1, 0), fc, fp),
        "albedo and emission swapped": (em, col, fc, fp),
        "sign flipped": (-col, -em, -fc, -fp),
        "dfresnel_coef zeroed": (col, em, torch.zeros_like(fc), fp),
        "dfresnel_pow zeroed": (col, em, fc, torch.zeros_like(fp)),
        "dfresnel_coef and dfresnel_pow swapped": (col, em, fp, fc),
    }


# K1's check builds (csrc/radiance.cu with -DVPT_CHECK_INSTANCES, whose
# vpt_radiance_check launches the exact cuts alone, the parent design or
# the planted fault), with FMA contraction as K1 ships and without.  With
# contraction on, nvcc fuses a few multiply-adds of the parent loop and the
# cut loop differently (the mirror branch's normalisation), so cuts (a) and
# (b) are held bit for bit to the parent design in the contraction-free
# build, where both compute the same arithmetic: exact at the source level.
# With contraction, the elements apart (measured on an H100: 9, 1, 7 and 0
# of the four scenes' 4.2 M, 0.26 M, 0.26 M and 8 K elements) are held
# under CUT_FMA_APART_FRAC of each scene's, far below what a wrong cut
# moves (the planted fault: 0.28% of the Cornell scene's rgb elements).
K1_CHECK = ("radiance", ("-DVPT_CHECK_INSTANCES",))
K1_CHECK_NOFMA = ("radiance", ("-DVPT_CHECK_INSTANCES", "-fmad=false"))
K1_EXACT, K1_PARENT, K1_FAULT = 0, 8, 9
CUT_FMA_APART_FRAC = 1e-4


def specular_walls(scene):
    """``scene`` with a grey specular colour of 0.3 on every row whose
    specular colour is 0 (the Cornell walls and light): every DIFF hit is a
    Fresnel surface, so cut (a) is never taken."""
    spec = scene.spheres.spec_color.clone()
    spec[(spec == 0).all(dim=1)] = 0.3
    return scene.replace_spheres(spec_color=spec)


def flip_free_frame(scene, settings, cam, fc=0.1, fp=3.0):
    """The first frame in 1..24 where K1 and its plain version agree on
    every rgb element to 1e-5 (a flipped branch moves K2's sums by a whole
    path)."""
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1

    for frame in range(1, 25):
        got, _ = k1.render_pass_cuda(scene, settings, cam, frame, fc, fp)
        want, _ = k1.render_pass_reference(scene, settings, cam, frame, fc, fp)
        if (got - want).abs().max().item() <= 1e-5:
            return frame
    raise AssertionError("no flip-free frame in 1..24")


def k2_small_check(a, label):
    """K2 against its plain version on ``a`` (cornell_loss_grads'
    arguments) at the tolerances of tests/test_pallas_grad.py; returns the
    largest absolute error."""
    from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2

    got = k2.cornell_loss_grads(*a)
    torch.cuda.synchronize()
    want = k2.cornell_loss_grads_reference(*a)
    print(f"  {label}: loss {got[0].item():.6g} vs {want[0].item():.6g}")
    rel = abs(got[0].item() - want[0].item()) / abs(want[0].item())
    assert rel <= 1e-4, f"loss rel err {rel}"
    err = 0.0
    for name, i, rtol, atol in (("dcolor", 1, 1e-2, 2e-4),
                                ("demission", 2, 1e-2, 2e-4),
                                ("dfresnel_coef", 3, 1e-2, 1e-6),
                                ("dfresnel_pow", 4, 1e-2, 1e-6)):
        err = max(err, _close(name, got[i], want[i], rtol, atol))
    if a[-1]:  # with_camera
        for name, rtol, atol in (("origin", 2e-2, 2e-6), ("yaw", 2e-2, 1e-5),
                                 ("pitch", 2e-2, 1e-5), ("fov_deg", 2e-2, 1e-6)):
            err = max(err, _close(f"dcamera.{name}", getattr(got[5], name),
                                  getattr(want[5], name), rtol, atol))
    return err


def k1_check_launcher(lib, dev):
    """K1's check build ``lib`` as ``fn(cam, spheres, settings, frame, seed,
    variant, pixel_offset=0, sample_offset=0, n_local=None) -> (rgb,
    depth)`` (csrc/radiance.cu vpt_radiance_check)."""
    import ctypes

    fn = ctypes.CDLL(str(lib)).vpt_radiance_check
    ptr, i32, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    fn.argtypes = [ptr, ptr, i32, u32, u32, u32, i32, i32, i32, i32,
                   ctypes.c_float, i32, u32, i32, ptr, ptr, ptr, i32]
    fn.restype = ctypes.c_int

    def run(cam_t, sph, s, frame, seed, variant, pixel_offset=0,
            sample_offset=0, n_local=None):
        n = s.n_pixels - pixel_offset if n_local is None else n_local
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        depth = torch.empty((n,), dtype=torch.float32, device=dev)
        err = fn(cam_t.data_ptr(), sph.data_ptr(), sph.shape[0], seed, 0,
                 frame, s.width, s.height, s.samples_per_pass, s.bounces,
                 s.depth_scale, pixel_offset, sample_offset, n,
                 rgb.data_ptr(), depth.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream, variant)
        assert err == 0, f"K1 check instance {variant} launch failed: {err}"
        return rgb, depth

    return run


def k1_cut_checks(dev, libs, base, cam):
    """Phase 3's check of cuts (a) and (b): in the contraction-free check
    build K1's exact cuts alone give the parent design's image and depth bit
    for bit, and the planted fault (cut (a) taken on Fresnel surfaces too)
    does not; in the check build with contraction, as K1 ships, the
    elements apart are counted and held under CUT_FMA_APART_FRAC.  On a
    scene with specular walls (cut (a) never taken) the shipped kernel
    holds K1's contract against the plain version and the fault breaks it.
    Returns a summary for the kernels line."""
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

    nofma = k1_check_launcher(libs[K1_CHECK_NOFMA], dev)
    fma = k1_check_launcher(libs[K1_CHECK], dev)

    def same(x, y):
        return torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])

    full = base.replace(width=WIDTH, height=HEIGHT)
    cornell = Scene.analytic(full, dev)
    cases = {
        "Cornell 1024^2, frame 1": (cornell, full, 1, 0.1, 3.0, 0),
        "Cornell 256^2, frame 3, seed 7, sliders (0.4, 1.5)": (
            cornell, base.replace(width=256, height=256), 3, 0.4, 1.5, 7),
        "specular walls 256^2, frame 1": (
            specular_walls(cornell), base.replace(width=256, height=256), 1,
            0.1, 3.0, 0),
        "well-conditioned scene 64x32, frame 2, sliders (0.4, 1.5)": (
            _benign_scene(dev), base.replace(width=64, height=32), 2, 0.4,
            1.5, 0),
    }
    apart = {}
    for name, (scene, s, frame, fc, fp, seed) in cases.items():
        cam_t, sph = k1.pack_camera(cam, s, fc, fp), k1.pack_spheres(scene.spheres)
        parent = nofma(cam_t, sph, s, frame, seed, K1_PARENT)
        exact = nofma(cam_t, sph, s, frame, seed, K1_EXACT)
        fault = nofma(cam_t, sph, s, frame, seed, K1_FAULT)
        pair = [fma(cam_t, sph, s, frame, seed, v) for v in (K1_PARENT, K1_EXACT)]
        apart[name] = int((pair[0][0] != pair[1][0]).sum()
                          + (pair[0][1] != pair[1][1]).sum())
        frac = apart[name] / (4 * s.n_pixels)
        print(f"  cuts (a) and (b), {name}: without contraction "
              f"{'bit-identical' if same(exact, parent) else 'DIFFERENT'} to the "
              f"parent design, the planted fault "
              f"{(fault[0] != parent[0]).sum().item()} rgb elements apart; "
              f"with contraction {apart[name]} elements apart ({frac:.3g}, "
              f"limit {CUT_FMA_APART_FRAC})")
        assert same(exact, parent), f"cuts (a) and (b) change K1's output: {name}"
        assert not same(fault, parent), f"K1's planted fault changes nothing: {name}"
        assert frac <= CUT_FMA_APART_FRAC, f"cuts (a) and (b) with contraction: {name}"
    walls = specular_walls(cornell)
    _compare("K1 1024x1024 specular walls (cut (a) never taken)",
             k1.render_pass_cuda(walls, full, cam, 1, 0.1, 3.0),
             k1.render_pass_reference(walls, full, cam, 1, 0.1, 3.0),
             depth_outliers=True)
    fault_frac = {}
    for name, scene in (("specular walls", walls), ("Cornell", cornell)):
        cam_t, sph = k1.pack_camera(cam, full, 0.1, 3.0), k1.pack_spheres(scene.spheres)
        got = fma(cam_t, sph, full, 1, 0, K1_FAULT)
        want = k1.render_pass_reference(scene, full, cam, 1, 0.1, 3.0)
        fault_frac[name] = ((got[0] - want[0]).abs() > RGB_ATOL).float().mean().item()
        print(f"  planted fault (cut (a) on Fresnel surfaces too), {name} "
              f"1024x1024: {fault_frac[name]:.4%} rgb elements off by more "
              f"than {RGB_ATOL} (contract: under {OUTLIER_FRAC:.0%})")
    assert fault_frac["specular walls"] >= OUTLIER_FRAC, "K1's fault holds the contract"
    return {"nofma": True, "fma_apart": apart, "fault": fault_frac}


def cornell_work(scene, settings, camera, frame, fc, fp, seed=0):
    """What K1 and K2 trace for these inputs, counted with the plain
    integrator's own pieces: a path runs the sphere test at every bounce
    until its first miss, which ends it.  Returns a dict: "pixels"; "hits0",
    pixels whose primary ray hits; "fres0", those whose bounce-0 hit is a
    Fresnel surface (DIFF with spec[0] != 0); per sample at bounces >= 1,
    "tests" (sphere-test steps), "hits" and "fres" (hit steps, on Fresnel
    surfaces); over all bounces "steps" and "fres_steps" (hit steps, on
    Fresnel surfaces); for K2, "records" (hit steps of samples that
    survive) and "scores" (their Fresnel records with p inside its clip
    range); "spp"; and the parent design's "tests_all" for FWD_STEP."""
    from vrenderer_pathtracer_tpu_torch.core import rng
    from vrenderer_pathtracer_tpu_torch.core.camera import generate_rays, pixel_ids
    from vrenderer_pathtracer_tpu_torch.ops.shading import ORIGIN_OFFSET, scatter
    from vrenderer_pathtracer_tpu_torch.render.integrator import _intersect_sphere_set
    from vrenderer_pathtracer_tpu_torch.scene.spheres import BRDF, SPEC

    ray_o0, ray_d0 = generate_rays(camera, settings.width, settings.height)
    ids = pixel_ids(settings.width, settings.height, ray_o0.device)
    w = dict.fromkeys(("tests", "hits", "fres", "steps", "fres_steps",
                       "records", "scores", "tests_all", "hits0", "fres0"), 0)
    w["pixels"], w["spp"] = settings.n_pixels, settings.samples_per_pass
    with torch.no_grad():
        for s in range(settings.samples_per_pass):
            o, d = ray_o0, ray_d0
            alive = torch.ones_like(ids, dtype=torch.bool)
            sid = torch.full_like(ids, s)
            rec = torch.zeros_like(ids)
            score = torch.zeros_like(ids)
            for b in range(settings.bounces):
                w["tests_all"] += int(alive.sum())
                if b > 0:
                    w["tests"] += int(alive.sum())
                hd = _intersect_sphere_set(scene, o, d)
                alive = alive & hd.hit
                fres = (alive & (hd.hit_type != SPEC) & (hd.hit_type != BRDF)
                        & (hd.spec_color[:, 0] != 0))
                n_hit, n_fres = int(alive.sum()), int(fres.sum())
                if b == 0 and s == 0:
                    w["hits0"], w["fres0"] = n_hit, n_fres
                if b > 0:
                    w["hits"] += n_hit
                    w["fres"] += n_fres
                w["steps"] += n_hit
                w["fres_steps"] += n_fres
                u0, _ = rng.uniform2(seed, ids, rng.make_stream(frame, sid, b, 0))
                u1, u2 = rng.uniform2(seed, ids, rng.make_stream(frame, sid, b, 1))
                aoi = (hd.normal * -d).sum(-1)
                p = ((1.0 - aoi).clamp(min=0.0) ** fp * (1.0 - fc) + fc) * hd.spec_color[:, 0]
                rec += alive.long()
                score += (fres & (p >= 1e-6) & (p <= 1.0 - 1e-6)).long()
                nd, _ = scatter(d, hd.normal, hd.tangent, hd.color,
                                hd.spec_color, hd.hit_type, u0, u1, u2, fc, fp)
                a3 = alive[:, None]
                o = torch.where(a3, hd.point + ORIGIN_OFFSET * hd.normal, o)
                d = torch.where(a3, nd, d)
            w["records"] += int(rec[alive].sum())
            w["scores"] += int(score[alive].sum())
    return w


def cornell_ops(w, n_spheres, kernel):
    """Operations per type of K1 ("k1") or K2 ("k2") on the work ``w`` of
    ``cornell_work`` (CORNELL_OPS), or of the parent design's loop
    ("parent": FWD_STEP on every sample's steps)."""
    ops = {"fp32": 0, "sfu": 0, "int32": 0, "fma": 0}

    def add(piece, count):
        for k, v in CORNELL_OPS[piece].items():
            ops[k] += count * v

    if kernel == "parent":
        for k in ops:
            ops[k] = w["steps"] * FWD_STEP.get(k, 0)
        for k in ("fp32", "sfu", "fma"):
            ops[k] += w["tests_all"] * n_spheres * FWD_STEP[f"{k}_per_sphere"]
        return ops
    spp = w["spp"]
    # K1 holds bounce 0's Surface for the pixel (cut (b)); K2 only its
    # sphere loop, and recomputes the rest per sample.
    surfaces0 = w["hits0"] if kernel == "k1" else spp * w["hits0"]
    fres0 = w["fres0"] if kernel == "k1" else spp * w["fres0"]
    add("sphere", (w["pixels"] + w["tests"]) * n_spheres)
    add("surface", surfaces0 + w["hits"])
    add("fresnel", fres0 + w["fres"])
    add("scatter", w["steps"])
    add("draw0", w["fres_steps"])
    if kernel == "k1":
        add("pixel", w["pixels"])
    else:
        add("reverse", w["records"])
        add("score", w["scores"])
        add("k2_pixel", w["pixels"])
    return ops


def bound(ops, n_bytes):
    """(bound_ms, bound_by, issue_ms): the larger of the bytes over the
    memory rate and, per operation type, the operations over the card's
    peak rate; and the larger of the bytes' time and the instructions over
    the issue rate (``issue_s``)."""
    t_ops = pipe_s(ops)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes) * 1e3, by, max(issue_s(ops), t_bytes) * 1e3


def device_profile(name, fn, n, top=5):
    """Trace ``n`` calls of ``fn`` with torch.profiler; print the device
    busy time per call, the host wall per call (profiled), the idle share
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / n * 1e6
    # Device-side events only: a CPU op's row repeats its kernels' time.
    rows = [(e.key, e.self_device_time_total / n, e.count // n)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(r[1] for r in rows)
    if busy == 0:
        print(f"profile {name}: the trace holds no device time (not measured)")
        return
    print(f"profile {name}: device busy {busy:.1f} us/call, host wall "
          f"{wall:.1f} us/call (profiled), idle share {1 - busy / wall:.1%}, "
          f"{sum(r[2] for r in rows)} device ops/call")
    for key, us, count in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"    {us:9.1f} us  x{count}  {key[:90]}")


def nm_assets():
    """The nm scene's HDRI and maps, bench.py's recipe (seed 0)."""
    rng = np.random.default_rng(0)
    hdr = rng.uniform(0, 1.5, (64, 128, 3)).astype(np.float32)
    tex = rng.uniform(0.1, 1, (256, 256, 3)).astype(np.float32)
    nmap = (rng.uniform(0, 1, (256, 256, 3)) * 0.2
            + (0.4, 0.4, 0.8)).astype(np.float32)
    smap = rng.uniform(0, 1, (256, 256, 3)).astype(np.float32)
    return hdr, tex, nmap, smap


def nm_renderer(obj, width, height, device, **settings):
    """The nm scene through the Renderer's own entry points."""
    from vrenderer_pathtracer_tpu_torch import Renderer, RenderSettings

    hdr, tex, nmap, smap = nm_assets()
    r = Renderer(width, height, settings=RenderSettings(
        samples_per_pass=2, bounces=4, **settings), device=device)
    r.load_mesh(obj)
    r.load_texture(tex, 2.2, 0)
    r.load_texture(nmap, 2.2, 1)
    r.load_texture(smap, 2.2, 2)
    r.load_hdr(hdr)
    r.update_camera(origin=(0.0, 0.0, 40.0))
    return r


def capture_waves(r):
    """Render one pass of ``r`` and return the (ray_o, ray_d, t_max) of
    every mesh search in it, in bounce order."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3

    waves, real = [], k3.traverse_cuda

    def spy(mesh, o, d, t):
        waves.append((o.clone(), d.clone(), t.clone()))
        return real(mesh, o, d, t)

    k3.traverse_cuda = spy
    try:
        r.render()
    finally:
        k3.traverse_cuda = real
    return waves


def traversal_contract(a):
    """Whether a ``hit_agreement`` reading meets the phase-13 contract."""
    return (a["hit_mismatch"] <= HIT_MISMATCH_FRAC
            and a["geometry_mismatch"] <= GEOMETRY_MISMATCH_FRAC
            and a["t_rel_max"] <= T_RTOL and a["miss_t_exact"])


def agreement(name, mesh, got, want, t_max, want_mesh=None):
    """Print how two closest-hit results on the same rays agree."""
    from vrenderer_pathtracer_tpu_torch.accel.cuda_traverse import hit_agreement

    a = hit_agreement(mesh, got, want, t_max, want_mesh)
    print(f"  {name}: {a['rays']} rays, hit {a['hit_frac']:.4%}, hit/miss "
          f"mismatch {a['hit_mismatch']:.5%}, other triangle "
          f"{a['geometry_mismatch']:.5%}, t rel err max {a['t_rel_max']:.3g}"
          f" (abs {a['t_abs_max']:.3g}), misses return t_max: "
          f"{a['miss_t_exact']}")
    return a


def check_hits(name, mesh, got, want, t_max, want_mesh=None):
    """Hold two closest-hit results to the phase-13 contract."""
    a = agreement(name, mesh, got, want, t_max, want_mesh)
    assert traversal_contract(a), name
    return a


def planted_traversal_faults(mesh, slot):
    """``mesh`` as K3 (with its 8-wide tree) or K3b (without) would walk it
    with one fault each, through its node records: the last triangle of
    every leaf skipped; the last inner child of every node dropped (the far
    one for rays along the node's sort axis); and, a rare fault, the one
    leaf that holds triangle ``slot`` dropped, so only the rays that would
    hit that leaf go wrong.  K3 and K3b walk their copies, so the copies
    are built anew from the faulty records (``with_copy``).  Slots still
    index the same triangles."""
    import dataclasses

    from vrenderer_pathtracer_tpu_torch.accel.mesh import with_copy

    name = "nodes8_i" if mesh.nodes8_f is not None else "nodes_i"
    recs = getattr(mesh, name)

    def children():  # [nodes, children, (ref, count)], a fresh copy
        return recs.clone().view(recs.shape[0], -1, 2)

    short = children()
    cnt = short[..., 1]
    cnt[cnt >= 2] -= 1
    pruned = children()
    inner = pruned[..., 1] == 0
    k = torch.arange(inner.shape[1], device=recs.device)
    last = torch.where(inner, k, -1).max(dim=1).values
    rows = (last >= 0).nonzero().squeeze(1)
    pruned[rows, last[rows], 1] = -1
    dropped = children()
    ref, cnt = dropped[..., 0], dropped[..., 1]
    row = (slot if name == "nodes_i" else
           int((mesh.tri_pack[:, 9] == slot).nonzero()[0, 0]))
    node, child = ((cnt > 0) & (ref <= row) & (row < ref + cnt)).nonzero()[0]
    dropped[node, child, 1] = -1
    return {what: with_copy(dataclasses.replace(mesh, **{name: r.reshape(recs.shape)}))
            for what, r in (("last triangle of every leaf skipped", short),
                            ("last inner child of every node dropped", pruned),
                            (f"the leaf of triangle {slot} dropped", dropped))}


def copy_bytes(nodes8_c, leaf_rows):
    """Bytes of a compressed copy: 80 a node, 48 a leaf row."""
    return (nodes8_c.numel() + leaf_rows.numel()) * 4


def float_layout_bytes(nodes8_i):
    """Bytes of the float layout the walk read before the compressed copy,
    each once: a node's 64-byte record row and 4-byte axis, 24 of a child
    box row's 32 bytes for each non-empty child, 48 of a leaf-block row's
    64 bytes for each leaf row."""
    from vrenderer_pathtracer_tpu_torch.accel.mesh import MAX_LEAF

    cnt = nodes8_i.view(-1, 8, 2)[..., 1]
    return (cnt.shape[0] * (64 + 4) + 24 * int((cnt >= 0).sum())
            + 48 * int(cnt.clamp(0, MAX_LEAF).sum()))


def wide_array_bytes(tree):
    """Bytes of the float layout's arrays (``nodes8_f``, ``nodes8_i``,
    ``nodes8_ax``, ``tri_pack``, padded leaf blocks included) of a
    ``MeshData`` or ``PagedNodes``."""
    return sum(getattr(tree, f).numel() * 4
               for f in ("nodes8_f", "nodes8_i", "nodes8_ax", "tri_pack"))


def mesh_read_bytes(mesh, wide, layout="copy"):
    """Bytes of the mesh arrays K3 (``wide``) or K3b reads, each once.  K3:
    the compressed copy, every node and leaf row (``copy_bytes``), or for
    ``layout`` "float" the float layout's (``float_layout_bytes``).  K3b
    ("binary"): its copy's 64-byte node and a 48-byte row for each leaf
    slot; the parent K3b ("float"): a node's 48-byte box row and 16-byte
    record, and 36 bytes (v0, e1, e2) for each leaf slot."""
    from vrenderer_pathtracer_tpu_torch.accel.mesh import MAX_LEAF

    if wide:
        if layout == "float":
            return float_layout_bytes(mesh.nodes8_i)
        return copy_bytes(mesh.nodes8_c, mesh.leaf_rows)
    cnt = mesh.nodes_i.view(-1, 2, 2)[..., 1]
    slots = int(cnt.clamp(0, MAX_LEAF).sum())
    if layout == "binary":
        return cnt.shape[0] * 64 + 48 * slots
    return cnt.shape[0] * (48 + 16) + 36 * slots


def traversal_bound(mesh, wide, waves, layout="copy", launch=None):
    """(bound_ms, bound_by, work, bytes, issue_ms) of K3 (``wide``) or K3b
    over one pass's ``waves``: per wave the larger of the bytes over the
    memory rate and, per operation type, the operations over the card's
    peak rate (issue_ms: their sum over the issue rate), summed over the
    waves.  A wave reads t_max (4 bytes) and writes slot
    and t (8) for every ray, and reads origin and direction (24) only where
    t_max > 0: a dead lane returns after reading t_max.  The mesh is read
    once a pass (``mesh_read_bytes``, charged to the first wave): it stays
    in L2 between waves.  The work is what ``launch`` (K3's or K3b's by
    default) itself counts on these rays, its operations what that work
    needs (TRAV_OPS).  ``layout`` "decode": the same with the compressed
    copy's decode (TRAV_OPS_DECODE); "float": the bytes and operations of
    the same work on the float layout the walk read before
    (TRAV_OPS_FLOAT), whose slab test the parent K3b shares; "binary":
    K3b's walk on its copy (TRAV_OPS_BINARY)."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3

    if launch is None:
        launch = k3.launch_k3 if wide else k3.launch_k3b
    mesh_bytes = mesh_read_bytes(mesh, wide, layout)
    total, by_ops, work, n_bytes, issue = 0.0, 0.0, [0, 0, 0], 0, 0.0
    for i, (o, d, t) in enumerate(waves):
        stats = torch.zeros(3, dtype=torch.int64, device=o.device)
        launch(mesh, o, d, t, stats=stats)
        visits, boxes, tris = (int(x) for x in stats.tolist())
        work = [a + b for a, b in zip(work, (visits, boxes, tris))]
        ops = trav_ops(visits, boxes, tris, layout)
        t_ops = pipe_s(ops)
        wave_bytes = (o.shape[0] * (4 + 8) + int((t > 0).sum()) * 24
                      + (mesh_bytes if i == 0 else 0))
        n_bytes += wave_bytes
        t_bytes = wave_bytes / HBM_BYTES_PER_S
        total += max(t_ops, t_bytes)
        issue += max(issue_s(ops), t_bytes)
        by_ops += t_ops if t_ops >= t_bytes else 0.0
    return (total * 1e3, "operations" if by_ops >= total / 2 else "bytes",
            work, n_bytes, issue * 1e3)


# Rounds of phase 15's turns of K3b against the parent K3b.
K3B_TURNS = 4


def smi_clocks():
    """The card's SM clock, its maximum and the power draw, as nvidia-smi
    reads them now."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "n/a"


def smi_under_load(fn, seconds=1.5):
    """Call ``fn`` over and over for ``seconds`` while nvidia-smi samples the
    SM clock and power draw every 20 ms; the samples taken while the card
    ran, as (MHz, W) pairs."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        out = proc.communicate()[0]
    pairs = []
    for line in out.strip().splitlines():
        try:
            mhz, watts = (float(x) for x in line.split(","))
        except ValueError:
            continue
        pairs.append((mhz, watts))
    # Drop the samples from before the loop started (the first 0.3 s).
    return pairs[15:] if len(pairs) > 20 else pairs


def k3b_pair_turns(binary, waves, dev, card):
    """Phase 15's turns of K3b against the parent K3b (both from the check
    build, whose K3b is the shipped source) on each wave of one pass, K3B_TURNS rounds, the order reversed every other
    round, with the SM clock and power before and after.  Returns
    {"K3b"/"parent": (pass ms mean, [per-wave ms means], [pass ms per
    round])}."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms

    # Both from the check build, each launch prepared once, so that the
    # host's work stays below the sparsest wave's launch.
    launch = {name: [k3.k3b_check_launcher(binary, *w, variant) for w in waves]
              for name, variant in (("K3b", 0), ("parent", k3.K3B_PARENT))}
    names = list(launch)
    t = {name: [[] for _ in waves] for name in names}
    before = smi_clocks()
    for r in range(K3B_TURNS):
        for name in (names if r % 2 == 0 else names[::-1]):
            for w in range(len(waves)):
                t[name][w].append(cuda_time_ms(launch[name][w], dev, iters=30,
                                               warmup=1))
    after = smi_clocks()
    print(f"K3b against the parent K3b in turns ({K3B_TURNS} rounds, ms a wave "
          f"and a pass, the spread in brackets; SM clock, max, power before: "
          f"{before}; after: {after}), {card}:")
    out = {}
    for name in names:
        per_round = [sum(t[name][w][r] for w in range(len(waves)))
                     for r in range(K3B_TURNS)]
        out[name] = (float(np.mean(per_round)), [float(np.mean(x)) for x in t[name]],
                     per_round)
        print(f"  {name:7s} pass {np.mean(per_round):.4f} "
              f"({min(per_round):.4f}-{max(per_round):.4f}); waves "
              + ", ".join(f"{np.mean(x):.4f} ({min(x):.4f}-{max(x):.4f})"
                          for x in t[name]))
    return out


def chain_pairs(r, s, dev, card, pairs=CHAIN_PAIRS):
    """The nm pass through the full-width and the compact chain: images
    bit-identical, then ``pairs`` pairs of passes timed one by one (CUDA
    events), alternating which chain runs first; at the default view and
    at a close-up where the sphere fills the frame."""
    from vrenderer_pathtracer_tpu_torch.render.integrator import render_camera_pass
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms

    for view, z in (("default view", 40.0), ("close-up", 20.0)):
        cam = r.camera.replace(origin=torch.tensor([0.0, 0.0, z], device=dev))

        def run(compact):
            return render_camera_pass(r.scene, s.replace(compact_waves=compact),
                                      cam, 1, r.fresnel_coef, r.fresnel_pow)

        comp, full = run(True), run(False)
        assert all(torch.equal(a, b) for a, b in zip(comp, full)), view
        hits = (full[1] < 1).float().mean().item()
        t = {True: [], False: []}
        for i in range(pairs):
            for compact in ((True, False) if i % 2 else (False, True)):
                t[compact].append(cuda_time_ms(lambda: run(compact), dev,
                                               iters=1, warmup=0))
        med = {k: float(np.median(v)) for k, v in t.items()}
        q1, q3 = np.percentile(t[False], [25, 75])
        wins = sum(c < f for c, f in zip(t[True], t[False]))
        print(f"nm pass, {view} ({hits:.2%} of pixels hit), {WIDTH}x{HEIGHT}: "
              f"images bit-identical; full-width chain median {med[False]:.3f} ms "
              f"(quartiles {q1:.3f}-{q3:.3f}), compact chain median "
              f"{med[True]:.3f} ms ({med[True] / med[False]:.3f}x), compact "
              f"faster in {wins} of {pairs} pairs, {card}")
        print(f"  full width: {', '.join(f'{x:.2f}' for x in t[False])} ms")
        print(f"  compact:    {', '.join(f'{x:.2f}' for x in t[True])} ms")


def mesh_phases(dev, card, rays_per_pass_of):
    """Phases 12-17; returns the K3 and K3b rows of the kernel table."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera, generate_rays
    from vrenderer_pathtracer_tpu_torch.kernels.build import BUILD_DIR
    from vrenderer_pathtracer_tpu_torch.native import load_obj
    from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    # 12. The nm scene.
    work_dir = BUILD_DIR / "smoke"
    work_dir.mkdir(parents=True, exist_ok=True)
    nm_obj, small_obj = str(work_dir / "nm_sphere.obj"), str(work_dir / "small.obj")
    soup_obj = str(work_dir / "soup.obj")
    write_uv_sphere(nm_obj, *NM_SPHERE)
    write_uv_sphere(small_obj, *SMALL_SPHERE)
    write_soup(soup_obj, SOUP_TRIANGLES)
    t0 = time.perf_counter()
    r = nm_renderer(nm_obj, WIDTH, HEIGHT, dev)
    setup_s = time.perf_counter() - t0
    s, mesh = r.settings, r.scene.mesh
    assert (s.radiance_kernel, s.traversal) == ("wavefront", "cuda")
    assert s.has_mesh and s.has_hdr and s.has_normal_map and s.has_specular_map
    binary = mesh.without_wide()
    print(f"nm scene: {mesh.tri_count.item()} triangles, "
          f"{mesh.nodes_i.shape[0]} binary / {mesh.nodes8_i.shape[0]} wide "
          f"nodes, load_mesh + textures + HDRI {setup_s:.2f} s; the walk's "
          f"compressed copy {copy_bytes(mesh.nodes8_c, mesh.leaf_rows)} bytes "
          f"({mesh.nodes8_c.shape[0]} nodes, {mesh.leaf_rows.shape[0]} leaf "
          f"rows) against {wide_array_bytes(mesh)} of the float layout "
          f"({mesh.tri_pack.shape[0]} padded leaf rows)")

    # 13. K3 and K3b against the plain traversal and brute_force.
    view = Camera.default(dev).replace(
        origin=torch.tensor([0.0, 0.0, 28.0], device=dev))
    bo, bd = (x.contiguous() for x in generate_rays(view, 1024, 512))
    bt = torch.full((bo.shape[0],), 1e6, device=dev)
    small = nm_renderer(nm_obj, 256, 256, dev)
    bounce1_256 = capture_waves(small)[1]
    main_waves = capture_waves(r)
    assert len(main_waves) == s.bounces
    # Rays from random points around and inside the sphere in random
    # directions (fixed seed).
    gen = torch.Generator(device="cpu").manual_seed(13)
    ro = (torch.rand((65536, 3), generator=gen) * 60 - 30).to(dev)
    rd = torch.randn((65536, 3), generator=gen).to(dev)
    rd = (rd / rd.norm(dim=1, keepdim=True)).contiguous()
    sets = {"bench view 1024x512": (bo, bd, bt),
            "bounce-1 wave 256^2": bounce1_256,
            "primary wave 1024^2": main_waves[0],
            "bounce-1 wave 1024^2": main_waves[1],
            "random rays 65536": (ro, rd, torch.full((65536,), 1e6, device=dev))}
    print("K3/K3b vs the plain traverse on the card "
          f"(limits: hit/miss {HIT_MISMATCH_FRAC:g}, other triangle "
          f"{GEOMETRY_MISMATCH_FRAC:g} of the rays, t rtol {T_RTOL:g}):")
    max_err = {"K3": 0.0, "K3b": 0.0}
    wants = {}
    for name, (o, d, t) in sets.items():
        want = wants[name] = trav.traverse(mesh, o, d, t)
        for kname, m in (("K3", mesh), ("K3b", binary)):
            a = check_hits(f"{kname} {name}", mesh,
                           k3.traverse_cuda(m, o, d, t), want, t)
            max_err[kname] = max(max_err[kname], a["t_abs_max"])
        check_hits(f"K3 vs K3b {name}", mesh, k3.traverse_cuda(mesh, o, d, t),
                   k3.traverse_cuda(binary, o, d, t), t)
    # Planted faults on the primary wave: each is a wrong kernel, and each
    # must break the contract.  The rare one drops the leaf that holds the
    # triangle the centre pixel's ray hits.
    o, d, t = main_waves[0]
    want = wants["primary wave 1024^2"]
    centre = int(want[0][HEIGHT // 2 * WIDTH + WIDTH // 2])
    assert centre >= 0, "the centre ray misses the mesh"
    print("planted faults, primary wave 1024^2 against the plain traverse:")
    for kname, m in (("K3", mesh), ("K3b", binary)):
        for what, bad in planted_traversal_faults(m, centre).items():
            a = agreement(f"{kname}, {what}", mesh,
                          k3.traverse_cuda(bad, o, d, t), want, t)
            assert not traversal_contract(a), f"{kname}, {what} passes"
    # K3b's own planted faults (the check build), each on the sets where
    # it must break the contract.  The dropped batch holds the set's centre
    # ray (the bench view's centre row: 32 of 524,288 rays, where the limit
    # allows 5).  The half-distance cull drops a stacked subtree only where
    # the first hit the walk finds is not the nearest, which near-to-far
    # order makes rare on the convex sphere (on the primary wave 52 rays of
    # 2M, where 41 are allowed): it must break the contract on the soup,
    # whose overlapping leaves make such rays common, by SOUP_FAULT_MARGIN
    # times the limit (rays from 30 away at random points of its cube).
    soup = pack_mesh(load_obj(soup_obj), device=dev)
    soup_b = soup.without_wide()
    gen = torch.Generator(device="cpu").manual_seed(14)
    so = torch.randn((SOUP_RAYS, 3), generator=gen)
    so = 30 * so / so.norm(dim=1, keepdim=True)
    sd = torch.rand((SOUP_RAYS, 3), generator=gen) * 16 - 8 - so
    so, sd = so.to(dev), (sd / sd.norm(dim=1, keepdim=True)).to(dev).contiguous()
    st = torch.full((SOUP_RAYS,), 1e6, device=dev)
    soup_want = trav.traverse(soup, so, sd, st)
    print(f"triangle soup, {soup.tri_count.item()} triangles, {SOUP_RAYS} rays "
          f"into its cube:")
    for kname, m in (("K3", soup), ("K3b", soup_b)):
        check_hits(f"{kname} soup", soup, k3.traverse_cuda(m, so, sd, st),
                   soup_want, st)
    check_hits("K3b parent soup", soup,
               k3.k3b_check_launcher(soup_b, so, sd, st, k3.K3B_PARENT)(), soup_want, st)
    centres = {"bench view 1024x512": 256 * 1024 + 512,
               "primary wave 1024^2": HEIGHT // 2 * WIDTH + WIDTH // 2,
               "random rays 65536": 32768}
    half_cull, drop = k3.K3B_FAULTS.values()
    print("K3b's planted faults against the plain traverse:")
    for name, fault_ray in centres.items():
        fo, fd, ft = sets[name]
        a = agreement(f"K3b, the batch holding ray {fault_ray} dropped, {name}",
                      mesh, k3.k3b_check_launcher(binary, fo, fd, ft, drop,
                                                  fault_ray=fault_ray)(),
                      wants[name], ft)
        assert not traversal_contract(a), f"K3b's dropped batch passes on {name}"
        agreement(f"K3b, a pop culls at 0.5x the best t, {name}", mesh,
                  k3.k3b_check_launcher(binary, fo, fd, ft, half_cull)(), wants[name], ft)
    a = agreement("K3b, a pop culls at 0.5x the best t, soup", soup,
                  k3.k3b_check_launcher(soup_b, so, sd, st, half_cull)(), soup_want, st)
    print(f"    {a['geometry_mismatch'] / GEOMETRY_MISMATCH_FRAC:.1f}x the limit of "
          f"rays on another triangle (the fault must reach {SOUP_FAULT_MARGIN}x)")
    assert a["geometry_mismatch"] + a["hit_mismatch"] >= \
        SOUP_FAULT_MARGIN * GEOMETRY_MISMATCH_FRAC, "K3b's half-distance cull passes"
    sm = pack_mesh(load_obj(small_obj), device=dev)
    so, sd = (x.contiguous() for x in generate_rays(
        Camera.default(dev).replace(origin=torch.tensor([0.0, 0.0, 40.0],
                                                        device=dev)), 64, 64))
    st = torch.full((so.shape[0],), 1e6, device=dev)
    want = trav.brute_force(sm, so, sd, st)
    print(f"K3/K3b vs brute_force, {sm.tri_count.item()} triangles, 64x64 rays:")
    check_hits("plain traverse", sm, trav.traverse(sm, so, sd, st), want, st)
    for kname, m in (("K3", sm), ("K3b", sm.without_wide())):
        check_hits(kname, sm, k3.traverse_cuda(m, so, sd, st), want, st)
    for kname, m in (("K3", mesh), ("K3b", binary)):
        o, d, t = main_waves[1]
        assert all(torch.equal(x, y) for x, y in zip(
            k3.traverse_cuda(m, o, d, t), k3.traverse_cuda(m, o, d, t))), kname
    print("K3 and K3b repeat launches bit-identical")
    # K3b's check build: the parent K3b held to the same contract; the
    # shipped K3b against the parent; K3 and K3b winner by winner.
    print("The parent K3b vs the plain traverse, K3b vs the parent, K3 vs K3b:")
    for name, (o, d, t) in sets.items():
        parent = k3.k3b_check_launcher(binary, o, d, t, k3.K3B_PARENT)()
        check_hits(f"K3b parent, {name}", mesh, parent, wants[name], t)
        check_hits(f"K3b vs the parent K3b, {name}", mesh,
                   k3.traverse_cuda(binary, o, d, t), parent, t)
        a = agreement(f"K3 vs K3b, {name}", mesh, k3.traverse_cuda(mesh, o, d, t),
                      k3.traverse_cuda(binary, o, d, t), t)
        print(f"    K3 and K3b: {round(a['geometry_mismatch'] * a['rays'])} rays "
              f"on another triangle, {round(a['hit_mismatch'] * a['rays'])} "
              f"hit/miss apart, of {a['rays']}")

    # 14. The mesh render path: K3 only, bounces launches a pass.
    k1.launch.count = k2.launch.count = 0
    k3.launch_k3.count = k3.launch_k3b.count = trav.traverse.count = 0
    r.clear_buffer()
    r.render()
    torch.cuda.synchronize()
    assert k3.launch_k3.count == s.bounces
    t0 = time.perf_counter()
    for i in range(MESH_PASSES):
        img, depth = r.render()
        assert k3.launch_k3.count == s.bounces * (i + 2)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / MESH_PASSES
    k3_launches = k3.launch_k3.count
    assert k3.launch_k3b.count == trav.traverse.count == 0
    assert k1.launch.count == k2.launch.count == 0
    assert torch.isfinite(img).all() and torch.isfinite(depth).all()
    centre = img[HEIGHT // 2 - 32:HEIGHT // 2 + 32, WIDTH // 2 - 32:WIDTH // 2 + 32]
    assert centre.mean().item() > 0.05, "the mesh's centre is black"
    assert (depth[HEIGHT // 2, WIDTH // 2] < 1.0).item()
    rays = rays_per_pass_of(s)
    print(f"mesh render path: nm scene {WIDTH}x{HEIGHT}, {s.samples_per_pass}"
          f" spp, {s.bounces} bounces: {wall * 1e3:.3f} ms/pass wall, "
          f"{rays / wall / 1e6:.1f} Mrays/s, image mean {img.mean().item():.4f},"
          f" centre {centre.mean().item():.4f}, K3 launches {k3_launches}, "
          f"K3b 0, plain traverse 0, {card}")
    profile_pass = r.render

    # 16. Where the time goes (before the mesh changes below).
    device_profile("mesh render pass", profile_pass, 20, top=12)

    # 14, continued: the same renderer with the 8-wide tree dropped runs K3b.
    r.init_mesh(binary)
    k3.launch_k3.count = k3.launch_k3b.count = trav.traverse.count = 0
    for i in range(MESH_K3B_PASSES):
        bimg, _ = r.render()
        assert k3.launch_k3b.count == s.bounces * (i + 1)
    torch.cuda.synchronize()
    k3b_launches = k3.launch_k3b.count
    assert k3.launch_k3.count == trav.traverse.count == 0
    assert torch.isfinite(bimg).all()
    print(f"binary mesh render path: {MESH_K3B_PASSES} passes, K3b launches "
          f"{k3b_launches}, K3 0, plain traverse 0")
    r.init_mesh(mesh)
    pair = [[torch.from_numpy(x) for x in nm_renderer(nm_obj, 64, 32, d)
             .render_frames(2)] for d in (dev, "cpu")]
    _compare("nm scene Renderer 64x32 cuda vs cpu", pair[0], pair[1])

    # 15. Times (CUDA events), in turns.  Also the nm pass through the
    # full-width chain (the scene's own) and through the compact chain.
    chain_pairs(r, s, dev, card)

    prim, bounce = main_waves[0], main_waves[1]

    parents = {id(w): k3.k3b_check_launcher(binary, *w, k3.K3B_PARENT)
               for w in main_waves}

    def parent(w):
        return parents[id(w)]()

    timed = {
        "K3 primary": (lambda: k3.launch_k3(mesh, *prim), 20),
        "K3 bounce-1": (lambda: k3.launch_k3(mesh, *bounce), 20),
        "K3 pass (4 waves)": (lambda: [k3.launch_k3(mesh, *w) for w in main_waves], 10),
        "K3b primary": (lambda: k3.launch_k3b(binary, *prim), 20),
        "K3b bounce-1": (lambda: k3.launch_k3b(binary, *bounce), 20),
        "K3b pass (4 waves)": (lambda: [k3.launch_k3b(binary, *w) for w in main_waves], 10),
        "parent K3b primary": (lambda: parent(prim), 20),
        "parent K3b bounce-1": (lambda: parent(bounce), 20),
        "parent K3b pass (4 waves)": (lambda: [parent(w) for w in main_waves], 10),
        "wrapper primary": (lambda: k3.traverse_cuda(mesh, *prim), 20),
        "plain bench view": (lambda: trav.traverse(mesh, bo, bd, bt), 1),
        "plain pass (4 waves)": (lambda: [trav.traverse(mesh, *w) for w in main_waves], 1),
    }
    t = {name: [] for name in timed}
    clocks = [smi_clocks()]
    for name in [*timed, *reversed(timed)]:
        fn, iters = timed[name]
        t[name].append(cuda_time_ms(fn, dev, iters=iters, warmup=1))
    clocks.append(smi_clocks())
    ms = {name: sum(v) / len(v) for name, v in t.items()}
    for name, v in t.items():
        print(f"{name}: {', '.join(f'{x:.4f}' for x in v)} ms")
    print(f"  SM clock, max, power before the loop: {clocks[0]}; after: {clocks[1]}")
    print(f"K3 {ms['K3 primary']:.4f} ms per primary wave ({prim[0].shape[0]} "
          f"rays, {prim[0].shape[0] / ms['K3 primary'] / 1e3:.1f} Mrays/s), "
          f"{ms['K3 bounce-1']:.4f} per bounce-1 wave; K3b "
          f"{ms['K3b primary']:.4f} / {ms['K3b bounce-1']:.4f} (the parent K3b "
          f"{ms['parent K3b primary']:.4f} / {ms['parent K3b bounce-1']:.4f}); "
          f"plain at the bench view {ms['plain bench view']:.2f} ms, {card}")
    # K3b against the parent K3b in turns, wave by wave (the turns that
    # chose K3b's ingredients and fetch constants are k3b_cuts.py's).
    turns = k3b_pair_turns(binary, main_waves, dev, card)
    spread = max(turns["K3b"][2]) - min(turns["K3b"][2])
    gain = turns["parent"][0] - turns["K3b"][0]
    print(f"  K3b faster than the parent by {gain:.4f} ms a pass "
          f"({gain / spread if spread else float('inf'):.1f}x the turns' spread "
          f"{spread:.4f})")

    # 17. Bounds on one pass's waves.
    rows = []
    b_ms, by, work, n_bytes, i_ms = traversal_bound(mesh, True, main_waves)
    k_ms = ms["K3 pass (4 waves)"]
    print(f"K3 bound per pass {b_ms:.4f} ms ({by}; node visits "
          f"{work[0]}, box tests {work[1]}, triangle tests {work[2]}, "
          f"bytes {n_bytes} of which mesh {mesh_read_bytes(mesh, True)}, "
          f"live rays {[int((w[2] > 0).sum()) for w in main_waves]}), "
          f"measured {k_ms:.4f} ms = {b_ms / k_ms:.1%} of bound; issue "
          f"bound {i_ms:.4f} ms = {i_ms / k_ms:.1%}")
    d_ms, d_by = traversal_bound(mesh, True, main_waves, "decode")[:2]
    f_ms, f_by, _, f_bytes, _ = traversal_bound(mesh, True, main_waves, "float")
    print(f"  K3 bound with the copy's decode: {d_ms:.4f} ms "
          f"({d_by}, TRAV_OPS_DECODE), {d_ms / k_ms:.1%} of the "
          f"measured time; on the float layout it read before: "
          f"{f_ms:.4f} ms ({f_by}; bytes {f_bytes} of which mesh "
          f"{mesh_read_bytes(mesh, True, 'float')}, TRAV_OPS_FLOAT), "
          f"{f_ms / k_ms:.1%} of the measured time")
    rows.append({
        "name": "K3 8-wide BVH traversal",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/traverse.cu",
        "replaces": "vrenderer_pathtracer_tpu/accel/pallas_traverse.py:173",
        "launches": k3_launches,
        "max_abs_err": max_err["K3"],
        "ms": k_ms,
        "ms_primary_wave": ms["K3 primary"],
        "ms_bounce1_wave": ms["K3 bounce-1"],
        "plain_ms": ms["plain pass (4 waves)"],
        "bound_ms": b_ms,
        "bound_by": by,
        "bound_issue_ms": i_ms,
        "bound_ms_decode": d_ms,
        "library_ms": None,
    })
    # K3b: the bound on this design's counted work (TRAV_OPS_BINARY, its
    # copy's bytes) and on the parent K3b's (TRAV_OPS_FLOAT, the float
    # arrays' bytes), each against both designs' times.
    k_ms, p_ms = ms["K3b pass (4 waves)"], ms["parent K3b pass (4 waves)"]
    b_ms, by, work, n_bytes, i_ms = traversal_bound(binary, False, main_waves,
                                                    "binary")
    pb_ms, pby, pwork, p_bytes, pi_ms = traversal_bound(
        binary, False, main_waves, "float",
        launch=lambda m, o, d, tm, stats: k3.k3b_check_launcher(
            m, o, d, tm, k3.K3B_PARENT, stats=stats)())
    print(f"K3b bound per pass on its work {b_ms:.4f} ms ({by}; node visits "
          f"{work[0]}, box tests {work[1]}, triangle tests {work[2]}, bytes "
          f"{n_bytes} of which mesh {mesh_read_bytes(binary, False, 'binary')},"
          f" TRAV_OPS_BINARY), issue bound {i_ms:.4f}; measured {k_ms:.4f} ms"
          f" = {b_ms / k_ms:.1%} of bound, {i_ms / k_ms:.1%} of the issue bound")
    print(f"  the parent K3b's work: bound {pb_ms:.4f} ms ({pby}; node visits "
          f"{pwork[0]}, box tests {pwork[1]}, triangle tests {pwork[2]}, bytes "
          f"{p_bytes}, TRAV_OPS_FLOAT), issue bound {pi_ms:.4f}; the parent "
          f"measured {p_ms:.4f} ms = {pb_ms / p_ms:.1%} of its bound, "
          f"{pi_ms / p_ms:.1%} of its issue bound; the new K3b "
          f"{pb_ms / k_ms:.1%} / {pi_ms / k_ms:.1%} of the parent work's "
          f"bounds")
    rows.append({
        "name": "K3b binary BVH traversal",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/traverse.cu",
        "replaces": "vrenderer_pathtracer_tpu/accel/pallas_traverse.py:109",
        "launches": k3b_launches,
        "max_abs_err": max_err["K3b"],
        "ms": k_ms,
        "ms_primary_wave": ms["K3b primary"],
        "ms_bounce1_wave": ms["K3b bounce-1"],
        "ms_waves": turns["K3b"][1],
        "parent_ms": p_ms,
        "parent_ms_waves": turns["parent"][1],
        "turns_pass_ms": {k: v[0] for k, v in turns.items()},
        "work": work,
        "parent_work": pwork,
        "plain_ms": ms["plain pass (4 waves)"],
        "bound_ms": b_ms,
        "bound_by": by,
        "bound_issue_ms": i_ms,
        "bound_ms_parent_work": pb_ms,
        "bound_issue_ms_parent_work": pi_ms,
        "library_ms": None,
    })
    return rows


# The fused mesh path (phases 18-26).  The mesh-megakernel scene of
# bench.py::_mesh_megakernel_bench (the nm sphere, its 256^2 diffuse map and
# 64x128 HDRI from default_rng(0), no Cornell box, camera at z = 40);
# BASELINE config 4 (the example sphere under the HDRI with a synthetic
# gold-paint-like MERL table written as a .binary and loaded through
# Renderer.load_brdf, 1024x768), with and without lobe MIS; and the nm
# sphere with a glossy synthetic table under lobe MIS.
K4_PASSES = 10
K4_STEPS = 12
# Launches a reading where K4 is timed alone (phase 24).  Each launch waits
# for the card (cuda_mesh.supports reads the sphere table back), so on
# config 4, where the host's time a launch exceeds the kernel's, CUDA events
# time the host; the profile after the readings gives the card's time.
K4_TIMED_LAUNCHES = 200
CONFIG4 = (1024, 768)
# Contract of K4 against records_reference on the same inputs.  The two
# programs round differently (FMA contraction in K4, torch's reduction
# order in the plain version), so a grazing ray flips hit or miss, or a MERL
# bin edge flips an index, on a few lanes, and every later record of that
# sample follows.  Held per record field (the fraction of elements off by
# more than 1e-4; depth by more than 1e-3, K1's depth tolerance; MERL
# indices unequal) and on the composed image (pixels off by more than 1e-3,
# the mean error of the others, depth).  Measured on an H100 (PERF.md, PR
# 4): at most 0.0078% of any field or of the pixels in the open scenes, and
# in the Cornell box, whose r = 1e5 walls amplify the noise as they do for
# K1, 0.20% (uv records) and 0.18% of the pixels.  The limits:
# K4_FRAC in open scenes, K4_CORNELL_FRAC (K1's OUTLIER_FRAC) in the
# Cornell box; the planted faults read 6.6% and more.
K4_FRAC, K4_CORNELL_FRAC, K4_INLIER_MEAN = 1e-3, 1e-2, 1e-5
K4_LOSS_DROP = 0.9
K4_GRAD_RTOL, K4_GRAD_FRAC = 0.05, 0.02
# Operations per unit of K4's counted work (csrc/mesh.cu), from the source
# as FWD_STEP and TRAV_OPS are: a traced step tests every sphere (and the
# example sphere) as K1 does; a hit runs the hit point, the surface (normal,
# uv, tangent), two threefry blocks, the scatter and up to 14 record stores
# (FWD_STEP plus ~40 FP32 operations and 2 SFU); a BRDF hit adds the MERL
# index (two acosf, two atan2f, three normalisations: ~190 FP32, 8 SFU); a
# lobe-MIS draw adds a threefry block, a 7-step binary search, a frame, a
# reflection and the two pdfs (~180 FP32, 10 SFU, ~100 INT32).  Fused
# pairs: a hit FWD_STEP's 78 and ~10 of the surface's; a BRDF index the
# polynomials of acosf and atan2f (~40) and the normalisations' (~30); a
# MIS draw's frame, reflection and pdfs (~40).
K4_OPS = {"hit_fp32": 320, "hit_sfu": 19, "hit_int32": 155, "hit_fma": 88,
          "brdf_fp32": 190, "brdf_sfu": 8, "brdf_fma": 70,
          "mis_fp32": 180, "mis_sfu": 10, "mis_int32": 100, "mis_fma": 40}
# The direct mode's fetches (csrc/mesh.cu env_fetch, tex_fetch,
# merl_factor), counted the same way: an HDRI fetch is atan2f and acosf
# (~40 FP32, 3 SFU), two IEEE divisions (8 FP32, 2 SFU), the texel address
# (~10 INT32, ~30 with the bilinear wrap) and the blend (6 FP32 a channel
# nearest, 24 bilinear) times the path weight; a texture fetch the
# address and the blend; a MERL factor 9 FP32 and 3 INT32 for its index.
# Fused pairs: the polynomials and divisions (~21) and the weighted blend;
# the bilinear lerps are FMAs.
K4_FETCH_OPS = {"env_fp32": 70, "env_sfu": 5, "env_int32": 10, "env_fma": 25,
                "env_bilinear_fp32": 125, "env_bilinear_int32": 30,
                "env_bilinear_fma": 50,
                "tex_fp32": 12, "tex_int32": 10, "tex_fma": 3,
                "tex_bilinear_fp32": 80, "tex_bilinear_int32": 30,
                "tex_bilinear_fma": 35,
                "merl_fp32": 9, "merl_int32": 3, "merl_fma": 3}


def glossy_merl(width, tint, amp=3000.0, floor=2.0):
    """A synthetic glossy MERL table, [3, 90*90*180] raw values: a
    theta_h lobe of the given width (radians) over a small floor, per
    channel tinted (tests/test_brdf_sampling.py::glossy_table's recipe)."""
    th = ((np.arange(90) + 0.5) / 90) ** 2 * (np.pi / 2)
    prof = amp * np.exp(-((th / width) ** 2)) + floor
    t = prof[None, :, None] * np.asarray(tint, np.float64)[:, None, None]
    return np.broadcast_to(t, (3, 90, 90 * 180)).reshape(3, -1)


def write_merl(path, table):
    """``table`` as a MERL-100 .binary (int32 dims, then float64 values)."""
    with open(path, "wb") as f:
        np.asarray([90, 90, 180], np.int32).tofile(f)
        np.asarray(table, np.float64).reshape(-1).tofile(f)


def k4_renderers(work_dir, nm_obj, dev, cornell_size=256):
    """The K4 scenes, each through the Renderer's entry points:
    ``{name: Renderer}``."""
    from vrenderer_pathtracer_tpu_torch import Renderer, RenderSettings

    hdr, tex, _, _ = nm_assets()
    gloss = str(work_dir / "glossy.binary")
    write_merl(gloss, glossy_merl(0.08, (1.0, 1.0, 1.0)))

    def make(w, h, **kw):
        return Renderer(w, h, settings=RenderSettings(
            samples_per_pass=2, bounces=4, **kw), device=dev)

    out = {}
    r = out["mesh-megakernel"] = make(WIDTH, HEIGHT)
    r.load_mesh(nm_obj)
    r.load_texture(tex, 2.2, 0)
    r.load_hdr(hdr)
    for name, mis in (("config 4", False), ("config 4 + MIS", True)):
        out[name] = config4_renderer(work_dir, dev, mis)
    r = out["mesh + MERL + MIS"] = make(WIDTH, HEIGHT, brdf_importance_sampling=True)
    r.load_mesh(nm_obj)
    r.load_hdr(hdr)
    r.load_brdf(gloss)
    r.use_brdf(True)
    for r in out.values():
        r.update_camera(origin=(0.0, 0.0, 40.0))
    # The Cornell box with the mesh and the diffuse map (deferred emission
    # under Cornell kills), and the same Cornell-mode scene without the five
    # walls: the light and the two small spheres over the mesh, where many
    # paths miss and are killed (the planted kill fault's scene; inside the
    # walls, an infinite tube open only along +z, almost no path misses).
    for name, walls in (("Cornell + mesh + texture", True),
                        ("Cornell light, no walls, + mesh + texture", False)):
        r = out[name] = make(cornell_size, cornell_size, use_cornell_box=True,
                             has_hdr=False)
        r.load_mesh(nm_obj)
        r.load_texture(tex, 2.2, 0)
        if not walls:
            keep = torch.tensor([0, 6, 7], device=dev)  # light, mirror, Fresnel
            sp = r.scene.spheres
            r.scene = r.scene.replace_spheres(**{
                f: getattr(sp, f)[keep] for f in (
                    "pos", "radius", "emission", "color", "refl", "spec_color")})
            r.clear_buffer()
    return out


def config4_renderer(work_dir, dev, mis=False):
    """BASELINE config 4 through the Renderer's entry points: the example
    sphere, a synthetic gold-paint-like MERL table written as a ``.binary``
    and loaded through ``load_brdf(path)``, the nm scene's 64x128 HDRI,
    1024x768, 2 spp, 4 bounces, the camera at z = 40."""
    from vrenderer_pathtracer_tpu_torch import Renderer, RenderSettings

    hdr = nm_assets()[0]
    gold = work_dir / "gold.binary"
    if not gold.exists():
        write_merl(str(gold), glossy_merl(0.12, (1.0, 0.72, 0.32)))
    r = Renderer(*CONFIG4, settings=RenderSettings(
        samples_per_pass=2, bounces=4, brdf_importance_sampling=mis),
        device=dev)
    r.use_example_sphere(True)
    r.load_hdr(hdr)
    r.load_brdf(str(gold))
    r.use_brdf(True)
    r.update_camera(origin=(0.0, 0.0, 40.0))
    return r


def k4_args(r):
    """(packed camera, packed spheres, scene, settings) of a Renderer."""
    from vrenderer_pathtracer_tpu_torch.render.cuda_radiance import (
        pack_camera, pack_spheres)

    return (pack_camera(r.camera, r.settings, r.fresnel_coef, r.fresnel_pow),
            pack_spheres(r.scene.spheres), r.scene, r.settings)


def k4_readings(r, got, want):
    """How K4's records ``got`` agree with the plain version's ``want``:
    per record field (records_agreement) and for the composed images:
    the fraction of pixels off by more than 1e-3, the mean error of the
    others and the depth's outliers."""
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

    out = {"records": k4.records_agreement(got, want, r.settings,
                                           atol={"depth": DEPTH_ATOL})}
    (rgb_g, dep_g), (rgb_w, dep_w) = (k4.compose(x, r.scene, r.settings)
                                      for x in (got, want))
    diff = (rgb_g - rgb_w).abs().amax(dim=-1)
    out["pixel_outliers"] = (diff > 1e-3).float().mean().item()
    ok = diff[diff <= 1e-3]
    out["inlier_mean_err"] = ok.mean().item() if ok.numel() else 0.0
    out["max_abs_err"] = diff.max().item()
    out["depth_outliers"] = ((dep_g - dep_w).abs() > 1e-3).float().mean().item()
    out["finite"] = bool(torch.isfinite(rgb_g).all() and torch.isfinite(dep_g).all())
    return out


def direct_readings(got, want):
    """How a pass ``got`` of K4's direct mode (``[4, N]``: depth, rgb)
    agrees with the composed pass ``want`` (``(rgb [N,3], depth [N])``) on
    the image and the depth, as ``k4_readings`` reads the composed images
    (no records: ``k4_contract`` holds it to the image and depth limits)."""
    rgb_g, dep_g = got[1:].T, got[0]
    rgb_w, dep_w = want
    diff = (rgb_g - rgb_w).abs().amax(dim=-1)
    ok = diff[diff <= 1e-3]
    return {"records": {},
            "pixel_outliers": (diff > 1e-3).float().mean().item(),
            "inlier_mean_err": ok.mean().item() if ok.numel() else 0.0,
            "max_abs_err": diff.max().item(),
            "depth_outliers": ((dep_g - dep_w).abs() > 1e-3).float().mean().item(),
            "finite": bool(torch.isfinite(rgb_g).all() and torch.isfinite(dep_g).all())}


def print_readings(name, a):
    rec = ", ".join(f"{k} {v[0]:.4%} (max {v[1]:.3g})"
                    for k, v in a["records"].items())
    print(f"  {name}: image outliers {a['pixel_outliers']:.4%} (inlier mean "
          f"{a['inlier_mean_err']:.3g}, max {a['max_abs_err']:.4g}), depth "
          f"outliers {a['depth_outliers']:.4%}"
          + (f"; records off: {rec}" if rec else ""))


def k4_contract(a, cornell):
    """Whether K4's readings against its plain version (``k4_readings``)
    meet the card's contract (see K4_* above)."""
    limit = K4_CORNELL_FRAC if cornell else K4_FRAC
    return (a["finite"] and a["pixel_outliers"] <= limit
            and a["inlier_mean_err"] <= K4_INLIER_MEAN
            and a["depth_outliers"] <= limit
            and all(frac <= limit for frac, _ in a["records"].values()))


def k4_bound(r, stats, n_slots, direct=False, layout="copy"):
    """(bound_ms, bound_by, ops, bytes, issue_ms) of one K4 launch on ``r``'s scene
    from the work the kernel counted (``stats``, cuda_mesh.STATS order):
    the larger of the bytes over the memory rate and, per operation type,
    the operations over the card's peak rate.  Bytes: the mesh, its
    per-slot attribute arrays and the small tables read once, and the
    records written once (``n_slots`` floats a pixel); in ``direct`` mode
    16 bytes a pixel written (depth and rgb) and the HDRI, diffuse texture
    and MERL table the scene fetches read once, with the fetches' own
    operations (K4_FETCH_OPS).  The mesh walk's bytes are the compressed
    copy's and its operations what its work needs (``trav_ops``), or for
    ``layout`` "decode" with the copy's decode, or for "float" the float
    layout's bytes and operations."""
    visits, boxes, tris, traced, hits, brdf, mis, env, tex = stats
    s, scene = r.settings, r.scene
    spheres = scene.spheres.count + (1 if s.use_example_sphere else 0)
    walk = trav_ops(visits, boxes, tris, layout)
    ops = {
        "fp32": (traced * spheres * FWD_STEP["fp32_per_sphere"]
                 + hits * K4_OPS["hit_fp32"] + brdf * K4_OPS["brdf_fp32"]
                 + mis * K4_OPS["mis_fp32"] + walk["fp32"]),
        "sfu": (traced * spheres * FWD_STEP["sfu_per_sphere"]
                + hits * K4_OPS["hit_sfu"] + brdf * K4_OPS["brdf_sfu"]
                + mis * K4_OPS["mis_sfu"] + walk["sfu"]),
        "int32": (hits * K4_OPS["hit_int32"] + mis * K4_OPS["mis_int32"]
                  + walk["int32"]),
        "fma": (traced * spheres * FWD_STEP["fma_per_sphere"]
                + hits * K4_OPS["hit_fma"] + brdf * K4_OPS["brdf_fma"]
                + mis * K4_OPS["mis_fma"] + walk["fma"]),
    }
    n_bytes = 14 * 4 * scene.spheres.count
    if s.has_mesh and not s.use_example_sphere:
        mesh = scene.mesh
        n_bytes += mesh_read_bytes(mesh, True, layout) + sum(
            getattr(mesh, f).numel() * 4 for f in ("tri_e1", "tri_e2", "tri_uv", "tri_t"))
    if direct:
        from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

        bil = "_bilinear" if s.texture_filter == "bilinear" else ""
        f = K4_FETCH_OPS
        ops["fp32"] += (env * f[f"env{bil}_fp32"] + tex * f[f"tex{bil}_fp32"]
                        + brdf * f["merl_fp32"])
        ops["sfu"] += env * f["env_sfu"]
        ops["int32"] += (env * f[f"env{bil}_int32"] + tex * f[f"tex{bil}_int32"]
                         + brdf * f["merl_int32"])
        ops["fma"] += (env * f[f"env{bil}_fma"] + tex * f[f"tex{bil}_fma"]
                       + brdf * f["merl_fma"])
        defer = k4.Defer(s)
        n_bytes += 16 * s.n_pixels + sum(
            t.numel() * 4 for t, on in ((scene.hdr, defer.env),
                                        (scene.diffuse_map, defer.tex),
                                        (scene.brdf, defer.merl)) if on)
    else:
        n_bytes += 4 * n_slots * s.n_pixels
    t_ops = pipe_s(ops)
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_issue = max(issue_s(ops), t_bytes)
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            ops, n_bytes, t_issue * 1e3)


def many_spheres(scene, n, rng, visible):
    """``scene`` with diffuse spheres added up to ``n``: small ones on a
    lattice inside the Cornell box, none overlapping (``visible``: random
    radii and albedos), or unit ones far beyond its back and side walls,
    where no ray of the box reaches."""
    from vrenderer_pathtracer_tpu_torch import interop

    sp = scene.spheres
    k = n - sp.count
    if visible:
        # Diffuse and apart (spacing 10, radius 1.5-2.5): no mirror chains
        # or near-equal hits of overlapping spheres to amplify float noise.
        grid = np.stack(np.meshgrid(np.arange(-40.0, 41.0, 10.0),
                                    np.arange(-40.0, 41.0, 10.0),
                                    np.arange(-95.0, 0.0, 10.0), indexing="ij"), -1)
        extra = dict(pos=grid.reshape(-1, 3)[:k], radius=rng.uniform(1.5, 2.5, k),
                     color=rng.uniform(0.2, 0.9, (k, 3)))
    else:
        extra = dict(pos=np.stack([1e6 + 3.0 * np.arange(k), np.zeros(k),
                                   np.full(k, -1e6)], 1),
                     radius=np.ones(k), color=np.full((k, 3), 0.5))
    extra.update(emission=np.zeros((k, 3)), refl=np.ones(k),
                 spec_color=np.zeros((k, 3)))
    return interop.scene_from_numpy(
        {f: np.concatenate([getattr(sp, f).cpu().numpy(), v]) for f, v in extra.items()},
        device=sp.device)


def k4_phases(dev, card, work_dir, nm_obj):
    """Phases 18-26; returns K4's row of the kernel table."""
    from vrenderer_pathtracer_tpu_torch import (
        DeferredParams, Renderer, RenderSettings, deferred_opt_step)
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.render import integrator
    from vrenderer_pathtracer_tpu_torch.render.renderer import (
        render_pass as render_pass_dispatch)
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms

    # 18. The K4 scenes, through the Renderer's entry points.
    t0 = time.perf_counter()
    rs = k4_renderers(work_dir, nm_obj, dev)
    print(f"K4 scenes built in {time.perf_counter() - t0:.2f} s:")
    for name, r in rs.items():
        s = r.settings
        assert (s.radiance_kernel, s.traversal) == ("cuda_mesh", "cuda"), name
        print(f"  {name}: {s.width}x{s.height}, {s.samples_per_pass} spp, "
              f"{s.bounces} bounces, {k4.layout(s)[1]} record slots, "
              f"MIS {s.brdf_importance_sampling}")

    # 19. K4 against its plain version on the card, records and images.
    print("K4 vs records_reference on the card (limits: image, depth and "
          f"record outliers {K4_FRAC:g}, in the Cornell box {K4_CORNELL_FRAC:g}; "
          f"inlier mean {K4_INLIER_MEAN:g}):")
    wants, max_err = {}, 0.0
    for name, r in rs.items():
        a = k4_args(r)
        got = k4.launch_k4(*a, 1, 0)
        torch.cuda.synchronize()
        want = wants[name] = k4.records_reference(
            r.scene, r.settings, r.camera, 1, r.fresnel_coef, r.fresnel_pow, 0)
        rd = k4_readings(r, got, want)
        print_readings(name, rd)
        assert k4_contract(rd, r.settings.use_cornell_box), name
        max_err = max(max_err, rd["max_abs_err"])
        assert torch.equal(got, k4.launch_k4(*a, 1, 0)), f"{name}: K4 repeats differ"
        composed = k4.compose(got, r.scene, r.settings)
        del got
        # The direct mode (the Renderer's): against the plain version's
        # composed pass and against the records mode's.
        direct = k4.launch_k4(*a, 1, 0, direct=True)
        torch.cuda.synchronize()
        assert direct.shape == (4, r.settings.n_pixels), name
        for what, want_pass in (
                ("plain", k4.compose(want, r.scene, r.settings)),
                ("records + compose", composed)):
            rd = direct_readings(direct, want_pass)
            print_readings(f"{name}, direct vs {what}", rd)
            assert k4_contract(rd, r.settings.use_cornell_box), f"{name} direct vs {what}"
            max_err = max(max_err, rd["max_abs_err"])
        assert torch.equal(direct, k4.launch_k4(*a, 1, 0, direct=True)), name
        del direct, composed
    print("K4 repeat launches bit-identical (records and direct)")

    # 20. Planted faults: each is a wrong K4, and each must break the contract.
    print("planted K4 faults against records_reference:")
    for what, (name, fault, arg) in {
            "MIS factor dropped": ("mesh + MERL + MIS", k4.FAULT_MIS_FACTOR, 0.0),
            "MERL index off by one": ("config 4", k4.FAULT_MERL_INDEX, 0.0),
            "kill-zeroing skipped": ("Cornell light, no walls, + mesh + texture",
                                     k4.FAULT_KILL, 0.0),
            "uv off by one texel": ("mesh-megakernel", k4.FAULT_UV, 1.0 / 256)}.items():
        r = rs[name]
        bad = k4.launch_k4(*k4_args(r), 1, 0, fault=fault, fault_arg=arg)
        rd = k4_readings(r, bad, wants[name])
        print_readings(f"{what} ({name})", rd)
        assert not k4_contract(rd, r.settings.use_cornell_box), f"{what} passes"
    print("planted K4 direct-mode faults against the plain version's pass:")
    for what, (name, fault) in {
            "HDRI one texel off in u": ("mesh-megakernel", k4.FAULT_ENV_U),
            "texture v flipped": ("mesh-megakernel", k4.FAULT_TEX_V),
            "MERL channel scale dropped": ("config 4", k4.FAULT_MERL_SCALE)}.items():
        r = rs[name]
        bad = k4.launch_k4(*k4_args(r), 1, 0, direct=True, fault=fault)
        rd = direct_readings(bad, k4.compose(wants[name], r.scene, r.settings))
        print_readings(f"{what} ({name})", rd)
        assert not k4_contract(rd, r.settings.use_cornell_box), f"{what} passes"
    del wants, bad

    # 21. Render paths: K4 once a pass; no plain version, no K3, no K1/K2.
    plain_pass = integrator.render_pass

    def no_plain(*_a, **_k):
        raise AssertionError("the plain integrator ran on a K4 scene")

    integrator.render_pass = no_plain
    k4.launch_k4.count = k4.records_reference.count = trav.traverse.count = 0
    k3.launch_k3.count = k3.launch_k3b.count = k1.launch.count = k2.launch.count = 0
    k4.compose.count = 0
    walls, launches = {}, {}
    for name, r in rs.items():
        if "no walls" in name:
            continue  # the kill fault's scene: almost every path is killed
        r.clear_buffer()
        base = k4.launch_k4.count
        r.render()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(K4_PASSES):
            img, depth = r.render()
            assert k4.launch_k4.count == base + i + 2
            assert k4.compose.count == 0, "a Renderer pass composed records"
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) / K4_PASSES
        launches[name] = k4.launch_k4.count - base
        assert torch.isfinite(img).all() and torch.isfinite(depth).all(), name
        h, w = img.shape[:2]
        centre = img[h // 2 - 32:h // 2 + 32, w // 2 - 32:w // 2 + 32].mean().item()
        assert centre > 0.05, f"{name}: the centre is black"
        assert (depth[h // 2, w // 2] < 1.0).item(), name
        rays = r.settings.n_pixels * r.settings.samples_per_pass * r.settings.bounces
        print(f"K4 render path, {name}: {walls[name] * 1e3:.3f} ms/pass wall, "
              f"{rays / walls[name] / 1e6:.1f} Mrays/s, image mean "
              f"{img.mean().item():.4f}, centre {centre:.4f}, K4 launches "
              f"{launches[name]} (mode {k4.mode(r.scene)}), compose calls "
              f"{k4.compose.count}, {card}")
    integrator.render_pass = plain_pass
    assert (k4.records_reference.count, trav.traverse.count, k3.launch_k3.count,
            k3.launch_k3b.count, k1.launch.count, k2.launch.count) == (0,) * 6
    k4_launches = k4.launch_k4.count
    # The comparison pass: the mesh-megakernel scene on the wavefront.
    r = rs["mesh-megakernel"]
    rw = Renderer(WIDTH, HEIGHT, settings=RenderSettings(
        samples_per_pass=2, bounces=4, radiance_kernel="wavefront"), device=dev)
    rw.load_mesh(nm_obj)
    hdr, tex, _, _ = nm_assets()
    rw.load_texture(tex, 2.2, 0)
    rw.load_hdr(hdr)
    rw.update_camera(origin=(0.0, 0.0, 40.0))
    assert rw.settings.radiance_kernel == "wavefront"
    k4.launch_k4.count = 0
    rw.render()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(K4_PASSES):
        wimg, wdepth = rw.render()
    torch.cuda.synchronize()
    wf_wall = (time.perf_counter() - t0) / K4_PASSES
    assert k4.launch_k4.count == 0 and k3.launch_k3.count == 4 * (K4_PASSES + 1)
    kimg, kdepth = r.current_frame()
    diff = (kimg - wimg).abs()
    px = (diff > 1e-3).any(dim=-1).float().mean().item()
    print(f"  K4 vs wavefront image after {K4_PASSES + 1} passes: {px:.4%} "
          f"pixels off by >1e-3, mean {diff.mean().item():.3g}, depth >1e-3 "
          f"{((kdepth - wdepth).abs() > 1e-3).float().mean().item():.4%}")
    assert px <= 0.02 and diff.mean().item() <= 2e-3  # the golden image contract
    print(f"wavefront comparison pass, mesh-megakernel scene: {wf_wall * 1e3:.3f} "
          f"ms/pass wall against K4's {walls['mesh-megakernel'] * 1e3:.3f}, {card}")
    del rw

    # 22. Training the deferred tables (config 4's HDRI and MERL table).
    r = rs["config 4"]
    s = r.settings
    target, _ = k4.render_pass_mesh(r.scene.replace(hdr=r.scene.hdr * 1.5), s,
                                    r.camera, 1, r.fresnel_coef, r.fresnel_pow)
    params = DeferredParams.from_scene(r.scene, hdr=True, brdf=True)
    for leaf in params.leaves():
        leaf.requires_grad_()
    step = deferred_opt_step(s, torch.optim.Adam(params.leaves(), lr=0.05),
                             scene=r.scene)
    integrator.render_pass = no_plain
    k4.launch_k4.count = k4.compose.count = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(K4_STEPS):
        params, m = step(params, r.scene, r.camera, target, 1, r.fresnel_coef,
                         r.fresnel_pow)
        losses.append(m["loss"].item())
        # The tables require grad: the records mode, then compose.
        assert k4.launch_k4.count == k4.compose.count == i + 1
    step_wall = (time.perf_counter() - t0) / K4_STEPS
    step_launches = (k4.launch_k4.count, k4.compose.count)
    device_profile("deferred_opt_step (config 4)", lambda: step(
        params, r.scene, r.camera, target, 1, r.fresnel_coef, r.fresnel_pow), 3,
        top=8)
    integrator.render_pass = plain_pass
    assert all(math.isfinite(x) for x in losses)
    print(f"deferred_opt_step, config 4 {s.width}x{s.height}, Adam on hdr + "
          f"brdf: loss {losses[0]:.6g} -> {losses[-1]:.6g} in {K4_STEPS} steps, "
          f"K4 launches {step_launches[0]} (records mode, compose calls "
          f"{step_launches[1]}), {step_wall * 1e3:.3f} ms/step wall")
    assert losses[-1] < K4_LOSS_DROP * losses[0], losses
    # The same gradients through K4 + compose and through the wavefront's
    # autograd, on the same frame.
    grads = {}
    for kernel in ("cuda_mesh", "wavefront"):
        ks = s.replace(radiance_kernel=kernel)
        h = r.scene.hdr.clone().requires_grad_()
        t = r.scene.brdf.clone().requires_grad_()
        rgb, _ = render_pass_dispatch(r.scene.replace(hdr=h, brdf=t), ks, r.camera,
                                      1, r.fresnel_coef, r.fresnel_pow)
        loss = torch.sum((rgb - target) ** 2) / (s.n_pixels * 3)
        grads[kernel] = torch.autograd.grad(loss, [h, t])
    grad_err = {}
    for name, g, w in zip(("hdr", "brdf"), grads["cuda_mesh"], grads["wavefront"]):
        rel = ((g - w).norm() / w.norm()).item()
        frac = ((g - w).abs() > 1e-3 * w.abs().max()).float().mean().item()
        grad_err[name] = (rel, frac)
        print(f"  d loss / d {name}: K4 vs wavefront rel err {rel:.4g}, entries "
              f"off by >1e-3 of the scale {frac:.4%} (limits {K4_GRAD_RTOL:g}, "
              f"{K4_GRAD_FRAC:g})")
        assert w.abs().max().item() > 0 and rel <= K4_GRAD_RTOL and frac <= K4_GRAD_FRAC
    del grads

    # 23. Cornell scenes of 600 spheres (more than K1 stages in shared
    # memory) through K1: with 592 spheres beyond the walls that no ray
    # reaches, bit-identical to the 8-sphere scene (the table read from
    # global memory gives the same winners); with 592 small visible
    # spheres, against the plain version under the golden image contract.
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene, settings_for_scene

    # The visible scene at 1 spp and 2 bounces: each ray segment near a
    # silhouette of the 592 spheres may flip between the two programs, so
    # fewer segments keep the comparison about the sphere table.
    cs = RenderSettings(width=256, height=256, samples_per_pass=1, bounces=2,
                        use_cornell_box=True, has_hdr=False)
    base = Scene.analytic(cs, dev)
    cam = Camera.default(dev)
    rng = np.random.default_rng(1)
    far, visible = (many_spheres(base, 600, rng, visible=v) for v in (False, True))
    k1.launch.count = 0
    for scene in (far, visible):
        assert settings_for_scene(scene, cs).radiance_kernel == "cuda"
        assert scene.spheres.count == 600 > k1.SMEM_SPHERES
    got_far, got_base = (k1.render_pass_cuda(sc, cs, cam, 1, 0.1, 3.0) for sc in (far, base))
    assert all(torch.equal(x, y) for x, y in zip(got_far, got_base)), "K1 600 far spheres"
    got = k1.render_pass_cuda(visible, cs, cam, 1, 0.1, 3.0)
    want = k1.render_pass_reference(visible, cs, cam, 1, 0.1, 3.0)
    torch.cuda.synchronize()
    assert k1.launch.count == 3
    diff = (got[0] - want[0]).abs().amax(dim=-1)
    px = (diff > 1e-3).float().mean().item()
    print(f"K1, 600-sphere Cornell scenes 256x256: beyond the walls bit-identical "
          f"to the 8-sphere scene; visible, against plain: {px:.4%} pixels off "
          f"by >1e-3, mean {diff.mean().item():.3g}, depth >1e-3 "
          f"{((got[1] - want[1]).abs() > 1e-3).float().mean().item():.4%}")
    assert px <= 0.02 and diff.mean().item() <= 2e-3  # the golden image contract

    # 24. Times (CUDA events), in turns, on the mesh-megakernel scene and
    # config 4: K4 alone on packed tables in each mode, the pass in each
    # mode (direct: render_pass_mesh, packing + K4; records: packing + K4 +
    # compose), compose alone, the plain version and the wavefront pass.
    # On the other scenes with lobe MIS or the Cornell box, K4 alone in each
    # mode (what its occupancy setting, kMinBlocks in csrc/mesh.cu, trades).
    n = K4_TIMED_LAUNCHES
    timed = {}
    for name in ("config 4 + MIS", "mesh + MERL + MIS", "Cornell + mesh + texture"):
        a = k4_args(rs[name])
        timed[f"K4 direct {name}"] = (lambda a=a: k4.launch_k4(*a, 1, 0, direct=True), n)
        timed[f"K4 records {name}"] = (lambda a=a: k4.launch_k4(*a, 1, 0), n)
    for name in ("mesh-megakernel", "config 4"):
        r = rs[name]
        a = k4_args(r)
        rec = k4.launch_k4(*a, 1, 0)
        pargs = (r.scene, r.settings, r.camera, 1, r.fresnel_coef, r.fresnel_pow, 0)
        ws = r.settings.replace(radiance_kernel="wavefront")
        assert k4.mode(r.scene) == k4.DIRECT
        timed[f"K4 direct {name}"] = (lambda a=a: k4.launch_k4(*a, 1, 0, direct=True), n)
        timed[f"K4 records {name}"] = (lambda a=a: k4.launch_k4(*a, 1, 0), n)
        timed[f"pass direct {name}"] = (lambda p=pargs: k4.render_pass_mesh(*p), 10)
        timed[f"pass records {name}"] = (lambda r=r: k4.compose(
            k4.launch_k4(*k4_args(r), 1, 0), r.scene, r.settings), 10)
        timed[f"compose {name}"] = (lambda rec=rec, r=r: k4.compose(rec, r.scene, r.settings), 10)
        timed[f"plain {name}"] = (lambda p=pargs, r=r: k4.compose(
            k4.records_reference(*p), r.scene, r.settings), 1)
        timed[f"wavefront {name}"] = (lambda p=pargs, ws=ws: integrator.render_camera_pass(
            p[0], ws, *p[2:]), 3)
    t = {name: [] for name in timed}
    for name in [*timed, *reversed(timed)]:
        fn, iters = timed[name]
        t[name].append(cuda_time_ms(fn, dev, iters=iters, warmup=1))
    ms = {name: sum(v) / len(v) for name, v in t.items()}
    for name, v in t.items():
        print(f"{name}: {', '.join(f'{x:.4f}' for x in v)} ms")
    # K4 alone on config 4 under the profiler: the card's busy time a launch
    # beside the host's wall, which says whether the readings above time the
    # kernel or its wrapper.
    for mode in (k4.DIRECT, k4.RECORDS):
        device_profile(f"K4 {mode} config 4, alone", lambda a=k4_args(rs["config 4"]),
                       d=mode == k4.DIRECT: k4.launch_k4(*a, 1, 0, direct=d),
                       K4_TIMED_LAUNCHES, top=3)

    # 25. Where the time goes: 20 K4 passes of the mesh-megakernel scene.
    device_profile("K4 render pass (mesh-megakernel)", rs["mesh-megakernel"].render,
                   20, top=10)

    # 26. K4's bound from the work it counts, per scene and mode.
    rows = {}
    for name in ("mesh-megakernel", "config 4"):
        r = rs[name]
        n_slots = k4.layout(r.settings)[1]
        for mode in (k4.DIRECT, k4.RECORDS):
            stats = torch.zeros(len(k4.STATS), dtype=torch.int64, device=dev)
            k4.launch_k4(*k4_args(r), 1, 0, stats=stats, direct=mode == k4.DIRECT)
            counts = dict(zip(k4.STATS, stats.tolist()))
            b_ms, by, ops, n_bytes, i_ms = k4_bound(r, stats.tolist(), n_slots,
                                                    direct=mode == k4.DIRECT)
            d_ms, f_ms = (k4_bound(r, stats.tolist(), n_slots, direct=mode == k4.DIRECT,
                                   layout=lay)[0] for lay in ("decode", "float"))
            rows[(name, mode)] = (b_ms, by, d_ms, i_ms)
            k_ms = ms[f"K4 {mode} {name}"]
            print(f"K4 bound, {name}, {mode} mode: {b_ms:.4f} ms ({by}; {counts}; "
                  f"ops {ops}; bytes {n_bytes}"
                  + (f", records {4 * n_slots * r.settings.n_pixels} written and "
                     "read again by compose" if mode == k4.RECORDS else "")
                  + f"), measured {k_ms:.4f} ms = {b_ms / k_ms:.1%} of bound; "
                  f"issue bound {i_ms:.4f} ms = {i_ms / k_ms:.1%}; "
                  f"with the copy's decode {d_ms:.4f} ms, on the float layout "
                  f"the walk read before {f_ms:.4f} ms, {card}")
    for name in ("mesh-megakernel", "config 4"):
        print(f"K4 pass, {name}: direct {ms[f'pass direct {name}']:.4f} ms "
              f"(K4 {ms[f'K4 direct {name}']:.4f}), records "
              f"{ms[f'pass records {name}']:.4f} ms (K4 "
              f"{ms[f'K4 records {name}']:.4f}, compose {ms[f'compose {name}']:.4f}), "
              f"{card}")
    return {
        "name": "K4 fused mesh-scene pass",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/mesh.cu",
        "replaces": "vrenderer_pathtracer_tpu/render/pallas_mesh.py:254",
        "launches": k4_launches,
        "launches_by_scene": launches,
        "max_abs_err": max_err,
        "ms": ms["K4 direct mesh-megakernel"],
        "ms_records": ms["K4 records mesh-megakernel"],
        "ms_config4": ms["K4 direct config 4"],
        "ms_records_config4": ms["K4 records config 4"],
        "pass_ms": ms["pass direct mesh-megakernel"],
        "pass_records_ms": ms["pass records mesh-megakernel"],
        "compose_ms": ms["compose mesh-megakernel"],
        "wavefront_ms": ms["wavefront mesh-megakernel"],
        "plain_ms": ms["plain mesh-megakernel"],
        "bound_ms": rows[("mesh-megakernel", k4.DIRECT)][0],
        "bound_by": rows[("mesh-megakernel", k4.DIRECT)][1],
        "bound_ms_decode": rows[("mesh-megakernel", k4.DIRECT)][2],
        "bound_issue_ms": rows[("mesh-megakernel", k4.DIRECT)][3],
        "bound_ms_records": rows[("mesh-megakernel", k4.RECORDS)][0],
        "bound_ms_config4": rows[("config 4", k4.DIRECT)][0],
        "grad_rel_err": grad_err,
        "library_ms": None,
    }


# The config-5 path (phases 27-36): BASELINE config 5 as bench.py:249-288
# and examples/config5.py run it, with its assets made by the port's
# examples/config5.py::synth_assets (the sky as an array): the
# ~499k-triangle UV sphere (paged: K5 as the mesh search, compact bounce
# waves), the 128x256 gradient sky, a Lambertian MERL table written as a
# .binary and read by load_brdf(path), FXAA, remat; 1920x1080, 2 spp, 4
# bounces, the default camera.  No cut.
C5_SIZE = (1920, 1080)
C5_SMALL = (480, 270)
C5_THETA = 500                  # the sphere's rings: 499,000 triangles
C5_CPU_SPHERE = (12.0, 40, 40)  # 3,120 triangles, paged at 512 a page
C5_WARM, C5_PASSES = 2, 5
K5_SAMPLE = 65536               # rays sampled from each spec wave
# The gradient parity policy of tests/test_paged_grad_parity.py: relative
# L2 of each gradient, and the share of coefficients within 1e-2 of the
# single-level one (with a floor of 1e-4 of its largest magnitude).
GRAD_REL_L2, GRAD_TIGHT_FRAC = 5e-3, 0.995
# K6: the probe's 512-step chain; its rate is timed on a card-filling
# array (2^22 float32 elements, 2^23 bf16: the same bytes) at the probe's
# constants, under which the bf16 chain keeps its input.  Its agreement
# with the plain chain is checked at kernels/probe.py's check constants,
# where the chain moves in both dtypes, at the probe's shapes and the
# card-filling ones: float32 within probe.F32_RTOL (the FMA against two
# roundings a step), bf16 bit-equal; the planted no-op kernel must fail.
K6_N = 1 << 22
# A size with a ragged tail at every chain count above 2 (both dtypes).
K6_RAGGED = (1 << 22) + 6
# A packed __hfma2 does two bf16 FMAs in one instruction at the FP32 FMA
# issue rate: 2 x 67 TFLOP/s (NVIDIA's Hopper architecture white paper,
# 133.8 TFLOP/s non-tensor FP16/BF16).
BF16X2_RATE = 2 * RATES["fp32"]


def config5_assets(work_dir):
    """The port's ``examples/config5.py::synth_assets``, written into
    ``work_dir/c5``: (obj path, its ``sky_image()`` [128,256,3] as an
    array, MERL .binary path).  The EXR beside them holds the same sky in
    half floats; phase 48 reads it."""
    from vrenderer_pathtracer_tpu_torch.examples import config5

    out = work_dir / "c5"
    out.mkdir(parents=True, exist_ok=True)
    obj, _, brdf = config5.synth_assets(str(out), C5_THETA)
    return obj, config5.sky_image(), brdf


def config5_renderer(width, height, device, sky, brdf, mesh):
    """Config 5 through the Renderer's entry points, on a packed mesh."""
    from vrenderer_pathtracer_tpu_torch import Renderer, RenderSettings

    r = Renderer(width, height, settings=RenderSettings(
        samples_per_pass=2, bounces=4, use_fxaa=True, use_brdf=True,
        remat_bounces=True), device=device)
    r.load_hdr(sky)
    r.load_brdf(brdf)
    r.init_mesh(mesh)
    return r


def capture_paged_waves(r):
    """Render one pass of ``r`` and return the (ray_o, ray_d, t_max) of
    every K5 search in it, in bounce order."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5

    waves, real = [], k5.traverse_paged_cuda

    def spy(mesh, o, d, t):
        waves.append((o.clone(), d.clone(), t.clone()))
        return real(mesh, o, d, t)

    k5.traverse_paged_cuda = spy
    try:
        r.render()
    finally:
        k5.traverse_paged_cuda = real
    return waves


def paged_read_bytes(mesh, layout="copy"):
    """Bytes of the paged arrays K5 reads, each once: as mesh_read_bytes
    counts K3's, over the top tree and every page's tree (the compressed
    copy, or for ``layout`` "float" the float layout)."""
    pg = mesh.paged
    if layout == "float":
        return float_layout_bytes(pg.nodes8_i)
    return copy_bytes(pg.nodes8_c, pg.leaf_rows)


def paged_bound(mesh, waves, layout="copy"):
    """(bound_ms, bound_by, work, bytes, issue_ms) of K5 over ``waves``, as
    ``traversal_bound`` counts K3's (``layout`` too): the work K5 counts on
    these rays (node visits, box tests, triangle tests, pages searched), the
    rays' bytes, and the paged arrays once."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5

    mesh_bytes = paged_read_bytes(mesh, layout)
    total, by_ops, work, n_bytes, issue = 0.0, 0.0, [0, 0, 0, 0], 0, 0.0
    for i, (o, d, t) in enumerate(waves):
        stats = torch.zeros(4, dtype=torch.int64, device=o.device)
        k5.launch_k5(mesh, o, d, t, stats=stats)
        got = [int(x) for x in stats.tolist()]
        work = [a + b for a, b in zip(work, got)]
        visits, boxes, tris, _ = got
        ops = trav_ops(visits, boxes, tris, layout)
        t_ops = pipe_s(ops)
        wave_bytes = (o.shape[0] * (4 + 8) + int((t > 0).sum()) * 24
                      + (mesh_bytes if i == 0 else 0))
        n_bytes += wave_bytes
        t_bytes = wave_bytes / HBM_BYTES_PER_S
        total += max(t_ops, t_bytes)
        issue += max(issue_s(ops), t_bytes)
        by_ops += t_ops if t_ops >= t_bytes else 0.0
    return (total * 1e3, "operations" if by_ops >= total / 2 else "bytes",
            work, n_bytes, issue * 1e3)


def sample_rays(wave, n, seed):
    """``n`` rays of ``wave`` (all of them if it holds fewer), chosen with a
    fixed seed."""
    o, d, t = wave
    g = torch.Generator(device="cpu").manual_seed(seed)
    idx = torch.randperm(o.shape[0], generator=g)[:n].to(o.device)
    return o[idx].contiguous(), d[idx].contiguous(), t[idx].contiguous()


def config5_grads(scene, settings, camera, target, fc, fp):
    """``examples/config5.py::env_material_grads`` (loss, MERL and HDRI
    gradients of one wavefront pass) with wall seconds and peak device
    bytes."""
    from vrenderer_pathtracer_tpu_torch.examples.config5 import env_material_grads

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, g_brdf, g_hdr = env_material_grads(scene, settings, camera, target,
                                             fc, fp)
    torch.cuda.synchronize()
    return (loss.item(), g_brdf, g_hdr, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated())


def grad_parity(name, got, want):
    """tests/test_paged_grad_parity.py's policy: (rel L2, tight share)."""
    got, want = got.double(), want.double()
    rel = ((got - want).norm() / want.norm().clamp(min=1e-12)).item()
    denom = want.abs() + 1e-4 * want.abs().max() + 1e-12
    tight = ((got - want).abs() / denom < 1e-2).double().mean().item()
    print(f"  {name}: rel L2 {rel:.4g} (limit {GRAD_REL_L2:g}), within 1e-2: "
          f"{tight:.5%} (limit {GRAD_TIGHT_FRAC:.1%}), |grad| "
          f"{want.norm().item():.4g}")
    return rel, tight


def sass_opcodes(lib):
    """Print each kernel's count of SASS instructions and of FMA-class ones
    in ``lib`` (cuobjdump, where the toolkit has it)."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                             text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        print(f"  SASS: cuobjdump not available ({e})")
        return
    for chunk in out.split("Function : ")[1:]:
        name = chunk.split()[0]
        ops = re.findall(r"\b(FFMA|HFMA2(?:\.[A-Z0-9_]+)*|FMUL|FADD)\b", chunk)
        counts = {op: ops.count(op) for op in sorted(set(ops))}
        total = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/", chunk, re.M))
        # The mangled name's end holds the template arguments.
        print(f"  SASS ...{name[-64:]}: {total} instructions, {counts}")


def config5_phases(dev, card, work_dir):
    """Phases 27-36; returns the K5 and K6 rows of the kernel table and
    phase 32's K7 launches."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.accel.mesh import pack_mesh
    from vrenderer_pathtracer_tpu_torch.accel.paged import pack_mesh_paged
    from vrenderer_pathtracer_tpu_torch.core import rng
    from vrenderer_pathtracer_tpu_torch.kernels import build
    from vrenderer_pathtracer_tpu_torch.kernels import probe as k6
    from vrenderer_pathtracer_tpu_torch.native import load_mesh_file, load_obj
    from vrenderer_pathtracer_tpu_torch.ops.fxaa import fxaa
    from vrenderer_pathtracer_tpu_torch.ops.tonemap import tonemap
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4
    from vrenderer_pathtracer_tpu_torch.render import integrator
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    # 27. Config-5 set-up: the assets, the OBJ, the paged pack.
    t0 = time.perf_counter()
    obj, sky, brdf = config5_assets(work_dir)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = load_mesh_file(obj)
    load_s = time.perf_counter() - t0
    seconds = {}
    mesh = pack_mesh_paged(host, device=dev, seconds=seconds)
    pg = mesh.paged
    dev_bytes = sum(t.numel() * t.element_size() for t in mesh.tensors())
    print(f"config 5: {len(host.tris)} triangles in {pg.n_pages} pages of "
          f"{pg.page_tris}, {pg.n_top} top-level and "
          f"{pg.nodes8_i.shape[0] - pg.n_top} page nodes, "
          f"{pg.tri_pack.shape[0]} leaf rows, {dev_bytes / 1e6:.1f} MB on the "
          f"card; the walk's compressed copy "
          f"{copy_bytes(pg.nodes8_c, pg.leaf_rows) / 1e6:.2f} MB "
          f"({pg.nodes8_c.shape[0]} nodes, {pg.leaf_rows.shape[0]} leaf rows) "
          f"against {wide_array_bytes(pg) / 1e6:.2f} MB of the float layout; "
          f"set-up: assets {synth_s:.2f} s, OBJ {load_s:.2f} s, page "
          f"SBVHs {seconds['sbvh']:.2f} s, collapse + leaf blocks "
          f"{seconds['collapse']:.2f} s, top tree + upload "
          f"{seconds['upload']:.2f} s")
    w, h = C5_SIZE
    r = config5_renderer(w, h, dev, sky, brdf, mesh)
    t0 = time.perf_counter()
    r.load_mesh(obj)  # the entry point a user calls: pack_mesh(paged=None)
    print(f"  Renderer.load_mesh: {time.perf_counter() - t0:.2f} s")
    mesh = r.scene.mesh
    assert mesh.paged is not None and mesh.paged.n_pages == pg.n_pages

    # 28. Resolution.
    s = r.settings
    assert (s.radiance_kernel, s.traversal, s.compact_waves) == (
        "wavefront", "cuda_paged", True), s
    assert s.use_fxaa and s.remat_bounces and s.has_brdf and s.has_hdr
    assert not k4.supports(r.scene, s)
    print(f"config 5 resolves: radiance {s.radiance_kernel}, traversal "
          f"{s.traversal}, compact waves {s.compact_waves}")

    # 29. K5 against its plain version: 65,536 rays sampled from each wave
    # of a spec pass, every ray of a 480x270 pass, planted faults, NaN rays.
    spec_waves = capture_paged_waves(r)
    assert len(spec_waves) == s.bounces
    r.clear_buffer()
    small = config5_renderer(*C5_SMALL, dev, sky, brdf, mesh)
    small_waves = capture_paged_waves(small)
    sets = {f"spec wave {i} (sample of {wv[0].shape[0]})":
            sample_rays(wv, K5_SAMPLE, seed=i)
            for i, wv in enumerate(spec_waves)}
    sets.update({f"480x270 wave {i}": wv for i, wv in enumerate(small_waves)})
    print("K5 vs traverse_paged_reference on the card (limits: hit/miss "
          f"{HIT_MISMATCH_FRAC:g}, other triangle {GEOMETRY_MISMATCH_FRAC:g} "
          f"of the rays, t rtol {T_RTOL:g}):")
    k5_err = 0.0
    wants = {}
    for name, (o, d, t) in sets.items():
        want = wants[name] = trav.traverse_paged_reference(mesh, o, d, t)
        a = check_hits(f"K5 {name}", mesh, k5.traverse_paged_cuda(mesh, o, d, t),
                       want, t)
        k5_err = max(k5_err, a["t_abs_max"])
    union = [torch.cat([sets[n][k] for n in sets if n.startswith("spec")])
             for k in range(3)]
    want_u = trav.traverse_paged_reference(mesh, *union)
    print("planted K5 faults, the sampled spec rays against the plain version:")
    gate = k5.FAULTS["a page's occlusion skip tests > against the next entry's entry t"]
    for what, f in k5.FAULTS.items():
        a = agreement(f"K5, {what}", mesh,
                      k5.launch_k5(mesh, *union, fault=f), want_u, union[2])
        # The skip faults leave the walk running: each loses some hits, not
        # every one (an all-miss kernel would read the hit fraction).
        if f != k5.FAULTS["global slot one page off"]:
            assert a["hit_mismatch"] < a["hit_frac"], f"K5, {what} kills every hit"
        if f != gate:
            assert not traversal_contract(a), f"K5, {what} passes"
    # The gate fault errs only where the page that holds a ray's hit is the
    # last entry left on its stack (no farther box behind the hit: the
    # silhouette), a rate below the contract's hit/miss allowance.  It must
    # change rays of the full spec waves against the sound kernel.
    changed = rays = exact_off = gate_off = slot_off = 0
    ref_s = 0.0
    for wv in spec_waves:
        good, bad = k5.launch_k5(mesh, *wv), k5.launch_k5(mesh, *wv, fault=gate)
        changed += int(((good[0] != bad[0]) | (good[1] != bad[1])).sum())
        rays += wv[0].shape[0]
        t0 = time.perf_counter()
        ref = trav.traverse_paged_reference(mesh, *wv)
        torch.cuda.synchronize()
        ref_s += time.perf_counter() - t0
        for got, n in ((good, "sound"), (bad, "gate")):
            a = k3.hit_agreement(mesh, got, ref, wv[2])
            off = round((a["hit_mismatch"] + a["geometry_mismatch"]) * a["rays"])
            if n == "sound":
                exact_off += off
                slot_off += int((got[0] != ref[0]).sum())
            else:
                gate_off += off
    print(f"  K5, the gate fault on the full spec waves: {changed} of {rays} "
          f"rays changed ({changed / rays:.3g}; the contract allows "
          f"{HIT_MISMATCH_FRAC:g} hit/miss)")
    print(f"  K5 against traverse_paged_reference on every ray of the full "
          f"spec waves ({ref_s:.1f} s for the plain version): rays that hit "
          f"or miss apart or hit another triangle: sound kernel {exact_off} "
          f"({slot_off} with another slot number), gate fault {gate_off}")
    assert changed > 0, "K5's gate fault changes no ray"
    o, d, t = small_waves[0]
    o2, d2 = o.clone(), d.clone()
    o2[::7] = float("nan")
    d2[3::11, 1] = float("nan")
    bad = torch.zeros(o.shape[0], dtype=torch.bool, device=dev)
    bad[::7] = True
    bad[3::11] = True
    clean = k5.launch_k5(mesh, o, d, t)
    mixed = k5.launch_k5(mesh, o2, d2, t)
    assert all(torch.equal(x[~bad], y[~bad]) for x, y in zip(clean, mixed))
    assert bool((mixed[0][bad] == -1).all())
    assert all(torch.equal(x, y) for x, y in zip(clean, k5.launch_k5(mesh, o, d, t)))
    print(f"K5 NaN lanes: {int(bad.sum())} NaN rays among {o.shape[0]} leave "
          "every other ray's (slot, t) bit-identical and miss; repeat "
          "launches bit-identical")

    # 30. Compact against full width on the card, 480x270: the same lanes
    # through the same arithmetic.
    ss = small.settings
    fc, fp = small.fresnel_coef, small.fresnel_pow
    comp = integrator.render_camera_pass(small.scene, ss, small.camera, 1, fc, fp)
    full = integrator.render_camera_pass(
        small.scene, ss.replace(compact_waves=False), small.camera, 1, fc, fp)
    same = [torch.equal(a, b) for a, b in zip(comp, full)]
    print(f"compact vs full width, 480x270: rgb bit-identical {same[0]}, depth "
          f"{same[1]}; hit pixels {(comp[1] < 1).float().mean().item():.3%}")
    assert all(same)

    # 31. The card against the CPU at 64x32, a small paged mesh.
    cpu_obj = str(work_dir / "c5_cpu.obj")
    write_uv_sphere(cpu_obj, *C5_CPU_SPHERE)
    small_host = load_obj(cpu_obj)
    pair = []
    for d_ in (dev, "cpu"):
        rr = config5_renderer(64, 32, d_, sky, brdf,
                              pack_mesh_paged(small_host, 512, device=d_))
        rr.update_camera(origin=(0.0, 0.0, 40.0))
        assert rr.settings.traversal == ("cuda_paged" if d_ == dev else "torch")
        pair.append([torch.from_numpy(x) for x in rr.render_frames(2)])
    _compare("config-5 scene, 3,120-triangle paged sphere, Renderer 64x32 "
             "cuda vs cpu", pair[0], pair[1])

    # 32. Timed passes at spec: K5 and K7 `bounces` times a pass, no plain
    # search.
    r.clear_buffer()
    rng.bounce_uniforms.count = 0
    k5.launch_k5.count = k3.launch_k3.count = k3.launch_k3b.count = 0
    k4.launch_k4.count = 0
    trav.traverse.count = trav.traverse_paged_reference.count = 0
    for _ in range(C5_WARM):
        r.render()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(C5_PASSES):
        img, depth = r.render()
        assert k5.launch_k5.count == s.bounces * (C5_WARM + i + 1)
        assert rng.bounce_uniforms.count == s.bounces * (C5_WARM + i + 1)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / C5_PASSES
    k5_launches, k7_launches = k5.launch_k5.count, rng.bounce_uniforms.count
    assert (k3.launch_k3.count == k3.launch_k3b.count == k4.launch_k4.count
            == trav.traverse.count == trav.traverse_paged_reference.count == 0)
    assert img.shape == (h, w, 3) and torch.isfinite(img).all()
    assert torch.isfinite(depth).all() and 0 <= img.min() and img.max() <= 1
    # The displayed image is FXAA of the tonemapped accumulation.  The
    # sky (0.7-1.2, doubled on a miss) and the sphere (a Lambertian 0.05
    # table, weighted 24x) both tonemap at or near the clamp, as in the JAX
    # package, so FXAA finds few edges to move.
    toned = tonemap(r._accum, r.frame - 1, s.gamma).reshape(h, w, 3)
    assert torch.equal(img, fxaa(toned, r.fxaa_subpix_quality,
                                 r.fxaa_edge_threshold))
    moved = (img != toned).any(dim=-1).float().mean().item()
    hit_px = (depth < 1).float().mean().item()
    centre = img[h // 2 - 8:h // 2 + 8, w // 2 - 8:w // 2 + 8]
    sky_mean = img[:64].mean().item()
    assert 1e-3 < hit_px < 0.2, hit_px
    assert (depth[h // 2, w // 2] < 1).item() and centre.mean().item() > 0.5
    assert sky_mean > 0.5
    rays = w * h * s.samples_per_pass * s.bounces
    print(f"config-5 render path: {w}x{h}, {s.samples_per_pass} spp, "
          f"{s.bounces} bounces, FXAA: {wall * 1e3:.3f} ms/pass wall, "
          f"{rays / wall / 1e6:.1f} Mrays/s, hit pixels {hit_px:.3%}, image "
          f"mean {img.mean().item():.4f}, sphere centre "
          f"{centre.mean().item():.4f}, sky rows {sky_mean:.4f}, pixels FXAA "
          f"moved {moved:.3%}, K5 launches {k5_launches}, K7 launches "
          f"{k7_launches} ({C5_WARM + C5_PASSES} passes), plain searches 0, "
          f"{card}")

    # 33. The gradient at spec with remat: MERL table and HDRI, against the
    # same scene packed single-level through the K3 wavefront.
    target = torch.clamp(img.reshape(-1, 3) * 0.9, 0.0, 1.0).detach()
    gset = s.replace(use_fxaa=False)
    loss, g_brdf, g_hdr, grad_s, peak = config5_grads(
        r.scene, gset, r.camera, target, r.fresnel_coef, r.fresnel_pow)
    assert math.isfinite(loss)
    assert torch.isfinite(g_brdf).all() and torch.isfinite(g_hdr).all()
    assert g_brdf.abs().sum() > 0 and g_hdr.abs().sum() > 0
    t0 = time.perf_counter()
    flat = pack_mesh(host, paged=False, device=dev)
    flat_s = time.perf_counter() - t0
    flat_scene = r.scene.replace(mesh=flat)
    fset = gset.replace(traversal="cuda", compact_waves=False)
    k3.launch_k3.count = 0
    f_loss, f_brdf, f_hdr, f_s, f_peak = config5_grads(
        flat_scene, fset, r.camera, target, r.fresnel_coef, r.fresnel_pow)
    assert k3.launch_k3.count > 0
    print(f"config-5 gradient, {w}x{h}, remat: loss {loss:.6g}, "
          f"{grad_s * 1e3:.1f} ms wall, peak {peak / 2**30:.2f} GiB; "
          f"single-level K3 wavefront (full width): loss {f_loss:.6g}, "
          f"{f_s * 1e3:.1f} ms, peak {f_peak / 2**30:.2f} GiB (pack "
          f"{flat_s:.1f} s, {flat.tri_count.item()} slots)")
    for name, got, want in (("MERL gradient", g_brdf, f_brdf),
                            ("HDRI gradient", g_hdr, f_hdr)):
        rel, tight = grad_parity(name, got, want)
        assert rel < GRAD_REL_L2 and tight >= GRAD_TIGHT_FRAC, name
    assert abs(loss - f_loss) <= 1e-4 * abs(f_loss), (loss, f_loss)

    # 34. Where the time goes, and K5's bound on the spec waves.
    device_profile("config-5 render pass", r.render, 5, top=12)
    timed = {
        "K5 pass (4 waves)": (lambda: [k5.launch_k5(mesh, *wv) for wv in spec_waves], 10),
        "K5 primary": (lambda: k5.launch_k5(mesh, *spec_waves[0]), 10),
        "K3 pass (4 waves)": (lambda: [k3.launch_k3(flat, *wv) for wv in spec_waves], 10),
        "K3 primary": (lambda: k3.launch_k3(flat, *spec_waves[0]), 10),
        "plain pass (4 waves)": (lambda: [trav.traverse_paged_reference(mesh, *wv)
                                          for wv in spec_waves], 1),
        "Renderer pass": (r.render, 3),
    }
    tms = {name: [] for name in timed}
    for name in [*timed, *reversed(timed)]:
        fn, iters = timed[name]
        tms[name].append(cuda_time_ms(fn, dev, iters=iters, warmup=1))
    ms = {name: sum(v) / len(v) for name, v in tms.items()}
    for name, v in tms.items():
        print(f"{name}: {', '.join(f'{x:.4f}' for x in v)} ms")
    b_ms, by, work, n_bytes, i_ms = paged_bound(mesh, spec_waves)
    print(f"K5 bound per pass {b_ms:.4f} ms ({by}; node visits {work[0]}, box "
          f"tests {work[1]}, triangle tests {work[2]}, pages searched "
          f"{work[3]}, bytes {n_bytes} of which mesh {paged_read_bytes(mesh)}, "
          f"rays {[wv[0].shape[0] for wv in spec_waves]}, live "
          f"{[int((wv[2] > 0).sum()) for wv in spec_waves]}), measured "
          f"{ms['K5 pass (4 waves)']:.4f} ms = "
          f"{b_ms / ms['K5 pass (4 waves)']:.1%} of bound; issue bound "
          f"{i_ms:.4f} ms = {i_ms / ms['K5 pass (4 waves)']:.1%}, {card}")
    d_ms, d_by = paged_bound(mesh, spec_waves, "decode")[:2]
    f_ms, f_by, _, f_bytes, _ = paged_bound(mesh, spec_waves, "float")
    print(f"  K5 bound with the copy's decode: {d_ms:.4f} ms ({d_by}, "
          f"TRAV_OPS_DECODE), {d_ms / ms['K5 pass (4 waves)']:.1%} of the "
          f"measured time; on the float layout it read before: {f_ms:.4f} ms "
          f"({f_by}; bytes {f_bytes} of which mesh "
          f"{paged_read_bytes(mesh, 'float')}, TRAV_OPS_FLOAT), "
          f"{f_ms / ms['K5 pass (4 waves)']:.1%} of the measured time")

    # 35. K3 on a single-level pack of the same mesh, the same four waves.
    # The two run the same per-ray search (traverse.cuh) and find the same
    # triangle on every ray, exactly: a limit that K5's gate fault, below
    # the contract's allowance against the plain version, must break.
    gate_off = 0
    for i, wv in enumerate(spec_waves):
        want = k3.launch_k3(flat, *wv)
        a = check_hits(f"K3 single-level vs K5, spec wave {i}", flat, want,
                       k5.launch_k5(mesh, *wv), wv[2], want_mesh=mesh)
        assert a["hit_mismatch"] == a["geometry_mismatch"] == 0, i
        a = k3.hit_agreement(flat, want, k5.launch_k5(mesh, *wv, fault=gate),
                             wv[2], want_mesh=mesh)
        gate_off += round((a["hit_mismatch"] + a["geometry_mismatch"]) * a["rays"])
    print(f"K5 and K3 on the single-level pack: the same triangle and hit/miss "
          f"on every ray of the four spec waves; K5's gate fault: {gate_off} "
          f"rays apart")
    assert gate_off > 0, "K5's gate fault keeps K3's every winner"
    k3b_ms, k3by, k3work = traversal_bound(flat, True, spec_waves)[:3]
    print(f"K3 comparison, config-5 waves: K5 {ms['K5 pass (4 waves)']:.4f} "
          f"ms a pass ({ms['K5 primary']:.4f} primary), K3 on the "
          f"single-level pack {ms['K3 pass (4 waves)']:.4f} ms "
          f"({ms['K3 primary']:.4f} primary; bound {k3b_ms:.4f} ms, {k3by}; "
          f"visits {k3work[0]}, box tests {k3work[1]}, triangle tests "
          f"{k3work[2]}), {card}")

    # 36. K6, the elementwise-rate probe: every chain count against the
    # plain chain, at the probe's shapes, the card-filling ones and a
    # ragged size (a tail at every k above 2), and the planted no-op.
    k6.launch_k6.count = 0
    k6_err = 0.0
    gen = torch.Generator(device="cpu").manual_seed(6)
    print(f"K6 vs the plain chain at c = {k6.CHECK_C}, a = {k6.CHECK_A} "
          f"(float32 rtol {k6.F32_RTOL:g}, bf16 bit-equal), k chains a "
          f"thread {k6.CHAINS}:")
    for shape, dtype in (((256, 128), torch.float32), ((512, 128), torch.bfloat16),
                         ((K6_N,), torch.float32), ((2 * K6_N,), torch.bfloat16),
                         ((K6_RAGGED,), torch.float32),
                         ((K6_RAGGED,), torch.bfloat16)):
        x = (torch.rand(shape, generator=gen) + 0.5).to(dev, dtype)
        want = k6.chain_reference(x, k6.CHECK_C, k6.CHECK_A)
        for k in k6.CHAINS:
            for grid in k6.GRIDS:
                ok, err, rel = k6.chain_agreement(
                    k6.launch_k6(x, k6.CHECK_C, k6.CHECK_A, k=k, grid=grid), want)
                print(f"  K6 {dtype} {tuple(shape)} k={k} {grid} grid (vectors, "
                      f"tail {k6.vector_split(x.numel(), dtype, k)}): max abs "
                      f"err {err:.3g}, rel {rel:.3g}, {'ok' if ok else 'FAILS'}")
                assert ok, f"K6 {dtype} {tuple(shape)} k={k} {grid}"
                k6_err = max(k6_err, err)
        bad, _, bad_rel = k6.chain_agreement(
            k6.launch_k6(x, k6.CHECK_C, k6.CHECK_A, fault=1), want)
        print(f"    planted no-op kernel: rel {bad_rel:.3g}, "
              f"{'passes' if bad else 'caught'}")
        assert not bad, f"K6's no-op fault passes at {dtype} {tuple(shape)}"
    xf = torch.rand(K6_N, generator=gen).to(dev) + 0.5
    xb = (torch.rand(2 * K6_N, generator=gen) + 0.5).to(dev, torch.bfloat16)
    # Bounds: each element read and written once (4 or 2 bytes each way),
    # N_OPS FMAs (2 flops) an element.
    f32_flops, bf16_flops = K6_N * k6.N_OPS * 2, 2 * K6_N * k6.N_OPS * 2
    f32_bound_ms = max(f32_flops / RATES["fp32"],
                       K6_N * 8 / HBM_BYTES_PER_S) * 1e3
    bf16_bound_ms = max(bf16_flops / BF16X2_RATE,
                        2 * K6_N * 4 / HBM_BYTES_PER_S) * 1e3
    # The chain is nothing but packed FMAs, so its issue bound counts them
    # as instructions: one a pair of elements (4 flops).
    bf16_issue_ms = max(bf16_flops / 4 / ISSUE_RATE,
                        2 * K6_N * 4 / HBM_BYTES_PER_S) * 1e3
    # The sweep over k and the grid in turns, at the probe's constants.
    sweep = {(dt, k, g): [] for dt in ("f32", "bf16") for k in k6.CHAINS
             for g in k6.GRIDS}
    clocks = [smi_clocks()]
    for rnd in range(4):
        for dt, k, g in (list(sweep) if rnd % 2 == 0 else list(sweep)[::-1]):
            x = xf if dt == "f32" else xb
            sweep[(dt, k, g)].append(cuda_time_ms(
                lambda: k6.launch_k6(x, k=k, grid=g), dev, iters=20, warmup=1))
    clocks.append(smi_clocks())
    print(f"K6 sweep over k and the grid at the probe's constants, ms a launch "
          f"(float32 2^22, bf16 2^23 elements; bound float32 "
          f"{f32_bound_ms:.4f}, bf16 {bf16_bound_ms:.4f}; SM clock, max, power "
          f"before: {clocks[0]}; after: {clocks[1]}), {card}:")
    for (dt, k, g), v in sweep.items():
        bound_ms = f32_bound_ms if dt == "f32" else bf16_bound_ms
        print(f"  {dt:4s} k={k} {g:6s}: {', '.join(f'{x:.4f}' for x in v)} "
              f"(mean {np.mean(v):.4f}, {bound_ms / np.mean(v):.1%} of bound)")
    best = {dt: min(((k, g) for k in k6.CHAINS for g in k6.GRIDS),
                    key=lambda kg: np.mean(sweep[(dt, *kg)]))
            for dt in ("f32", "bf16")}
    print(f"  fastest: float32 k={best['f32'][0]} {best['f32'][1]} grid (shipped "
          f"{k6.K_F32} {k6.GRID_F32}), bf16 k={best['bf16'][0]} "
          f"{best['bf16'][1]} grid (shipped {k6.K_BF16} {k6.GRID_BF16})")
    sass_opcodes(build.library_path("probe"))
    # The SM clock while the shipped bf16 chain runs on and on.
    load = smi_under_load(lambda: k6.launch_k6(xb))
    if load:
        mhz, watts = (np.array(x) for x in zip(*load))
        print(f"K6 bf16 under load ({len(load)} nvidia-smi samples): SM clock "
              f"{mhz.min():.0f}-{mhz.max():.0f} MHz (median {np.median(mhz):.0f}),"
              f" power {watts.min():.1f}-{watts.max():.1f} W, {card}")
        k6_clock = float(np.median(mhz))
    else:
        print("K6 under load: nvidia-smi gave no samples (not measured)")
        k6_clock = None
    # The shipped k of each dtype against the plain chain, in turns.
    k6.launch_k6.count = 0  # the probe's own launches: the timed ones
    timed = {"f32": (lambda: k6.launch_k6(xf), 20),
             "bf16": (lambda: k6.launch_k6(xb), 20),
             "plain f32": (lambda: k6.chain_reference(xf), 2),
             "plain bf16": (lambda: k6.chain_reference(xb), 2)}
    tms6 = {name: [] for name in timed}
    clocks = [smi_clocks()]
    for name in [*timed, *reversed(timed)]:
        fn, iters = timed[name]
        tms6[name].append(cuda_time_ms(fn, dev, iters=iters, warmup=1))
    clocks.append(smi_clocks())
    ms6 = {name: sum(v) / len(v) for name, v in tms6.items()}
    k6_launches = k6.launch_k6.count
    f32_rate = K6_N / (ms6["f32"] * 1e-3)
    bf16_rate = 2 * K6_N / (ms6["bf16"] * 1e-3)
    for name, v in tms6.items():
        print(f"K6 {name}: {', '.join(f'{x:.4f}' for x in v)} ms")
    print(f"K6: float32 {f32_rate / 1e9:.2f} G elements/s "
          f"({f32_flops / (ms6['f32'] * 1e-3) / 1e12:.2f} TFLOP/s, bound "
          f"{f32_bound_ms:.4f} ms), bf16 {bf16_rate / 1e9:.2f} G elements/s "
          f"({bf16_flops / (ms6['bf16'] * 1e-3) / 1e12:.2f} TFLOP/s, bound "
          f"{bf16_bound_ms:.4f} ms); bf16 / float32 elements/s "
          f"{bf16_rate / f32_rate:.3f}; SM clock, max, power before: "
          f"{clocks[0]}; after: {clocks[1]}, {card}")

    return [{
        "name": "K5 paged BVH traversal",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/paged.cu",
        "replaces": "vrenderer_pathtracer_tpu/accel/pallas_paged.py:49",
        "launches": k5_launches,
        "max_abs_err": k5_err,
        "ms": ms["K5 pass (4 waves)"],
        "ms_primary_wave": ms["K5 primary"],
        "k3_single_level_ms": ms["K3 pass (4 waves)"],
        "renderer_pass_ms": ms["Renderer pass"],
        "plain_ms": ms["plain pass (4 waves)"],
        "bound_ms": b_ms,
        "bound_by": by,
        "bound_issue_ms": i_ms,
        "bound_ms_decode": d_ms,
        "library_ms": None,
    }, {
        "name": "K6 bf16 elementwise probe",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/probe.cu",
        "replaces": ".bench/bf16_vpu.py:23",
        "launches": k6_launches,
        "max_abs_err": k6_err,
        "ms": ms6["bf16"],
        "f32_ms": ms6["f32"],
        "f32_bound_ms": f32_bound_ms,
        "bf16_over_f32_elements_per_s": bf16_rate / f32_rate,
        "k": {"f32": k6.K_F32, "bf16": k6.K_BF16},
        "grid": {"f32": k6.GRID_F32, "bf16": k6.GRID_BF16},
        "k_sweep_ms": {f"{dt} k={k} {g}": float(np.mean(v))
                       for (dt, k, g), v in sweep.items()},
        "sm_clock_mhz_under_load": k6_clock,
        "plain_ms": ms6["plain bf16"],
        "bound_ms": bf16_bound_ms,
        "bound_by": "operations",
        "bound_issue_ms": bf16_issue_ms,
        "library_ms": None,
    }], k7_launches

# K7 (phase 51): the bounce draws at config 5's width, every lane of a
# 1920x1080 pass at 8 spp (the compact waves draw on the hit lanes, at most
# these).  Counted per pipe from the SASS of csrc/draws.cu (cuobjdump,
# sm_90a).  Its slot loop, the 20-round threefry block with the slot's
# counter word and to_unit, is 87 instructions: on the INT32 pipe 22 SHF
# (20 funnel-shift rotates, to_unit's two shifts), 21 LOP3, 8 IADD3 and
# the loop's VIADD and ISETP; 27 IMAD, adds and moves on the FMA pipe,
# counted as FMAs (2 flops, one instruction); two I2FP conversions (SFU),
# two FMUL scales, two stores and a branch.  The lane's part of the
# grid-stride loop, which every slot shares (the loads, their addresses
# and the key words), adds 19 INT32-pipe instructions and 11 IMAD.
K7_LANES = 1920 * 1080 * 8
K7_SLOT_OPS = {"fp32": 2 + 2 * 27, "sfu": 2, "int32": 53, "fma": 27}
K7_LANE_OPS = {"fp32": 2 * 11, "int32": 19, "fma": 11}


def k7_phase(dev, card, launches):
    """Phase 51: K7 against the int64 path, bit for bit, and both timed
    in turns at ``K7_LANES``.  Returns K7's row of the kernels line, with
    ``launches``, phase 32's count on the config-5 render path."""
    from vrenderer_pathtracer_tpu_torch.core import rng
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms

    g = torch.Generator(device=dev).manual_seed(51)
    pix, samp = (torch.randint(0, 2 ** 32, (K7_LANES,), generator=g,
                               device=dev, dtype=torch.int64) for _ in range(2))
    seed, frame, bounce = 0x1234_5678_9ABC, 3, 1

    def int64(n_slots):
        return [u for slot in range(n_slots) for u in rng.uniform2(
            seed, pix, rng.make_stream(frame, samp, bounce, slot))]

    before = rng.bounce_uniforms.count
    for n_slots in (2, 3):
        got = rng.bounce_uniforms(seed, pix, samp, frame, bounce, n_slots)
        torch.cuda.synchronize()
        want = int64(n_slots)
        assert len(got) == 2 * n_slots and all(
            torch.equal(a, b) for a, b in zip(got, want)), n_slots
        del got, want
    assert rng.bounce_uniforms.count == before + 2
    timed = {}
    for n_slots in (2, 3):
        timed[f"k7 {n_slots}"] = (lambda n=n_slots: rng.bounce_uniforms(
            seed, pix, samp, frame, bounce, n), 20)
        timed[f"int64 {n_slots}"] = (lambda n=n_slots: int64(n), 3)
    t = {name: [] for name in timed}
    for name in [*timed, *reversed(timed)]:
        fn, iters = timed[name]
        t[name].append(cuda_time_ms(fn, dev, iters=iters))
    ms = {name: float(np.mean(v)) for name, v in t.items()}
    bounds = {}
    for n_slots in (2, 3):
        ops = {k: (v * n_slots + K7_LANE_OPS.get(k, 0)) * K7_LANES
               for k, v in K7_SLOT_OPS.items()}
        bounds[n_slots] = bound(ops, K7_LANES * (16 + 8 * n_slots))
        b_ms, by, i_ms = bounds[n_slots]
        k7_ms, plain_ms = ms[f"k7 {n_slots}"], ms[f"int64 {n_slots}"]
        print(f"K7 {n_slots} slots at {K7_LANES:,} lanes: "
              f"{', '.join(f'{x:.4f}' for x in t[f'k7 {n_slots}'])} ms; "
              f"int64 path {', '.join(f'{x:.3f}' for x in t[f'int64 {n_slots}'])}"
              f" ms ({plain_ms / k7_ms:.0f}x); bound {b_ms:.4f} ms ({by}, "
              f"{b_ms / k7_ms:.1%}), issue bound {i_ms:.4f} ms "
              f"({i_ms / k7_ms:.1%}), {card}")
    b_ms, by, i_ms = bounds[2]
    return {
        "name": "K7 bounce draws",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/draws.cu",
        "replaces": None,
        "launches": launches,
        "max_abs_err": 0.0,
        "lanes": K7_LANES,
        "ms": ms["k7 2"],
        "ms_3_slots": ms["k7 3"],
        "plain_ms": ms["int64 2"],
        "plain_ms_3_slots": ms["int64 3"],
        "bound_ms": b_ms,
        "bound_by": by,
        "bound_issue_ms": i_ms,
        "bound_ms_3_slots": bounds[3][0],
        "library_ms": None,
    }


# K3c and config 3 (phases 37-40).  K3c's contract against its plain
# version (K3's traversal contract on slot and t, then the captured fields
# against capture_reference at the plain traversal's winners, on the rays
# where both hit the same triangle): rtol 1e-4 / atol 1e-5 on every
# element (capture_contract), zeros on the misses.  Its work beyond K3's,
# counted from csrc/traverse.cu: a hit reads the winner's e1 and e2 (12
# bytes each), uv corners (24), tangent and normal corners (36 each), 120
# bytes counted once for each triangle that wins in the pass (the rows stay
# in L2, as the mesh does); K3c writes 11 floats for every ray; a hit
# computes the face normal (9 FP32 operations), the uv (12) and two
# interpolations (15 each), and three normalisations (17 FP32 with the IEEE
# square root and division counted as TRAV_OPS counts a division, 2 SFU
# each); of these, 3 + 4 + 6 + 6 + 3 * 6 pairs fuse.
CAPTURE_ROW_BYTES = 12 + 12 + 24 + 36 + 36
CAPTURE_RAY_BYTES = 11 * 4
CAPTURE_OPS = {"fp32_per_hit": 9 + 12 + 15 + 15 + 3 * 17, "sfu_per_hit": 3 * 2,
               "fma_per_hit": 3 + 4 + 6 + 6 + 3 * 6}
CAPTURE_PAIRS = 10
# BASELINE config 3 from its files: a UV sphere standing in for the
# Stanford bunny (69,451 triangles; the bunny is not in the repository),
# 256^2 diffuse, normal and specular PNGs from default_rng(0) and a
# 128x256 PIZ EXR sky, 512x512, 2 spp a pass, 4 bounces, 8 passes, camera
# at z = 40.
C3_SPHERE = (12.0, 180, 194)     # 2 * 194 * 179 = 69,452 triangles
C3_SIZE, C3_PASSES = 512, 8


def capture_bound(mesh, waves, fields, layout="copy"):
    """(bound_ms, bound_by, rows, issue_ms) of K3c over one pass's ``waves``: K3's work
    (``traversal_bound``, its operations as ``layout`` counts them) on each
    wave plus the capture's bytes and operations on its hits, per wave the
    larger of bytes and operations over the card's rates, summed.  A
    winning triangle's attribute row is charged once, to the first wave in
    which it wins; ``rows`` counts them."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3

    mesh_bytes = mesh_read_bytes(mesh, True)
    total = by_ops = issue = 0.0
    read = torch.zeros(mesh.tri_e1.shape[0], dtype=torch.bool,
                       device=mesh.tri_e1.device)
    for i, (o, d, t) in enumerate(waves):
        stats = torch.zeros(3, dtype=torch.int64, device=o.device)
        slot = k3.launch_k3(mesh, o, d, t, stats=stats, capture=fields)[0]
        visits, boxes, tris = (int(x) for x in stats.tolist())
        won = torch.zeros_like(read)
        won[slot[slot >= 0].long()] = True
        hits, rows = int((slot >= 0).sum()), int((won & ~read).sum())
        read |= won
        ops = trav_ops(visits, boxes, tris, layout)
        ops["fp32"] += hits * CAPTURE_OPS["fp32_per_hit"]
        ops["sfu"] += hits * CAPTURE_OPS["sfu_per_hit"]
        ops["fma"] += hits * CAPTURE_OPS["fma_per_hit"]
        t_ops = pipe_s(ops)
        n_bytes = (o.shape[0] * (4 + 8 + CAPTURE_RAY_BYTES)
                   + int((t > 0).sum()) * 24 + rows * CAPTURE_ROW_BYTES
                   + (mesh_bytes if i == 0 else 0))
        t_bytes = n_bytes / HBM_BYTES_PER_S
        total += max(t_ops, t_bytes)
        issue += max(issue_s(ops), t_bytes)
        by_ops += t_ops if t_ops >= t_bytes else 0.0
    return (total * 1e3, "operations" if by_ops >= total / 2 else "bytes",
            int(read.sum()), issue * 1e3)


def capture_reading(name, a):
    """Print a ``capture_agreement`` reading."""
    fields = ", ".join(f"{f} max abs {v['abs_max']:.3g} (excess over rtol "
                       f"{v['excess_max']:.3g}, {v['outside']} outside)"
                       for f, v in a["fields"].items())
    print(f"  {name}: {a['rays']} agreeing hits; {fields}; misses zero: "
          f"{a['miss_zero']}")


def image_outliers(got, want):
    """The outlier contract of tests/test_config3_textured_mesh.py on two
    [N,3] images: (share of pixels with a max-channel error above 1e-3,
    mean error of the others)."""
    err = (got - want).abs().amax(dim=-1)
    ok = err <= 1e-3
    return (1.0 - ok.float().mean().item(),
            err[ok].mean().item() if ok.any() else 0.0)


def capture_phases(dev, card, nm_obj):
    """Phases 37-39; returns K3c's row of the kernel table."""
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.render.integrator import render_camera_pass
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms

    # 37. K3c against its plain version on the nm scene's four waves.
    r = nm_renderer(nm_obj, WIDTH, HEIGHT, dev)
    s, mesh = r.settings, r.scene.mesh
    fields = trav.capture_fields(s)
    assert fields == tuple(trav.CAPTURE_WIDTHS), fields
    waves = capture_waves(r)
    print("K3c vs its plain version on the nm waves 1024^2 (K3's contract on "
          "slot and t; fields rtol 1e-4 / atol 1e-5 on agreeing hits):")
    max_err, wants = 0.0, []
    for i, (o, d, t) in enumerate(waves):
        got = k3.launch_k3(mesh, o, d, t, capture=fields)
        plain = k3.launch_k3(mesh, o, d, t)
        assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]), i
        st = trav.traverse(mesh, o, d, t)
        check_hits(f"K3c wave {i}", mesh, got[:2], st, t)
        want = (*st, trav.capture_reference(mesh, o, d, st[0], fields))
        wants.append(want)
        a = k3.capture_agreement(mesh, got, want)
        capture_reading(f"K3c wave {i}", a)
        assert k3.capture_contract(a), f"K3c wave {i}"
        max_err = max([max_err] + [v["abs_max"] for v in a["fields"].values()])
    print("K3c's slot and t bit-identical to K3's on every wave")

    # 38. Planted faults: each must break the contract on the waves.
    print("planted K3c faults against the plain version, the four waves:")
    for what, fault in k3.CAPTURE_FAULTS.items():
        outside = dict.fromkeys(fields, 0)
        worst = dict.fromkeys(fields, 0.0)
        broken = False
        for i, (o, d, t) in enumerate(waves):
            a = k3.capture_agreement(
                mesh, k3.launch_k3(mesh, o, d, t, capture=fields, fault=fault),
                wants[i])
            broken |= not k3.capture_contract(a)
            for f, v in a["fields"].items():
                outside[f] += v["outside"]
                worst[f] = max(worst[f], v["abs_max"])
        print(f"  {what}: elements outside the limits over the four waves "
              + ", ".join(f"{f} {outside[f]} (max abs {worst[f]:.3g})"
                          for f in fields))
        assert broken, f"K3c, {what} passes"

    # 39. The captured path through the Renderer: K3c bounces times a pass,
    # no K3, no plain search; then the captured pass against the recompute
    # pass (the outlier contract), and times in turns.
    rc = nm_renderer(nm_obj, WIDTH, HEIGHT, dev, captured_attrs=True)
    assert rc.settings.captured_attrs and not rc.settings.compact_waves
    k3.launch_k3.count = k3.launch_k3.capture_count = 0
    k3.launch_k3b.count = trav.traverse.count = 0
    rc.render()
    for i in range(MESH_PASSES):
        img, depth = rc.render()
    torch.cuda.synchronize()
    k3c_launches = k3.launch_k3.capture_count
    assert k3c_launches == s.bounces * (MESH_PASSES + 1), k3c_launches
    assert k3.launch_k3.count == k3.launch_k3b.count == trav.traverse.count == 0
    assert torch.isfinite(img).all() and torch.isfinite(depth).all()
    print(f"captured render path: nm scene {WIDTH}x{HEIGHT}, "
          f"{MESH_PASSES + 1} passes, K3c launches {k3c_launches}, K3 0, "
          f"plain traverse 0, image mean {img.mean().item():.4f}")
    cs = rc.settings

    def run(captured):
        return render_camera_pass(rc.scene, cs.replace(captured_attrs=captured),
                                  rc.camera, 1, rc.fresnel_coef, rc.fresnel_pow)

    (cap_rgb, cap_d), (rec_rgb, rec_d) = run(True), run(False)
    frac, mean = image_outliers(cap_rgb, rec_rgb)
    print(f"captured vs recompute pass, nm 1024^2: {frac:.4%} pixels off by "
          f">1e-3, mean {mean:.3g} over the rest, depth max abs "
          f"{(cap_d - rec_d).abs().max().item():.3g}")
    assert frac <= 0.02 and mean <= 1e-4
    t = {True: [], False: []}
    for i in range(CAPTURE_PAIRS):
        for captured in ((True, False) if i % 2 else (False, True)):
            t[captured].append(cuda_time_ms(lambda: run(captured), dev,
                                            iters=1, warmup=0))
    med = {k: float(np.median(v)) for k, v in t.items()}
    wins = sum(c < f for c, f in zip(t[True], t[False]))
    print(f"nm pass 1024^2: recompute median {med[False]:.3f} ms, captured "
          f"median {med[True]:.3f} ms ({med[True] / med[False]:.3f}x), "
          f"captured faster in {wins} of {CAPTURE_PAIRS} pairs, {card}")
    print(f"  recompute: {', '.join(f'{x:.2f}' for x in t[False])} ms")
    print(f"  captured:  {', '.join(f'{x:.2f}' for x in t[True])} ms")
    timed = {
        "K3 pass (4 waves)": lambda: [k3.launch_k3(mesh, *w) for w in waves],
        "K3c pass (4 waves)": lambda: [k3.launch_k3(mesh, *w, capture=fields)
                                       for w in waves],
        "plain pass (4 waves)": lambda: [trav.capture_reference(
            mesh, w[0], w[1], trav.traverse(mesh, *w)[0], fields) for w in waves],
    }
    tk = {name: [] for name in timed}
    for name in [*timed, *reversed(timed)]:
        iters = 1 if name.startswith("plain") else 10
        tk[name].append(cuda_time_ms(timed[name], dev, iters=iters, warmup=1))
    ms = {name: sum(v) / len(v) for name, v in tk.items()}
    for name, v in tk.items():
        print(f"{name}: {', '.join(f'{x:.4f}' for x in v)} ms")
    b_ms, by, rows, i_ms = capture_bound(mesh, waves, fields)
    d_ms = capture_bound(mesh, waves, fields, "decode")[0]
    print(f"K3c bound per pass {b_ms:.4f} ms ({by}; {rows} winning triangles' "
          f"attribute rows), measured "
          f"{ms['K3c pass (4 waves)']:.4f} ms = "
          f"{b_ms / ms['K3c pass (4 waves)']:.1%} of bound (with the copy's "
          f"decode {d_ms:.4f} ms; issue bound {i_ms:.4f} ms = "
          f"{i_ms / ms['K3c pass (4 waves)']:.1%}); K3 "
          f"{ms['K3 pass (4 waves)']:.4f} ms on the same waves, {card}")
    return {
        "name": "K3c 8-wide BVH traversal with win-time attribute capture",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/traverse.cu",
        "replaces": "vrenderer_pathtracer_tpu/accel/pallas_traverse.py:173",
        "launches": k3c_launches,
        "max_abs_err": max_err,
        "ms": ms["K3c pass (4 waves)"],
        "k3_ms_same_waves": ms["K3 pass (4 waves)"],
        "captured_pass_ms": med[True],
        "recompute_pass_ms": med[False],
        "plain_ms": ms["plain pass (4 waves)"],
        "bound_ms": b_ms,
        "bound_by": by,
        "bound_issue_ms": i_ms,
        "bound_ms_decode": d_ms,
        "library_ms": None,
    }


def config3_assets(d):
    """Config 3's files, written into ``d``: the OBJ, three maps, the sky."""
    from PIL import Image

    from vrenderer_pathtracer_tpu_torch.io import write_exr
    from vrenderer_pathtracer_tpu_torch.utils.uv_sphere import write_uv_sphere

    write_uv_sphere(str(d / "bunny_standin.obj"), *C3_SPHERE)
    rng = np.random.default_rng(0)
    maps = {"diffuse": rng.uniform(0.1, 1, (256, 256, 3)),
            "normal": rng.uniform(0, 1, (256, 256, 3)) * 0.2 + (0.4, 0.4, 0.8),
            "specular": rng.uniform(0, 1, (256, 256, 3))}
    for name, m in maps.items():
        Image.fromarray((m * 255 + 0.5).astype(np.uint8)).save(d / f"{name}.png")
    sky = rng.uniform(0, 1.5, (128, 256, 3)).astype(np.float32)
    write_exr(str(d / "sky.exr"), sky, "piz")
    return ["--mesh", str(d / "bunny_standin.obj"), "--hdr", str(d / "sky.exr"),
            "--diffuse-map", str(d / "diffuse.png"),
            "--normal-map", str(d / "normal.png"),
            "--specular-map", str(d / "specular.png"),
            "--camera", "0", "0", "40", "--quiet"]


def config3_cli_phase(dev, card):
    """Phase 40: config 3 from its files through ``cli.main(["render",
    ...])`` on the card, its outputs, and a stopped and resumed run."""
    import pathlib
    import tempfile

    from vrenderer_pathtracer_tpu_torch import cli
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse as k3
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.io import load_exr, load_image
    from vrenderer_pathtracer_tpu_torch.native import load_obj
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4

    with tempfile.TemporaryDirectory() as tmp:
        d = pathlib.Path(tmp)
        t0 = time.perf_counter()
        scene = config3_assets(d)
        n_tris = len(load_obj(str(d / "bunny_standin.obj")).tris)
        print(f"config 3 assets: {n_tris} triangles, 3 maps 256^2, PIZ EXR "
              f"sky 128x256, written in {time.perf_counter() - t0:.2f} s")
        size = ["--width", str(C3_SIZE), "--height", str(C3_SIZE),
                "--samples-per-pass", "2", "--bounces", "4"]
        spp = str(2 * C3_PASSES)

        def outputs(tag):
            return ["--out", str(d / f"{tag}.png"),
                    "--out-exr", str(d / f"{tag}.exr"),
                    "--depth-out", str(d / f"{tag}_depth.png")]

        ck = ["--checkpoint-every", "1", "--checkpoint-dir"]
        k3.launch_k3.count = k3.launch_k3.capture_count = 0
        k3.launch_k3b.count = trav.traverse.count = k4.launch_k4.count = 0
        t0 = time.perf_counter()
        assert cli.main(["render", *size, "--spp", spp, *scene, *outputs("a"),
                         "--metrics", str(d / "a.jsonl"),
                         *ck, str(d / "ck_a")]) == 0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = k3.launch_k3.count
        assert launches == 4 * C3_PASSES, launches
        assert (k3.launch_k3b.count == trav.traverse.count
                == k4.launch_k4.count == k3.launch_k3.capture_count == 0)
        img = load_image(str(d / "a.png"))
        ex = load_exr(str(d / "a.exr"))
        dep = load_image(str(d / "a_depth.png"))
        events = [json.loads(x) for x in (d / "a.jsonl").read_text().splitlines()]
        kinds = [e["event"] for e in events]
        assert kinds == ["pass", "checkpoint"] * C3_PASSES + ["done"], kinds
        pass_ms = [e["ms"] for e in events if e["event"] == "pass"]
        assert img.shape == (C3_SIZE, C3_SIZE, 3) and ex.shape == img.shape
        assert np.isfinite(ex).all() and dep.shape == img.shape
        c = C3_SIZE // 2
        assert img[c - 32:c + 32, c - 32:c + 32].mean() > 0.05, "the mesh is dark"
        assert dep[c, c, 0] > 0.0, "the centre ray misses"
        assert (d / "ck_a" / "latest").is_file()
        print(f"config 3 via cli.main render {C3_SIZE}x{C3_SIZE}, {spp} spp in "
              f"{C3_PASSES} passes, 4 bounces: {wall:.2f} s wall with load, "
              f"K3 launches {launches}, K3b/K4/plain 0; per-pass ms from the "
              f"metrics log {', '.join(f'{x:.1f}' for x in pass_ms)}; image "
              f"mean {img.mean():.4f}, EXR mean {ex.mean():.4f}, {card}")
        # Stopped after half the passes and resumed: the same files.
        assert cli.main(["render", *size, "--spp", str(C3_PASSES), *scene,
                         *ck, str(d / "ck_b")]) == 0
        assert cli.main(["render", *size, "--spp", spp, *scene, *outputs("b"),
                         *ck, str(d / "ck_b")]) == 0
        same = {suffix: (d / f"a{suffix}").read_bytes()
                == (d / f"b{suffix}").read_bytes()
                for suffix in (".png", ".exr", "_depth.png")}
        print(f"config 3 stopped at {C3_PASSES // 2} passes and resumed to "
              f"{C3_PASSES}: files bitwise equal to the uninterrupted run: {same}")
        assert all(same.values())
        # The card against the CPU at 32x32, the same files and flags.
        small = ["--width", "32", "--height", "32", "--samples-per-pass", "2",
                 "--bounces", "4", "--spp", "4"]
        pngs = []
        for tag, extra in (("card", []), ("cpu", ["--cpu"])):
            assert cli.main(["render", *small, *scene, *extra,
                             "--out", str(d / f"s_{tag}.png")]) == 0
            pngs.append(torch.from_numpy(load_image(str(d / f"s_{tag}.png"))))
        frac, mean = image_outliers(pngs[0].reshape(-1, 3), pngs[1].reshape(-1, 3))
        print(f"config 3 CLI 32x32, card vs CPU PNGs: {frac:.4%} pixels off by "
              f">1e-3, mean {mean:.3g} over the rest")
        assert frac <= 0.02 and mean <= 1e-4


# The shard phases (41-46).  K1's four tile ranges over the 1024^2 frame,
# (offset, pixels): the second, [1000, 1000 + 4096), starts mid-row; K4's
# over config 4's 1024x768 frame, and K2's two tiles (the second starts
# mid-row, at 500,000 = 488 rows + 288).
K1_TILES = ((0, 1000), (1000, 4096), (5096, 300000), (305096, 743480))
K4_TILES = ((0, 1000), (1000, 4096), (5096, 400000), (405096, 381336))
K2_TILES = ((0, 500000), (500000, 548576))
K1_NO_SAMPLE_OFFSET, K1_LOCAL_RNG = 10, 11   # K1's planted offset faults
SHARD_PASSES = 4      # world-size-1 Renderer passes held bit for bit
SHARD_TIMED = 10      # alternating timed passes (and steps) of each
GLOO_TIMEOUT_S = 300  # a rank of the two-process gloo phase


def _tiles(launch, tiles, dim=0):
    """``launch(offset, n)`` over ``tiles``, the outputs concatenated."""
    parts = [launch(off, n) for off, n in tiles]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=dim)
    return [torch.cat(x, dim=dim) for x in zip(*parts)]


def _rel_close(got, want, rtol=1e-6):
    """Whether ``got`` is within ``rtol`` of ``want`` relative, elementwise
    (equal zeros included), and the largest relative error."""
    err = (got - want).abs()
    rel = torch.where(err == 0, torch.zeros_like(err),
                      err / want.abs().clamp_min(1e-30))
    return bool((err <= rtol * want.abs()).all()), rel.max().item()


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def gloo_rank(init, rank, out_dir):
    """A rank of phase 46 (``chip_smoke.py --gloo-rank``): two processes on
    the one card in a gloo group; K1 with its offsets on a 1x2 and a 2x1
    mesh, the gathered frames saved by rank 0."""
    import pathlib

    import torch.distributed as dist

    from vrenderer_pathtracer_tpu_torch import RenderSettings
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.parallel import (
        make_render_mesh, multihost, replicate, shard_pixels,
        sharded_render_step)
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene

    rank = int(rank)
    torch.cuda.set_device(0)
    multihost.initialize(init, 2, rank, backend="gloo")
    dev = torch.device("cuda", 0)
    s = RenderSettings(width=WIDTH, height=HEIGHT, use_cornell_box=True,
                       has_hdr=False)
    scene, cam = Scene.analytic(s, dev), Camera.default(dev)
    f32 = dict(dtype=torch.float32, device=dev)
    for n_tiles, n_samples in ((1, 2), (2, 1)):
        mesh = make_render_mesh(n_tiles, n_samples, "cuda")
        step = sharded_render_step(mesh, s, scene=scene)
        accum = shard_pixels(mesh, torch.zeros((s.n_pixels, 3), **f32))
        k1.launch.count = 0
        t0 = time.perf_counter()
        out = step(*replicate(mesh, (scene, cam)), accum, 1,
                   torch.tensor(0.1, **f32), torch.tensor(3.0, **f32))
        full = [multihost.gather_image(x, mesh) for x in out]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        assert k1.launch.count == 1, k1.launch.count
        if rank == 0:
            for name, x in zip(("accum", "img", "depth"), full):
                np.save(pathlib.Path(out_dir) / f"{n_tiles}x{n_samples}_{name}.npy",
                        x.cpu().numpy())
            print(f"  gloo rank 0, {n_tiles}x{n_samples}: the step and the "
                  f"gathers {wall * 1e3:.1f} ms (the first call)")
    dist.barrier()
    dist.destroy_process_group()


def shard_phases(dev, card, libs, work_dir):
    """Phases 41-46: the shard offsets of K1, K4 and K2 on the card, the
    world-size-1 NCCL group through the public sharded entry points,
    ``TrainParams.hdr`` at full width, and two gloo ranks on the card.
    Returns the readings the kernels line carries."""
    import pathlib
    import subprocess
    import tempfile

    import torch.distributed as dist

    from vrenderer_pathtracer_tpu_torch import (
        DeferredParams, Renderer, RenderSettings, TrainParams,
        deferred_opt_step, train_step)
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.parallel import (
        make_render_mesh, multihost, sharded_train_step)
    from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms

    out = {}
    base = RenderSettings(use_cornell_box=True, has_hdr=False, width=WIDTH,
                          height=HEIGHT)
    scene, cam = Scene.analytic(base, dev), Camera.default(dev)
    assert sum(n for _, n in K1_TILES) == base.n_pixels

    # 41. K1 shards: four tile ranges (one from mid-row) against the full
    # frame bit for bit; two sample halves against it within 1e-6 relative,
    # the last half's depth bit for bit; the planted offset faults break
    # the checks.
    tables = (k1.pack_camera(cam, base, 0.1, 3.0), k1.pack_spheres(scene.spheres))
    full = k1.launch(*tables, base, 1)
    tiled = _tiles(lambda o, n: k1.launch(*tables, base, 1, 0, o, 0, n), K1_TILES)
    assert torch.equal(tiled[0], full[0]) and torch.equal(tiled[1], full[1]), \
        "K1's tiles differ from its full frame"
    half = base.replace(samples_per_pass=1)
    a, b = (k1.launch(*tables, half, 1, 0, 0, so) for so in (0, 1))
    ok, rel = _rel_close((a[0] + b[0]) / 2, full[0])
    assert ok and torch.equal(b[1], full[1]), f"K1's sample halves: rel {rel}"
    check = k1_check_launcher(libs[K1_CHECK], dev)
    faults = {}
    fa, fb = (check(*tables, half, 1, 0, K1_NO_SAMPLE_OFFSET, 0, so)
              for so in (0, 1))
    fmean = (fa[0] + fb[0]) / 2
    faults["sample_offset ignored"] = (
        _rel_close(fmean, full[0])[0] and torch.equal(fb[1], full[1]),
        (fmean - full[0]).abs().max().item(),
        (fmean != full[0]).any(-1).float().mean().item())
    frgb, fdepth = _tiles(lambda o, n: check(*tables, base, 1, 0, K1_LOCAL_RNG,
                                             o, 0, n), K1_TILES)
    faults["pixel_offset not in the RNG"] = (
        torch.equal(frgb, full[0]) and torch.equal(fdepth, full[1]),
        (frgb - full[0]).abs().max().item(),
        (frgb != full[0]).any(-1).float().mean().item())
    whole = check(*tables, base, 1, 0, K1_LOCAL_RNG)
    print(f"K1 shards, {WIDTH}x{HEIGHT}, {base.samples_per_pass} spp, "
          f"{base.bounces} bounces: tiles {list(K1_TILES)} reassemble the frame "
          f"bit for bit; sample halves within {rel:.3g} relative (limit 1e-6), "
          f"the last half's depth bit for bit; the local-RNG fault's instance "
          f"on the whole frame "
          f"{'equals' if torch.equal(whole[0], full[0]) else 'differs from'} K1's")
    for name, (passes, err, frac) in faults.items():
        print(f"  planted fault, {name}: the check "
              f"{'passes' if passes else 'breaks'} (max err {err:.4g}, "
              f"{frac:.4%} of pixels apart)")
        assert not passes, f"K1 fault '{name}' passes the shard checks"
    t_full = cuda_time_ms(lambda: k1.launch(*tables, base, 1), dev, iters=50)
    t_tiles = cuda_time_ms(lambda: _tiles(
        lambda o, n: k1.launch(*tables, base, 1, 0, o, 0, n), K1_TILES),
        dev, iters=50)
    print(f"K1 full frame {t_full:.4f} ms, as the four tiles {t_tiles:.4f} ms, "
          f"{card}")
    out["k1"] = {"tiles_bit_identical": True, "sample_halves_max_rel": rel,
                 "faults_caught": len(faults), "tiles_ms": t_tiles}

    # 42. K4 shards on config 4, both modes: tiles (one from mid-row)
    # against the full launch bit for bit; sample halves: direct within 1e-6
    # relative, records sample for sample bit for bit.
    r4 = config4_renderer(work_dir, dev)
    assert r4.settings.radiance_kernel == "cuda_mesh"
    args = k4_args(r4)
    s4 = r4.settings
    assert sum(n for _, n in K4_TILES) == s4.n_pixels
    for direct in (True, False):
        full4 = k4.launch_k4(*args, 1, 0, direct=direct)
        tiled4 = _tiles(lambda o, n: k4.launch_k4(
            *args, 1, 0, direct=direct, pixel_offset=o, n_local_pixels=n),
            K4_TILES, dim=1)
        assert torch.equal(tiled4, full4), f"K4 tiles, direct={direct}"
    h4 = s4.replace(samples_per_pass=1)
    args_h = (*args[:3], h4)
    da, db = (k4.launch_k4(*args_h, 1, 0, direct=True, sample_offset=so)
              for so in (0, 1))
    full4 = k4.launch_k4(*args, 1, 0, direct=True)
    ok4, rel4 = _rel_close((da[1:] + db[1:]) / 2, full4[1:])
    assert ok4 and torch.equal(db[0], full4[0]), f"K4 direct halves: rel {rel4}"
    rec = k4.launch_k4(*args, 1, 0)
    idx, _ = k4.layout(s4)
    idx1, _ = k4.layout(h4)
    widths = {"A": 3, "E": 3, "dir": 3, "uv": 2, "midx": 1}
    for so in (0, 1):
        got = k4.launch_k4(*args_h, 1, 0, sample_offset=so)
        for key, k in idx1.items():
            if key[0] in widths:
                src = idx[(key[0], so, key[2])]
                assert torch.equal(got[k:k + widths[key[0]]],
                                   rec[src:src + widths[key[0]]]), (so, key)
    print(f"K4 shards, config 4 {s4.width}x{s4.height}: tiles {list(K4_TILES)} "
          f"reassemble the direct and the records launches bit for bit; direct "
          f"sample halves within {rel4:.3g} relative, the last half's depth bit "
          f"for bit; each half's records its samples' bit for bit")
    out["k4"] = {"tiles_bit_identical": True, "sample_halves_max_rel": rel4}

    # 43. K2 on two tiles (the second from mid-row): the rows summed against
    # the full frame's, leaf by leaf under SHARD_GRAD_RTOL, with and without
    # the camera.
    bright = scene.spheres.emission.clone()
    bright[0] *= 1.5
    target, _ = k1.render_pass_cuda(scene.replace_spheres(emission=bright),
                                    base, cam, 1, 0.1, 3.0)
    k2_err = {}
    for with_camera in (False, True):
        row = k2.launch(*tables, base, target, 1, 0, with_camera)
        rows = sum(k2.launch(*tables, base, target[o:o + n].contiguous(), 1, 0,
                             with_camera, pixel_offset=o, n_local_pixels=n)
                   for o, n in K2_TILES)
        (want, dw), (got, dg) = (k2.unpack(x, scene.spheres.count, base.n_pixels)
                                 for x in (row, rows))
        err = _leaf_errors(got[1:5], want[1:5])
        err["loss"] = abs(got[0].item() - want[0].item()) / want[0].item()
        if with_camera:
            err["dcam"] = ((dg - dw).norm() / dw.norm()).item()
        k2_err[f"with_camera={with_camera}"] = err
        print(f"K2 on tiles {list(K2_TILES)}, with_camera={with_camera}: "
              + ", ".join(f"{k} {v:.4g}" for k, v in err.items())
              + f" (limit {SHARD_GRAD_RTOL})")
        assert all(v <= SHARD_GRAD_RTOL for v in err.values()), err
    out["k2"] = {"tile_sums_rel_err": k2_err}

    # 44. A world-size-1 NCCL group: the sharded Renderer and
    # sharded_train_step against the unsharded ones, bit for bit, and their
    # wall times in turns.
    multihost.initialize(f"localhost:{_free_port()}", 1, 0)
    assert dist.get_backend() == "nccl"
    mesh = make_render_mesh(1, 1, "cuda")
    rs = {"sharded": Renderer(WIDTH, HEIGHT, settings=base, device_mesh=mesh),
          "unsharded": Renderer(WIDTH, HEIGHT, settings=base)}
    k1.launch.count = 0
    imgs = {name: [r.render() for _ in range(SHARD_PASSES)]
            for name, r in rs.items()}
    assert k1.launch.count == 2 * SHARD_PASSES
    for (a_img, a_dep), (b_img, b_dep) in zip(imgs["sharded"], imgs["unsharded"]):
        assert torch.equal(a_img, b_img) and torch.equal(a_dep, b_dep), \
            "the 1x1 sharded Renderer differs from the unsharded one"

    def turns(fns):
        walls = {name: [] for name in fns}
        for i in range(SHARD_TIMED):
            for name in (list(fns) if i % 2 == 0 else list(fns)[::-1]):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fns[name]()
                torch.cuda.synchronize()
                walls[name].append((time.perf_counter() - t0) * 1e3)
        return walls

    walls = turns({name: r.render for name, r in rs.items()})
    params = TrainParams.from_scene(scene)
    steps = {"sharded": sharded_train_step(mesh, base),
             "unsharded": train_step(base)}
    k2.launch.count = 0
    res = {name: st(params, scene, cam, target, 1) for name, st in steps.items()}
    assert k2.launch.count == 2
    for x, y in zip(res["sharded"][0].leaves(), res["unsharded"][0].leaves()):
        assert torch.equal(x, y), "sharded_train_step differs from train_step"
    assert torch.equal(res["sharded"][1], res["unsharded"][1])
    step_walls = turns({name: (lambda st=st: st(params, scene, cam, target, 1))
                        for name, st in steps.items()})
    dist.destroy_process_group()
    for what, w in (("Renderer pass", walls), ("train step", step_walls)):
        print(f"world size 1 (NCCL), {WIDTH}x{HEIGHT}, {what} wall ms in turns: "
              + "; ".join(f"{name} {', '.join(f'{x:.3f}' for x in v)} (median "
                          f"{float(np.median(v)):.3f})" for name, v in w.items())
              + f", {card}")
    print(f"world size 1: {SHARD_PASSES} sharded Renderer passes and one "
          "sharded_train_step bit for bit the unsharded ones")
    out["world1_pass_ms"] = {k: float(np.median(v)) for k, v in walls.items()}
    out["world1_step_ms"] = {k: float(np.median(v)) for k, v in step_walls.items()}

    # 45. TrainParams.hdr at full width (config 4): the HDRI gradient of one
    # train_step (the wavefront's autograd) against DeferredParams.hdr's
    # through K4's records and compose, on the same loss and frame.
    target4, _ = k4.render_pass_mesh(r4.scene.replace(hdr=r4.scene.hdr * 1.5),
                                     s4, r4.camera, 1, r4.fresnel_coef,
                                     r4.fresnel_pow)
    p = TrainParams.from_scene(r4.scene, optimize_hdr=True)
    k4.launch_k4.count = k4.compose.count = 0
    t0 = time.perf_counter()
    p1, m1 = train_step(s4, lr=1.0, with_metrics=True)(
        p, r4.scene, r4.camera, target4, 1)
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    assert k4.launch_k4.count == 0  # the wavefront's autograd, not K4
    g_train = p.hdr - p1.hdr
    d = DeferredParams(hdr=r4.scene.hdr.clone().requires_grad_())
    before = d.hdr.detach().clone()
    _, m2 = deferred_opt_step(s4, torch.optim.SGD([d.hdr], lr=1.0),
                              scene=r4.scene)(d, r4.scene, r4.camera, target4,
                                              1, r4.fresnel_coef, r4.fresnel_pow)
    assert k4.launch_k4.count == k4.compose.count == 1  # records + compose
    g_def = before - d.hdr.detach()
    rel_h = ((g_train - g_def).norm() / g_def.norm()).item()
    frac_h = ((g_train - g_def).abs() > 1e-3 * g_def.abs().max()).float().mean().item()
    print(f"TrainParams.hdr, config 4 {s4.width}x{s4.height}: train_step loss "
          f"{m1['loss'].item():.6g} (the wavefront, {train_wall * 1e3:.1f} ms "
          f"wall) vs deferred_opt_step {m2['loss'].item():.6g} (K4 records + "
          f"compose); d loss / d hdr rel err {rel_h:.4g}, entries off by >1e-3 "
          f"of the scale {frac_h:.4%} (limits {K4_GRAD_RTOL:g}, "
          f"{K4_GRAD_FRAC:g})")
    assert g_def.abs().max().item() > 0
    assert rel_h <= K4_GRAD_RTOL and frac_h <= K4_GRAD_FRAC
    out["train_hdr"] = {"rel_err": rel_h, "frac": frac_h}

    # 46. Two ranks on the one card in a gloo group (NCCL takes one rank a
    # card): K1 with its offsets on 1x2 and 2x1 meshes, the gathered frames
    # against the single-process K1 frame.
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        init = f"file://{tmp / 'store'}"
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, __file__, "--gloo-rank",
                                   init, str(rank), str(tmp)])
                 for rank in range(2)]
        try:
            for proc in procs:
                proc.wait(timeout=max(GLOO_TIMEOUT_S - (time.perf_counter() - t0), 1))
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        assert all(proc.returncode == 0 for proc in procs), \
            [proc.returncode for proc in procs]
        for shape in ("2x1", "1x2"):
            acc, dep = (torch.from_numpy(np.load(tmp / f"{shape}_{f}.npy")).to(dev)
                        for f in ("accum", "depth"))
            if shape == "2x1":
                assert torch.equal(acc, full[0]), "gloo 2x1 differs from K1"
                how = "bit for bit"
            else:
                ok_g, g_rel = _rel_close(acc, full[0])
                assert ok_g, f"gloo 1x2: rel {g_rel}"
                how = f"within {g_rel:.3g} relative of"
            assert torch.equal(dep, full[1]), f"gloo {shape} depth"
            print(f"gloo, two ranks on the card, {shape}: the gathered frame "
                  f"{how} the single-process K1 frame, depth bit for bit")
        print(f"gloo phase: {time.perf_counter() - t0:.1f} s with the ranks' "
              "start-up")
    out["gloo_two_ranks"] = True
    return out


# Phase 47's key script, one batch of keys a viewer pass: orbit, dolly,
# the Fresnel slider, FXAA, the depth view, and an SGR left-button drag
# (press, motion +3 columns +2 rows, a wheel report, release).
VIEW_SCRIPT = (("right",), ("up", "w"), ("]", "f"), ("enter",),
               ("0;10;5M", "32;13;7M", "64;13;7M", "0;13;7m"), ("enter",))
VIEW_PASSES = 8          # the headless run after the script
VIEW_SMALL = (64, 32)    # the card viewer against the CPU viewer
EXAMPLE_STEPS = 10       # inverse_rendering's and envmap_recovery's steps


def view_script_keys(viewer):
    """VIEW_SCRIPT with its SGR reports decoded by the viewer."""
    return [[viewer._parse_sgr_mouse(k) if k[-1] in "Mm" and ";" in k else k
             for k in batch] for batch in VIEW_SCRIPT]


def drive_viewer(r, passes=VIEW_PASSES):
    """The key script through ``TerminalViewer.step``, a pass a batch, then
    ``run(max_passes=passes, interactive=False)``: the viewer."""
    import io

    from vrenderer_pathtracer_tpu_torch.view import TerminalViewer

    v = TerminalViewer(r, out=io.StringIO(), max_cols=48, max_rows=16)
    for keys in view_script_keys(v):
        v.step(keys)
    v.run(max_passes=passes, interactive=False)
    return v


def viewer_state(v):
    r = v.r
    return {"yaw": r.camera.yaw.item(), "pitch": r.camera.pitch.item(),
            "origin": r.camera.origin.tolist(),
            "fresnel_coef": r.fresnel_coef.item(),
            "fresnel_pow": r.fresnel_pow.item(), "fxaa": r.settings.use_fxaa,
            "show_depth": v.show_depth, "frame": r.frame, "passes": v._passes}


def app_phases(dev, card, work_dir):
    """Phases 47-49: the viewer, the four examples and the scaling harness
    on the card, through the entry points a user calls."""
    from vrenderer_pathtracer_tpu_torch import Renderer, RenderSettings, bench_scaling
    from vrenderer_pathtracer_tpu_torch.accel import cuda_paged as k5
    from vrenderer_pathtracer_tpu_torch.accel import traverse as trav
    from vrenderer_pathtracer_tpu_torch.examples import (
        bench_paged, config5, envmap_recovery, inverse_rendering)
    from vrenderer_pathtracer_tpu_torch.ops.tonemap import tonemap
    from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
    from vrenderer_pathtracer_tpu_torch.render import cuda_mesh as k4
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.render import integrator
    from vrenderer_pathtracer_tpu_torch.utils.profiling import (
        measure_renderer, profiler_trace)

    base = RenderSettings(use_cornell_box=True, has_hdr=False)

    # 47. The viewer headless on the card at 1024^2: K1 once a pass (launch
    # count and profiler), no plain version; the camera and sliders after
    # the script against the CPU viewer's; the card's frame against the
    # CPU's at 64x32 within phase 3's limits; measure_renderer.
    def no_plain(*_a, **_k):
        raise AssertionError("a plain version ran on the viewer's path")

    plain = (k1.render_pass_reference, integrator.render_pass)
    k1.render_pass_reference = integrator.render_pass = no_plain
    try:
        r = Renderer(WIDTH, HEIGHT, settings=base)
        k1.launch.count = 0
        trace_dir = work_dir / "viewer_trace"
        t0 = time.perf_counter()
        with profiler_trace(trace_dir) as prof:
            v = drive_viewer(r)
        wall = time.perf_counter() - t0
        launches = k1.launch.count
        traced = sum(e.count for e in prof.key_averages()
                     if "radiance_kernel" in e.key)
        small_card = drive_viewer(Renderer(*VIEW_SMALL, settings=base))
    finally:
        k1.render_pass_reference, integrator.render_pass = plain
    small_cpu = drive_viewer(Renderer(*VIEW_SMALL, settings=base, device="cpu"))
    passes = v._passes
    assert passes == len(VIEW_SCRIPT) + VIEW_PASSES and launches == passes, \
        (passes, launches)
    assert traced == passes, f"the profiler shows K1 {traced} times"
    want = viewer_state(small_cpu)
    for got in (viewer_state(v), viewer_state(small_card)):
        for key in ("yaw", "pitch", "fresnel_coef", "fresnel_pow", "fxaa",
                    "show_depth", "frame", "passes"):
            assert got[key] == want[key], (key, got[key], want[key])
        assert np.allclose(got["origin"], want["origin"], rtol=1e-6, atol=0)
    origin_bitwise = viewer_state(v)["origin"] == want["origin"]
    # The frames before FXAA, held to phase 3's limits; FXAA's edge tests
    # turn a rounding difference of its input into a discrete change over
    # a 3x3 neighbourhood, so its frames are only reported.
    shown = [x.r.current_frame()[0].cpu().numpy() for x in (small_card, small_cpu)]
    raw = [tonemap(x.r.accumulation(), x.r.frame - 1,
                   x.r.settings.gamma).cpu().numpy() for x in (small_card, small_cpu)]
    img_err = np.abs(raw[0] - raw[1])
    fxaa_err = np.abs(shown[0] - shown[1])
    print(f"  viewer 64x32 card vs CPU: before FXAA "
          f"{(img_err > 1e-3).any(axis=-1).mean():.4%} pixels off by >1e-3, "
          f"mean {img_err.mean():.3g}; shown (FXAA) "
          f"{(fxaa_err > 1e-3).any(axis=-1).mean():.4%}, mean "
          f"{fxaa_err.mean():.3g}")
    assert (img_err > 1e-3).any(axis=-1).mean() <= 0.02
    assert img_err.mean() <= 2e-3
    assert "spp" in v.out.getvalue() and "\u2580" in v.out.getvalue()
    traces = sorted(trace_dir.glob("trace_*.json"))
    assert traces, "profiler_trace wrote no trace"
    stats = measure_renderer(r, warmup=1, iters=10)
    r.toggle_fxaa(False)
    plain_stats = measure_renderer(r, warmup=1, iters=10)
    r.toggle_fxaa(True)
    device_profile("viewer pass (FXAA)", r.render, 10)
    print(f"viewer, {WIDTH}x{HEIGHT}: {passes} passes ({len(VIEW_SCRIPT)} "
          f"under the key script, {VIEW_PASSES} headless) in {wall:.2f} s "
          f"profiled, K1 launches {launches} (profiler {traced}), no plain "
          f"version; camera and sliders after the script equal the CPU "
          f"viewer's (yaw {want['yaw']!r}, pitch {want['pitch']!r}, origin "
          f"{'bit for bit' if origin_bitwise else 'within 1e-6 relative'}); "
          f"last HUD ms/pass "
          f"{v._last_ms:.3f}; measure_renderer {stats.ms_per_pass:.4f} ms/pass,"
          f" {stats.mrays_per_s:.1f} Mrays/s with FXAA, "
          f"{plain_stats.ms_per_pass:.4f} ms/pass without; "
          f"trace {traces[-1].name} ({traces[-1].stat().st_size} B), {card}")

    # 48. The four examples at their default widths, fewer steps.
    ex_dir = work_dir / "examples"
    ex_dir.mkdir(parents=True, exist_ok=True)
    k1.launch.count = k2.launch.count = 0
    ir = inverse_rendering.main([
        "--steps", str(EXAMPLE_STEPS), "--out", str(ex_dir / "ir.png"),
        "--metrics", str(ex_dir / "ir.jsonl")])
    assert k2.launch.count == EXAMPLE_STEPS, k2.launch.count
    assert k1.launch.count == 4 * inverse_rendering.N_TARGET, k1.launch.count
    assert all(math.isfinite(x) for _, x in ir["losses"])
    assert (ex_dir / "ir.png").is_file()
    assert (ex_dir / "ir.jsonl").read_text().count("train_step") >= 1
    print(f"inverse_rendering 256^2, 4 spp, {EXAMPLE_STEPS} steps: "
          f"{ir['ms_per_step']:.3f} ms/step wall (after the first step "
          f"{ir['ms_per_step_after_first']:.3f}), K2 launches "
          f"{k2.launch.count}, loss {ir['losses'][0][1]:.5g} -> "
          f"{ir['losses'][-1][1]:.5g}; converged MSE recovered "
          f"{ir['rec_mse']:.5g} vs true {ir['true_mse']:.5g}, {card}")

    k4.launch_k4.count = k4.compose.count = 0
    em = envmap_recovery.main(["--steps", str(EXAMPLE_STEPS),
                               "--out", str(ex_dir / "env.png")])
    assert em["backend"] == "cuda_mesh", em["backend"]
    assert k4.launch_k4.count == k4.compose.count == EXAMPLE_STEPS, \
        (k4.launch_k4.count, k4.compose.count)
    assert math.isfinite(em["loss"]) and em["sun_err"] < em["sun_err_init"]
    print(f"envmap_recovery 256^2, {EXAMPLE_STEPS} steps: "
          f"{em['ms_per_step']:.3f} ms/step wall (after the first step "
          f"{em['ms_per_step_after_first']:.3f}), K4 (records) launches "
          f"{k4.launch_k4.count}, compose {k4.compose.count}; sun-disc |err| "
          f"{em['sun_err']:.3f} (init {em['sun_err_init']:.3f}), {card}")

    c5 = work_dir / "c5"
    k5.launch_k5.count = 0
    trav.traverse.count = trav.traverse_paged_reference.count = 0
    cf = config5.main(["--mesh", str(c5 / "mesh.obj"), "--hdr",
                       str(c5 / "sky.exr"), "--brdf", str(c5 / "lambert.binary"),
                       "--out", str(ex_dir / "config5.png")])
    bounces = 4
    assert cf["traversal"] == "cuda_paged" and cf["passes"] == 8
    assert k5.launch_k5.count >= bounces * (cf["passes"] + 1), k5.launch_k5.count
    assert trav.traverse.count == trav.traverse_paged_reference.count == 0
    assert cf["g_brdf_abs"] > 0 and cf["g_hdr_abs"] > 0
    print(f"config5 960x540, 16 spp: set-up {cf['load_s']:.2f} s, "
          f"{cf['ms_per_pass']:.3f} ms/pass wall over {cf['passes']} passes, "
          f"gradient {cf['grad_s'] * 1e3:.1f} ms (loss {cf['loss']:.5g}), K5 "
          f"launches {k5.launch_k5.count}, plain searches 0, {card}")

    k5.launch_k5.count = 0
    bp = bench_paged.main(["--iters", "3"])
    assert k5.launch_k5.count == 3 * 4, k5.launch_k5.count
    print("bench_paged, " + ", ".join(
        f"{c} {bp[c]['mrays_per_s']:.1f} Mrays/s ({bp[c]['ms']:.3f} ms, hit "
        f"{bp[c]['hitrate']:.3f})"
        for c in ("coherent", "shuffled", "shuffled_sorted"))
        + f", {bp['mesh']['tris']} triangles in {bp['mesh']['pages']} pages, "
        f"{card}")

    # 49. bench_scaling: world size 1 over NCCL (strong and weak, render and
    # train: K1 and K2), then two gloo ranks on the card, a harness check.
    k1.launch.count = k2.launch.count = 0
    iters = 6
    real = bench_scaling.main(["--real", "--iters", str(iters)])
    assert k1.launch.count == k2.launch.count == 2 * (iters + 1), \
        (k1.launch.count, k2.launch.count)
    assert not real["virtual_cpu_sweep"] and real["caveat"] is None
    gloo = bench_scaling.main(["--device", "cuda", "--counts", "1,2",
                               "--iters", "3"])
    assert gloo["harness_check"] and gloo["caveat"]
    for name, summary in (("NCCL world size 1", real),
                          ("gloo, two ranks on one card (harness check)", gloo)):
        print(f"bench_scaling, {name}: " + "; ".join(
            f"{k} " + ", ".join(f"n={r['n_devices']} {r['pass_ms']:.3f} ms "
                                f"{r['mrays_per_s']:.1f} Mrays/s "
                                f"{r['efficiency_pct']:.1f}%" for r in rows)
            for k, rows in summary["tables"].items()) + f", {card}")


def bench_phase(card, work_dir, k2_ms):
    """Phase 50: the bench command on the card; returns its ``extra``."""
    import shutil

    from vrenderer_pathtracer_tpu_torch import bench
    from vrenderer_pathtracer_tpu_torch.utils.profiling import PLAIN_VERSION

    trace_dir = work_dir / "bench_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    torch.cuda.empty_cache()  # the subprocess needs the card's memory
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "vrenderer_pathtracer_tpu_torch", "bench",
         "--trace", str(trace_dir)], capture_output=True, text=True,
        timeout=BENCH_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], sep="\n", file=sys.stderr)
        raise AssertionError(f"bench exited {proc.returncode}")
    print(proc.stderr.strip()[-2000:])
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(json.dumps(line))
    extra = line["extra"]
    assert line["metric"] == bench.METRIC and line["unit"] == "Mrays/s"
    assert line["vs_baseline"] == 1.0 and extra["platform"] == "gpu"
    assert extra["n_devices"] == 1 and f"{extra['card']}, {extra['power_limit']}" == card
    record_keys = ("metric", "value", "unit", "vs_baseline", "extra")
    keys = ["value"] + [bench.KEYS[k] for k in bench.KEYS if k not in record_keys]
    keys += [k for pair in bench.TWINS.items() for k in pair]
    for key in keys:
        value = line[key] if key == "value" else extra[key]
        if isinstance(value, str):
            assert value, key
            continue
        for x in value if isinstance(value, list) else [value]:
            assert isinstance(x, (int, float)) and math.isfinite(x) and x > 0, \
                (key, value)
    # The profiler's timelines of the twins: the kernels the card ran, and
    # no plain version's range.
    kernels, plain = set(), set()
    traces = sorted(trace_dir.glob("*.json"))
    for path in traces:
        for e in json.loads(path.read_text())["traceEvents"]:
            name = e.get("name", "")
            if e.get("cat") == "kernel":
                kernels.add(name)
            elif name.startswith(PLAIN_VERSION):
                plain.add(name)
    seen = bench.kernel_ms(dict.fromkeys(kernels, 1.0))
    assert {"K1", "K2", "K3", "K4", "K5"} <= set(seen), sorted(seen)
    assert not plain, f"plain versions ran on the card: {sorted(plain)}"
    assert all(extra["launches"][k] > 0 for k in ("K1", "K2", "K3", "K4", "K5")), \
        extra["launches"]
    twin = extra["fwdbwd_k2_device_ms"]
    rel = abs(twin - k2_ms) / k2_ms
    print(f"bench: exit 0 in {wall:.1f} s, headline {line['value']:.1f} "
          f"Mrays/s (K2 {extra['fwdbwd_k2_ms']:.4f} ms a step wall, "
          f"{twin:.4f} device; phase 9's K2 row {k2_ms:.4f}, {rel:.2%} apart); "
          f"{len(keys)} keys present, finite and positive; kernels in "
          f"{len(traces)} timelines: {sorted(seen)}, no plain version; "
          f"launches {extra['launches']}, {card}")
    assert rel <= BENCH_TWIN_RTOL, f"headline twin {twin} vs K2 row {k2_ms}"
    return extra


def with_bench_keys(rows, extra):
    """The kernel rows with the bench keys that drive each and the kernel's
    device ms in each of the bench's twins."""
    twins = extra["kernel_device_ms"]
    for row in rows:
        kid = row["name"].split()[0]
        row["bench_keys"] = list(BENCH_KEYS_OF.get(kid, ()))
        row["bench_device_ms"] = {w: ms[kid] for w, ms in twins.items()
                                  if kid in ms}
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from vrenderer_pathtracer_tpu_torch import (
        Renderer, RenderSettings, TrainParams, opt_step, train_step)
    from vrenderer_pathtracer_tpu_torch.accel import cuda_traverse
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera
    from vrenderer_pathtracer_tpu_torch.kernels import build
    from vrenderer_pathtracer_tpu_torch.render import cuda_grad as k2
    from vrenderer_pathtracer_tpu_torch.render import cuda_radiance as k1
    from vrenderer_pathtracer_tpu_torch.render import integrator
    from vrenderer_pathtracer_tpu_torch.scene.scene import Scene
    from vrenderer_pathtracer_tpu_torch.utils.profiling import cuda_time_ms

    dev = torch.device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")

    # 1. Card.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)

    # 2. Build, and K1's check builds for phases 3 and 5.
    t0 = time.perf_counter()
    libs = build.build_all([*build.KERNELS, K1_CHECK, K1_CHECK_NOFMA,
                            cuda_traverse.K3B_CHECK], verbose=True)
    print(f"build: {time.perf_counter() - t0:.1f} s -> "
          f"{', '.join(p.name for p in libs.values())}")
    for name in ("radiance", K1_CHECK, "grad", cuda_traverse.K3B_CHECK):
        sass_opcodes(libs[name])
    k3b_ship = cuda_traverse.k3b_ingredients()
    print(f"K3b ships ingredient mask {k3b_ship} "
          f"({', '.join(n for n, b in cuda_traverse.K3B_INGREDIENTS.items() if k3b_ship & b)})")

    # 3. K1 vs plain.
    base = RenderSettings(use_cornell_box=True, has_hdr=False)
    cam = Camera.default(dev)
    for w, h, frames in ((256, 256, (1, 3)), (WIDTH, HEIGHT, (1,))):
        s = base.replace(width=w, height=h)
        scene = Scene.analytic(s, dev)
        for frame in frames:
            got = k1.render_pass_cuda(scene, s, cam, frame, 0.1, 3.0, 0)
            torch.cuda.synchronize()
            want = k1.render_pass_reference(scene, s, cam, frame, 0.1, 3.0, 0)
            k1_err = _compare(f"K1 {w}x{h} frame {frame}", got, want,
                              depth_outliers=w == WIDTH)
    small = [Renderer(64, 32, settings=base, device=d).render_frames(2)
             for d in (dev, "cpu")]
    img_err = np.abs(small[0][0] - small[1][0])
    print(f"  Renderer 64x32 cuda vs cpu: {(img_err > 1e-3).mean():.4%} "
          f"pixels off by >1e-3, max {img_err.max():.4g}")
    assert (img_err > 1e-3).any(axis=-1).mean() <= 0.02
    assert img_err.mean() <= 2e-3
    cuts = k1_cut_checks(dev, libs, base, cam)

    # 4. Render path.
    r = Renderer(WIDTH, HEIGHT, settings=base)
    assert r.device.type == "cuda" and r.settings.radiance_kernel == "cuda"
    k1.launch.count = k2.launch.count = 0
    r.render()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PASSES):
        img, depth = r.render()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / PASSES
    k1_launches = k1.launch.count
    assert k1_launches == PASSES + 1, f"K1 launched {k1_launches} times"
    assert k2.launch.count == 0
    assert r.get_frame_count() == PASSES + 2
    assert img.shape == (HEIGHT, WIDTH, 3) and depth.shape == (HEIGHT, WIDTH)
    assert torch.isfinite(img).all() and torch.isfinite(depth).all()
    mean = img.mean().item()
    assert 0.2 < mean < 0.7, f"implausible Cornell image mean {mean}"
    rays = WIDTH * HEIGHT * base.samples_per_pass * base.bounces
    print(f"render path: {WIDTH}x{HEIGHT}, {base.samples_per_pass} spp, "
          f"{base.bounces} bounces: {wall * 1e3:.3f} ms/pass wall, "
          f"{rays / wall / 1e6:.1f} Mrays/s, image mean {mean:.4f}, "
          f"K1 launches {k1_launches}")

    # 5. K1 times per pass (CUDA events), in turns: kernel, wrapper, plain,
    # plain, wrapper, kernel.  The kernel alone runs on tables packed once;
    # the wrapper also packs them on every pass (a few dozen small launches
    # the host must enqueue).  Then, in turns, K1 against the check build's
    # parent design and exact cuts alone (the same flags but the macro).
    s = r.settings
    args = (r.scene, s, r.camera, 1, r.fresnel_coef, r.fresnel_pow, 0)
    tables = (k1.pack_camera(r.camera, s, r.fresnel_coef, r.fresnel_pow),
              k1.pack_spheres(r.scene.spheres), s, 1, 0)
    timed = {"kernel": lambda: k1.launch(*tables),
             "wrapper": lambda: k1.render_pass_cuda(*args),
             "plain": lambda: k1.render_pass_reference(*args)}
    iters = {"kernel": 50, "wrapper": 50, "plain": 5}
    t = {name: [] for name in timed}
    for name in ("kernel", "wrapper", "plain", "plain", "wrapper", "kernel"):
        t[name].append(cuda_time_ms(timed[name], dev, iters=iters[name]))
    k1_ms, k1_wrapper_ms, k1_plain_ms = (sum(v) / len(v) for v in t.values())
    for name, v in t.items():
        print(f"K1 {name}: {', '.join(f'{x:.4f}' for x in v)} ms/pass "
              f"({rays / (sum(v) / len(v)) / 1e3:.1f} Mrays/s)")
    print(f"K1 {k1_ms:.4f} ms/pass, wrapper {k1_wrapper_ms:.4f}, plain "
          f"{k1_plain_ms:.4f}, {card}")
    check = k1_check_launcher(libs[K1_CHECK], dev)
    variants = {"parent design": lambda: check(*tables, K1_PARENT),
                "exact cuts": lambda: check(*tables, K1_EXACT),
                "K1 (exact cuts + kCornellFast)": lambda: k1.launch(*tables)}
    tv = {name: [] for name in variants}
    for name in [*variants, *reversed(variants)]:
        tv[name].append(cuda_time_ms(variants[name], dev, iters=50))
    k1_variant_ms = {name: sum(v) / len(v) for name, v in tv.items()}
    for name, v in tv.items():
        print(f"K1 instance {name}: {', '.join(f'{x:.4f}' for x in v)} ms/pass")

    # 6. K2 vs plain on the well-conditioned scene at a flip-free frame.
    benign = _benign_scene(dev)
    k2_err = 0.0
    sb = base.replace(width=64, height=32, samples_per_pass=2, bounces=4)
    frame = flip_free_frame(benign, sb, cam)
    target = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 0.5, (sb.n_pixels, 3)).astype(np.float32)).to(dev)
    print(f"K2 vs plain, well-conditioned scene 64x32, frame {frame}:")
    for fc, fp, with_camera in ((0.1, 3.0, False), (0.4, 1.5, False),
                                (0.1, 3.0, True)):
        a = (benign, sb, cam, target, frame, fc, fp, 0, with_camera)
        k2_err = max(k2_err, k2_small_check(a, f"sliders ({fc}, {fp}), "
                                            f"with_camera={with_camera}"))
    s35 = sb.replace(samples_per_pass=3, bounces=5)
    frame35 = flip_free_frame(benign, s35, cam)
    print(f"K2 vs plain at 3 spp x 5 bounces, frame {frame35}:")
    k2_err = max(k2_err, k2_small_check(
        (benign, s35, cam, target, frame35, 0.1, 3.0, 0, False), "sliders (0.1, 3.0)"))

    # 7. K2 at the full size on the Cornell scene.  The target: the Cornell
    # image with the light 1.5x brighter, rendered by K1 (frame 1).
    s = base.replace(width=WIDTH, height=HEIGHT)
    scene = Scene.analytic(s, dev)
    bright = scene.spheres.emission.clone()
    bright[0] *= 1.5
    target, _ = k1.render_pass_cuda(scene.replace_spheres(emission=bright), s,
                                    cam, 1, 0.1, 3.0)
    a = (scene, s, cam, target, 1, 0.1, 3.0)
    got = k2.cornell_loss_grads(*a)
    torch.cuda.synchronize()
    want = k2.cornell_loss_grads_reference(*a)
    assert all(torch.isfinite(x).all() for x in got[:5])
    # The loss: K2's is the L2 loss of K1's image, and the plain version's
    # that of the plain image, so the two differ only as far as the two
    # forward images do (held by phase 3's contract on this same frame).
    def l2(rgb):
        return torch.mean((rgb.double() - target.double()) ** 2).item()

    k1_loss = l2(k1.render_pass_cuda(scene, s, cam, 1, 0.1, 3.0)[0])
    plain_img_loss = l2(k1.render_pass_reference(scene, s, cam, 1, 0.1, 3.0)[0])
    k1_rel = abs(got[0].item() - k1_loss) / k1_loss
    plain_rel = abs(want[0].item() - plain_img_loss) / plain_img_loss
    loss_rel = abs(got[0].item() - want[0].item()) / want[0].item()
    image_rel = abs(k1_loss - plain_img_loss) / want[0].item()
    print(f"K2 {WIDTH}x{HEIGHT} Cornell: loss {got[0].item():.7g}, plain "
          f"{want[0].item():.7g} (rel err {loss_rel:.4g}; the two images' "
          f"losses differ by {image_rel:.4g}); K2 vs the L2 loss of K1's "
          f"image {k1_rel:.3g}, plain vs the plain image's {plain_rel:.3g}")
    assert k1_rel <= K1_LOSS_RTOL and plain_rel <= K1_LOSS_RTOL
    assert loss_rel <= image_rel + 2 * K1_LOSS_RTOL
    # The gradients, leaf by leaf, against limits that the planted faults
    # must exceed: each is a wrong kernel that keeps the loss.  The norm of
    # the whole gradient vector is held to the same rtol.
    grad_err = _leaf_errors(got[1:5], want[1:5])
    flat = [torch.cat([x.reshape(-1) for x in out[1:5]]).double()
            for out in (got, want)]
    norm_rel = abs(flat[0].norm() - flat[1].norm()).item() / flat[1].norm().item()
    print(f"  gradient rel err |K2 - plain| / |plain| (limit {GRAD_RTOL}): "
          + ", ".join(f"{k} {v:.4g}" for k, v in grad_err.items())
          + f"; gradient-norm rel err {norm_rel:.4g}")
    assert norm_rel <= GRAD_RTOL, f"K2 gradient-norm rel err {norm_rel}"
    packed = (k1.pack_camera(cam, s, 0.1, 3.0), k1.pack_spheres(scene.spheres),
              s, target, 1, 0)
    planted = {name: _leaf_errors(grads, want[1:5])
               for name, grads in _planted_faults(got[1:5]).items()}
    # A fault of the kernel itself: channel 1's unit-g sums scaled by
    # channel 0's g.
    faulty = k2.unpack(k2.launch(*packed, fault=True),
                       scene.spheres.count, s.n_pixels)[0]
    planted["kernel: channel 1 scaled by channel 0's g"] = _leaf_errors(
        faulty[1:5], want[1:5])
    for name, err in planted.items():
        print(f"  planted fault, {name}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in err.items()))
    for k, v in grad_err.items():
        assert v <= GRAD_RTOL, f"K2 {k} rel err {v} > {GRAD_RTOL}"
    for name, err in planted.items():
        assert max(err.values()) > GRAD_RTOL, f"{name} passes the check"
    for with_camera in (False, True):
        p1 = k2.launch(*packed, with_camera=with_camera)
        p2 = k2.launch(*packed, with_camera=with_camera)
        assert torch.equal(p1, p2), "K2 launches differ"
    print("K2 repeat launches bit-identical (with and without camera)")

    # 8. Training path: Adam on the emission, through opt_step and K2 only.
    params = TrainParams.from_scene(scene)
    params.emission.requires_grad_()
    step = opt_step(s, torch.optim.Adam([params.emission], lr=0.1))
    plain_pass = integrator.render_pass

    def no_plain(*_a, **_k):
        raise AssertionError("the plain integrator ran on the training path")

    integrator.render_pass = no_plain
    k1.launch.count = k2.launch.count = 0
    losses = []
    t0 = time.perf_counter()
    for i in range(STEPS):
        params, metrics = step(params, scene, cam, target, 1)
        losses.append(metrics["loss"].item())
        assert k2.launch.count == i + 1, f"K2 launched {k2.launch.count} times"
    train_wall = (time.perf_counter() - t0) / STEPS
    k2_launches = k2.launch.count
    integrator.render_pass = plain_pass
    assert k1.launch.count == 0
    assert all(math.isfinite(x) for x in losses)
    print(f"training path: {STEPS} Adam steps at {WIDTH}x{HEIGHT}: loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}, K2 launches {k2_launches}, "
          f"{train_wall * 1e3:.3f} ms/step wall "
          f"(loss read every step)")
    assert losses[-1] < 0.5 * losses[0], losses

    # 9. K2 times per loss + gradient step (CUDA events), in turns.
    fwdbwd_rays = 2 * rays
    p = TrainParams.from_scene(scene)
    leaves = [x.requires_grad_() for x in p.leaves()]

    def wrapper():
        loss = k2.cornell_loss(p, scene, s, cam, target, 1)
        torch.autograd.grad(loss, leaves)

    timed = {"kernel": (lambda: k2.launch(*packed), 20),
             "with_camera": (lambda: k2.launch(*packed, with_camera=True), 20),
             "wrapper": (wrapper, 20),
             "plain": (lambda: k2.cornell_loss_grads_reference(*a), 3)}
    t = {name: [] for name in timed}
    for name in [*timed, *reversed(timed)]:
        fn, n_iter = timed[name]
        t[name].append(cuda_time_ms(fn, dev, iters=n_iter))
    k2_times = {name: sum(v) / len(v) for name, v in t.items()}
    k2_ms, k2_wrapper_ms, k2_plain_ms = (
        k2_times[k] for k in ("kernel", "wrapper", "plain"))
    for name, v in t.items():
        print(f"K2 {name}: {', '.join(f'{x:.4f}' for x in v)} ms/step "
              f"({fwdbwd_rays / (sum(v) / len(v)) / 1e3:.1f} Mrays/s)")
    sgd = train_step(s)
    p = TrainParams.from_scene(scene)
    p, _ = sgd(p, scene, cam, target, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PASSES):
        p, loss = sgd(p, scene, cam, target, 1)
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) / PASSES
    print(f"K2 {k2_ms:.4f} ms/step, wrapper {k2_wrapper_ms:.4f}, plain "
          f"{k2_plain_ms:.4f}, train_step {step_wall * 1e3:.4f} ms wall "
          f"({fwdbwd_rays / step_wall / 1e6:.1f} Mrays/s), {card}")

    # 10. Where the time goes: torch.profiler over both paths.
    device_profile("render pass", r.render, 20)
    device_profile("train_step", lambda: sgd(p, scene, cam, target, 1), 20)

    # 11. Bounds on this run's inputs (frame 1, default sliders): the work
    # the kernels trace, its operations (CORNELL_OPS) and bytes; the
    # per-pipe bound, the issue bound, and the parent design's work.
    work = cornell_work(scene, s, cam, 1, 0.1, 3.0)
    ns, npx = scene.spheres.count, s.n_pixels
    print(f"work at frame 1: {work}")
    k1_bound = bound(cornell_ops(work, ns, "k1"), npx * 16)
    k2_bound = bound(cornell_ops(work, ns, "k2"), npx * 12)
    parent_ops = cornell_ops(work, ns, "parent")
    parent_k2_ops = {k: v + work["steps"] * REV_STEP.get(k, 0)
                     for k, v in parent_ops.items()}
    for name, (b_ms, by, i_ms), ms, parent in (
            ("K1", k1_bound, k1_ms, bound(parent_ops, npx * 16)),
            ("K2", k2_bound, k2_ms, bound(parent_k2_ops, npx * 12))):
        print(f"{name} bound {b_ms:.4f} ms ({by}), measured {ms:.4f} ms = "
              f"{b_ms / ms:.1%} of bound; issue bound {i_ms:.4f} ms = "
              f"{i_ms / ms:.1%}; the parent design's work: {parent[0]:.4f} ms "
              f"per pipe, {parent[2]:.4f} ms issue")
    print(f"K1 ops {cornell_ops(work, ns, 'k1')}, K2 ops "
          f"{cornell_ops(work, ns, 'k2')}, {card}")

    mesh_rows = mesh_phases(
        dev, card,
        lambda st: st.n_pixels * st.samples_per_pass * st.bounces)
    work_dir = build.BUILD_DIR / "smoke"
    k4_row = k4_phases(dev, card, work_dir, str(work_dir / "nm_sphere.obj"))
    c5_rows, k7_launches = config5_phases(dev, card, work_dir)
    k3c_row = capture_phases(dev, card, str(work_dir / "nm_sphere.obj"))
    config3_cli_phase(dev, card)
    shards = shard_phases(dev, card, libs, work_dir)
    app_phases(dev, card, work_dir)
    bench_extra = bench_phase(card, work_dir, k2_ms)
    k7_row = k7_phase(dev, card, k7_launches)
    k4_row["shards"] = shards["k4"]
    k4_row["train_params_hdr_grad"] = shards["train_hdr"]

    rows = [{
        "name": "K1 radiance",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/radiance.cu",
        "replaces": "vrenderer_pathtracer_tpu/render/pallas_radiance.py:212",
        "launches": k1_launches,
        "max_abs_err": k1_err,
        "ms": k1_ms,
        "wrapper_ms": k1_wrapper_ms,
        "instance_ms": k1_variant_ms,
        "cuts_bit_identical_nofma": cuts["nofma"],
        "cuts_elements_apart_fma": cuts["fma_apart"],
        "fault_no_fresnel_outliers": cuts["fault"],
        "shards": shards["k1"],
        "world1_pass_wall_ms": shards["world1_pass_ms"],
        "gloo_two_ranks": shards["gloo_two_ranks"],
        "plain_ms": k1_plain_ms,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "bound_issue_ms": k1_bound[2],
        "library_ms": None,
    }, {
        "name": "K2 loss + gradients",
        "route": "cuda",
        "source": "vrenderer_pathtracer_tpu_torch/csrc/grad.cu",
        "replaces": "vrenderer_pathtracer_tpu/render/pallas_grad.py:216",
        "launches": k2_launches,
        "max_abs_err": k2_err,
        "loss_rel_err_1024": loss_rel,
        "grad_rel_err_1024": grad_err,
        "grad_norm_rel_err_1024": norm_rel,
        "ms": k2_ms,
        "with_camera_ms": k2_times["with_camera"],
        "wrapper_ms": k2_wrapper_ms,
        "train_step_wall_ms": step_wall * 1e3,
        "shards": shards["k2"],
        "world1_step_wall_ms": shards["world1_step_ms"],
        "plain_ms": k2_plain_ms,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "bound_issue_ms": k2_bound[2],
        "library_ms": None,
    }, *mesh_rows, k3c_row, k4_row, *c5_rows, k7_row]
    print(json.dumps({"kernels": with_bench_keys(rows, bench_extra)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:
        gloo_rank(*sys.argv[2:])
        sys.exit(0)
    sys.exit(main())
