"""Command-line front end of the port: ``render`` to PNG, EXR and depth PNG,
``view``, and ``bench``.

The flags and defaults are the JAX package's ``cli.py``: asset loads
(``--mesh`` OBJ/PLY/FBX, ``--hdr`` EXR, ``--brdf`` MERL, ``--*-map``
images), scene toggles, camera, Fresnel and FXAA sliders, the progressive
loop to ``--spp`` with ``--checkpoint-dir`` resume and a ``--metrics``
JSONL log.  It renders on the card unless ``--cpu`` is given, and fails
when there is no card.

Example:
    python -m vrenderer_pathtracer_tpu_torch render --cornell --width 512 \\
        --height 512 --spp 64 --out cornell.png --depth-out depth.png

``--tiles`` and ``--sample-shards`` shard the render over the processes of
a ``torchrun`` launch (its ``WORLD_SIZE`` and ``RANK``; NCCL on the cards,
gloo with ``--cpu``), e.g. two tiles on the CPU:

    torchrun --nproc-per-node 2 -m vrenderer_pathtracer_tpu_torch render \\
        --cpu --tiles 2 --cornell --out cornell.png

Every rank renders its tile and holds the gathered frame; rank 0 writes
the files, the metrics log and the checkpoints.

``view`` is the live terminal viewer (``view.py``) on a renderer built
from the same flags, plus ``--cols``, ``--rows``, ``--passes`` and
``--headless``:

    python -m vrenderer_pathtracer_tpu_torch view --cornell

``bench`` is the headline benchmark (``bench.py``): K1-K5 timed on the card
at the repository's ``bench.py`` sizes, one JSON line as its last line of
output.  It runs on the card only (no ``--cpu``); ``--only`` picks
measurements beside the headline, ``--baseline`` an earlier line to
compare with, ``--trace`` a directory for the profiler's timelines:

    python -m vrenderer_pathtracer_tpu_torch bench --only mesh,paged
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _add_render_args(p: argparse.ArgumentParser):
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--spp", type=int, default=32, help="target samples per pixel")
    p.add_argument("--samples-per-pass", type=int, default=2,
                   help="samples per progressive pass (reference kSamps=2)")
    p.add_argument("--bounces", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    # scene toggles
    p.add_argument("--cornell", action="store_true", help="Cornell box mode")
    p.add_argument("--example-sphere", action="store_true")
    p.add_argument("--use-brdf", action="store_true",
                   help="shade mesh/example sphere with the loaded MERL BRDF")
    p.add_argument("--brdf-importance-sampling", action="store_true",
                   help="importance-sample the measured BRDF lobe (MIS with "
                        "cosine; lower variance on glossy tables)")
    # assets
    p.add_argument("--mesh", help="OBJ, PLY or FBX path")
    p.add_argument("--hdr", help="EXR lat-long environment map")
    p.add_argument("--brdf", help="MERL .binary path")
    p.add_argument("--diffuse-map", help="image path (linearised at load)")
    p.add_argument("--normal-map", help="image path")
    p.add_argument("--specular-map", help="image path")
    p.add_argument("--texture-gamma", type=float, default=2.2)
    # camera
    p.add_argument("--camera", type=float, nargs=3, metavar=("X", "Y", "Z"),
                   default=None, help="camera origin (default 0 0 150)")
    p.add_argument("--yaw", type=float, default=None, help="radians")
    p.add_argument("--pitch", type=float, default=None, help="radians")
    p.add_argument("--fov", type=float, default=None, help="degrees (default 75)")
    # materials
    p.add_argument("--fresnel-coef", type=float, default=0.1)
    p.add_argument("--fresnel-power", type=float, default=3.0)
    # post
    p.add_argument("--fxaa", action="store_true")
    p.add_argument("--fxaa-subpix", type=float, default=0.75)
    p.add_argument("--fxaa-edge-threshold", type=float, default=0.166)
    # outputs
    p.add_argument("--out", help="PNG output path")
    p.add_argument("--out-exr", help="EXR (linear accumulation) output path")
    p.add_argument("--depth-out", help="PNG depth-channel output path")
    # progressive / fault tolerance
    p.add_argument("--checkpoint-dir")
    p.add_argument("--metrics", help="JSONL metrics log path (per-pass ms, "
                   "Mrays/s, checkpoint/resume events)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="passes between checkpoints (0 = off)")
    # execution
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the CUDA card)")
    p.add_argument("--tiles", type=int, default=0,
                   help="tile shards (default: world size / sample shards)")
    p.add_argument("--sample-shards", type=int, default=1,
                   help="sample shards (tiles x sample shards = world size)")
    p.add_argument("--quiet", action="store_true")


def _device_mesh(args):
    """The ``(tiles, samples)`` mesh ``--tiles`` and ``--sample-shards`` ask
    for over the ``torchrun`` world (``WORLD_SIZE``, ``RANK``), or None for
    one process rendering the whole frame.  Raises ``ValueError`` when the
    shard counts do not multiply to the world size."""
    from vrenderer_pathtracer_tpu_torch.parallel import multihost
    from vrenderer_pathtracer_tpu_torch.parallel.sharding import make_render_mesh

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 and args.tiles in (0, 1) and args.sample_shards == 1:
        return None
    n_tiles = args.tiles or max(world // args.sample_shards, 1)
    if n_tiles * args.sample_shards != world:
        raise ValueError(
            f"--tiles {n_tiles} x --sample-shards {args.sample_shards} needs "
            f"{n_tiles * args.sample_shards} processes, but the world size is "
            f"{world} (run under torchrun --nproc-per-node "
            f"{n_tiles * args.sample_shards})")
    import torch.distributed as dist

    if not dist.is_initialized():
        multihost.initialize(None, world, int(os.environ.get("RANK", "0")),
                             backend="gloo" if args.cpu else None)
    return make_render_mesh(n_tiles, args.sample_shards,
                            "cpu" if args.cpu else "cuda")


def _build_renderer(args):
    """A Renderer set up from the scene, camera and material flags, on the
    card unless ``--cpu``, sharded as ``--tiles``/``--sample-shards`` ask."""
    from vrenderer_pathtracer_tpu_torch import Renderer, RenderSettings
    from vrenderer_pathtracer_tpu_torch.io import load_image

    device_mesh = _device_mesh(args)
    settings = RenderSettings(
        samples_per_pass=args.samples_per_pass,
        bounces=args.bounces,
        use_cornell_box=args.cornell,
        use_example_sphere=args.example_sphere,
        use_fxaa=args.fxaa,
    )
    r = Renderer(args.width, args.height, settings=settings, seed=args.seed,
                 device="cpu" if args.cpu else "cuda", device_mesh=device_mesh)
    if args.hdr:
        r.load_hdr(args.hdr)
    if args.mesh:
        r.load_mesh(args.mesh)
    if args.brdf:
        r.load_brdf(args.brdf)
    for kind, path in enumerate((args.diffuse_map, args.normal_map,
                                 args.specular_map)):
        if path:
            r.load_texture(load_image(path), args.texture_gamma, kind)
    if args.use_brdf:
        r.use_brdf(True)
    if args.brdf_importance_sampling:
        r.settings = r.settings.replace(brdf_importance_sampling=True)
    r.set_fresnel_coef(args.fresnel_coef)
    r.set_fresnel_power(args.fresnel_power)
    r.set_fxaa_params(subpix_quality=args.fxaa_subpix,
                      edge_threshold=args.fxaa_edge_threshold)
    cam_kw = {}
    if args.camera is not None:
        cam_kw["origin"] = args.camera
    if args.yaw is not None:
        cam_kw["yaw"] = args.yaw
    if args.pitch is not None:
        cam_kw["pitch"] = args.pitch
    if args.fov is not None:
        cam_kw["fov_deg"] = args.fov
    if cam_kw:
        r.update_camera(**cam_kw)
    return r


def cmd_render(args) -> int:
    import numpy as np

    from vrenderer_pathtracer_tpu_torch.io import save_depth_png, save_png, write_exr
    from vrenderer_pathtracer_tpu_torch.render.progressive import ProgressiveScheduler

    from vrenderer_pathtracer_tpu_torch.parallel.multihost import is_main_process

    r = _build_renderer(args)
    writes = is_main_process()
    t0 = time.perf_counter()

    def on_pass(i, spp):
        if not args.quiet and writes:
            dt = time.perf_counter() - t0
            print(f"pass {i}: {spp} spp, {dt:.2f}s, "
                  f"{dt / max(i, 1) * 1e3:.1f} ms/pass", file=sys.stderr)

    sched = ProgressiveScheduler(
        r, target_spp=args.spp,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        on_pass=on_pass,
        metrics_path=args.metrics if writes else None,
    )
    if (args.checkpoint_dir and sched.resume_if_possible() and not args.quiet
            and writes):
        print(f"resumed at {r.samples_per_pixel} spp", file=sys.stderr)
    img, depth = sched.run()
    accum = r.accumulation() if args.out_exr else None  # every rank gathers
    if not writes:
        return 0

    if args.out:
        save_png(args.out, img)
        if not args.quiet:
            print(f"wrote {args.out}", file=sys.stderr)
    if args.out_exr:
        linear = accum.cpu().numpy().reshape(
            args.height, args.width, 3) / max(r.frame - 1, 1)
        write_exr(args.out_exr, linear[::-1])
        if not args.quiet:
            print(f"wrote {args.out_exr}", file=sys.stderr)
    if args.depth_out:
        save_depth_png(args.depth_out, depth)
        if not args.quiet:
            print(f"wrote {args.depth_out}", file=sys.stderr)
    if not (args.out or args.out_exr or args.depth_out):
        print(f"rendered {r.samples_per_pixel} spp "
              f"(mean luminance {float(np.mean(img)):.4f}); "
              "no output path given (--out/--out-exr)", file=sys.stderr)
    return 0


def cmd_view(args) -> int:
    """Live progressive viewer, on the card unless ``--cpu``."""
    from vrenderer_pathtracer_tpu_torch.view import TerminalViewer

    r = _build_renderer(args)
    viewer = TerminalViewer(r, max_cols=args.cols, max_rows=args.rows)
    viewer.run(max_passes=args.passes or None,
               interactive=False if args.headless else None)
    return 0


def cmd_bench(args) -> int:
    """The headline benchmark on the card; its line is the last printed."""
    from vrenderer_pathtracer_tpu_torch import bench

    bench.run(args)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="vrenderer_pathtracer_tpu_torch",
        description="PyTorch + CUDA port of the differentiable path tracer",
    )
    sub = parser.add_subparsers(dest="command", required=True)
    pr = sub.add_parser("render", help="render a scene to PNG/EXR")
    _add_render_args(pr)
    pr.set_defaults(fn=cmd_render)
    pv = sub.add_parser(
        "view", help="live terminal viewer (arrows orbit, w/s dolly, "
        "enter toggles depth, q quits)")
    _add_render_args(pv)
    pv.add_argument("--cols", type=int, default=0, help="max display columns")
    pv.add_argument("--rows", type=int, default=0, help="max display rows")
    pv.add_argument("--passes", type=int, default=0,
                    help="stop after N passes (0 = until quit)")
    pv.add_argument("--headless", action="store_true",
                    help="no key input (for scripts/tests)")
    pv.set_defaults(fn=cmd_view)
    pb = sub.add_parser(
        "bench", help="the headline benchmark on the card (one JSON line)")
    from vrenderer_pathtracer_tpu_torch.bench import add_arguments

    add_arguments(pb)
    pb.set_defaults(fn=cmd_bench)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
