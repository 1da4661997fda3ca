"""Faults planted in the program's inverse-rendering step of a table-valued
scene, for showing that the ``c5inverse`` cell's ``correct`` catches them
(the tests, and on the card through ``controls.py``'s runs).  Each planter
takes ``patch(obj, name, value)``, as ``faults.py``'s do, and breaks the
program's path only: the loops and the references are left as they are.

    python3 benchmark/grad_faults.py --workload c5inverse.grad8 \\
        --seeds 1 2 --mode hdr_texel_off

runs ``controls.py`` with these faults among its modes.
"""

from __future__ import annotations

import pathlib
import sys

import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def hdr_texel_off(patch):
    """Each HDRI fetch returns its texel's value, and its gradient lands on
    the next texel of the row."""
    from vrenderer_pathtracer_tpu_torch.ops import envmap

    real = envmap.sample_env_nearest

    def off(hdr, ray_d):
        g = real(torch.roll(hdr, -1, dims=1), ray_d)
        return real(hdr.detach(), ray_d) + (g - g.detach())
    patch(envmap, "sample_env_nearest", off)


def remat_other_frame(patch):
    """The remat recompute in the backward pass draws the next frame's
    samples, not those its forward pass drew."""
    from vrenderer_pathtracer_tpu_torch.core import rng

    real = rng.bounce_uniforms

    def draws(seed, pix, samp, frame, bounce, n_slots):
        return real(seed, pix, samp, frame + 1 if _in_backward() else frame,
                    bounce, n_slots)
    draws.count, draws.lanes = real.count, real.lanes
    patch(rng, "bounce_uniforms", draws)


def merl_last_bounce_dropped(patch):
    """The MERL table's gradient through the last bounce whose scatter
    weight reaches the image (the one before the last: the last bounce's
    weight is never used) left out."""
    from vrenderer_pathtracer_tpu_torch.render import integrator

    real = integrator._shade

    def shade(ctx, hd, ray_o, ray_d, mask, alive, pix, samp, bounce):
        if bounce == ctx.settings.bounces - 2 and ctx.brdf_table is not None:
            ctx = ctx._replace(brdf_table=ctx.brdf_table.detach())
        return real(ctx, hd, ray_o, ray_d, mask, alive, pix, samp, bounce)
    patch(integrator, "_shade", shade)


FAULTS = {"hdr_texel_off": hdr_texel_off,
          "remat_other_frame": remat_other_frame,
          "merl_last_bounce_dropped": merl_last_bounce_dropped}


if __name__ == "__main__":
    from benchmark import controls, faults

    faults.FAULTS.update(FAULTS)
    sys.exit(controls.main())
