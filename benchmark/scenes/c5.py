"""The ``c5`` configuration in the program: the seeded high-poly mesh,
HDRI and glossy MERL table through the ``Renderer``'s loaders (the mesh
from an OBJ written to the run's temporary directory), FXAA, MERL shading
and bounce remat as the config-5 example sets them; the wavefront with K5
on the card."""

from __future__ import annotations

import os
import tempfile

from benchmark import program
from benchmark.reference import c5_assets


def renderer(run):
    from vrenderer_pathtracer_tpu_torch import Renderer

    from benchmark import harness

    c = run.cfg
    s = program.settings(run, use_brdf=True, remat_bounces=c["remat_bounces"])
    r = Renderer(s.width, s.height, settings=s, seed=run.seed,
                 device=run.device, device_mesh=program.render_mesh(run))
    r.set_fresnel_coef(c["fresnel_coef"])
    r.set_fresnel_power(c["fresnel_pow"])
    r.load_hdr(c5_assets.hdri(c, run.seed))
    r.load_brdf(c5_assets.merl(c, run.seed))
    harness.note(run, "HDRI and MERL table loaded")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh.obj")
        with open(path, "w") as f:
            f.write(c5_assets.obj_text(*c5_assets.mesh(c, run.seed)))
        harness.note(run, "OBJ written")
        r.load_mesh(path)
    harness.note(run, "mesh loaded")
    return r


apply_view = program.apply_view
