"""The program's entry points as the cells' scenes and loops use them:
the camera of a view, and the device mesh of a sharded renderer.  Every
call here is one a user of the port makes."""

from __future__ import annotations


def apply_view(run, renderer, view: dict) -> None:
    """Move ``renderer``'s camera to ``view`` (``reference/views.py``): a
    drag of the default camera through ``Camera.orbit``, or an orbit
    camera through ``Renderer.update_camera``."""
    from vrenderer_pathtracer_tpu_torch.core.camera import Camera

    if view["kind"] == "drag":
        renderer.set_camera(Camera.default(renderer.device).orbit(
            view["dx"], view["dy"]))
    else:
        renderer.update_camera(origin=view["origin"], yaw=view["yaw"],
                               pitch=view["pitch"], fov_deg=view["fov_deg"])


def render_mesh(run):
    """The ``(tiles, 1)`` device mesh of a traffic with ``tiles`` > 1 (the
    CLI's ``--tiles``), else None."""
    tiles = run.traffic.get("tiles", 1)
    if tiles == 1:
        return None
    from vrenderer_pathtracer_tpu_torch.parallel import make_render_mesh

    return make_render_mesh(tiles, 1, run.device.type)


def settings(run, **kw):
    """The configuration's ``RenderSettings`` at the traffic's size."""
    from vrenderer_pathtracer_tpu_torch import RenderSettings

    c, t = run.cfg, run.traffic
    return RenderSettings(width=t["width"], height=t["height"],
                          samples_per_pass=t["spp_per_pass"],
                          bounces=c["bounces"], use_fxaa=c["fxaa"], **kw)
