"""The cameras of a render traffic mix, drawn from the run's seed.

A view is a plain dict.  ``{"kind": "drag", "dx", "dy"}`` is a user's drag
of the default camera (origin (0, 0, 150), yaw 0, pitch 0, fov 75) by
whole pixels; ``{"kind": "orbit", "origin", "yaw", "pitch", "fov_deg"}``
is a camera placed on a sphere about the scene's centre, looking at it.
:func:`camera` gives the camera a float32 program computes from either.
"""

from __future__ import annotations

import numpy as np

# Radians per pixel of a drag (the viewer's left-button orbit).
DRAG_RAD_PER_PX = np.float32(0.00174532925)
DEFAULT = {"origin": (0.0, 0.0, 150.0), "yaw": 0.0, "pitch": 0.0,
           "fov_deg": 75.0}


def spec(views: dict, seed: int, index: int) -> dict:
    """The ``index``-th view of a run under the traffic's ``views``."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, 100, index])
    if views["kind"] == "drag":
        return {"kind": "drag",
                "dx": int(rng.integers(-views["dx_px"], views["dx_px"] + 1)),
                "dy": int(rng.integers(-views["dy_px"], views["dy_px"] + 1))}
    if views["kind"] == "orbit":
        yaw = rng.uniform(-np.pi, np.pi)
        pitch = np.radians(rng.uniform(-views["pitch_deg"], views["pitch_deg"]))
        fwd = np.array([np.sin(yaw) * np.cos(pitch), np.sin(pitch),
                        np.cos(yaw) * np.cos(pitch)])
        f = np.float32
        return {"kind": "orbit",
                "origin": [float(f(x)) for x in views["distance"] * fwd],
                "yaw": float(f(yaw)), "pitch": float(f(pitch)),
                "fov_deg": float(f(views["fov_deg"]))}
    raise ValueError(f"unknown view kind {views['kind']!r}")


def camera(view: dict) -> dict:
    """{origin, yaw, pitch, fov_deg} of ``view``, as float32 arithmetic
    gives them (a drag: ``yaw = 0 + s * dx``, the pitch clamped to
    +-pi/2)."""
    if view["kind"] == "orbit":
        return {k: view[k] for k in ("origin", "yaw", "pitch", "fov_deg")}
    f = np.float32
    return dict(DEFAULT,
                yaw=float(f(0.0) + DRAG_RAD_PER_PX * f(view["dx"])),
                pitch=float(np.clip(f(0.0) + DRAG_RAD_PER_PX * f(view["dy"]),
                                    f(-np.pi / 2), f(np.pi / 2))))
