"""Analytic sphere content, SoA-packed (port of ``scene/spheres.py``).

Two small spheres (a mirror and a gray Fresnel-diffuse one) and, in Cornell
mode, the box as six giant spheres (the smallpt trick): a light and five
walls; and the example sphere's position and radius.  Rows are listed in the reference's iteration order; the
intersection keeps the earliest row on a tie, so the order is the
tie-break.
"""

from __future__ import annotations

import dataclasses

import torch

SPEC = 0
DIFF = 1
BRDF = 2


@dataclasses.dataclass(frozen=True)
class SphereSet:
    """SoA sphere tensors; every field has leading dim = number of spheres."""

    pos: torch.Tensor         # [N,3] float32
    radius: torch.Tensor      # [N]
    emission: torch.Tensor    # [N,3]
    color: torch.Tensor       # [N,3]
    refl: torch.Tensor        # [N] int32
    spec_color: torch.Tensor  # [N,3]

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device


# (radius, pos, emission, color, refl, specular_color_at_hit)
_MIRROR_AND_FRESNEL = [
    (3.5, (15.0, 0.0, 15.0), (0, 0, 0), (0, 0, 0), SPEC, (1, 1, 1)),
    (3.5, (25.0, 0.0, 15.0), (0, 0, 0), (1, 1, 1), DIFF, (1, 1, 1)),
]

_CORNELL = [
    (160.0, (0.0, 209.0, 0.0), (4.0, 3.6, 3.2), (0, 0, 0), DIFF, (0, 0, 0)),          # light
    (1e5, (1e5 + 50.0, 0.0, 0.0), (0.075, 0.025, 0.025), (0.75, 0.25, 0.25), DIFF, (0, 0, 0)),  # right wall
    (1e5, (-1e5 - 50.0, 0.0, 0.0), (0.025, 0.075, 0.025), (0.25, 0.75, 0.25), DIFF, (0, 0, 0)), # left wall
    (1e5, (0.0, 0.0, -1e5 - 100.0), (0, 0, 0), (1, 1, 1), DIFF, (0, 0, 0)),            # back wall
    (1e5, (0.0, 1e5 + 50.0, 0.0), (0, 0, 0), (1, 1, 1), DIFF, (0, 0, 0)),              # ceiling
    (1e5, (0.0, -1e5 - 50.0, 0.0), (0, 0, 0), (1, 1, 1), DIFF, (0, 0, 0)),             # floor
]

# The example sphere (white diffuse, r = 10 at the origin) that replaces the
# mesh when enabled (integrator._example_sphere_hit).
EXAMPLE_SPHERE_RADIUS = 10.0
EXAMPLE_SPHERE_POS = (0.0, 0.0, 0.0)


def _soa(rows, device) -> SphereSet:
    f32 = dict(dtype=torch.float32, device=device)
    return SphereSet(
        pos=torch.tensor([r[1] for r in rows], **f32),
        radius=torch.tensor([r[0] for r in rows], **f32),
        emission=torch.tensor([r[2] for r in rows], **f32),
        color=torch.tensor([r[3] for r in rows], **f32),
        refl=torch.tensor([r[4] for r in rows], dtype=torch.int32, device=device),
        spec_color=torch.tensor([r[5] for r in rows], **f32),
    )


def build_sphere_set(use_cornell_box: bool, device) -> SphereSet:
    """Analytic spheres in the reference's order: Cornell shells first."""
    rows = (_CORNELL if use_cornell_box else []) + _MIRROR_AND_FRESNEL
    return _soa(rows, device)


def example_sphere(device) -> SphereSet:
    """The example sphere as a one-row set: white diffuse, r = 10 at the
    origin."""
    return _soa([(EXAMPLE_SPHERE_RADIUS, EXAMPLE_SPHERE_POS, (0, 0, 0),
                  (1, 1, 1), DIFF, (0, 0, 0))], device)
