"""Virtual camera: orientation state, orthonormal basis, primary rays.

Port of ``vrenderer_pathtracer_tpu/core/camera.py``:

* yaw/pitch -> ``forward = (sin(yaw)cos(pitch), sin(pitch), cos(yaw)cos(pitch))``;
  the view direction is ``-forward``.
* ``right = normalize(cross(forward + (0,1,0), forward))``,
  ``up = cross(forward, right)``, ``fov_scale = tan(fov_deg * pi/360)``.
* per-pixel ray ``d = dir + cx*((0.25+x)/w - 0.5) + cy*((0.25+y)/h - 0.5)``
  with ``cx = fov_scale*(w/h)*right``, ``cy = fov_scale*up``: a fixed
  quarter-pixel offset, no jitter.

Every leaf is a float32 tensor, so autograd reaches ``origin``/``yaw``/
``pitch``/``fov_deg`` from the pixels.  ``orbit`` and ``move_forward`` are
the reference's mouse controls as pure updates (the viewer's keys and
drags).
"""

from __future__ import annotations

import dataclasses
import math

import torch


def _sincos(angle: torch.Tensor):
    """float32 sin and cos of ``angle``, computed in float64 and rounded
    once: the correctly rounded values, which XLA's float32 sin and cos
    give on all but ~1.3% of inputs and torch's on only ~95% of them."""
    a = angle.double()
    return torch.sin(a).float(), torch.cos(a).float()


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True)


def _forward(sy, cy, sp, cp) -> torch.Tensor:
    """The unit forward vector from the sines and cosines of yaw and pitch
    (the view direction is its negation)."""
    return _normalize(torch.stack([sy * cp, sp, cy * cp]))


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera parameters; all leaves are float32 tensors on one device."""

    origin: torch.Tensor   # [3]
    yaw: torch.Tensor      # scalar, radians
    pitch: torch.Tensor    # scalar, radians
    fov_deg: torch.Tensor  # scalar, degrees

    @classmethod
    def default(cls, device) -> "Camera":
        """Reference defaults: position (0,0,150), fov 75 degrees."""
        f32 = dict(dtype=torch.float32, device=device)
        return cls(
            origin=torch.tensor([0.0, 0.0, 150.0], **f32),
            yaw=torch.tensor(0.0, **f32),
            pitch=torch.tensor(0.0, **f32),
            fov_deg=torch.tensor(75.0, **f32),
        )

    @property
    def device(self) -> torch.device:
        return self.origin.device

    def replace(self, **kw) -> "Camera":
        return dataclasses.replace(self, **kw)

    def basis(self):
        """Return ``(origin, view_dir, up, right, fov_scale)``."""
        forward = _forward(torch.sin(self.yaw), torch.cos(self.yaw),
                           torch.sin(self.pitch), torch.cos(self.pitch))
        bent = forward + torch.tensor([0.0, 1.0, 0.0], dtype=forward.dtype,
                                      device=forward.device)
        right = _normalize(torch.linalg.cross(bent, forward))
        up = torch.linalg.cross(forward, right)
        fov_scale = torch.tan(self.fov_deg * (math.pi / 360.0))
        return self.origin, -forward, up, right, fov_scale

    def with_pitch_clamped(self) -> "Camera":
        """Clamp |pitch| to pi/2, as the reference does."""
        half_pi = math.pi / 2
        return self.replace(pitch=torch.clamp(self.pitch, -half_pi, half_pi))

    # -- interaction (the reference's mouse controls, as pure updates) ------

    # LMB drag sensitivity: radians per pixel.
    DRAG_RAD_PER_PX = 0.00174532925

    def _f32(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def orbit(self, dx_px, dy_px) -> "Camera":
        """LMB drag: dx -> yaw, dy -> pitch, then the pitch clamp.  The step
        is a float32 constant times a float32 delta, as in the JAX package,
        so a key script gives its yaw and pitch bit for bit."""
        s = self._f32(self.DRAG_RAD_PER_PX)
        return self.replace(
            yaw=self.yaw + s * self._f32(dx_px),
            pitch=self.pitch + s * self._f32(dy_px),
        ).with_pitch_clamped()

    def move_forward(self, amount) -> "Camera":
        """RMB drag: translate along the view direction.  Its sines and
        cosines are rounded once from float64 (``_sincos``), so that a key
        script moves the camera as the JAX package does, bit for bit;
        ``basis``, which every render pass and train step packs, keeps the
        float32 ones and their fewer device operations."""
        view_dir = -_forward(*_sincos(self.yaw), *_sincos(self.pitch))
        return self.replace(origin=self.origin + view_dir * self._f32(amount))


def generate_rays(camera: Camera, width: int, height: int):
    """Primary rays for every pixel, flattened row-major (id = x + y*width),
    through the reference's fixed 0.25 sub-pixel offset.

    Returns ``(origins [N,3], directions [N,3])`` with N = width*height.
    """
    origin, view_dir, up, right, fov_scale = camera.basis()
    cx = (fov_scale * (width / height)) * right  # [3]
    cy = fov_scale * up                          # [3]

    f32 = dict(dtype=torch.float32, device=origin.device)
    xx = torch.arange(width, **f32).repeat(height)                # pixel x
    yy = torch.arange(height, **f32).repeat_interleave(width)     # pixel y
    u = (0.25 + xx) / width - 0.5
    v = (0.25 + yy) / height - 0.5

    d = view_dir[None, :] + u[:, None] * cx[None, :] + v[:, None] * cy[None, :]
    d = _normalize(d)
    return origin[None, :].expand(d.shape), d


def pixel_ids(width: int, height: int, device) -> torch.Tensor:
    """Row-major pixel ids (id = x + y*width), the RNG counters; int64."""
    return torch.arange(width * height, dtype=torch.int64, device=device)
