"""Display transform (port of ``ops/tonemap.py``): progressive scaling,
clamp, gamma, 8-bit quantisation."""

from __future__ import annotations

import torch


def tonemap(accum: torch.Tensor, frame, gamma: float = 2.2) -> torch.Tensor:
    """Accumulated radiance [..,3] + frame count -> display-linear [0,1]."""
    color = torch.clamp(accum / frame, 0.0, 1.0)
    return torch.pow(color, 1.0 / gamma)


def to_uint8(img01: torch.Tensor) -> torch.Tensor:
    return (img01 * 255.0).to(torch.uint8)


def depth_to_uint8(depth: torch.Tensor) -> torch.Tensor:
    """The reference packs (1-depth)*255 into the depth texture."""
    return ((1.0 - depth) * 255.0).to(torch.uint8)
